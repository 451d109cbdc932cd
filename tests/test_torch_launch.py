"""How the port's kernel wrappers launch, checked on the CPU with a stand-in
for the kernel library: every wrapper calls into C inside its tensors'
device (not whatever device is current), and K2's bands, which keep each
launch's float indices within 32 bits, cover any image the reference
tonemaps.  The kernels themselves run in tests/test_torch_cuda.py."""
import contextlib

import numpy as np
import pytest
import torch

from photorealistic_rendering_using_opencl_tpu_torch.ops import (
    _cuda, bvh_walk, compaction, mesh_brute, passthrough,
)
from photorealistic_rendering_using_opencl_tpu_torch.ops import tonemap as tm

INT_MAX = 2**31 - 1


class _FakeLibrary:
    """Stands in for ``_cuda.LIBRARY``: each ``prt_*`` entry records its
    name, its arguments and the device current at the call, and reports
    success."""

    def __init__(self, state):
        self.state = state

    def get(self):
        return self

    def __getattr__(self, name):
        if not name.startswith("prt_"):
            raise AttributeError(name)

        def entry(*args):
            self.state["calls"].append((name, self.state["current"], args))
            return 0
        return entry


@pytest.fixture
def fake_cuda(monkeypatch):
    """``torch.cuda.device`` as a context that tracks the current device
    (cuda:0 outside any), the library and the stream replaced."""
    state = {"current": torch.device("cuda", 0), "calls": []}

    @contextlib.contextmanager
    def device(dev):
        before, state["current"] = state["current"], torch.device(dev)
        try:
            yield
        finally:
            state["current"] = before

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(_cuda, "LIBRARY", _FakeLibrary(state))
    monkeypatch.setattr(_cuda, "stream_handle", lambda t: 0)
    return state


def _k1():
    n, nt = 40, 2
    z = torch.zeros
    args = (z((mesh_brute.FEAT, 4 * mesh_brute.TILE * nt)), z((nt, 8)),
            z((n, 3)), z((n, 3)), z((n,)), torch.ones(n, dtype=torch.bool),
            z(n, dtype=torch.bool), torch.full((n,), -1, dtype=torch.int32))
    return mesh_brute.mesh_brute_kernel, args, "prt_mesh_brute"


def _t1():
    n, nt, block = 300, 3, 128
    args = (torch.zeros((3, 1), dtype=torch.int32),
            torch.zeros((mesh_brute.FEAT, n)),
            torch.zeros((mesh_brute.FEAT, 4 * mesh_brute.TILE * nt)), block)
    return mesh_brute.matmul_only_kernel, args, "prt_matmul_only"


def _w1():
    n, m = 40, 3
    z = torch.zeros
    args = (z((m, 8)), z((8 * m, 2), dtype=torch.int32), z((2, 36)),
            z((n, 3)), z((n, 3)), z((n,)), torch.ones(n, dtype=torch.bool),
            z(n, dtype=torch.bool), True)
    return bvh_walk.bvh_walk_kernel, args, "prt_bvh_walk"


WRAPPERS = {
    "K1": _k1,
    "K2": lambda: (tm.tonemap_kernel, (torch.zeros((5, 7, 3)), True, 1.0),
                   "prt_tonemap"),
    "K3": lambda: (compaction.block_scan_kernel,
                   (torch.zeros(256, dtype=torch.int32), 64),
                   "prt_block_scan"),
    "T1": _t1,
    "T2a": lambda: (passthrough.passthrough_kernel, (torch.zeros((9, 3)),),
                    "prt_passthrough"),
    "T2b": lambda: (passthrough.passthrough_flat_kernel,
                    (torch.zeros(256),), "prt_passthrough"),
    "W1": _w1,
}


@pytest.mark.parametrize("kernel", list(WRAPPERS))
def test_wrapper_launches_on_its_tensors_device(fake_cuda, kernel):
    """With cuda:0 current and the tensors elsewhere (here on the CPU, so
    that no card is needed), the C entry runs inside the tensors' device,
    once, and the launch count moves by one; cuda:0 is current again
    after."""
    wrapper, args, entry = WRAPPERS[kernel]()
    before = wrapper.launches
    wrapper(*args)
    assert [(name, dev) for name, dev, _ in fake_cuda["calls"]] == [
        (entry, torch.device("cpu"))]
    assert wrapper.launches == before + 1
    assert fake_cuda["current"] == torch.device("cuda", 0)


def test_w1_launch_arguments(fake_cuda):
    """W1's C entry gets every table, lane and output pointer, the node
    visits and the W1_COUNTERS-word counters where asked, nothing else (its
    ray pool is in shared memory), then the stream; counters of another
    length are refused before any launch."""
    wrapper, args, entry = _w1()
    counters = torch.zeros(bvh_walk.W1_COUNTERS, dtype=torch.int64)
    t, tri, u, v, steps = wrapper(*args[:8], count_steps=True,
                                  counters=counters)
    [(name, dev, c_args)] = fake_cuda["calls"]
    assert (name, dev) == (entry, torch.device("cpu"))
    assert len(c_args) == len(_cuda._SIGNATURES[entry]) == 17
    assert c_args[10:16] == tuple(x.data_ptr() for x in (t, tri, u, v, steps,
                                                         counters))
    assert bvh_walk.W1_COUNTERS == 5
    with pytest.raises(ValueError):
        wrapper(*args[:8], counters=torch.zeros(3, dtype=torch.int64))
    assert len(fake_cuda["calls"]) == 1
    wrapper(*args[:8])
    assert fake_cuda["calls"][1][2][14:16] == (None, None)


# ---------------------------------------------------------------------------
# F10: K2's bands
# ---------------------------------------------------------------------------

def _kernel_coords(p0, n, w, y0, x0, g):
    """csrc/tonemap.cu's index arithmetic for groups ``g`` of 4 pixels of
    the band (p0, n, y0, x0): the float offset of the group in the band's
    view (int32) and the (row, column) of its first pixel (uint32 sum and
    division), with numpy's fixed-width integers."""
    g = np.asarray(g, np.int64)
    offset = np.int32(12) * g.astype(np.int32)
    pos = np.uint32(x0) + np.uint32(4) * g.astype(np.uint32)
    q = pos // np.uint32(w)
    return offset, y0 + q.astype(np.int64), (pos - q * np.uint32(w)).astype(
        np.int64)


@pytest.mark.parametrize("h,w", [(26755, 26755), (8192, 87382),
                                 (1, 715827883), (46341, 46341)])
def test_bands_cover_images_past_int32(h, w):
    """Images with 3*H*W just above 2^31 - 1 and far above it: the bands
    tile the pixels in order, each starts on a 16-byte boundary of an
    aligned image with its row and column, and each band's largest float
    index, group offset and column sum fit the kernel's 32-bit types; the
    first and last groups and tail pixels of every band land on the
    pixel they stand for."""
    assert 3 * h * w > INT_MAX
    bands = tm.bands(h, w)
    assert len(bands) > 1
    p = 0
    for p0, n, y0, x0 in bands:
        assert p0 == p and 0 < n <= tm.BAND_PIXELS and 3 * n <= INT_MAX
        assert (12 * p0) % 16 == 0 and (y0, x0) == divmod(p0, w)
        groups = n // 4
        g = np.array(sorted({0, 1, max(groups - 1, 0)}))
        offset, y, x = _kernel_coords(p0, n, w, y0, x0, g)
        np.testing.assert_array_equal(offset, 12 * g)
        want = np.array([divmod(p0 + 4 * int(k), w) for k in g])
        np.testing.assert_array_equal(np.stack([y, x], 1), want)
        # the tail: pixels 4 * groups .. n - 1, one a thread
        for t in range(4 * groups, n):
            pos = np.uint32(x0) + np.uint32(t)
            assert (y0 + int(pos // np.uint32(w)),
                    int(pos % np.uint32(w))) == divmod(p0 + t, w)
        assert x0 + 4 * groups + 3 < 2**32 and 3 * n - 1 <= INT_MAX
        p += n
    assert p == h * w and bands[-1][2] < h


def test_k2_wrapper_launches_each_band(fake_cuda, monkeypatch):
    """One C call a band, at the band's first pixel's byte offset, with the
    whole image's h and w and the band's row and column (bands of 12
    pixels on a 5x7 image start mid-row)."""
    monkeypatch.setattr(tm, "BAND_PIXELS", 12)
    img = torch.zeros((5, 7, 3))
    before = tm.tonemap_kernel.launches
    out = tm.tonemap_kernel(img, True, 1.0)
    calls = [args for name, _, args in fake_cuda["calls"]]
    assert tm.tonemap_kernel.launches == before + 3
    want = [(0, 12, 0, 0), (12, 12, 1, 5), (24, 11, 3, 3)]
    assert tm.bands(5, 7) == want
    assert [(src - img.data_ptr(), dst - out.data_ptr(), n, w, h, y0, x0)
            for src, dst, n, w, h, y0, x0, *_ in calls] == [
        (12 * p0, 12 * p0, n, 7, 5, y0, x0) for p0, n, y0, x0 in want]
