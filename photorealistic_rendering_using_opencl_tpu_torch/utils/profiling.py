"""The port's tracer and its device traces.

Port of ``photorealistic_rendering_using_opencl_tpu/utils/profiling.py``.
The reference's ``Metrics`` times spans with a host clock; on the card that
clock measures the enqueue, so here ``Metrics`` is the program's tracer,
whose spans are ranges of ``torch.profiler`` itself (on the clock of the
device events it records beside them) and whose counters are read after
the traced region.  The reference's ``xla_trace`` (a ``jax.profiler``
scope) becomes ``torch_trace``, a ``torch.profiler`` scope that writes a
Chrome trace.

The tracer records while a ``torch.profiler`` session records, and never
otherwise: ``torch_trace`` (the CLI's ``--profile``) and the benchmark's
traced region switch it on by starting one, and off by stopping it.  Off,
a span is one shared no-op context and a counter returns at once.

Spans (``request``, an argument of each, is the number of the pass or step
they belong to; a profiler that records shapes shows it):

- ``prt.pass``: one progressive pass (``pathtracer.progressive_step``);
- ``prt.forward``: one differentiable render and its loss (the loss
  function ``diff.inverse.make_loss_fn`` returns);
- ``prt.intersect``: one merged dispatch
  (``intersect.intersect_and_shadow_detached``: W1 or K1, the analytic
  hits, the shadow rays), and one reattachment of its winners to the
  differentiable scene (``intersect.finish_hit``);
- ``prt.shade``: one shading step (``integrator.shade_step``);
- ``prt.recompute``: one re-run of a checkpointed segment in the backward
  (``integrator.trace``, ``pathtracer.trace_regen_scan``);
- ``prt.sky_grad``: one backward node of a sky lookup's four taps
  (``envmap.sample_bilinear``), the scatter of the sky map's gradient.

Counters: ``loop.bounces`` / ``regen.iterations`` (shading steps of the
bounce loop and of the regeneration loop, forward only), ``loop.lanes`` /
``regen.lanes`` (the lanes those steps shaded), ``loop.live_lanes`` /
``regen.live_lanes`` (the lanes alive entering them), ``w1.launches`` and
``w1.rays`` (calls of ``intersect.bvh_traverse`` and the rays they asked
to walk), ``sky_grad.taps`` (4 a lane of each backward of the sky lookup,
``envmap.BilinearLookup``) and ``sky_grad.writes`` (the texel writes its
kernel made: 4 a lane whose gradient is not zero).  A count the device
holds is kept as its tensor (a mask, or a kernel's counts a block) and
summed by ``value``, after the region, so that counting launches no
kernel inside it.
"""
from __future__ import annotations

import contextlib
import functools
import os
import threading

import torch
import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast

_NO_SPAN = contextlib.nullcontext()


def in_backward() -> bool:
    """Whether autograd's engine runs the calling code (a checkpoint's
    re-run, a backward node or its hooks)."""
    return torch._C._current_graph_task_id() != -1


class Metrics:
    """The program's spans and counters.  ``TRACER`` is the instance the
    program records into."""

    def __init__(self):
        self.request = 0  # the number of the pass or step begun last
        self.counters: dict[str, int] = {}
        self._tensors: dict[str, list] = {}
        self._recording = False  # the last pass or step began under a profiler
        self._local = threading.local()  # request of an open backward span

    @property
    def on(self) -> bool:
        """Whether a ``torch.profiler`` session records (torch's own flag,
        which it reads for the same purpose)."""
        return _profiler._is_profiler_enabled

    def begin(self, name: str):
        """The span of a new pass or step.  The first one begun under a
        profiler after one begun without clears the counters, so that they
        hold the profiled passes or steps."""
        self.request += 1
        on = self.on
        if on and not self._recording:
            self.reset()
        self._recording = on
        return self.span(name)

    def span(self, name: str, request: int | None = None):
        """A profiler range named ``name`` carrying ``request`` (by default
        that of the enclosing backward span, else of the current pass or
        step); the shared no-op context when off."""
        if not self.on:
            return _NO_SPAN
        if request is None:
            request = getattr(self._local, "request", None) or self.request
        return _RecordFunctionFast(name, [], {"request": request})

    @contextlib.contextmanager
    def _backward_span(self, name: str, request: int):
        outer = getattr(self._local, "request", None)
        self._local.request = request
        try:
            with self.span(name, request):
                yield
        finally:
            self._local.request = outer

    def recompute(self, request: int):
        """``prt.recompute`` around a checkpointed segment: a span when
        autograd's engine runs it (the backward's re-run), none in the
        forward.  ``request`` is the forward's."""
        if not self.on or not in_backward():
            return _NO_SPAN
        return self._backward_span("prt.recompute", request)

    def span_nodes(self, name: str, nodes) -> None:
        """``name`` around each run of the autograd ``nodes`` (opened by a
        pre-hook, closed by a hook), carrying the current request.  Only
        while on, and in the forward: a checkpoint's re-run builds nodes
        that never run."""
        if not self.on or in_backward():
            return
        request = self.request
        for node in nodes:
            if node is None:
                continue
            open_spans = []

            def enter(grad_outputs, open_spans=open_spans):
                cm = self._backward_span(name, request)
                cm.__enter__()
                open_spans.append(cm)

            def leave(grad_inputs, grad_outputs, open_spans=open_spans):
                open_spans.pop().__exit__(None, None, None)

            node.register_prehook(enter)
            node.register_hook(leave)

    def count(self, name: str, n: int = 1) -> None:
        """Add the host integer ``n`` to counter ``name``, while on."""
        if self.on:
            self.counters[name] = self.counters.get(name, 0) + int(n)

    def count_mask(self, name: str, mask: torch.Tensor) -> None:
        """Add ``mask``'s true entries to counter ``name``, while on: the
        mask is kept with its version and summed by ``value``."""
        self.count_tensor(name, mask)

    def count_tensor(self, name: str, counts: torch.Tensor) -> None:
        """Add the sum of ``counts``' entries (a mask, or the counts a
        kernel wrote one a block) to counter ``name``, while on: the tensor
        is kept with its version and summed by ``value``."""
        if self.on:
            self._tensors.setdefault(name, []).append((counts, counts._version))

    def shaded(self, loop: str, step: str, alive: torch.Tensor) -> None:
        """One shading step of ``loop`` in the forward: ``loop.step`` + 1,
        ``loop.lanes`` + the lanes, ``loop.live_lanes`` + those alive."""
        if not self.on or in_backward():
            return
        self.count(f"{loop}.{step}")
        self.count(f"{loop}.lanes", alive.shape[0])
        self.count_mask(f"{loop}.live_lanes", alive)

    def value(self, name: str) -> int:
        """Counter ``name``: its host integers and its tensors' sums
        (raises if a tensor was changed in place after it was counted)."""
        total = self.counters.get(name, 0)
        for counts, version in self._tensors.get(name, ()):
            if counts._version != version:
                raise RuntimeError(f"counter {name!r}: a tensor was changed "
                                   "in place after it was counted")
            total += int(counts.sum())
        return total

    def reset(self) -> None:
        self.counters.clear()
        self._tensors.clear()


TRACER = Metrics()


def spanned(name: str, request: bool = False):
    """Decorator: the function's calls run inside span ``name`` while the
    tracer is on; with ``request`` each call begins a new pass or step."""
    def wrap(fn):
        if request:
            @functools.wraps(fn)
            def begun(*args, **kwargs):
                with TRACER.begin(name):
                    return fn(*args, **kwargs)
            return begun

        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not TRACER.on:
                return fn(*args, **kwargs)
            with TRACER.span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def torch_trace(logdir: str | None):
    """The port's ``xla_trace``: a ``torch.profiler`` scope over the host
    and, where a card is present, its CUDA kernels, with the tracer's spans
    and their ``request`` arguments; on exit it writes the Chrome trace
    ``logdir/trace.json`` (open it in Perfetto or chrome://tracing).  A
    no-op when ``logdir`` is None."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=acts, record_shapes=True)
    prof.start()
    try:
        yield
    finally:  # an interrupted render keeps its trace, as the reference's
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))
