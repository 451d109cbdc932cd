"""Host SAH BVH build (numpy) -> threaded flat arrays.

Port of ``photorealistic_rendering_using_opencl_tpu/scene/bvh_build.py``
(``build_bvh``, ``build_bvh_py``, ``permute_triangles``, ``pack_for_device``,
``thread_octants``).  The build serves both mesh backends: the brute tables
are packed in BVH order so that consecutive 128-triangle tiles are
spatially compact, and ``pack_for_device`` lays the tree out for the
skip-link walk (ops/intersect.py: ``bvh_traverse``; ops/bvh_walk.py).
Its arrays are bitwise the reference's for the same ``FlatBVH``; the
reference's per-leaf copy and per-node DFS are vectorised here (a
327,680-triangle mesh has ~160,000 nodes, eight threadings of them).

The native build and ``build_bvh_py`` are both sweep-SAH builds but do
NOT give the same ``order`` on every mesh (they differ on the
81,920-triangle ``icosphere_hi.obj``), so triangle indices are only
comparable between two scenes built by the same implementation.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

LEAF_SIZE = 4
TRAVERSAL_COST = 1.0
INTERSECT_COST = 1.0


class FlatBVH(NamedTuple):
    bounds_min: np.ndarray  # [M,3]
    bounds_max: np.ndarray  # [M,3]
    miss: np.ndarray  # [M] int32; == M when traversal ends
    first_prim: np.ndarray  # [M] int32
    prim_count: np.ndarray  # [M] int32 (0 for inner nodes)
    order: np.ndarray  # [T] permutation: new position -> original triangle


def build_bvh(tri_verts: np.ndarray) -> FlatBVH:
    """tri_verts [T,3,3] -> flat threaded BVH (sweep SAH, leaf<=LEAF_SIZE).

    Uses the native library (runtime/native.py) when it builds, else the
    Python implementation; set PRT_NO_NATIVE=1 to force the latter.
    """
    from photorealistic_rendering_using_opencl_tpu_torch.runtime import native
    res = native.build_bvh_native(tri_verts)
    if res is not None:
        bmin, bmax, miss, first, count, order = res
        return FlatBVH(bmin, bmax, miss, first, count, order)
    return build_bvh_py(tri_verts)


def build_bvh_py(tri_verts: np.ndarray) -> FlatBVH:
    """Pure-numpy sweep-SAH build."""
    t = tri_verts.shape[0]
    lo = tri_verts.min(axis=1)
    hi = tri_verts.max(axis=1)
    centers = (lo + hi) * 0.5
    order = np.arange(t, dtype=np.int64)

    n_min, n_max, n_first, n_count = [], [], [], []
    # preorder DFS with an explicit stack: an inner node's left child is
    # node + 1, so the "hit" successor needs no pointer
    stack = [(0, t)]
    while stack:
        begin, end = stack.pop()
        seg = order[begin:end]
        n_min.append(lo[seg].min(axis=0))
        n_max.append(hi[seg].max(axis=0))
        split = _find_split(lo, hi, centers, order, begin, end)
        if split is None:
            n_first.append(begin)
            n_count.append(end - begin)
            continue
        axis, mid = split
        order[begin:end] = seg[np.argsort(centers[seg, axis], kind="stable")]
        n_first.append(0)
        n_count.append(0)
        stack.append((begin + mid, end))  # right pushed first: left pops first
        stack.append((begin, begin + mid))

    m = len(n_min)
    prim_count = np.asarray(n_count, np.int32)
    # subtree of node i is [i, subtree_end[i]) in preorder
    subtree_end = np.empty(m, np.int64)
    for i in range(m - 1, -1, -1):
        subtree_end[i] = (i + 1 if prim_count[i] > 0
                          else subtree_end[subtree_end[i + 1]])
    miss = np.empty(m, np.int32)
    miss_stack = [(0, m)]
    while miss_stack:
        i, mlink = miss_stack.pop()
        miss[i] = mlink
        if prim_count[i] == 0:
            right = int(subtree_end[i + 1])
            miss_stack.append((i + 1, right))
            miss_stack.append((right, mlink))

    return FlatBVH(np.asarray(n_min, np.float32), np.asarray(n_max, np.float32),
                   miss, np.asarray(n_first, np.int32), prim_count,
                   order.astype(np.int64))


def _find_split(lo, hi, centers, order, begin, end):
    """Full-sweep SAH over all 3 axes; None -> make a leaf."""
    count = end - begin
    if count <= 2:
        return None
    seg = order[begin:end]
    best = (np.inf, -1, -1)
    for axis in range(3):
        perm = np.argsort(centers[seg, axis], kind="stable")
        slo = lo[seg][perm]
        shi = hi[seg][perm]
        pmin = np.minimum.accumulate(slo, axis=0)
        pmax = np.maximum.accumulate(shi, axis=0)
        smin = np.minimum.accumulate(slo[::-1], axis=0)[::-1]
        smax = np.maximum.accumulate(shi[::-1], axis=0)[::-1]

        def area(mn, mx):
            d = np.maximum(mx - mn, 0.0)
            return 2.0 * (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2]
                          + d[:, 2] * d[:, 0])

        nl = np.arange(1, count)
        cost = area(pmin, pmax)[:-1] * nl + area(smin, smax)[1:] * (count - nl)
        j = int(np.argmin(cost))
        if cost[j] < best[0]:
            best = (cost[j], axis, j + 1)

    whole = np.maximum(hi[seg].max(axis=0) - lo[seg].min(axis=0), 0.0)
    whole_area = 2.0 * (whole[0] * whole[1] + whole[1] * whole[2]
                        + whole[2] * whole[0])
    split_cost = TRAVERSAL_COST + best[0] / max(whole_area, 1e-20)
    if count <= LEAF_SIZE and split_cost >= INTERSECT_COST * count:
        return None
    return best[1], best[2]


def permute_triangles(tri_verts: np.ndarray, tri_normals: np.ndarray,
                      bvh: FlatBVH, pad: int = LEAF_SIZE):
    """Reorder triangles into leaf order and pad for fixed-width leaf tests."""
    v = tri_verts[bvh.order]
    n = tri_normals[bvh.order]
    padv = np.zeros((pad, 3, 3), np.float32)  # degenerate: never hit
    padn = np.zeros((pad, 3, 3), np.float32)
    return (np.concatenate([v, padv], axis=0),
            np.concatenate([n, padn], axis=0))


def _subtree_end(prim_count: np.ndarray) -> np.ndarray:
    """[M] int64: node i's subtree is [i, end[i]) in preorder."""
    m = prim_count.shape[0]
    leaf = (prim_count > 0).tolist()
    end = [0] * m
    for i in range(m - 1, -1, -1):
        end[i] = i + 1 if leaf[i] else end[end[i + 1]]
    return np.asarray(end, np.int64)


def pack_for_device(bvh: FlatBVH, tri_verts: np.ndarray,
                    tri_normals: np.ndarray):
    """Device layout of the walk -> (nodes [M,8] f32, leaf_verts
    [L, LEAF_SIZE*9] f32, tri_verts_lm [L*LEAF_SIZE,3,3], tri_normals_lm
    [L*LEAF_SIZE,3,3], links [8M,2] int32).

    * ``nodes`` row: bmin(0:3) | bmax(3:6) | bitcast(miss) | bitcast(meta)
      with meta = (leaf_idx << 3) | count for leaves, 0 for inner nodes: a
      step's node fetch is one 32-byte row.
    * triangles are leaf-major, every leaf padded to LEAF_SIZE slots
      (degenerate zero triangles never hit), so a leaf's candidates are
      one 144-byte ``leaf_verts`` row; a hit's index is
      leaf_idx * LEAF_SIZE + k into the ``_lm`` tables.
    """
    m = bvh.miss.shape[0]
    is_leaf = bvh.prim_count > 0
    leaf_ids = np.cumsum(is_leaf) - 1  # preorder leaf numbering
    n_leaves = int(is_leaf.sum())

    meta = np.where(is_leaf,
                    (leaf_ids.astype(np.int64) << 3)
                    | bvh.prim_count.astype(np.int64),
                    0).astype(np.int32)
    nodes = np.zeros((m, 8), np.float32)
    nodes[:, 0:3] = bvh.bounds_min
    nodes[:, 3:6] = bvh.bounds_max
    nodes[:, 6] = bvh.miss.view(np.float32)
    nodes[:, 7] = meta.view(np.float32)

    v_sorted = tri_verts[bvh.order].astype(np.float32)
    n_sorted = tri_normals[bvh.order].astype(np.float32)
    lm_v = np.zeros((n_leaves, LEAF_SIZE, 3, 3), np.float32)
    lm_n = np.zeros((n_leaves, LEAF_SIZE, 3, 3), np.float32)
    leaf_nodes = np.nonzero(is_leaf)[0]
    slot = np.arange(LEAF_SIZE)
    first = bvh.first_prim[leaf_nodes].astype(np.int64)
    used = slot[None, :] < bvh.prim_count[leaf_nodes][:, None]
    src = (first[:, None] + slot[None, :])[used]
    lm_v[used] = v_sorted[src]
    lm_n[used] = n_sorted[src]
    leaf_verts = lm_v.reshape(n_leaves, LEAF_SIZE * 9)
    links = thread_octants(bvh)
    return (nodes, leaf_verts,
            lm_v.reshape(n_leaves * LEAF_SIZE, 3, 3),
            lm_n.reshape(n_leaves * LEAF_SIZE, 3, 3),
            links)


def thread_octants(bvh: FlatBVH) -> np.ndarray:
    """Per-ray-octant hit/miss threading -> links [8*M, 2] int32.

    The reference's stack walk visits the near child first; a skip-link
    walk cannot reorder on the fly, so the near-first DFS is threaded once
    for each of the 8 direction octants: ray r uses rows [oct(r)*M,
    (oct(r)+1)*M).  hit = the next node when the box is hit (the near
    child), miss = the skip target; a leaf has hit == miss.  The near
    child: along the axis that separates the children's centres most (the
    first on ties), the one with the smaller centre, or the larger for a
    ray going down that axis.  The links follow parent to child, so they
    are filled one tree level at a time, the 8 octants together.
    """
    m = bvh.miss.shape[0]
    is_leaf = bvh.prim_count > 0
    centers = (bvh.bounds_min + bvh.bounds_max) * 0.5
    end = _subtree_end(bvh.prim_count)

    inner = np.nonzero(~is_leaf)[0]
    left = inner + 1
    right = end[left]
    sep = np.abs(centers[left] - centers[right])
    axis = np.argmax(sep, axis=1)
    left_le = centers[left, axis] <= centers[right, axis]

    # depth of every node: parents come before their children in preorder
    depth = [0] * m
    for i, lc, rc in zip(inner.tolist(), left.tolist(), right.tolist()):
        depth[lc] = depth[rc] = depth[i] + 1
    # inner nodes grouped by depth, one slice a level
    inner_depth = np.asarray(depth, np.int64)[inner]
    by_depth = np.argsort(inner_depth, kind="stable")
    levels = np.split(by_depth,
                      np.flatnonzero(np.diff(inner_depth[by_depth])) + 1)

    links = np.empty((8, m, 2), np.int32)
    for oct_ in range(8):
        sign = np.array([oct_ & 1, (oct_ >> 1) & 1, (oct_ >> 2) & 1], bool)
        left_near = left_le ^ sign[axis]
        near = np.where(left_near, left, right)
        far = np.where(left_near, right, left)
        miss = np.empty(m, np.int64)
        miss[0] = m
        for k in levels:
            miss[near[k]] = far[k]
            miss[far[k]] = miss[inner[k]]
        hit = miss.copy()
        hit[inner] = near
        links[oct_, :, 0] = hit
        links[oct_, :, 1] = miss
    return links.reshape(8 * m, 2)
