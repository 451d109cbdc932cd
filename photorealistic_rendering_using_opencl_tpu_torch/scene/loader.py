"""JSON scene loader -> (SceneConfig, SceneData) on the card by default.

Port of ``photorealistic_rendering_using_opencl_tpu/scene/loader.py``:
spheres, SDFs, boxes and quads in canonical order, the OBJ mesh with the
tables of both mesh backends (the brute coefficient table and the BVH
walk's nodes, links and leaf-major triangles), the global medium (sigmas
premultiplied by density), the phase function and an environment map with
its sampling tables.  The leaves are built in numpy exactly as the
reference builds them and copied to ``device`` at the end: the CUDA card
unless the caller passes ``device="cpu"`` (without a card, the default
raises; it never falls back to the CPU).  The environment map's CDF
tables are built on ``device`` from the map
(``ops/envmap.build_env_distribution``).  ``_pick_mesh_accel`` chooses
the mesh backend for ``device``.
"""
from __future__ import annotations

import json
import os
import warnings

import numpy as np

import torch

from photorealistic_rendering_using_opencl_tpu_torch.ops import envmap, mesh_brute
from photorealistic_rendering_using_opencl_tpu_torch.ops.math import RAY_INF
from photorealistic_rendering_using_opencl_tpu_torch.scene import bvh_build, obj as obj_io
from photorealistic_rendering_using_opencl_tpu_torch.scene.types import (
    ABS_REFR, ABS_REFR2, AU_ETA, AU_K, BECKMANN, BK7_ETA, BOX, DIEL, DIFF,
    LIGHT, QUAD, ROUGH_DIEL, SceneConfig, SceneData, SDF, SPHERE,
    default_lobes_for_type, empty_scene_data, _np_leaves_to_torch,
)
from photorealistic_rendering_using_opencl_tpu_torch.utils.device import (
    DEFAULT_DEVICE, resolve_device,
)

# the reference's CPU rule (its scene/loader.py:_pick_mesh_accel)
CPU_BRUTE_MAX_TRIS = 2048


def _mesh_table_dtype() -> torch.dtype:
    """The brute coefficient table's dtype: float32, or bfloat16 under
    ``PRT_MESH_DTYPE=bf16`` (the reference's switch, read at each load).
    A bf16 table runs the reduced-precision form "bf16" on the card (the
    tensor-core kernel) and the reference's bf16 dot on the CPU
    (ops/mesh_brute.py)."""
    if os.environ.get("PRT_MESH_DTYPE", "") == "bf16":
        return torch.bfloat16
    return torch.float32


def _pick_mesh_accel(n_tris: int, device: torch.device) -> str:
    """The mesh backend for a mesh of ``n_tris`` triangles on ``device``.

    On the CPU the reference's own rule: brute up to CPU_BRUTE_MAX_TRIS,
    the walk above, so a scene both packages load on the CPU gets the same
    backend.  On the card the walk W1 for every mesh: chip_smoke.py's
    phase 22 timed the whole ``mesh_closest`` call of each backend on an
    H100 (PERF.md, "Backend rule": icospheres of 320 to 327,680 triangles,
    a frame's camera rays and a regen dispatch's merged batch), and the
    walk was 7-18x faster than brute's ray sort, K1 and validation at
    every size brute carries, 320 triangles included.
    ``PRT_MESH_ACCEL=brute|bvh`` overrides both."""
    forced = os.environ.get("PRT_MESH_ACCEL", "")
    if forced in ("brute", "bvh"):
        return forced
    if device.type == "cuda":
        return "bvh"
    return "brute" if n_tris <= CPU_BRUTE_MAX_TRIS else "bvh"


_DEFAULT_MODEL_DIRS = (
    "resources/models",
    "scenes/assets",
)


class _Mat:
    def __init__(self):
        self.color = [1.0, 1.0, 1.0]
        self.eta = list(AU_ETA)
        self.k = list(AU_K)
        self.roughness = 0.0
        self.t = DIFF
        self.dist = BECKMANN


def _parse_material(doc: dict, mat: _Mat) -> int:
    """Material block -> the active-mats bit."""
    if "color" in doc:
        mat.color = [float(c) for c in doc["color"][:3]]
    if "roughness" in doc:
        mat.roughness = float(doc["roughness"])
    if "dist" in doc:
        mat.dist = 1 << int(doc["dist"])
    if "type" in doc:
        mat.t = 1 << int(doc["type"])
        if mat.t & (DIEL | ROUGH_DIEL):
            mat.eta = list(BK7_ETA)
            cc = int(doc.get("absorptive", 0))
            if cc:
                mat.t |= ABS_REFR if cc == 1 else ABS_REFR2
    if "eta" in doc:
        mat.eta = [float(c) for c in doc["eta"][:3]]
    if "k" in doc:
        mat.k = [float(c) for c in doc["k"][:3]]
    return mat.t


def find_model(path: str, models_dir: str | None = None) -> str:
    cands = [path]
    if models_dir:
        cands.append(os.path.join(models_dir, path))
    for d in _DEFAULT_MODEL_DIRS:
        cands.append(os.path.join(d, path))
    for c in cands:
        if os.path.isfile(c):
            return c
    raise FileNotFoundError(f"model not found: {path} (searched {cands})")


def load_scene(path: str, models_dir: str | None = None,
               env_map: np.ndarray | None = None,
               alpha_testing: bool = False,
               phase_function: str = "isotropic",
               mesh_override=None, *, device=DEFAULT_DEVICE):
    """Load a scene JSON file onto ``device``.

    mesh_override: optional (tri_verts, tri_normals) numpy arrays replacing
    the OBJ the file references.
    """
    with open(path) as fh:
        doc = json.load(fh)
    return build_scene(doc, models_dir=models_dir, env_map=env_map,
                       alpha_testing=alpha_testing,
                       phase_function=phase_function,
                       mesh_override=mesh_override, device=device)


def _store_mat(i, m: _Mat, color, eta, k, rough, mat_type, dist):
    color[i] = m.color
    eta[i] = m.eta
    k[i] = m.k
    rough[i] = m.roughness
    mat_type[i] = m.t
    dist[i] = m.dist


def build_scene(doc: dict, models_dir: str | None = None,
                env_map: np.ndarray | None = None,
                alpha_testing: bool = False,
                phase_function: str = "isotropic",
                mesh_override=None, *, device=DEFAULT_DEVICE
                ) -> tuple[SceneConfig, SceneData]:
    device = resolve_device(device)
    settings = doc.get("settings", {})
    scene_doc = doc.get("scene", {})

    spheres = scene_doc.get("spheres", [])
    sdfs = scene_doc.get("sdfs", [])
    boxes = scene_doc.get("boxes", [])
    quads = scene_doc.get("quads", [])
    n_obj = len(spheres) + len(sdfs) + len(boxes) + len(quads)
    nk = max(n_obj, 1)

    # ---------------- OBJ mesh -> both backends' tables ----------------
    obj_doc = scene_doc.get("obj")
    tri_v = tri_n = None
    obj_mat = _Mat()
    active_mats = 0
    if mesh_override is not None:
        tri_v, tri_n = mesh_override
    elif obj_doc and "path" in obj_doc:
        tri_v, tri_n = obj_io.load_obj(find_model(obj_doc["path"], models_dir))
    if obj_doc and "material" in obj_doc:
        active_mats |= _parse_material(obj_doc["material"], obj_mat)
    elif tri_v is not None:
        active_mats |= obj_mat.t

    n_tris = 0
    n_nodes = 0
    brute = packed = None
    if tri_v is not None:
        tri_v = np.asarray(tri_v)
        tri_n = np.asarray(tri_n)
        bvh = bvh_build.build_bvh(tri_v)
        n_tris = int(bvh.order.shape[0])
        n_nodes = int(bvh.miss.shape[0])
        packed = bvh_build.pack_for_device(bvh, tri_v, tri_n)
        # K1 streams at most BRUTE_STREAM_MAX_TRIS: past that only the walk
        # carries the mesh, and its brute tables stay empty.  BVH triangle
        # order makes consecutive tiles spatially compact; the tiles are
        # PRT_MESH_TILE's (mesh_brute.TILE)
        if n_tris <= mesh_brute.BRUTE_STREAM_MAX_TRIS:
            brute = mesh_brute.pack_brute(tri_v[bvh.order], tri_n[bvh.order],
                                          tile=mesh_brute.TILE)

    color = np.ones((nk, 3), np.float32)
    eta = np.tile(np.asarray(AU_ETA, np.float32), (nk, 1))
    kk = np.tile(np.asarray(AU_K, np.float32), (nk, 1))
    rough = np.zeros(nk, np.float32)
    mat_type = np.full(nk, DIFF, np.int32)
    dist = np.full(nk, BECKMANN, np.int32)
    position = np.zeros((nk, 3), np.float32)
    params = np.zeros((nk, 4), np.float32)
    geom_type = np.zeros(nk, np.int32)
    qbase = np.zeros((nk, 3), np.float32)
    qe0 = np.zeros((nk, 3), np.float32)
    qe1 = np.zeros((nk, 3), np.float32)
    qn = np.zeros((nk, 3), np.float32)
    qarea = np.zeros(nk, np.float32)
    extent = []  # per-object reach from the origin (for the RAY_INF check)

    idx = 0
    for s in spheres:
        geom_type[idx] = SPHERE
        position[idx] = s.get("pos", [0, 0, 0])[:3]
        params[idx, 0] = float(s.get("radius", 1.0))
        m = _Mat()
        if "material" in s:
            active_mats |= _parse_material(s["material"], m)
        _store_mat(idx, m, color, eta, kk, rough, mat_type, dist)
        extent.append(float(np.linalg.norm(position[idx])
                            + abs(params[idx, 0])))
        idx += 1
    for s in sdfs:
        geom_type[idx] = SDF | (1 << int(s.get("type", 4)))
        position[idx] = s.get("pos", [0, 0, 0])[:3]
        pr = s.get("params", [])
        params[idx, :len(pr[:4])] = pr[:4]
        m = _Mat()
        if "material" in s:
            active_mats |= _parse_material(s["material"], m)
        _store_mat(idx, m, color, eta, kk, rough, mat_type, dist)
        extent.append(float(np.linalg.norm(position[idx])
                            + np.abs(params[idx]).max()))
        idx += 1
    for b in boxes:
        geom_type[idx] = BOX
        position[idx] = b.get("pos", [0, 0, 0])[:3]
        params[idx, :3] = b.get("scale", [1, 1, 1])[:3]
        m = _Mat()
        if "material" in b:
            active_mats |= _parse_material(b["material"], m)
        _store_mat(idx, m, color, eta, kk, rough, mat_type, dist)
        extent.append(float(np.linalg.norm(position[idx])
                            + np.linalg.norm(params[idx, :3])))
        idx += 1
    for q in quads:
        geom_type[idx] = QUAD
        v = [float(x) for x in q["vertices"]]
        base = np.asarray(v[0:3], np.float32)
        e0 = np.asarray(v[3:6], np.float32)
        e1 = np.asarray(v[6:9], np.float32)
        nrm = np.cross(e0, e1)
        # the true parallelogram area |e0 x e1| (the reference stores the
        # squared length)
        area = float(np.sqrt(max(float(np.sum(nrm * nrm)), 1e-20)))
        nlen = np.linalg.norm(nrm)
        nrm = nrm / max(nlen, 1e-20)
        qbase[idx], qe0[idx], qe1[idx], qn[idx], qarea[idx] = base, e0, e1, nrm, area
        position[idx] = base
        m = _Mat()
        if "material" in q:
            active_mats |= _parse_material(q["material"], m)
        _store_mat(idx, m, color, eta, kk, rough, mat_type, dist)
        corners = base + np.asarray([[a, b] for a in (-0.5, 0.5)
                                     for b in (-0.5, 0.5)]) @ np.stack([e0, e1])
        extent.append(float(np.linalg.norm(corners, axis=1).max()))
        idx += 1
    if tri_v is not None:
        extent.append(float(np.linalg.norm(tri_v.reshape(-1, 3), axis=1).max()))

    light_indices = [i for i in range(n_obj) if mat_type[i] & LIGHT]

    # ---------------- global medium ----------------
    gm = doc.get("global_medium")
    has_medium = gm is not None
    sigma_a = np.zeros(3, np.float32)
    sigma_s = np.zeros(3, np.float32)
    medium_type = "homogeneous"
    if has_medium:
        density = float(gm.get("density", 0.1))
        sigma_a[:] = density * float(gm.get("sigmaA", 0.2))
        sigma_s[:] = density * float(gm.get("sigmaS", 1.0))
        medium_type = str(gm.get("type", "homogeneous"))
        if medium_type not in ("homogeneous", "exponential"):
            raise ValueError(f"unknown global_medium type {medium_type!r}")
    sigma_t = sigma_a + sigma_s
    absorption_only = has_medium and float(sigma_s.max()) == 0.0

    cfg = SceneConfig(
        n_spheres=len(spheres), n_sdfs=len(sdfs), n_boxes=len(boxes),
        n_quads=len(quads),
        n_triangles=n_tris, n_bvh_nodes=n_nodes,
        n_lights=len(light_indices),
        max_bounces=int(settings.get("MAX_BOUNCES", 12)),
        max_diff_bounces=int(settings.get("MAX_DIFF_BOUNCES", 4)),
        max_spec_bounces=int(settings.get("MAX_SPEC_BOUNCES", 4)),
        max_trans_bounces=int(settings.get("MAX_TRANS_BOUNCES", 12)),
        max_scattering_events=int(settings.get("MAX_SCATTERING_EVENTS", 12)),
        marching_steps=int(settings.get("MARCHING_STEPS", 128)),
        shadow_marching_steps=int(settings.get("SHADOW_MARCHING_STEPS", 64)),
        enable_light_sampling=bool(settings.get("ENABLE_LIGHT_SAMPLING", True)),
        pick_random_light=bool(settings.get("PICK_RANDOM_LIGHT", False)),
        has_global_medium=has_medium,
        medium_absorption_only=absorption_only,
        medium_type=medium_type,
        phase_function=phase_function,
        active_mats=int(active_mats),
        alpha_testing=alpha_testing,
        has_env_map=env_map is not None,
        mesh_accel=_pick_mesh_accel(n_tris, device),
        # the reference's rule: sort rays for K1 above BRUTE_MAX_TRIS
        # triangles, a multiple of every tile K1 takes (128, 256, 512), so
        # the padded count K1 sees gives the same answer (ROADMAP F3)
        mesh_sort_rays=n_tris > mesh_brute.BRUTE_MAX_TRIS,
    )

    # the reference clamps every ray at RAY_INF (a 20-unit world): warn when
    # an object reaches far enough that part of the scene may fall past it
    if extent and max(extent) > 0.45 * RAY_INF:
        warnings.warn(
            f"scene extent ~{max(extent):.1f} approaches the RAY_INF="
            f"{RAY_INF} ray horizon: geometry farther than that from a "
            "shading point is unreachable", stacklevel=2)

    leaves = dict(
        color=color, eta=eta, k=kk, roughness=rough, mat_type=mat_type,
        lobes=np.asarray([default_lobes_for_type(int(t)) for t in mat_type],
                         np.int32),
        dist=dist, position=position, params=params, geom_type=geom_type,
        quad_base=qbase, quad_edge0=qe0, quad_edge1=qe1, quad_normal=qn,
        quad_area=qarea,
        light_indices=np.asarray(light_indices or [0], np.int32),
        medium_sigma_a=sigma_a, medium_sigma_s=sigma_s, medium_sigma_t=sigma_t,
    )
    if brute is not None:
        leaves.update(
            bf_feat=brute.feat, bf_clusters=brute.clusters,
            bf_tri_verts=brute.tri_verts, bf_tri_normals=brute.tri_normals)
    if packed is not None:
        leaves.update(
            bvh_nodes=packed[0], leaf_verts=packed[1], tri_verts=packed[2],
            tri_normals=packed[3], bvh_links=packed[4],
            obj_color=np.asarray(obj_mat.color, np.float32),
            obj_eta=np.asarray(obj_mat.eta, np.float32),
            obj_k=np.asarray(obj_mat.k, np.float32),
            obj_roughness=np.asarray(obj_mat.roughness, np.float32),
            obj_mat_type=np.asarray(obj_mat.t, np.int32),
            obj_lobes=np.asarray(default_lobes_for_type(obj_mat.t), np.int32),
            obj_dist=np.asarray(obj_mat.dist, np.int32),
        )
    data = empty_scene_data(n_objects=n_obj, n_lights=1, device=device)
    for name, value in _np_leaves_to_torch(leaves, device).items():
        setattr(data, name, value)
    if brute is not None:
        # the table in the dtype PRT_MESH_DTYPE asks for (rounded to
        # nearest-even, as the reference's asarray rounds it)
        data.bf_feat = data.bf_feat.to(_mesh_table_dtype())
    if env_map is not None:
        data.env_map = torch.as_tensor(np.asarray(env_map, np.float32),
                                       device=device).contiguous()
        dist = envmap.build_env_distribution(data.env_map)
        data.env_cond_cdf = dist["cond_cdf"]
        data.env_marg_cdf = dist["marg_cdf"]
        data.env_weights = dist["weights"]
        data.env_total = dist["total"]
    return cfg, data
