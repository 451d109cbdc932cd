"""Scene type system: material/geometry bitmasks and SoA scene tensors.

Port of ``photorealistic_rendering_using_opencl_tpu/scene/types.py``.  The
bitmask constants and ``SceneConfig`` are identical; ``SceneData`` is a
dataclass of torch tensors with an explicit ``.to(device)``.
``scene_from_numpy`` carries a scene over from numpy leaves (for example
the JAX package's scene, each leaf passed through ``np.asarray``), so both
packages can be fed the very same scene.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Material type bitmask (JSON "type": n -> 1<<n)
# ---------------------------------------------------------------------------
LIGHT = 1 << 0
DIFF = 1 << 1
COND = 1 << 2
DIEL = 1 << 3
COAT = 1 << 4
VOL = 1 << 5
TRANS = 1 << 6
SPECSUB = 1 << 7
ABS_REFR = 1 << 8
ABS_REFR2 = 1 << 9
ROUGH_COND = 1 << 10
ROUGH_DIEL = 1 << 11
BURLEY = 1 << 12

# ---------------------------------------------------------------------------
# Lobe bitmask
# ---------------------------------------------------------------------------
NULL_LOBE = 0
GLOSSY_REFLECTION_LOBE = 1 << 0
GLOSSY_TRANSMISSION_LOBE = 1 << 1
DIFFUSE_REFLECTION_LOBE = 1 << 2
DIFFUSE_TRANSMISSION_LOBE = 1 << 3
SPECULAR_REFLECTION_LOBE = 1 << 4
SPECULAR_TRANSMISSION_LOBE = 1 << 5
ANISOTROPIC_LOBE = 1 << 6
FORWARD_LOBE = 1 << 7

GLOSSY_LOBE = GLOSSY_REFLECTION_LOBE | GLOSSY_TRANSMISSION_LOBE
DIFFUSE_LOBE = DIFFUSE_REFLECTION_LOBE | DIFFUSE_TRANSMISSION_LOBE
SPECULAR_LOBE = SPECULAR_REFLECTION_LOBE | SPECULAR_TRANSMISSION_LOBE
TRANSMISSIVE_LOBE = (
    GLOSSY_TRANSMISSION_LOBE | DIFFUSE_TRANSMISSION_LOBE | SPECULAR_TRANSMISSION_LOBE
)
REFLECTIVE_LOBE = (
    GLOSSY_REFLECTION_LOBE | DIFFUSE_REFLECTION_LOBE | SPECULAR_REFLECTION_LOBE
)
ALL_LOBES = TRANSMISSIVE_LOBE | REFLECTIVE_LOBE | ANISOTROPIC_LOBE

# ---------------------------------------------------------------------------
# Microfacet distributions
# ---------------------------------------------------------------------------
BECKMANN = 1 << 0
PHONG = 1 << 1
GGX = 1 << 2

# ---------------------------------------------------------------------------
# Geometry type bitmask
# ---------------------------------------------------------------------------
SPHERE = 1 << 0
BOX = 1 << 1
SDF = 1 << 2
QUAD = 1 << 3
TRIANGLE_MESH = 1 << 6

SDF_SPHERE = 1 << 4
SDF_BOX = 1 << 5
SDF_ROUND_BOX = 1 << 6
SDF_PLANE = 1 << 7
SDF_CYLINDER = 1 << 8
SDF_TORUS = 1 << 9

# ---------------------------------------------------------------------------
# Spectral constants, sRGB-ish 3-sample SPDs
# ---------------------------------------------------------------------------
BK7_ETA = (1.5121, 1.5180, 1.5337)
CU_ETA = (0.29019, 0.61122, 1.2290)
CU_K = (3.5080, 2.7107, 2.1706)
AU_ETA = (0.17229, 0.36901, 1.5478)
AU_K = (4.2223, 2.4628, 1.8063)
PT_ETA = (2.6656, 2.1114, 1.6782)
PT_K = (4.7023, 3.7726, 2.7284)

@dataclasses.dataclass(frozen=True)
class SceneConfig:
    """Static (hashable) scene facts; the same fields as the reference.

    Presence flags gate whole code paths out of the trace exactly as in
    the JAX package, where ``jax.jit`` specializes on this object.
    """

    # object counts in canonical order sphere|sdf|box|quad
    n_spheres: int = 0
    n_sdfs: int = 0
    n_boxes: int = 0
    n_quads: int = 0
    n_triangles: int = 0  # OBJ mesh triangle count (0 = no mesh)
    n_bvh_nodes: int = 0
    n_lights: int = 0

    # bounce budgets
    max_bounces: int = 12
    max_diff_bounces: int = 4
    max_spec_bounces: int = 4
    max_trans_bounces: int = 12
    max_scattering_events: int = 12

    # raymarching
    marching_steps: int = 128
    shadow_marching_steps: int = 64

    # global medium
    has_global_medium: bool = False
    medium_absorption_only: bool = False
    medium_type: str = "homogeneous"
    phase_function: str = "isotropic"

    # material presence mask (gates whole BSDF families)
    active_mats: int = 0

    # feature toggles
    enable_light_sampling: bool = True
    enable_volume_light_sampling: bool = True
    low_order_scattering: bool = True
    alpha_testing: bool = False
    pick_random_light: bool = False

    has_env_map: bool = False
    enable_env_sampling: bool = True

    # mesh intersection backend: "brute" = exhaustive tile-pruned testing
    # (ops/mesh_brute.py; the CUDA kernel K1 on the card), "bvh" = the
    # skip-link walk, which the port does not have yet (ROADMAP M12).
    mesh_accel: str = "brute"

    # Sort the merged batch before K1 so that a warp's rays need the same
    # tiles (ops/intersect.py: ray_sort_key), result-invariant; only where
    # the kernel runs (``mesh_brute.uses_kernel``), as the reference sorts
    # only for its TPU kernel.  The loader sets it above BRUTE_MAX_TRIS
    # triangles, as the reference's does.
    mesh_sort_rays: bool = False
    # Kept for field parity with the reference and IGNORED by the port: a
    # backstop of the TPU kernel's reduced-precision matmul, which K1 does
    # not have.
    mesh_second_pass: bool = False

    # gradients w.r.t. the mesh vertex/normal tables (forward: no effect)
    mesh_vertex_grads: bool = False

    @property
    def env_nee(self) -> bool:
        return self.has_env_map and self.enable_env_sampling

    @property
    def n_objects(self) -> int:
        return self.n_spheres + self.n_sdfs + self.n_boxes + self.n_quads

    @property
    def has_mesh(self) -> bool:
        return self.n_triangles > 0

    def has_mat(self, mask: int) -> bool:
        return bool(self.active_mats & mask)


@dataclasses.dataclass
class SceneData:
    """Per-object SoA tensors, field for field the reference's SceneData.

    Objects are stored in canonical order [spheres | sdfs | boxes | quads];
    the OBJ mesh has its own material slot (``obj_*``); the medium's
    sigmas, the HG anisotropy and the environment map (1x1 black when
    absent) with its sampling tables are differentiable leaves too.  The BVH-walk
    leaves (``tri_verts``, ``tri_normals``, ``bvh_nodes``, ``bvh_links``,
    ``leaf_verts``) are placeholders in scenes the port loads itself: the
    walk is ROADMAP M12.  The brute tables ``bf_*`` carry the mesh.
    """

    color: torch.Tensor  # [N,3]
    eta: torch.Tensor  # [N,3]
    k: torch.Tensor  # [N,3]
    roughness: torch.Tensor  # [N]
    mat_type: torch.Tensor  # [N] int32 bitmask
    lobes: torch.Tensor  # [N] int32
    dist: torch.Tensor  # [N] int32

    position: torch.Tensor  # [N,3]
    params: torch.Tensor  # [N,4]
    geom_type: torch.Tensor  # [N] int32
    quad_base: torch.Tensor  # [N,3]
    quad_edge0: torch.Tensor  # [N,3]
    quad_edge1: torch.Tensor  # [N,3]
    quad_normal: torch.Tensor  # [N,3]
    quad_area: torch.Tensor  # [N]

    light_indices: torch.Tensor  # [n_lights] int32

    tri_verts: torch.Tensor
    tri_normals: torch.Tensor
    bvh_nodes: torch.Tensor
    bvh_links: torch.Tensor
    leaf_verts: torch.Tensor
    bf_feat: torch.Tensor  # [16, 4*Tpad] Moller-Trumbore coefficient table
    bf_clusters: torch.Tensor  # [NT,8] per-tile AABBs
    bf_tri_verts: torch.Tensor  # [Tpad,3,3] triangles in bf index order
    bf_tri_normals: torch.Tensor  # [Tpad,3,3]
    obj_color: torch.Tensor  # [3]
    obj_eta: torch.Tensor  # [3]
    obj_k: torch.Tensor  # [3]
    obj_roughness: torch.Tensor  # []
    obj_mat_type: torch.Tensor  # [] int32
    obj_lobes: torch.Tensor  # [] int32
    obj_dist: torch.Tensor  # [] int32

    medium_sigma_a: torch.Tensor  # [3]
    medium_sigma_s: torch.Tensor  # [3]
    medium_sigma_t: torch.Tensor  # [3]
    phase_g: torch.Tensor  # []

    env_map: torch.Tensor  # [H,W,3]
    env_cond_cdf: torch.Tensor  # [H,W]
    env_marg_cdf: torch.Tensor  # [H]
    env_weights: torch.Tensor  # [H,W]
    env_total: torch.Tensor  # []

    def to(self, device) -> "SceneData":
        """A copy with every leaf on ``device``."""
        return SceneData(**{f.name: getattr(self, f.name).to(device)
                            for f in dataclasses.fields(self)})

    @property
    def device(self) -> torch.device:
        return self.color.device

    @property
    def env_dist(self) -> dict:
        """The environment map's sampling tables (ops/envmap.py)."""
        return dict(cond_cdf=self.env_cond_cdf, marg_cdf=self.env_marg_cdf,
                    weights=self.env_weights, total=self.env_total)


def _np_leaves_to_torch(leaves: dict, device) -> dict:
    out = {}
    for name, arr in leaves.items():
        a = np.array(arr, order="C", copy=True)  # keeps 0-d leaves 0-d
        if a.dtype == np.float64:
            raise TypeError(f"leaf {name!r} is float64; the scene is float32")
        out[name] = torch.from_numpy(a).to(device)
    return out


def empty_scene_data(n_objects: int = 0, n_tris: int = 0, n_nodes: int = 0,
                     n_lights: int = 0, *, device) -> SceneData:
    """Allocate the reference's default leaves (numpy first, then torch)."""
    n = max(n_objects, 1)
    t = max(n_tris, 1)
    m = max(n_nodes, 1)
    nl = max(n_lights, 1)
    f32 = np.float32
    z3 = np.zeros((n, 3), f32)
    zn = np.zeros((n,), f32)
    leaves = dict(
        color=np.ones((n, 3), f32),
        eta=np.broadcast_to(np.asarray(AU_ETA, f32), (n, 3)),
        k=np.broadcast_to(np.asarray(AU_K, f32), (n, 3)),
        roughness=zn,
        mat_type=np.full((n,), DIFF, np.int32),
        lobes=np.full((n,), DIFFUSE_REFLECTION_LOBE, np.int32),
        dist=np.full((n,), BECKMANN, np.int32),
        position=z3,
        params=np.zeros((n, 4), f32),
        geom_type=np.zeros((n,), np.int32),
        quad_base=z3,
        quad_edge0=z3,
        quad_edge1=z3,
        quad_normal=z3,
        quad_area=zn,
        light_indices=np.zeros((nl,), np.int32),
        tri_verts=np.zeros((t, 3, 3), f32),
        tri_normals=np.zeros((t, 3, 3), f32),
        bvh_nodes=np.zeros((m, 8), f32),
        bvh_links=np.zeros((8 * m, 2), np.int32),
        leaf_verts=np.zeros((1, 36), f32),
        bf_feat=np.zeros((16, 4), f32),
        # inverted bounds: no tile is ever relevant in an empty scene
        bf_clusters=np.asarray([[3e38, 3e38, 3e38, -3e38, -3e38, -3e38, 0, 0]],
                               f32),
        bf_tri_verts=np.zeros((1, 3, 3), f32),
        bf_tri_normals=np.zeros((1, 3, 3), f32),
        obj_color=np.ones((3,), f32),
        obj_eta=np.asarray(AU_ETA, f32),
        obj_k=np.asarray(AU_K, f32),
        obj_roughness=np.zeros((), f32),
        obj_mat_type=np.array(DIFF, np.int32),
        obj_lobes=np.array(DIFFUSE_REFLECTION_LOBE, np.int32),
        obj_dist=np.array(BECKMANN, np.int32),
        medium_sigma_a=np.zeros((3,), f32),
        medium_sigma_s=np.zeros((3,), f32),
        medium_sigma_t=np.zeros((3,), f32),
        phase_g=np.array(0.6, f32),
        env_map=np.zeros((1, 1, 3), f32),
        env_cond_cdf=np.ones((1, 1), f32),
        env_marg_cdf=np.ones((1,), f32),
        env_weights=np.ones((1, 1), f32),
        env_total=np.ones((), f32),
    )
    return SceneData(**_np_leaves_to_torch(leaves, device))


def scene_from_numpy(cfg_fields: dict, leaves: dict, device
                     ) -> tuple[SceneConfig, SceneData]:
    """(SceneConfig, SceneData) from plain fields and numpy leaves.

    ``cfg_fields`` is ``dataclasses.asdict`` of a SceneConfig (any package's);
    ``leaves`` maps every SceneData field name to an array.  Each leaf is
    copied bit for bit onto ``device``.
    """
    names = {f.name for f in dataclasses.fields(SceneData)}
    missing = names - set(leaves)
    if missing:
        raise KeyError(f"scene leaves missing: {sorted(missing)}")
    cfg = SceneConfig(**cfg_fields)
    data = SceneData(**_np_leaves_to_torch(
        {k: leaves[k] for k in names}, device))
    return cfg, data


def scene_to_numpy(scene: SceneData) -> dict:
    """The inverse of ``scene_from_numpy``'s leaf conversion."""
    return {f.name: getattr(scene, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(scene)}


def default_lobes_for_type(t: int) -> int:
    """Material type -> lobe mapping."""
    if t & LIGHT:
        return NULL_LOBE
    if t & (DIFF | BURLEY):
        return DIFFUSE_REFLECTION_LOBE
    if t & COND:
        return SPECULAR_REFLECTION_LOBE
    if t & (ROUGH_COND | COAT):
        return GLOSSY_REFLECTION_LOBE
    if t & DIEL:
        return SPECULAR_REFLECTION_LOBE | SPECULAR_TRANSMISSION_LOBE
    if t & ROUGH_DIEL:
        return GLOSSY_REFLECTION_LOBE | GLOSSY_TRANSMISSION_LOBE
    return DIFFUSE_REFLECTION_LOBE
