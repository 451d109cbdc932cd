"""A scene file read into plain tensors: spheres, one-sided quads, the
triangle mesh and its material, the environment map and its sampling
tables, the budgets.  Materials follow the scene format of
Mourtz/Photorealistic-Rendering-using-OpenCL: JSON ``"type": n`` is the
bit ``1 << n``; dielectrics default to BK7's IOR, everything else to
gold's eta and k; ``"dist": n`` picks the microfacet distribution.
"""
from __future__ import annotations

import math

import numpy as np
import torch

# material bits (JSON type n -> 1 << n)
LIGHT, DIFF, COND, DIEL, COAT = 1, 2, 4, 8, 16
ABS_REFR, ABS_REFR2 = 1 << 8, 1 << 9
ROUGH_COND, ROUGH_DIEL, BURLEY = 1 << 10, 1 << 11, 1 << 12
# lobes
GLOSSY_R, GLOSSY_T, DIFFUSE_R, DIFFUSE_T = 1, 2, 4, 8
SPECULAR_R, SPECULAR_T, FORWARD = 16, 32, 128
SPECULAR = SPECULAR_R | SPECULAR_T
TRANSMISSIVE = GLOSSY_T | DIFFUSE_T | SPECULAR_T
# microfacet distributions
BECKMANN, PHONG, GGX = 1, 2, 4

BK7_ETA = (1.5121, 1.5180, 1.5337)
AU_ETA = (0.17229, 0.36901, 1.5478)
AU_K = (4.2223, 2.4628, 1.8063)
LUMINANCE = (0.2126, 0.7152, 0.0722)
MESH_GROUP = 256  # consecutive triangles under one bounding box


def lobes_of(t: int) -> int:
    if t & LIGHT:
        return 0
    if t & (DIFF | BURLEY):
        return DIFFUSE_R
    if t & COND:
        return SPECULAR_R
    if t & (ROUGH_COND | COAT):
        return GLOSSY_R
    if t & DIEL:
        return SPECULAR_R | SPECULAR_T
    if t & ROUGH_DIEL:
        return GLOSSY_R | GLOSSY_T
    return DIFFUSE_R


def material(doc: dict) -> dict:
    m = {"color": [1.0, 1.0, 1.0], "eta": list(AU_ETA), "k": list(AU_K),
         "roughness": 0.0, "type": DIFF, "dist": BECKMANN}
    if "color" in doc:
        m["color"] = [float(c) for c in doc["color"][:3]]
    if "roughness" in doc:
        m["roughness"] = float(doc["roughness"])
    if "dist" in doc:
        m["dist"] = 1 << int(doc["dist"])
    if "type" in doc:
        m["type"] = 1 << int(doc["type"])
        if m["type"] & (DIEL | ROUGH_DIEL):
            m["eta"] = list(BK7_ETA)
            cc = int(doc.get("absorptive", 0))
            if cc:
                m["type"] |= ABS_REFR if cc == 1 else ABS_REFR2
    if "eta" in doc:
        m["eta"] = [float(c) for c in doc["eta"][:3]]
    if "k" in doc:
        m["k"] = [float(c) for c in doc["k"][:3]]
    return m


class Scene:
    """Objects in the order spheres, quads; the mesh's material is row
    ``n_objects`` of the material tables."""

    def __init__(self, doc: dict, mesh=None, env_map=None, *, device,
                 dtype=torch.float32):
        sc = doc.get("scene", {})
        st = doc.get("settings", {})
        for key in ("sdfs", "boxes"):
            if sc.get(key):
                raise NotImplementedError(f"the reference has no {key}")
        if doc.get("global_medium") or st.get("PICK_RANDOM_LIGHT"):
            raise NotImplementedError("the reference has no medium and "
                                      "samples the first light only")
        self.dev, self.dt = torch.device(device), dtype
        self.max_bounces = int(st.get("MAX_BOUNCES", 12))
        self.max_diff = int(st.get("MAX_DIFF_BOUNCES", 4))
        self.max_spec = int(st.get("MAX_SPEC_BOUNCES", 4))
        self.max_trans = int(st.get("MAX_TRANS_BOUNCES", 12))
        self.light_sampling = bool(st.get("ENABLE_LIGHT_SAMPLING", True))
        spheres, quads = sc.get("spheres", []), sc.get("quads", [])
        self.n_spheres, self.n_quads = len(spheres), len(quads)
        self.n_objects = len(spheres) + len(quads)
        mats = [material(s.get("material", {})) for s in spheres + quads]
        mats.append(material(sc.get("obj", {}).get("material", {})))

        def f(x, shape=None):
            a = np.asarray(x, np.float32)
            if shape is not None:
                a = a.reshape(shape)
            return torch.as_tensor(a, device=self.dev).to(dtype)

        def i(x):
            return torch.as_tensor(np.asarray(x, np.int64), device=self.dev)

        # the fitted leaves keep the renderer's names: "color" the objects',
        # "obj_color" the mesh's
        self.color = f([m["color"] for m in mats[:-1]], (-1, 3))
        self.obj_color = f(mats[-1]["color"])
        self.eta = f([m["eta"] for m in mats])
        self.k = f([m["k"] for m in mats])
        self.rough = f([m["roughness"] for m in mats])
        self.mtype = i([m["type"] for m in mats])
        self.lobes = i([lobes_of(m["type"]) for m in mats])
        self.dist = i([m["dist"] for m in mats])
        self.sph_c = f([s.get("pos", [0, 0, 0])[:3] for s in spheres], (-1, 3))
        self.sph_r = f([float(s.get("radius", 1.0)) for s in spheres])
        qb, q0, q1, qn, qa = [], [], [], [], []
        for q in quads:
            v = np.asarray([float(x) for x in q["vertices"]], np.float32)
            nrm = np.cross(v[3:6], v[6:9])
            qa.append(float(np.sqrt(max(float(np.sum(nrm * nrm)), 1e-20))))
            qn.append(nrm / max(np.linalg.norm(nrm), 1e-20))
            qb.append(v[0:3])
            q0.append(v[3:6])
            q1.append(v[6:9])
        self.q_base, self.q_e0 = f(qb, (-1, 3)), f(q0, (-1, 3))
        self.q_e1, self.q_n = f(q1, (-1, 3)), f(qn, (-1, 3))
        self.q_area = f(qa)
        lights = [j for j in range(self.n_objects) if mats[j]["type"] & LIGHT]
        self.n_lights = len(lights)
        self.light = lights[0] if lights else 0

        self.has_mesh = mesh is not None
        if self.has_mesh:
            tv = np.asarray(mesh[0], np.float32)
            self.tri_v = f(tv)
            self.tri_n = f(mesh[1])
            t = tv.shape[0]
            pad = (-t) % MESH_GROUP
            g = np.concatenate([tv, np.repeat(tv[-1:], pad, 0)]).reshape(
                -1, MESH_GROUP * 3, 3)
            lo, hi = g.min(1), g.max(1)
            slack = 1e-4 * (1.0 + np.abs(np.stack([lo, hi])).max(0))
            self.grp_lo, self.grp_hi = f(lo - slack), f(hi + slack)
            self.grp_size = MESH_GROUP

        self.has_env = env_map is not None
        if self.has_env:
            self.env_map = f(env_map)
            self.env_tables(self.env_map)

    def env_tables(self, env_map: torch.Tensor) -> None:
        """Row and conditional CDFs of luminance x sin(theta) over the
        equirect map (built once, from the map the scene is loaded with)."""
        env = env_map.detach()
        h = env.shape[0]
        lum = torch.sum(env * torch.tensor(LUMINANCE, dtype=self.dt,
                                           device=self.dev), dim=-1)
        theta = (torch.arange(h, dtype=self.dt, device=self.dev) + 0.5) \
            / h * math.pi
        weights = lum * torch.sin(theta)[:, None] + 1e-12
        rows = torch.sum(weights, dim=1)
        self.env_cond = torch.cumsum(weights, dim=1) / rows[:, None]
        self.env_marg = torch.cumsum(rows, dim=0) / torch.sum(rows)
        self.env_weights = weights
        self.env_total = torch.sum(rows)
