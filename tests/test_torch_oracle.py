"""The port's medium and dielectric estimators against tests/oracle.py, the
numpy port of the reference's integrator with no import from either
package: twins of tests/test_oracle.py's medium families (homogeneous,
per-channel sigmas, smooth dielectric, a medium around a mesh), converged
image means and per-pixel drift, with that file's bounds.

The oracle costs ~30 s a 64k samples, the port ~2 s (all (pixel, sample)
pairs in one batch of lanes), so the oracle takes ORACLE_SPP samples a
pixel and the port PORT_SPP: the comparison's noise is within 6% of two
1024-sample renders', the count the bounds were set for (~4-7 sigma).
"""
import dataclasses
import json
import os
import sys

import numpy as np
import torch

from photorealistic_rendering_using_opencl_tpu_torch.models import integrator, pathtracer
from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import default_camera
from photorealistic_rendering_using_opencl_tpu_torch.scene.loader import build_scene
from photorealistic_rendering_using_opencl_tpu_torch.scene.obj import make_icosphere

sys.path.insert(0, os.path.dirname(__file__))
import oracle  # noqa: E402

torch.set_num_threads(2)

MEDIA_SCENE = "scenes/oracle_media.json"
DIEL_SCENE = "scenes/oracle_diel.json"
W = 8
ORACLE_SPP, PORT_SPP = 512, 4096
# the mesh family's oracle is twice as slow a sample: 3/4 of the counts
MESH_ORACLE_SPP, MESH_PORT_SPP = 384, 3072


def _load(path):
    with open(path) as fh:
        doc = json.load(fh)
    return doc


def render_many(cfg, sc, w, spp, seed):
    """``render`` at spp samples, all (pixel, sample) pairs traced in one
    batch of lanes (the RNG is keyed on the pair, so this is the same
    estimator) -> [w, w, 3]."""
    cam = default_camera(w, w).pytree("cpu")
    px, py = pathtracer.pixel_grid(w, w, "cpu")
    px, py = px.repeat_interleave(spp), py.repeat_interleave(spp)
    pix = py * w + px
    smp = torch.arange(spp).repeat(w * w)
    o, d = pathtracer.camera_rays_for_sample(cam, w, w, px, py, pix, smp, seed)
    with torch.no_grad():
        rad, _ = integrator.trace(cfg, sc, o, d, pix, smp, seed=seed,
                                  method="while")
    return rad.reshape(w * w, spp, 3).mean(1).reshape(w, w, 3).numpy()


def test_render_many_is_render():
    cfg, sc = build_scene(_load(MEDIA_SCENE), device="cpu")
    want, _ = pathtracer.render(cfg, sc, default_camera(4, 4).pytree("cpu"),
                                4, 4, 3, seed=5, method="while")
    np.testing.assert_allclose(render_many(cfg, sc, 4, 3, 5), want.numpy(),
                               rtol=1e-6, atol=1e-7)


def test_homogeneous_medium_matches_oracle():
    """Spectral-channel distance sampling, the exited-path pdf, the sigma_s
    scatter weight, volumetric NEE and phase MIS."""
    ref = oracle.render(MEDIA_SCENE, W, W, ORACLE_SPP, seed=11)
    cfg, sc = build_scene(_load(MEDIA_SCENE), device="cpu")
    img = render_many(cfg, sc, W, PORT_SPP, 23)
    rel = abs(img.mean() - ref.mean()) / ref.mean()
    assert rel < 0.015, rel
    assert np.abs(img - ref).max() < 0.08


def test_homogeneous_medium_spectral_channels_match_oracle():
    """Per-channel sigmas (sigma_t varies 2x across channels) make the
    channel pick and the channel-average pdfs load-bearing."""
    sa = np.array([0.02, 0.03, 0.05])
    ss = np.array([0.10, 0.07, 0.04])
    ref = oracle.render(MEDIA_SCENE, W, W, ORACLE_SPP, seed=11, sigma_a=sa,
                        sigma_s=ss)
    cfg, sc = build_scene(_load(MEDIA_SCENE), device="cpu")
    f32 = np.float32
    sc = dataclasses.replace(
        sc, medium_sigma_a=torch.from_numpy(sa.astype(f32)),
        medium_sigma_s=torch.from_numpy(ss.astype(f32)),
        medium_sigma_t=torch.from_numpy((sa + ss).astype(f32)))
    img = render_many(cfg, sc, W, PORT_SPP, 23)
    rel = abs(img.mean() - ref.mean()) / ref.mean()
    assert rel < 0.025, rel
    for c in range(3):
        rc = abs(img[..., c].mean() - ref[..., c].mean()) / ref[..., c].mean()
        assert rc < 0.04, (c, rc)


def test_smooth_dielectric_matches_oracle():
    """Fresnel-weighted reflect/refract, the eta^2 scaling (a light inside
    the glass leaves it uncancelled), full-weight light hits after a
    specular bounce."""
    ref = oracle.render(DIEL_SCENE, W, W, ORACLE_SPP, seed=11)
    cfg, sc = build_scene(_load(DIEL_SCENE), device="cpu")
    img = render_many(cfg, sc, W, PORT_SPP, 23)
    rel = abs(img.mean() - ref.mean()) / ref.mean()
    assert rel < 0.012, rel
    assert np.abs(img - ref).max() < 0.15


def test_medium_times_mesh_matches_oracle():
    """A medium around a triangle mesh (K1's twin on the CPU):
    transmittance across mesh shadow segments, mesh occlusion of
    volumetric NEE, and scattered lanes' exemption from self-exclusion."""
    mesh_mat = {"color": [0.75, 0.75, 0.75], "type": 1}
    mesh = make_icosphere(subdiv=1, radius=0.9, center=(0.0, 1.2, 0.0))
    ref = oracle.render(MEDIA_SCENE, W, W, MESH_ORACLE_SPP, seed=11,
                        mesh_verts=mesh[0], mesh_normals=mesh[1],
                        mesh_mat=mesh_mat)
    doc = _load(MEDIA_SCENE)
    doc["scene"]["obj"] = {"material": mesh_mat}
    cfg, sc = build_scene(doc, mesh_override=mesh, device="cpu")
    assert cfg.has_mesh and cfg.has_global_medium
    img = render_many(cfg, sc, W, MESH_PORT_SPP, 23)
    rel = abs(img.mean() - ref.mean()) / ref.mean()
    assert rel < 0.02, rel
    assert np.abs(img - ref).max() < 0.08
