"""BSDF framework: sample / evaluate / pdf for the full material set, batched.

Port of ``photorealistic_rendering_using_opencl_tpu/ops/bsdf.py``: Lambert,
Burley, smooth and rough conductors, smooth and rough dielectrics (with
the ABS_REFR / ABS_REFR2 absorption variants) and the coat.  Every family
present in ``SceneConfig.active_mats`` is evaluated for the whole batch
and combined with masked selects, as in the reference.  A scene with a
volume-boundary material (VOL) raises ``NotImplementedError`` (ROADMAP
M11).

Conventions: tangent space with the shading normal as +z; ``wi`` points
away from the surface; ``evaluate`` returns f * |cos(theta_o)|;
``sample.weight`` is f * cos / pdf; dielectric transmission carries the
reference's non-adjoint eta^2 radiance scaling.
"""
from __future__ import annotations

from typing import NamedTuple

import math

import torch

from photorealistic_rendering_using_opencl_tpu_torch.ops import fresnel, microfacet
from photorealistic_rendering_using_opencl_tpu_torch.ops.math import (
    INV_PI, normalize, reflect_local, sgn_e,
)
from photorealistic_rendering_using_opencl_tpu_torch.ops.sampling import (
    cosine_hemisphere, cosine_hemisphere_pdf,
)
from photorealistic_rendering_using_opencl_tpu_torch.scene.types import (
    ABS_REFR, ABS_REFR2, BURLEY, COAT, COND, DIEL, DIFF,
    DIFFUSE_REFLECTION_LOBE, FORWARD_LOBE, GLOSSY_REFLECTION_LOBE,
    GLOSSY_TRANSMISSION_LOBE, ROUGH_COND, ROUGH_DIEL, SceneConfig,
    SPECULAR_LOBE, SPECULAR_REFLECTION_LOBE, SPECULAR_TRANSMISSION_LOBE,
    UNPORTED_MATS,
)

DIRAC_EPS = 1e-3  # DiracAcceptanceThreshold

# Coat layer constants
COAT_IOR = 1.3
COAT_THICKNESS = 1.0
COAT_SIGMA_A = 0.0


class MatProps(NamedTuple):
    """Per-ray gathered material attributes (SoA)."""

    color: torch.Tensor  # [N,3]
    eta: torch.Tensor  # [N,3]
    k: torch.Tensor  # [N,3]
    roughness: torch.Tensor  # [N]
    mat_type: torch.Tensor  # [N] int32
    lobes: torch.Tensor  # [N] int32
    dist: torch.Tensor  # [N] int32


class BSDFSample(NamedTuple):
    wo: torch.Tensor  # [N,3] sampled direction, tangent space
    pdf: torch.Tensor  # [N]
    weight: torch.Tensor  # [N,3] f*cos/pdf
    lobe: torch.Tensor  # [N] int32 sampled lobe
    valid: torch.Tensor  # [N] bool -- False terminates the path


def check_ported(cfg: SceneConfig) -> None:
    extra = cfg.active_mats & UNPORTED_MATS
    if extra:
        raise NotImplementedError(
            f"material bits {extra:#x}: a volume boundary needs the medium "
            "code (ROADMAP M11)")


def _check_reflection(wi, wo):
    """Dirac mirror constraint."""
    d = (wi[..., 2] * wo[..., 2] - wi[..., 0] * wo[..., 0]
         - wi[..., 1] * wo[..., 1])
    return torch.abs(d - 1.0) < DIRAC_EPS


def _check_refraction(wi, wo, eta, cos_theta_t):
    d = (-wi[..., 0] * wo[..., 0] * eta
         - wi[..., 1] * wo[..., 1] * eta
         - torch.copysign(cos_theta_t, wi[..., 2]) * wo[..., 2])
    return torch.abs(d - 1.0) < DIRAC_EPS


def _rel_eta(mat: MatProps, wi_z):
    """Relative IOR as the reference's dielectrics use it."""
    return torch.where(wi_z < 0.0, mat.eta[..., 0], 1.0 / mat.eta[..., 0])


def _absorption(mat: MatProps, backside, ray_t):
    """Beer-Lambert variants ABS_REFR / ABS_REFR2; other dielectrics use
    their plain albedo."""
    abs1 = (mat.mat_type & ABS_REFR) != 0
    abs2 = (mat.mat_type & ABS_REFR2) != 0
    any_abs = abs1 | abs2
    tint = torch.where(abs2[..., None], mat.color, 1.0)
    sigma = torch.where(abs1[..., None], mat.color, 1.0)
    beer = torch.exp(-ray_t[..., None] * sigma * 10.0)
    beer = torch.where(backside[..., None], beer, 1.0)
    return torch.where(any_abs[..., None], tint * beer, mat.color)


# ===========================================================================
# Lambert
# ===========================================================================

def lambert_sample(mat: MatProps, wi, u1, u2) -> BSDFSample:
    wo = cosine_hemisphere(u1, u2)
    pdf = cosine_hemisphere_pdf(wo)
    valid = wi[..., 2] > 0.0
    lobe = torch.full(wi.shape[:-1], DIFFUSE_REFLECTION_LOBE, dtype=torch.int32,
                      device=wi.device)
    return BSDFSample(wo, pdf, mat.color, lobe, valid)


def lambert_eval(mat: MatProps, wi, wo):
    f = mat.color * INV_PI * wo[..., 2:3]
    ok = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0)
    return torch.where(ok[..., None], f, 0.0)


def lambert_pdf(wi, wo):
    ok = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0)
    return torch.where(ok, cosine_hemisphere_pdf(wo), 0.0)


# ===========================================================================
# Burley diffuse
# ===========================================================================

def _burley_fd(roughness, cos_d, cos_x):
    fd90 = 0.5 + 2.0 * roughness * cos_d * cos_d
    return 1.0 + (fd90 - 1.0) * torch.pow(1.0 - torch.abs(cos_x), 5.0)


def _burley_factor(mat: MatProps, wi, wo):
    h = normalize(wi + wo)  # NaN-free backward at h ~= 0
    cos_d = torch.sum(h * wo, dim=-1)
    return (_burley_fd(mat.roughness, cos_d, wi[..., 2])
            * _burley_fd(mat.roughness, cos_d, wo[..., 2]))


def burley_sample(mat: MatProps, wi, u1, u2) -> BSDFSample:
    wo = cosine_hemisphere(u1, u2)
    pdf = cosine_hemisphere_pdf(wo)
    fd = _burley_factor(mat, wi, wo)
    valid = wi[..., 2] > 0.0
    lobe = torch.full(wi.shape[:-1], DIFFUSE_REFLECTION_LOBE, dtype=torch.int32,
                      device=wi.device)
    return BSDFSample(wo, pdf, mat.color * fd[..., None], lobe, valid)


def burley_eval(mat: MatProps, wi, wo):
    fd = _burley_factor(mat, wi, wo)
    f = mat.color * (INV_PI * fd * wo[..., 2])[..., None]
    ok = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0)
    return torch.where(ok[..., None], f, 0.0)


# ===========================================================================
# Smooth conductor
# ===========================================================================

def conductor_sample(mat: MatProps, wi) -> BSDFSample:
    f = fresnel.conductor_reflectance_rgb(mat.eta, mat.k, wi[..., 2])
    wo = reflect_local(wi)
    n = wi.shape[:-1]
    pdf = torch.ones(n, dtype=torch.float32, device=wi.device)
    lobe = torch.full(n, SPECULAR_REFLECTION_LOBE, dtype=torch.int32,
                      device=wi.device)
    valid = torch.ones(n, dtype=torch.bool, device=wi.device)
    return BSDFSample(wo, pdf, mat.color * f, lobe, valid)


def conductor_eval(mat: MatProps, wi, wo):
    f = fresnel.conductor_reflectance_rgb(mat.eta, mat.k, wi[..., 2])
    ok = _check_reflection(wi, wo)
    return torch.where(ok[..., None], mat.color * f, 0.0)


def conductor_pdf(wi, wo):
    return _check_reflection(wi, wo).to(torch.float32)


# ===========================================================================
# Rough conductor (also the coat's substrate)
# ===========================================================================

def rough_conductor_sample(mat: MatProps, wi, u1, u2) -> BSDFSample:
    alpha = microfacet.roughness_to_alpha(mat.dist, mat.roughness)
    m = microfacet.sample(mat.dist, alpha, u1, u2)
    wi_dot_m = torch.sum(wi * m, dim=-1)
    wo = 2.0 * wi_dot_m[..., None] * m - wi
    valid = (wi[..., 2] > 0.0) & (wi_dot_m > 0.0) & (wo[..., 2] > 0.0)
    g = microfacet.G(mat.dist, alpha, wi, wo, m)
    d = microfacet.D(mat.dist, alpha, m)
    m_pdf = microfacet.pdf(mat.dist, alpha, m)
    pdf = m_pdf * 0.25 / torch.clamp(wi_dot_m, min=1e-12)
    w = wi_dot_m * g * d / torch.clamp(wi[..., 2] * m_pdf, min=1e-12)
    f = fresnel.conductor_reflectance_rgb(mat.eta, mat.k, wi_dot_m)
    lobe = torch.full(wi.shape[:-1], GLOSSY_REFLECTION_LOBE, dtype=torch.int32,
                      device=wi.device)
    return BSDFSample(wo, pdf, mat.color * f * w[..., None], lobe, valid)


def rough_conductor_eval(mat: MatProps, wi, wo):
    alpha = microfacet.roughness_to_alpha(mat.dist, mat.roughness)
    hr = normalize(wi + wo)
    cos_m = torch.sum(wi * hr, dim=-1)
    f = fresnel.conductor_reflectance_rgb(mat.eta, mat.k, cos_m)
    g = microfacet.G(mat.dist, alpha, wi, wo, hr)
    d = microfacet.D(mat.dist, alpha, hr)
    fr = g * d * 0.25 / torch.clamp(wi[..., 2], min=1e-12)
    ok = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0)
    return torch.where(ok[..., None], mat.color * f * fr[..., None], 0.0)


def rough_conductor_pdf(mat: MatProps, wi, wo):
    alpha = microfacet.roughness_to_alpha(mat.dist, mat.roughness)
    hr = normalize(wi + wo)
    p = (microfacet.pdf(mat.dist, alpha, hr) * 0.25
         / torch.clamp(torch.sum(wi * hr, dim=-1), min=1e-12))
    ok = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0)
    return torch.where(ok, p, 0.0)


# ===========================================================================
# Smooth dielectric, with the absorption variants
# ===========================================================================

def dielectric_sample(mat: MatProps, wi, backside, ray_t, u0) -> BSDFSample:
    eta = _rel_eta(mat, wi[..., 2])
    f, cos_t = fresnel.dielectric_reflectance(eta, torch.abs(wi[..., 2]))
    reflect = u0 < f
    wo_r = reflect_local(wi)
    wo_t = torch.stack([
        -wi[..., 0] * eta,
        -wi[..., 1] * eta,
        -torch.copysign(cos_t, wi[..., 2]),
    ], dim=-1)
    wo = torch.where(reflect[..., None], wo_r, wo_t)
    pdf = torch.where(reflect, f, 1.0 - f)
    wsc = torch.where(reflect, f, 1.0 - f)
    valid = reflect | (f < 1.0)
    weight = torch.broadcast_to(
        wsc[..., None] / torch.clamp(pdf, min=1e-12)[..., None],
        wi.shape)  # == 1, kept for the reference's structure
    weight = weight * _absorption(mat, backside, ray_t)
    lobe = torch.where(reflect, SPECULAR_REFLECTION_LOBE,
                       SPECULAR_TRANSMISSION_LOBE).to(torch.int32)
    return BSDFSample(wo, pdf, weight, lobe, valid)


def _dielectric_value(mat: MatProps, wi, wo):
    eta = _rel_eta(mat, wi[..., 2])
    f, cos_t = fresnel.dielectric_reflectance(eta, torch.abs(wi[..., 2]))
    same_side = wi[..., 2] * wo[..., 2] >= 0.0
    refl_ok = _check_reflection(wi, wo)
    refr_ok = _check_refraction(wi, wo, eta, cos_t)
    return torch.where(same_side,
                       torch.where(refl_ok, f, 0.0),
                       torch.where(refr_ok, 1.0 - f, 0.0))


def dielectric_eval(mat: MatProps, wi, wo):
    return _dielectric_value(mat, wi, wo)[..., None] * mat.color


def dielectric_pdf(mat: MatProps, wi, wo):
    return _dielectric_value(mat, wi, wo)


def dielectric_eta(mat: MatProps, wi, wo):
    """Radiance-scaling eta for transmission."""
    same_side = wi[..., 2] * wo[..., 2] >= 0.0
    return torch.where(same_side, 1.0, _rel_eta(mat, wi[..., 2]))


# ===========================================================================
# Rough dielectric (Walter et al. 2007 style)
# ===========================================================================

def rough_dielectric_sample(mat: MatProps, wi, backside, ray_t,
                            u0, u1, u2) -> BSDFSample:
    wi_n = wi[..., 2]
    eta = _rel_eta(mat, wi_n)
    sample_rough = (1.2 - 0.2 * torch.sqrt(torch.abs(wi_n))) * mat.roughness
    alpha = microfacet.roughness_to_alpha(mat.dist, mat.roughness)
    sample_alpha = microfacet.roughness_to_alpha(mat.dist, sample_rough)
    m = microfacet.sample(mat.dist, sample_alpha, u1, u2)
    pm = microfacet.pdf(mat.dist, sample_alpha, m)

    wi_dot_m = torch.sum(wi * m, dim=-1)
    f, cos_t = fresnel.dielectric_reflectance(1.0 / mat.eta[..., 0], wi_dot_m)
    eta_m = torch.where(wi_dot_m < 0.0, mat.eta[..., 0], 1.0 / mat.eta[..., 0])

    reflect = u0 < f
    wo_r = 2.0 * wi_dot_m[..., None] * m - wi
    wo_t = ((eta_m * wi_dot_m - sgn_e(wi_dot_m) * cos_t)[..., None] * m
            - eta_m[..., None] * wi)
    wo = torch.where(reflect[..., None], wo_r, wo_t)
    wo_n = wo[..., 2]
    reflected = wi_n * wo_n > 0.0
    valid = (pm >= 1e-10) & (reflected == reflect)

    wo_dot_m = torch.sum(wo * m, dim=-1)
    g = microfacet.G(mat.dist, alpha, wi, wo, m)
    d = microfacet.D(mat.dist, alpha, m)
    w = (torch.abs(wi_dot_m) * g * d
         / torch.clamp(torch.abs(wi_n) * pm, min=1e-12))

    denom = torch.square(eta * wi_dot_m + wo_dot_m)
    pdf_r = f * pm * 0.25 / torch.clamp(torch.abs(wi_dot_m), min=1e-12)
    pdf_t = (1.0 - f) * pm * torch.abs(wo_dot_m) / torch.clamp(denom,
                                                              min=1e-12)
    pdf = torch.where(reflect, pdf_r, pdf_t)
    lobe = torch.where(reflect, GLOSSY_REFLECTION_LOBE,
                       GLOSSY_TRANSMISSION_LOBE).to(torch.int32)
    weight = w[..., None] * _absorption(mat, backside, ray_t)
    return BSDFSample(wo, pdf, weight, lobe, valid)


def _rough_dielectric_half(mat: MatProps, wi, wo):
    wi_n, wo_n = wi[..., 2], wo[..., 2]
    reflect = wi_n * wo_n >= 0.0
    eta = _rel_eta(mat, wi_n)
    m_r = sgn_e(wi_n)[..., None] * (wi + wo)
    m_t = -(wi * eta[..., None] + wo)
    m = torch.where(reflect[..., None], m_r, m_t)
    m = normalize(m)  # NaN-free backward at m ~= 0
    return reflect, eta, m


def rough_dielectric_eval(mat: MatProps, wi, wo):
    reflect, eta, m = _rough_dielectric_half(mat, wi, wo)
    alpha = microfacet.roughness_to_alpha(mat.dist, mat.roughness)
    wi_dot_m = torch.sum(wi * m, dim=-1)
    wo_dot_m = torch.sum(wo * m, dim=-1)
    f, _ = fresnel.dielectric_reflectance(1.0 / mat.eta[..., 0], wi_dot_m)
    g = microfacet.G(mat.dist, alpha, wi, wo, m)
    d = microfacet.D(mat.dist, alpha, m)
    wi_n = wi[..., 2]
    fx_r = f * g * d * 0.25 / torch.clamp(torch.abs(wi_n), min=1e-12)
    denom = torch.square(eta * wi_dot_m + wo_dot_m)
    fx_t = (torch.abs(wi_dot_m * wo_dot_m) * (1.0 - f) * g * d
            / torch.clamp(denom * torch.abs(wi_n), min=1e-12))
    fx = torch.where(reflect, fx_r, fx_t)
    return fx[..., None] * mat.color


def rough_dielectric_pdf(mat: MatProps, wi, wo):
    reflect, eta, m = _rough_dielectric_half(mat, wi, wo)
    wi_n = wi[..., 2]
    sample_rough = (1.2 - 0.2 * torch.sqrt(torch.abs(wi_n))) * mat.roughness
    sample_alpha = microfacet.roughness_to_alpha(mat.dist, sample_rough)
    wi_dot_m = torch.sum(wi * m, dim=-1)
    wo_dot_m = torch.sum(wo * m, dim=-1)
    f, _ = fresnel.dielectric_reflectance(1.0 / mat.eta[..., 0], wi_dot_m)
    pm = microfacet.pdf(mat.dist, sample_alpha, m)
    pdf_r = f * pm * 0.25 / torch.clamp(torch.abs(wi_dot_m), min=1e-12)
    denom = torch.square(eta * wi_dot_m + wo_dot_m)
    pdf_t = (1.0 - f) * pm * torch.abs(wo_dot_m) / torch.clamp(denom,
                                                              min=1e-12)
    return torch.where(reflect, pdf_r, pdf_t)


# ===========================================================================
# Coat: smooth dielectric clearcoat over a rough-conductor substrate
# ===========================================================================

def coat_sample(mat: MatProps, wi, u0, u1, u2) -> BSDFSample:
    eta = 1.0 / COAT_IOR
    scaled_sigma_a = COAT_THICKNESS * COAT_SIGMA_A
    avg_transmittance = math.exp(-2.0 * scaled_sigma_a)

    fi, cos_ti = fresnel.dielectric_reflectance(eta, wi[..., 2])
    spec_prob = fi / (fi + avg_transmittance * (1.0 - fi))
    pick_spec = u0 < spec_prob

    # specular branch
    wo_s = reflect_local(wi)
    pdf_s = spec_prob
    w_s = (fi / torch.clamp(spec_prob, min=1e-12))[..., None]

    # substrate branch: refract wi into the coat, bounce off rough conductor
    wi_sub = torch.stack([wi[..., 0] * eta, wi[..., 1] * eta, cos_ti], dim=-1)
    sub = rough_conductor_sample(mat, wi_sub, u1, u2)
    fo, cos_to = fresnel.dielectric_reflectance(COAT_IOR, sub.wo[..., 2])
    cos_sub = sub.wo[..., 2]
    wo_g = torch.stack([
        sub.wo[..., 0] * COAT_IOR, sub.wo[..., 1] * COAT_IOR, cos_to
    ], dim=-1)
    w_g = sub.weight * ((1.0 - fi) * (1.0 - fo))[..., None]
    w_g = w_g / torch.clamp(1.0 - spec_prob, min=1e-12)[..., None]
    pdf_g = (sub.pdf * (1.0 - spec_prob) * eta * eta
             * cos_to / torch.clamp(cos_sub, min=1e-12))
    valid_g = sub.valid & (fo < 1.0)

    wo = torch.where(pick_spec[..., None], wo_s, wo_g)
    pdf = torch.where(pick_spec, pdf_s, pdf_g)
    weight = torch.where(pick_spec[..., None], w_s, w_g)
    lobe = torch.where(pick_spec, SPECULAR_REFLECTION_LOBE,
                       GLOSSY_REFLECTION_LOBE).to(torch.int32)
    valid = (wi[..., 2] > 0.0) & (pick_spec | valid_g)
    return BSDFSample(wo, pdf, weight, lobe, valid)


def _coat_sub_dirs(wi, wo, eta):
    fi, cos_ti = fresnel.dielectric_reflectance(eta, wi[..., 2])
    fo, cos_to = fresnel.dielectric_reflectance(eta, wo[..., 2])
    wi_sub = torch.stack([wi[..., 0] * eta, wi[..., 1] * eta,
                          torch.copysign(cos_ti, wi[..., 2])], dim=-1)
    wo_sub = torch.stack([wo[..., 0] * eta, wo[..., 1] * eta,
                          torch.copysign(cos_to, wo[..., 2])], dim=-1)
    return fi, fo, cos_to, wi_sub, wo_sub


def coat_eval(mat: MatProps, wi, wo):
    eta = 1.0 / COAT_IOR
    fi, fo, cos_to, wi_sub, wo_sub = _coat_sub_dirs(wi, wo, eta)
    refl = _check_reflection(wi, wo)
    substrate = rough_conductor_eval(mat, wi_sub, wo_sub)
    laplacian = eta * eta * wo[..., 2] / torch.clamp(cos_to, min=1e-12)
    glossy = (laplacian * (1.0 - fi) * (1.0 - fo))[..., None] * substrate
    out = torch.where(refl[..., None], fi[..., None] * torch.ones_like(substrate),
                      glossy)
    ok = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0)
    return torch.where(ok[..., None], out, 0.0)


def coat_pdf(mat: MatProps, wi, wo):
    eta = 1.0 / COAT_IOR
    scaled_sigma_a = COAT_THICKNESS * COAT_SIGMA_A
    avg_transmittance = math.exp(-2.0 * scaled_sigma_a)
    fi, fo, cos_to, wi_sub, wo_sub = _coat_sub_dirs(wi, wo, eta)
    spec_prob = fi / (fi + avg_transmittance * (1.0 - fi))
    refl = _check_reflection(wi, wo)
    sub_pdf = rough_conductor_pdf(mat, wi_sub, wo_sub)
    glossy = (sub_pdf * (1.0 - spec_prob) * eta * eta
              * torch.abs(wo[..., 2] / torch.clamp(cos_to, min=1e-12)))
    p = torch.where(refl, spec_prob, glossy)
    ok = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0)
    return torch.where(ok, p, 0.0)


# ===========================================================================
# Dispatch (bitmask-gated, like the reference)
# ===========================================================================

def _select(mask, a: BSDFSample, b: BSDFSample) -> BSDFSample:
    m1 = mask[..., None]
    return BSDFSample(
        torch.where(m1, a.wo, b.wo),
        torch.where(mask, a.pdf, b.pdf),
        torch.where(m1, a.weight, b.weight),
        torch.where(mask, a.lobe, b.lobe),
        torch.where(mask, a.valid, b.valid),
    )


def sample(cfg: SceneConfig, mat: MatProps, wi, backside, ray_t,
           u0, u1, u2) -> BSDFSample:
    """Type-dispatched BSDF sampling with the eta^2 non-adjoint scaling."""
    check_ported(cfg)
    n = wi.shape[:-1]
    dev = wi.device
    out = BSDFSample(
        wo=torch.zeros_like(wi),
        pdf=torch.zeros(n, dtype=torch.float32, device=dev),
        weight=torch.zeros_like(wi),
        lobe=torch.zeros(n, dtype=torch.int32, device=dev),
        valid=torch.zeros(n, dtype=torch.bool, device=dev),
    )
    t = mat.mat_type
    if cfg.has_mat(DIFF):
        out = _select((t & DIFF) != 0, lambert_sample(mat, wi, u1, u2), out)
    if cfg.has_mat(BURLEY):
        out = _select((t & BURLEY) != 0, burley_sample(mat, wi, u1, u2), out)
    if cfg.has_mat(COND):
        out = _select((t & COND) != 0, conductor_sample(mat, wi), out)
    if cfg.has_mat(ROUGH_COND):
        out = _select((t & ROUGH_COND) != 0,
                      rough_conductor_sample(mat, wi, u1, u2), out)
    if cfg.has_mat(DIEL):
        out = _select((t & DIEL) != 0,
                      dielectric_sample(mat, wi, backside, ray_t, u0), out)
    if cfg.has_mat(ROUGH_DIEL):
        out = _select((t & ROUGH_DIEL) != 0,
                      rough_dielectric_sample(mat, wi, backside, ray_t,
                                              u0, u1, u2), out)
    if cfg.has_mat(COAT):
        out = _select((t & COAT) != 0, coat_sample(mat, wi, u0, u1, u2), out)
    if cfg.has_mat(DIEL) or cfg.has_mat(ROUGH_DIEL):
        eta_scale = _eta_for(mat, wi, out.wo)
        out = out._replace(
            weight=out.weight * torch.square(eta_scale)[..., None])
    return out


def _eta_for(mat: MatProps, wi, wo):
    is_diel = (mat.mat_type & (DIEL | ROUGH_DIEL)) != 0
    return torch.where(is_diel, dielectric_eta(mat, wi, wo), 1.0)


def evaluate(cfg: SceneConfig, mat: MatProps, wi, wo,
             backside=None, ray_t=None) -> torch.Tensor:
    """f(wi,wo)*cos with the eta^2 scaling of dielectric transmission."""
    check_ported(cfg)
    t = mat.mat_type
    f = torch.zeros_like(wi)
    for bit, fn in ((DIFF, lambda: lambert_eval(mat, wi, wo)),
                    (BURLEY, lambda: burley_eval(mat, wi, wo)),
                    (COND, lambda: conductor_eval(mat, wi, wo)),
                    (ROUGH_COND, lambda: rough_conductor_eval(mat, wi, wo)),
                    (DIEL, lambda: dielectric_eval(mat, wi, wo)),
                    (ROUGH_DIEL, lambda: rough_dielectric_eval(mat, wi, wo)),
                    (COAT, lambda: coat_eval(mat, wi, wo))):
        if cfg.has_mat(bit):
            f = torch.where(((t & bit) != 0)[..., None], fn(), f)
    if cfg.has_mat(DIEL) or cfg.has_mat(ROUGH_DIEL):
        f = f * torch.square(_eta_for(mat, wi, wo))[..., None]
    return f


def pdf(cfg: SceneConfig, mat: MatProps, wi, wo) -> torch.Tensor:
    check_ported(cfg)
    t = mat.mat_type
    p = torch.zeros(wi.shape[:-1], dtype=torch.float32, device=wi.device)
    for bit, fn in ((DIFF, lambda: lambert_pdf(wi, wo)),
                    (BURLEY, lambda: lambert_pdf(wi, wo)),
                    (COND, lambda: conductor_pdf(wi, wo)),
                    (ROUGH_COND, lambda: rough_conductor_pdf(mat, wi, wo)),
                    (DIEL, lambda: dielectric_pdf(mat, wi, wo)),
                    (ROUGH_DIEL, lambda: rough_dielectric_pdf(mat, wi, wo)),
                    (COAT, lambda: coat_pdf(mat, wi, wo))):
        if cfg.has_mat(bit):
            p = torch.where((t & bit) != 0, fn(), p)
    return p


def nee_capable(mat: MatProps) -> torch.Tensor:
    """Materials whose lobes admit light sampling."""
    return (mat.lobes & ~(SPECULAR_LOBE | FORWARD_LOBE)) != 0
