"""A plain unidirectional path tracer with next-event estimation, one path a
lane, every lane advancing one vertex at a time: the semantics of the
OpenCL renderer's ``pathtracing.cl`` integrator as the port states them.

Per vertex: a miss takes the sky (weighted by the power heuristic against
the sky's sampler), a light hit takes its emission (weighted against the
first light's sampler), a surface samples the first light and the sky
toward shadow rays, then continues by its BSDF; Russian roulette after
the third vertex; the path ends at the bounce budgets.  Random decisions
are drawn from fixed dimensions: the camera owns 0-7, vertex b owns
8 + 16 b onward (light 3, sky 2 when there is a sky, BSDF 3, roulette 1).

Only the radiance carries a gradient: the colours and the sky map may
require one, the geometry never does.  Every geometric factor is zeroed
where it is not used before it meets a radiance term, so that no lane
that does not contribute can turn a gradient into NaN.

``dtype`` sets the precision of all floating-point work (the benchmark's
control runs this tracer in bfloat16).
"""
from __future__ import annotations

import math

import torch

from benchmark.reference.rng import Stream
from benchmark.reference.scene import (
    ABS_REFR, ABS_REFR2, BECKMANN, BURLEY, COAT, COND, DIEL, DIFF,
    DIFFUSE_R, FORWARD, GLOSSY_R, GLOSSY_T, LIGHT, PHONG, ROUGH_COND,
    ROUGH_DIEL, SPECULAR, SPECULAR_R, SPECULAR_T, TRANSMISSIVE, Scene,
)

EPS = 1e-5
RAY_INF = 20.0  # the renderer's 20-unit world
PI = math.pi
INV_PI = 1.0 / math.pi
TWO_PI = 2.0 * math.pi
INV_TWO_PI = 1.0 / (2.0 * math.pi)
DIRAC_EPS = 1e-3
COAT_IOR = 1.3


# ---------------------------------------------------------------- vectors

def dot(a, b):
    return torch.sum(a * b, dim=-1)


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def normalize(a):
    return a * torch.reciprocal(torch.sqrt(torch.clamp(
        torch.sum(a * a, dim=-1, keepdim=True), min=1e-12)))


def ssqrt(x):
    neg = x <= 0.0
    return torch.where(neg, 0.0, torch.sqrt(torch.where(neg, 1.0, x)))


def frame(n):
    """Duff et al.'s branchless orthonormal basis about n."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    s = torch.where(nz >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (s + nz)
    b = nx * ny * a
    t = torch.stack([1.0 + s * nx * nx * a, s * b, -s * nx], -1)
    bt = torch.stack([b, s + ny * ny * a, -ny], -1)
    return t, bt


def to_local(n, v):
    t, bt = frame(n)
    return torch.stack([dot(t, v), dot(bt, v), dot(n, v)], -1)


def to_world(n, v):
    t, bt = frame(n)
    return t * v[..., 0:1] + bt * v[..., 1:2] + n * v[..., 2:3]


def mirror(w):
    return torch.stack([-w[..., 0], -w[..., 1], w[..., 2]], -1)


def power_heuristic(p0, p1):
    m = torch.maximum(p0, p1)
    big = m > 1e12
    s = torch.where(big, 1e12 / torch.where(big, m, 1.0), 1.0)
    p0, p1 = p0 * s, p1 * s
    q = p0 * p0
    den = q + p1 * p1
    tiny = den < 1e-12
    return torch.where(tiny, 0.0, q / torch.where(tiny, 1.0, den))


def polar(phi, z):
    r = ssqrt(1.0 - z * z)
    return torch.stack([torch.cos(phi) * r, torch.sin(phi) * r, z], -1)


def cosine_dir(u1, u2):
    phi = u1 * TWO_PI
    r = torch.sqrt(u2)
    return torch.stack([torch.cos(phi) * r, torch.sin(phi) * r,
                        torch.sqrt(torch.clamp(1.0 - u2, min=0.0))], -1)


# ---------------------------------------------------------------- camera

def camera_rays(cam: dict, width, height, px, py, jx, jy, a1, a2):
    """Thin-lens rays through jittered pixel positions."""
    view, up = normalize(cam["view"]), normalize(cam["up"])
    hx = normalize(cross(view, up))
    vy = normalize(cross(hx, view))
    middle = cam["position"] + view
    horiz = hx * torch.tan(cam["fov"][0] * 0.5 * (PI / 180.0))
    vert = vy * (-torch.tan(cam["fov"][1] * 0.5 * (PI / 180.0)))
    sx = (px.to(jx.dtype) + jx) / float(width - 1.0)
    sy = ((height - 1 - py).to(jx.dtype) + jy) / float(height - 1.0)
    plane = (middle[None] + horiz[None] * (2.0 * sx - 1.0)[:, None]
             + vert[None] * (2.0 * sy - 1.0)[:, None])
    target = cam["position"][None] + (plane - cam["position"][None]) \
        * cam["focal_distance"]
    ang = TWO_PI * a1
    r = torch.sqrt(a2)
    disk = torch.stack([torch.cos(ang) * r, torch.sin(ang) * r], -1) \
        * cam["aperture_radius"]
    lens = cam["position"][None] + hx[None] * disk[:, 0:1] \
        + vy[None] * disk[:, 1:2]
    origin = torch.where(cam["aperture_radius"] > 1e-5, lens,
                         torch.broadcast_to(cam["position"], lens.shape))
    return origin, normalize(target - origin)


# ---------------------------------------------------------- intersection

def sphere_t(o, d, c, r):
    """[N] rays x [S] spheres -> nearest t > EPS (inf on a miss)."""
    p = o[:, None, :] - c[None]
    b = torch.sum(p * d[:, None, :], -1)
    cc = torch.sum(p * p, -1) - r[None] * r[None]
    disc = b * b - cc
    miss = disc < EPS * EPS
    det = torch.where(miss, 0.0, torch.sqrt(torch.where(miss, 1.0, disc)))
    t0, t1 = -b - det, -b + det
    t = torch.where(t0 > EPS, t0, torch.where(t1 > EPS, t1, torch.inf))
    return torch.where(disc >= 0.0, t, torch.inf)


def quad_t(o, d, base, e0, e1, n):
    """One-sided parallelograms, seen only against their normal's side."""
    nd = torch.sum(n[None] * d[:, None, :], -1)
    anchor = base - (e0 + e1) * 0.5
    t = (torch.sum(n[None] * (anchor[None] - o[:, None, :]), -1)
         / torch.where(torch.abs(nd) < 1e-12, 1e-12, nd))
    v = o[:, None, :] + t[..., None] * d[:, None, :] - anchor[None]
    l0 = torch.sum(v * e0[None], -1) / torch.clamp(
        torch.sum(e0 * e0, -1)[None], min=1e-12)
    l1 = torch.sum(v * e1[None], -1) / torch.clamp(
        torch.sum(e1 * e1, -1)[None], min=1e-12)
    ok = ((nd >= 1e-5) & (t > EPS) & (l0 >= 0.0) & (l0 <= 1.0)
          & (l1 >= 0.0) & (l1 <= 1.0))
    return torch.where(ok, t, torch.inf)


def tri_tuv(p0, p1, p2, o, d):
    """Moller-Trumbore's t, u, v of rays against their triangles."""
    e1, e2 = p0 - p1, p2 - p0
    n = cross(e1, e2)
    c = p0 - o
    r = cross(d, c)
    den = torch.sum(n * d, -1)
    inv = 1.0 / torch.where(torch.abs(den) < 1e-20,
                            torch.copysign(torch.full_like(den, 1e-20), den),
                            den)
    return (torch.sum(n * c, -1) * inv, torch.sum(r * e2, -1) * inv,
            torch.sum(r * e1, -1) * inv)


def mesh_hits(sc: Scene, o, d, t_max, any_hit: bool,
              chunk: int = 1 << 24):
    """Every ray against every triangle of each group whose box it enters
    before ``t_max``.  The closest hit in (EPS, t_max) -> (t, tri), tri -1
    where none and the lowest index among equal t; with ``any_hit`` ->
    blocked [N] bool."""
    n = o.shape[0]
    dev = o.device
    inv = 1.0 / torch.where(torch.abs(d) < 1e-12,
                            torch.copysign(torch.full_like(d, 1e-12), d), d)
    rows, grps = [], []
    step = max(1, chunk // max(1, sc.grp_lo.shape[0]))
    for s in range(0, n, step):
        e = slice(s, s + step)
        a = (sc.grp_lo[None] - o[e, None]) * inv[e, None]
        b = (sc.grp_hi[None] - o[e, None]) * inv[e, None]
        near = torch.amax(torch.minimum(a, b), -1)
        far = torch.amin(torch.maximum(a, b), -1)
        r, g = torch.nonzero((near <= far) & (far > 0.0)
                             & (near < t_max[e, None]), as_tuple=True)
        rows.append(r + s)
        grps.append(g)
    rows, grps = torch.cat(rows), torch.cat(grps)
    n_tri = sc.tri_v.shape[0]
    group = sc.grp_size
    per = max(1, chunk // group)
    ar = torch.arange(group, device=dev)
    hr = [rows[:0]]
    ht = [rows[:0]]
    hv = [o.new_zeros((0,))]
    for s in range(0, rows.shape[0], per):
        rr = rows[s:s + per, None].expand(-1, group).reshape(-1)
        tt = (grps[s:s + per, None] * group + ar[None]).reshape(-1)
        keep = tt < n_tri
        rr, tt = rr[keep], tt[keep]
        tv = sc.tri_v[tt]
        t, u, v = tri_tuv(tv[:, 0], tv[:, 1], tv[:, 2], o[rr], d[rr])
        hit = ((u >= 0.0) & (v >= 0.0) & (1.0 - u - v >= 0.0) & (t > EPS)
               & (t < t_max[rr]))
        hr.append(rr[hit])
        ht.append(tt[hit])
        hv.append(t[hit])
    hr, ht, hv = torch.cat(hr), torch.cat(ht), torch.cat(hv)
    if any_hit:
        blocked = torch.zeros((n,), dtype=torch.bool, device=dev)
        blocked[hr] = True
        return blocked
    best = torch.full((n,), torch.inf, dtype=o.dtype, device=dev)
    best.scatter_reduce_(0, hr, hv, "amin")
    at = hv == best[hr]
    tri = torch.full((n,), n_tri, dtype=torch.int64, device=dev)
    tri.scatter_reduce_(0, hr[at], ht[at], "amin")
    return best, torch.where(tri < n_tri, tri, -1)


class Hit:
    pass


def closest(sc: Scene, o, d):
    """The first surface along each ray: t, object (-1 none; n_objects for
    the mesh), position, normal turned toward the ray (not for
    dielectrics), backside."""
    n = o.shape[0]
    dev = o.device
    t = torch.full((n,), RAY_INF, dtype=o.dtype, device=dev)
    obj = torch.full((n,), -1, dtype=torch.int64, device=dev)
    nrm = torch.zeros_like(o)
    if sc.n_spheres:
        ts = sphere_t(o, d, sc.sph_c, sc.sph_r)
        best, arg = torch.min(ts, -1)
        better = best < t
        t = torch.where(better, best, t)
        obj = torch.where(better, arg, obj)
        ns = normalize(o + d * t[..., None] - sc.sph_c[arg])
        nrm = torch.where(better[..., None], ns, nrm)
    if sc.n_quads:
        tq = quad_t(o, d, sc.q_base, sc.q_e0, sc.q_e1, sc.q_n)
        best, arg = torch.min(tq, -1)
        better = best < t
        t = torch.where(better, best, t)
        obj = torch.where(better, sc.n_spheres + arg, obj)
        nrm = torch.where(better[..., None], sc.q_n[arg], nrm)
    if sc.has_mesh:
        _, tri = mesh_hits(sc, o, d, t, any_hit=False)
        on = tri >= 0
        tv = sc.tri_v[torch.clamp(tri, min=0)]
        tm, u, v = tri_tuv(tv[:, 0], tv[:, 1], tv[:, 2], o, d)
        tn = sc.tri_n[torch.clamp(tri, min=0)]
        w = 1.0 - u - v
        nm = normalize(w[..., None] * tn[:, 0] + u[..., None] * tn[:, 1]
                       + v[..., None] * tn[:, 2])
        t = torch.where(on, tm, t)
        obj = torch.where(on, sc.n_objects, obj)
        nrm = torch.where(on[..., None], nm, nrm)
    h = Hit()
    h.t, h.obj, h.valid = t, obj, t < RAY_INF
    h.pos = o + d * t[..., None]
    mt = torch.where(obj < 0, 0, sc.mtype[torch.clamp(obj, min=0)])
    h.backside = torch.sum(nrm * d, -1) > 0.0
    flip = ((mt & ~(DIEL | ROUGH_DIEL)) != 0) & h.backside
    h.normal = torch.where(flip[..., None], -nrm, nrm)
    return h


def unblocked(sc: Scene, o, d, dist, active):
    """True where nothing lies on the segment short of ``dist``."""
    limit = dist * (1.0 - 1e-3)
    blocked = torch.zeros_like(active)
    if sc.n_spheres:
        blocked |= torch.amin(sphere_t(o, d, sc.sph_c, sc.sph_r), -1) < limit
    if sc.n_quads:
        blocked |= torch.amin(quad_t(o, d, sc.q_base, sc.q_e0, sc.q_e1,
                                     sc.q_n), -1) < limit
    if sc.has_mesh:
        todo = torch.nonzero(active & ~blocked).squeeze(1)
        if todo.numel():
            blocked[todo] = mesh_hits(sc, o[todo], d[todo], limit[todo],
                                      any_hit=True)
    return ~blocked


# ----------------------------------------------------------------- fresnel

def fresnel_conductor(eta, k, c):
    """Unpolarised conductor reflectance; eta, k [N,3], cosine [N] ->
    [N,3]."""
    c = c[..., None]
    c2 = c * c
    s2 = torch.clamp(1.0 - c2, min=0.0)
    s4 = s2 * s2
    inner = eta * eta - k * k - s2
    a2b2 = ssqrt(inner * inner + 4.0 * eta * eta * k * k)
    a = ssqrt((a2b2 + inner) * 0.5)
    rs = ((a2b2 + c2) - 2.0 * a * c) / torch.clamp(
        (a2b2 + c2) + 2.0 * a * c, min=1e-30)
    rp = ((c2 * a2b2 + s4) - 2.0 * a * c * s2) / torch.clamp(
        (c2 * a2b2 + s4) + 2.0 * a * c * s2, min=1e-30)
    return 0.5 * (rs + rs * rp)


def fresnel_dielectric(eta, ci):
    """(reflectance, cos of the refracted angle; 0 at total internal
    reflection); a negative cosine flips the interface."""
    eta = torch.as_tensor(eta, dtype=ci.dtype, device=ci.device)
    e = torch.where(ci < 0.0, 1.0 / eta, eta)
    ci = torch.abs(ci)
    s2t = e * e * torch.clamp(1.0 - ci * ci, min=0.0)
    tir = s2t > 1.0
    ct = ssqrt(1.0 - s2t)
    rs = (e * ci - ct) / torch.clamp(e * ci + ct, min=1e-30)
    rp = (e * ct - ci) / torch.clamp(e * ct + ci, min=1e-30)
    f = 0.5 * (rs * rs + rp * rp)
    return torch.where(tir, 1.0, f), torch.where(tir, 0.0, ct)


# -------------------------------------------------------------- microfacets

def mf_alpha(dist, rough):
    r = torch.clamp(rough, min=1e-3)
    return torch.where((dist & PHONG) != 0, 2.0 / (r * r) - 2.0, r)


def mf_D(dist, alpha, m):
    mz = m[..., 2]
    a2 = alpha * alpha
    c2 = mz * mz
    t2 = torch.clamp(1.0 - c2, min=0.0) / torch.clamp(c2, min=1e-12)
    c4 = torch.clamp(c2 * c2, min=1e-20)
    a2s = torch.clamp(a2, min=1e-12)
    c2s = torch.clamp(c2, min=1e-12)
    beck = INV_PI * torch.exp(-t2 / a2s - torch.log(a2s) - 2.0 * torch.log(c2s))
    phong = (alpha + 2.0) * INV_TWO_PI * torch.pow(torch.clamp(mz, min=1e-12),
                                                   alpha)
    ggx = a2 * INV_PI / (c4 * torch.square(a2 + t2))
    d = torch.where((dist & BECKMANN) != 0, beck,
                    torch.where((dist & PHONG) != 0, phong, ggx))
    return torch.where(mz <= 0.0, 0.0, d)


def _smith(a):
    a = torch.clamp(a, min=1e-12)
    low = (3.535 * a + 2.181 * a * a) / (1.0 + 2.276 * a + 2.577 * a * a)
    return torch.where(a < 1.6, low, 1.0)


def mf_G1(dist, alpha, v, m):
    vz = v[..., 2]
    back = torch.sum(v * m, -1) * vz <= 0.0
    c2 = vz * vz
    tan = torch.clamp(torch.abs(ssqrt(1.0 - c2)
                                / torch.where(vz == 0.0, 1e-12, vz)), min=1e-12)
    beck = _smith(1.0 / (torch.clamp(alpha, min=1e-12) * tan))
    phong = _smith(torch.sqrt(0.5 * alpha + 1.0) / tan)
    t2 = torch.clamp(1.0 - c2, min=0.0) / torch.clamp(c2, min=1e-12)
    ggx = 2.0 / (1.0 + torch.sqrt(1.0 + alpha * alpha * t2))
    g = torch.where((dist & BECKMANN) != 0, beck,
                    torch.where((dist & PHONG) != 0, phong, ggx))
    return torch.where(back, 0.0, g)


def mf_G(dist, alpha, wi, wo, m):
    return mf_G1(dist, alpha, wi, m) * mf_G1(dist, alpha, wo, m)


def mf_pdf(dist, alpha, m):
    return mf_D(dist, alpha, m) * torch.clamp(m[..., 2], min=0.0)


def mf_sample(dist, alpha, u1, u2):
    phi = u2 * TWO_PI
    xs = torch.clamp(u1, 0.0, 1.0 - 1e-7)
    beck = 1.0 / torch.sqrt(1.0 + (-alpha * alpha * torch.log1p(-xs)))
    phong = torch.pow(xs, 1.0 / (alpha + 2.0))
    ggx = 1.0 / torch.sqrt(1.0 + alpha * alpha * xs / (1.0 - xs))
    c = torch.where((dist & BECKMANN) != 0, beck,
                    torch.where((dist & PHONG) != 0, phong, ggx))
    r = ssqrt(1.0 - c * c)
    return torch.stack([torch.cos(phi) * r, torch.sin(phi) * r, c], -1)


# ------------------------------------------------------------------- BSDFs
#
# A lobe's value is A * s: s [N,3] a factor of the geometry alone, A the
# colour term that carries the gradient: "one" (1), "color" (the albedo)
# or "absorb" (a dielectric's albedo or its Beer-Lambert absorption).

class Mat:
    def __init__(self, sc: Scene, obj, color, obj_color):
        idx = torch.clamp(obj, 0, sc.n_objects).long()
        self.color = torch.cat([color, obj_color[None]])[idx]
        self.eta, self.k = sc.eta[idx], sc.k[idx]
        self.rough, self.type = sc.rough[idx], sc.mtype[idx]
        self.lobes, self.dist = sc.lobes[idx], sc.dist[idx]

    def term(self, mode, backside, ray_t):
        """The colour term of each lane's ``mode`` (0 one, 1 colour,
        2 absorption)."""
        abs1 = (self.type & ABS_REFR) != 0
        abs2 = (self.type & ABS_REFR2) != 0
        tint = torch.where(abs2[..., None], self.color, 1.0)
        sigma = torch.where(abs1[..., None], self.color, 1.0)
        beer = torch.where(backside[..., None],
                           torch.exp(-ray_t[..., None] * sigma * 10.0), 1.0)
        absorb = torch.where((abs1 | abs2)[..., None], tint * beer,
                             self.color)
        return torch.where((mode == 1)[..., None], self.color,
                           torch.where((mode == 2)[..., None], absorb, 1.0))


def _refl_ok(wi, wo):
    d = (wi[..., 2] * wo[..., 2] - wi[..., 0] * wo[..., 0]
         - wi[..., 1] * wo[..., 1])
    return torch.abs(d - 1.0) < DIRAC_EPS


def _refr_ok(wi, wo, eta, ct):
    d = (-wi[..., 0] * wo[..., 0] * eta - wi[..., 1] * wo[..., 1] * eta
         - torch.copysign(ct, wi[..., 2]) * wo[..., 2])
    return torch.abs(d - 1.0) < DIRAC_EPS


def _sign(x):
    """-1 below zero, else 1 (zero counts as positive)."""
    return torch.where(x < 0.0, -1.0, 1.0).to(x.dtype)


def _rel_eta(m: Mat, wz):
    return torch.where(wz < 0.0, m.eta[..., 0], 1.0 / m.eta[..., 0])


def _burley(m: Mat, wi, wo):
    h = normalize(wi + wo)
    cd = torch.sum(h * wo, -1)

    def fd(cx):
        f90 = 0.5 + 2.0 * m.rough * cd * cd
        return 1.0 + (f90 - 1.0) * torch.pow(1.0 - torch.abs(cx), 5.0)
    return fd(wi[..., 2]) * fd(wo[..., 2])


def _rough_cond_sample(m: Mat, wi, u1, u2):
    alpha = mf_alpha(m.dist, m.rough)
    h = mf_sample(m.dist, alpha, u1, u2)
    im = torch.sum(wi * h, -1)
    wo = 2.0 * im[..., None] * h - wi
    valid = (wi[..., 2] > 0.0) & (im > 0.0) & (wo[..., 2] > 0.0)
    g = mf_G(m.dist, alpha, wi, wo, h)
    d = mf_D(m.dist, alpha, h)
    hp = mf_pdf(m.dist, alpha, h)
    pdf = hp * 0.25 / torch.clamp(im, min=1e-12)
    w = im * g * d / torch.clamp(wi[..., 2] * hp, min=1e-12)
    s = fresnel_conductor(m.eta, m.k, im) * w[..., None]
    return wo, pdf, s, valid


def _rough_cond_eval(m: Mat, wi, wo):
    alpha = mf_alpha(m.dist, m.rough)
    h = normalize(wi + wo)
    f = fresnel_conductor(m.eta, m.k, torch.sum(wi * h, -1))
    fr = (mf_G(m.dist, alpha, wi, wo, h) * mf_D(m.dist, alpha, h) * 0.25
          / torch.clamp(wi[..., 2], min=1e-12))
    ok = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0)
    return torch.where(ok[..., None], f * fr[..., None], 0.0)


def _rough_cond_pdf(m: Mat, wi, wo):
    alpha = mf_alpha(m.dist, m.rough)
    h = normalize(wi + wo)
    p = (mf_pdf(m.dist, alpha, h) * 0.25
         / torch.clamp(torch.sum(wi * h, -1), min=1e-12))
    return torch.where((wi[..., 2] > 0.0) & (wo[..., 2] > 0.0), p, 0.0)


def _diel_value(m: Mat, wi, wo):
    eta = _rel_eta(m, wi[..., 2])
    f, ct = fresnel_dielectric(eta, torch.abs(wi[..., 2]))
    return torch.where(wi[..., 2] * wo[..., 2] >= 0.0,
                       torch.where(_refl_ok(wi, wo), f, 0.0),
                       torch.where(_refr_ok(wi, wo, eta, ct), 1.0 - f, 0.0))


def _rd_half(m: Mat, wi, wo):
    refl = wi[..., 2] * wo[..., 2] >= 0.0
    eta = _rel_eta(m, wi[..., 2])
    h = torch.where(refl[..., None],
                    _sign(wi[..., 2])[..., None]
                    * (wi + wo), -(wi * eta[..., None] + wo))
    return refl, eta, normalize(h)


def _rd_sample_rough(m: Mat, wz):
    return (1.2 - 0.2 * torch.sqrt(torch.abs(wz))) * m.rough


def _coat_dirs(wi, wo, eta):
    fi, cti = fresnel_dielectric(eta, wi[..., 2])
    fo, cto = fresnel_dielectric(eta, wo[..., 2])
    wi_s = torch.stack([wi[..., 0] * eta, wi[..., 1] * eta,
                        torch.copysign(cti, wi[..., 2])], -1)
    wo_s = torch.stack([wo[..., 0] * eta, wo[..., 1] * eta,
                        torch.copysign(cto, wo[..., 2])], -1)
    return fi, fo, cto, wi_s, wo_s


def bsdf_sample(m: Mat, wi, u0, u1, u2):
    """-> (wo, pdf, s, colour mode, lobe, valid) of each lane's family."""
    n = wi.shape[0]
    dev, dt = wi.device, wi.dtype
    wo = torch.zeros_like(wi)
    pdf = torch.zeros((n,), dtype=dt, device=dev)
    s = torch.zeros_like(wi)
    mode = torch.zeros((n,), dtype=torch.int64, device=dev)
    lobe = torch.zeros((n,), dtype=torch.int64, device=dev)
    valid = torch.zeros((n,), dtype=torch.bool, device=dev)
    t = m.type

    def put(bit, w_, p_, s_, md, lb, v_):
        nonlocal wo, pdf, s, mode, lobe, valid
        sel = (t & bit) != 0
        wo = torch.where(sel[..., None], w_, wo)
        pdf = torch.where(sel, p_, pdf)
        s = torch.where(sel[..., None], s_, s)
        mode = torch.where(sel, md, mode)
        lobe = torch.where(sel, lb, lobe)
        valid = torch.where(sel, v_, valid)

    one = torch.ones_like(wi)
    up = wi[..., 2] > 0.0
    cw = cosine_dir(u1, u2)
    cpdf = torch.abs(cw[..., 2]) * INV_PI
    put(DIFF, cw, cpdf, one, 1, DIFFUSE_R, up)
    put(BURLEY, cw, cpdf, _burley(m, wi, cw)[..., None] * one, 1, DIFFUSE_R,
        up)
    put(COND, mirror(wi), torch.ones_like(pdf),
        fresnel_conductor(m.eta, m.k, wi[..., 2]), 1, SPECULAR_R,
        torch.ones_like(valid))
    rc = _rough_cond_sample(m, wi, u1, u2)
    put(ROUGH_COND, rc[0], rc[1], rc[2], 1, GLOSSY_R, rc[3])

    # smooth dielectric
    eta = _rel_eta(m, wi[..., 2])
    f, ct = fresnel_dielectric(eta, torch.abs(wi[..., 2]))
    refl = u0 < f
    wt = torch.stack([-wi[..., 0] * eta, -wi[..., 1] * eta,
                      -torch.copysign(ct, wi[..., 2])], -1)
    p = torch.where(refl, f, 1.0 - f)
    put(DIEL, torch.where(refl[..., None], mirror(wi), wt), p,
        (p / torch.clamp(p, min=1e-12))[..., None] * one, 2,
        torch.where(refl, SPECULAR_R, SPECULAR_T), refl | (f < 1.0))

    # rough dielectric
    wz = wi[..., 2]
    alpha = mf_alpha(m.dist, m.rough)
    salpha = mf_alpha(m.dist, _rd_sample_rough(m, wz))
    h = mf_sample(m.dist, salpha, u1, u2)
    hp = mf_pdf(m.dist, salpha, h)
    im = torch.sum(wi * h, -1)
    f, ct = fresnel_dielectric(1.0 / m.eta[..., 0], im)
    em = torch.where(im < 0.0, m.eta[..., 0], 1.0 / m.eta[..., 0])
    refl = u0 < f
    wr = 2.0 * im[..., None] * h - wi
    wt = ((em * im - _sign(im) * ct)[..., None] * h
          - em[..., None] * wi)
    w_ = torch.where(refl[..., None], wr, wt)
    om = torch.sum(w_ * h, -1)
    g = mf_G(m.dist, alpha, wi, w_, h)
    d = mf_D(m.dist, alpha, h)
    ww = torch.abs(im) * g * d / torch.clamp(torch.abs(wz) * hp, min=1e-12)
    den = torch.square(eta * im + om)
    pr = f * hp * 0.25 / torch.clamp(torch.abs(im), min=1e-12)
    pt = (1.0 - f) * hp * torch.abs(om) / torch.clamp(den, min=1e-12)
    put(ROUGH_DIEL, w_, torch.where(refl, pr, pt), ww[..., None] * one, 2,
        torch.where(refl, GLOSSY_R, GLOSSY_T),
        (hp >= 1e-10) & ((wz * w_[..., 2] > 0.0) == refl))

    # coat: a clear dielectric layer over a rough conductor
    ce = 1.0 / COAT_IOR
    fi, cti = fresnel_dielectric(ce, wz)
    sp = fi / (fi + 1.0 * (1.0 - fi))
    pick = u0 < sp
    wi_s = torch.stack([wi[..., 0] * ce, wi[..., 1] * ce, cti], -1)
    so, sd, ss, sv = _rough_cond_sample(m, wi_s, u1, u2)
    fo, cto = fresnel_dielectric(COAT_IOR, so[..., 2])
    wg = torch.stack([so[..., 0] * COAT_IOR, so[..., 1] * COAT_IOR, cto], -1)
    sg = ss * ((1.0 - fi) * (1.0 - fo))[..., None] \
        / torch.clamp(1.0 - sp, min=1e-12)[..., None]
    pg = sd * (1.0 - sp) * ce * ce * cto / torch.clamp(so[..., 2], min=1e-12)
    put(COAT, torch.where(pick[..., None], mirror(wi), wg),
        torch.where(pick, sp, pg),
        torch.where(pick[..., None],
                    (fi / torch.clamp(sp, min=1e-12))[..., None] * one, sg),
        torch.where(pick, 0, 1), torch.where(pick, SPECULAR_R, GLOSSY_R),
        up & (pick | (sv & (fo < 1.0))))

    s = s * torch.square(_eta_scale(m, wi, wo))[..., None]
    return wo, pdf, s, mode, lobe, valid


def _eta_scale(m: Mat, wi, wo):
    diel = (m.type & (DIEL | ROUGH_DIEL)) != 0
    same = wi[..., 2] * wo[..., 2] >= 0.0
    return torch.where(diel & ~same, _rel_eta(m, wi[..., 2]), 1.0)


def bsdf_eval(m: Mat, wi, wo):
    """-> (s, colour mode): f(wi, wo) |cos| = A * s."""
    n = wi.shape[0]
    s = torch.zeros_like(wi)
    mode = torch.zeros((n,), dtype=torch.int64, device=wi.device)
    t = m.type
    both = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0)
    one = torch.ones_like(wi)

    def put(bit, s_, md):
        nonlocal s, mode
        sel = (t & bit) != 0
        s = torch.where(sel[..., None], s_, s)
        mode = torch.where(sel, md, mode)

    lam = torch.where(both, INV_PI * wo[..., 2], 0.0)[..., None] * one
    put(DIFF, lam, 1)
    put(BURLEY, torch.where(both, INV_PI * _burley(m, wi, wo) * wo[..., 2],
                            0.0)[..., None] * one, 1)
    put(COND, torch.where(_refl_ok(wi, wo)[..., None],
                          fresnel_conductor(m.eta, m.k, wi[..., 2]), 0.0), 1)
    put(ROUGH_COND, _rough_cond_eval(m, wi, wo), 1)
    put(DIEL, _diel_value(m, wi, wo)[..., None] * one, 1)

    refl, eta, h = _rd_half(m, wi, wo)
    alpha = mf_alpha(m.dist, m.rough)
    im, om = torch.sum(wi * h, -1), torch.sum(wo * h, -1)
    f, _ = fresnel_dielectric(1.0 / m.eta[..., 0], im)
    gd = mf_G(m.dist, alpha, wi, wo, h) * mf_D(m.dist, alpha, h)
    wz = wi[..., 2]
    fr = f * gd * 0.25 / torch.clamp(torch.abs(wz), min=1e-12)
    den = torch.square(eta * im + om)
    ft = (torch.abs(im * om) * (1.0 - f) * gd
          / torch.clamp(den * torch.abs(wz), min=1e-12))
    put(ROUGH_DIEL, torch.where(refl, fr, ft)[..., None] * one, 1)

    ce = 1.0 / COAT_IOR
    fi, fo, cto, wi_s, wo_s = _coat_dirs(wi, wo, ce)
    mirror_ok = _refl_ok(wi, wo)
    lap = ce * ce * wo[..., 2] / torch.clamp(cto, min=1e-12)
    glossy = (lap * (1.0 - fi) * (1.0 - fo))[..., None] \
        * _rough_cond_eval(m, wi_s, wo_s)
    coat = torch.where(mirror_ok[..., None], fi[..., None] * one, glossy)
    put(COAT, torch.where(both[..., None], coat, 0.0),
        torch.where(mirror_ok, 0, 1))
    return s * torch.square(_eta_scale(m, wi, wo))[..., None], mode


def bsdf_pdf(m: Mat, wi, wo):
    p = torch.zeros(wi.shape[:-1], dtype=wi.dtype, device=wi.device)
    t = m.type
    both = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0)
    lam = torch.where(both, torch.abs(wo[..., 2]) * INV_PI, 0.0)
    for bit, val in ((DIFF, lam), (BURLEY, lam),
                     (COND, _refl_ok(wi, wo).to(wi.dtype)),
                     (ROUGH_COND, _rough_cond_pdf(m, wi, wo)),
                     (DIEL, _diel_value(m, wi, wo))):
        p = torch.where((t & bit) != 0, val, p)

    refl, eta, h = _rd_half(m, wi, wo)
    salpha = mf_alpha(m.dist, _rd_sample_rough(m, wi[..., 2]))
    im, om = torch.sum(wi * h, -1), torch.sum(wo * h, -1)
    f, _ = fresnel_dielectric(1.0 / m.eta[..., 0], im)
    hp = mf_pdf(m.dist, salpha, h)
    pr = f * hp * 0.25 / torch.clamp(torch.abs(im), min=1e-12)
    pt = (1.0 - f) * hp * torch.abs(om) / torch.clamp(
        torch.square(eta * im + om), min=1e-12)
    p = torch.where((t & ROUGH_DIEL) != 0, torch.where(refl, pr, pt), p)

    ce = 1.0 / COAT_IOR
    fi, fo, cto, wi_s, wo_s = _coat_dirs(wi, wo, ce)
    sp = fi / (fi + 1.0 * (1.0 - fi))
    glossy = (_rough_cond_pdf(m, wi_s, wo_s) * (1.0 - sp) * ce * ce
              * torch.abs(wo[..., 2] / torch.clamp(cto, min=1e-12)))
    coat = torch.where(both, torch.where(_refl_ok(wi, wo), sp, glossy), 0.0)
    return torch.where((t & COAT) != 0, coat, p)


def nee_capable(m: Mat):
    return (m.lobes & ~(SPECULAR | FORWARD)) != 0


# ------------------------------------------------------------------ lights

def light_sample(sc: Scene, p, u1, u2):
    """Toward the first light: (direction, distance, solid-angle pdf,
    valid)."""
    j = sc.light
    if j < sc.n_spheres:
        c, r = sc.sph_c[j], sc.sph_r[j]
        ell = c - p
        d2 = torch.sum(ell * ell, -1)
        dd = torch.sqrt(torch.clamp(d2, min=1e-20))
        cc = d2 - r * r
        ldir = ell / dd[..., None]
        ctm = ssqrt(cc) / dd
        cap = polar(u1 * TWO_PI, u2 * (1.0 - ctm) + ctm)
        w = to_world(ldir, cap)
        b = dd * cap[..., 2]
        dist = b - ssqrt(b * b - cc)
        pdf = INV_TWO_PI / torch.clamp(1.0 - ctm, min=1e-12)
        return w, dist, pdf, cc > 0.0
    q = j - sc.n_spheres
    base, e0, e1 = sc.q_base[q], sc.q_e0[q], sc.q_e1[q]
    nrm, area = sc.q_n[q], sc.q_area[q]
    anchor = base - (e0 + e1) * 0.5
    front = torch.sum(nrm * (p - base), -1) > 0.0
    x = anchor + u1[..., None] * e0 + u2[..., None] * e1
    dv = x - p
    r2 = torch.sum(dv * dv, -1)
    dist = torch.sqrt(torch.clamp(r2, min=1e-20))
    dirn = dv / dist[..., None]
    cos = -torch.sum(nrm * dirn, -1)
    pdf = r2 / torch.clamp(cos * area, min=1e-12)
    return dirn, dist, pdf, front & (cos > 0.0)


def light_pdf(sc: Scene, p, d):
    """The first light's solid-angle pdf of direction d from p."""
    j = sc.light
    if j < sc.n_spheres:
        c, r = sc.sph_c[j], sc.sph_r[j]
        ell = c - p
        d2 = torch.sum(ell * ell, -1)
        dd = torch.sqrt(torch.clamp(d2, min=1e-20))
        ctm = ssqrt(d2 - r * r) / dd
        return INV_TWO_PI / torch.clamp(1.0 - ctm, min=1e-12)
    q = j - sc.n_spheres
    nrm = sc.q_n[q]
    nd = torch.sum(nrm * d, -1)
    t = (torch.sum(nrm * (sc.q_base[q] - p), -1)
         / torch.where(torch.abs(nd) < 1e-12, 1e-12, nd))
    return t * t / torch.clamp(torch.abs(nd) * sc.q_area[q], min=1e-12)


# --------------------------------------------------------------------- sky

def sky_uv(d):
    u = torch.atan2(d[..., 2], d[..., 0]) * INV_TWO_PI + 0.5
    v = torch.acos(torch.clamp(d[..., 1], -1.0, 1.0)) * INV_PI
    return u, v


def sky_radiance(env, d):
    """Bilinear lookup in the equirect map: u wraps, v clamps."""
    h, w = env.shape[0], env.shape[1]
    u, v = sky_uv(d)
    x, y = u * w - 0.5, v * h - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]
    x0i = torch.remainder(x0.to(torch.int64), w)
    x1i = torch.remainder(x0i + 1, w)
    y0i = torch.clamp(y0.to(torch.int64), 0, h - 1)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    flat = env.reshape(h * w, 3)
    c00, c10 = flat[y0i * w + x0i], flat[y0i * w + x1i]
    c01, c11 = flat[y1i * w + x0i], flat[y1i * w + x1i]
    return ((c00 * (1 - fx) + c10 * fx) * (1 - fy)
            + (c01 * (1 - fx) + c11 * fx) * fy)


def _sky_cell_pdf(sc: Scene, row, col, sin_t):
    h, w = sc.env_cond.shape
    cell = sc.env_weights[row, col] / sc.env_total
    return cell * h * w / torch.clamp(TWO_PI * PI * sin_t, min=1e-12)


def sky_pdf(sc: Scene, d):
    h, w = sc.env_cond.shape
    u, v = sky_uv(d)
    col = torch.clamp((u * w).to(torch.int64), 0, w - 1)
    row = torch.clamp((v * h).to(torch.int64), 0, h - 1)
    sin_t = torch.sqrt(torch.clamp(1.0 - d[..., 1] * d[..., 1], min=1e-12))
    return _sky_cell_pdf(sc, row, col, sin_t)


def sky_sample(sc: Scene, u1, u2):
    """Inverse-CDF sample of the sky's luminance: (direction, pdf)."""
    h, w = sc.env_cond.shape
    marg = sc.env_marg
    row = torch.clamp(torch.searchsorted(marg, u1.contiguous()), 0, h - 1)
    hi = marg[row]
    lo = torch.where(row > 0, marg[torch.clamp(row - 1, min=0)], 0.0)
    fv = torch.clamp((u1 - lo) / torch.clamp(hi - lo, min=1e-12), 0.0, 1.0)
    # the first column whose CDF reaches u2 (the last where none does)
    flat = sc.env_cond.reshape(-1)
    base = row * w
    a = torch.zeros_like(row)
    b = torch.full_like(row, w - 1)
    for _ in range(max(1, math.ceil(math.log2(max(w, 2))))):
        mid = torch.div(a + b, 2, rounding_mode="floor")
        below = flat[base + mid] < u2
        a, b = torch.where(below, mid + 1, a), torch.where(below, b, mid)
    col = torch.clamp(a, 0, w - 1)
    dhi = sc.env_cond[row, col]
    dlo = torch.where(col > 0, sc.env_cond[row, torch.clamp(col - 1, min=0)],
                      0.0)
    fu = torch.clamp((u2 - dlo) / torch.clamp(dhi - dlo, min=1e-12), 0.0, 1.0)
    theta = (row.to(u1.dtype) + fv) / h * PI
    phi = ((col.to(u1.dtype) + fu) / w - 0.5) * TWO_PI
    st = torch.sin(theta)
    d = torch.stack([torch.cos(phi) * st, torch.cos(theta),
                     torch.sin(phi) * st], -1)
    return d, _sky_cell_pdf(sc, row, col, st)


# -------------------------------------------------------------- integrator

def radiance(sc: Scene, cam: dict, width: int, height: int, pixel, sample,
             seed: int, leaves: dict | None = None):
    """One path per lane, lane i tracing sample ``sample[i]`` of pixel
    ``pixel[i]`` -> radiance [N,3].  ``leaves`` ("color" [K,3],
    "obj_color" [3], "env_map") replace the scene's and may require a
    gradient."""
    leaves = leaves or {}
    color = leaves.get("color", sc.color)
    obj_color = leaves.get("obj_color", sc.obj_color)
    env = leaves.get("env_map", sc.env_map) if sc.has_env else None
    dt = sc.dt
    rng = Stream(pixel, sample, seed)
    u = [rng.u(j).to(dt) for j in range(4)]
    o, d = camera_rays(cam, width, height, pixel % width, pixel // width, *u)
    n = o.shape[0]
    dev = o.device
    mask = torch.ones((n, 3), dtype=dt, device=dev)
    acc = torch.zeros((n, 3), dtype=dt, device=dev)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    prev_pdf = torch.ones((n,), dtype=dt, device=dev)
    prev_spec = torch.ones((n,), dtype=torch.bool, device=dev)
    prev_nee = torch.zeros((n,), dtype=torch.bool, device=dev)
    n_diff, n_spec, n_trans, n_total = (
        torch.zeros((n,), dtype=torch.int64, device=dev) for _ in range(4))
    light_sampling = sc.light_sampling and sc.n_lights > 0

    def add(acc, cond, factor, term):
        """acc + term * factor where cond; factor (geometry only) zeroed
        elsewhere first."""
        f = torch.where(cond[..., None], factor, 0.0)
        return acc + torch.where(cond[..., None], term * f, 0.0)

    for b in range(sc.max_bounces):
        if not bool(alive.any()):
            break
        dim = 8 + 16 * b
        h = closest(sc, o, d)
        m = Mat(sc, h.obj, color, obj_color)
        missed = alive & ~h.valid
        if env is not None:
            w_env = torch.where(prev_spec | ~prev_nee, 1.0,
                                power_heuristic(prev_pdf, sky_pdf(sc, d)))
            acc = add(acc, missed, w_env[..., None] * torch.ones_like(d),
                      mask * sky_radiance(env, d))
        is_light = alive & h.valid & ((m.type & LIGHT) != 0)
        if sc.n_lights:
            able = is_light & (h.obj == sc.light)
            w_mis = torch.where(prev_spec | ~prev_nee | ~able, 1.0,
                                power_heuristic(prev_pdf, light_pdf(sc, o, d)))
            if not sc.light_sampling:
                w_mis = torch.ones_like(w_mis)
            acc = add(acc, is_light, w_mis[..., None] * torch.ones_like(d),
                      mask * m.color)
        shade = alive & h.valid & ~is_light
        wi = to_local(h.normal, -d)
        capable = nee_capable(m)
        did_nee = torch.zeros_like(shade)
        u_l = [rng.u(dim + j).to(dt) for j in range(3)]
        if light_sampling:
            ld, ldist, lpdf, lok = light_sample(sc, h.pos, u_l[1], u_l[2])
            wo_l = to_local(h.normal, ld)
            fs, fmode = bsdf_eval(m, wi, wo_l)
            nonzero = torch.sum(fs * fs, -1) > 0.0
            pdf_safe = torch.where(lok, torch.clamp(lpdf, min=1e-12), 1.0)
            weight = (power_heuristic(lpdf, bsdf_pdf(m, wi, wo_l))
                      / pdf_safe)[..., None] * fs
            take = shade & capable & lok & nonzero
            take = take & unblocked(sc, h.pos, ld, ldist, take)
            acc = add(acc, take, weight, mask * color[sc.light]
                      * m.term(fmode, h.backside, h.t))
            did_nee = shade & capable
        k = 3
        if env is not None:
            ed, epdf = sky_sample(sc, rng.u(dim + 3).to(dt),
                                  rng.u(dim + 4).to(dt))
            wo_e = to_local(h.normal, ed)
            fs, fmode = bsdf_eval(m, wi, wo_e)
            nonzero = torch.sum(fs * fs, -1) > 0.0
            eok = shade & capable & (epdf > 1e-12)
            pdf_safe = torch.where(eok, torch.clamp(epdf, min=1e-12), 1.0)
            weight = (power_heuristic(epdf, bsdf_pdf(m, wi, wo_e))
                      / pdf_safe)[..., None] * fs
            take = eok & nonzero
            take = take & unblocked(sc, h.pos, ed,
                                    torch.full_like(epdf, RAY_INF), take)
            acc = add(acc, take, weight, mask * sky_radiance(env, ed)
                      * m.term(fmode, h.backside, h.t))
            did_nee = did_nee | (shade & capable)
            k = 5
        u0, u1, u2 = (rng.u(dim + k + j).to(dt) for j in range(3))
        wo, spdf, s, smode, lobe, svalid = bsdf_sample(m, wi, u0, u1, u2)
        s = torch.where(shade[..., None], s, 1.0)
        mask = mask * torch.where(shade[..., None],
                                  m.term(smode, h.backside, h.t), 1.0) * s
        o = torch.where(shade[..., None], h.pos, o)
        d = torch.where(shade[..., None], to_world(h.normal, wo), d)
        prev_pdf = torch.where(shade, spdf, prev_pdf)
        prev_spec = torch.where(shade, (lobe & SPECULAR) != 0, prev_spec)
        prev_nee = torch.where(shade, did_nee, prev_nee)
        n_diff = n_diff + (shade & ((lobe & (DIFFUSE_R | GLOSSY_R)) != 0))
        n_spec = n_spec + (shade & ((lobe & SPECULAR_R) != 0))
        n_trans = n_trans + (shade & ((lobe & TRANSMISSIVE) != 0))
        n_total = n_total + shade
        rp = torch.amax(mask, -1).detach()
        do_rr = (n_total > 2) & (rp < 0.1) & shade
        live = rng.u(dim + k + 3).to(dt) < rp
        mask = torch.where((do_rr & live)[..., None],
                           mask / torch.clamp(rp, min=1e-20)[..., None], mask)
        over = ((n_total >= sc.max_bounces) | (n_diff >= sc.max_diff)
                | (n_spec >= sc.max_spec) | (n_trans >= sc.max_trans))
        alive = (alive & ~missed & ~is_light & ~(shade & ~svalid)
                 & ~(do_rr & ~live) & ~over)
    return acc
