"""Scalar NumPy oracle renderer: the port's ground truth
(rt_tpu/render/oracle.py).

A deliberately independent, loop-based implementation of the renderer's
radiometric semantics (gpu-version/main.cu:17-70 and the per-primitive
hit functions). It scans the objects of the SceneDef in scene order, as
hittable_list::hit does (object.cuh:23-37), so it pins the tie-break the
vectorized engines must reproduce (a later object wins an exact tie).

Every random draw is the reference's counter-based stream at the same
(pixel, sample, bounce, purpose) coordinate, drawn here by NumPy twins
of rt_tpu's ops/rng.py and ops/qmc.py (the triple32 hash and the
Owen-scrambled Sobol' sampler, with their NumPy arithmetic: np.cbrt,
float32 scalars), so the oracle's image equals rt_tpu's oracle bit for
bit and every random decision matches the port's engines, whose frames
agree with it up to float association (images_close). The vector helpers
(reflect, refract, the affine transforms) are NumPy twins of
rt_tpu/ops/geometry.py for the same reason.

Slow (Python loops over pixels, samples and bounces): tiny frames only.
Imports neither torch's engines nor JAX: the scene's camera and, with
cfg.nee, the light table of scene/types.build_tables are read on the CPU.
"""

from __future__ import annotations

import numpy as np

from rt_tpu_torch.config import RenderConfig
from rt_tpu_torch.scene.types import SceneDef, _cylinder_o2w

# Draw purposes (rt_tpu/ops/rng.py:30-42; the port's ops/rng.py)
PIXEL_U = 1
PIXEL_V = 2
LENS_U1 = 3
LENS_U2 = 4
SCAT_U1 = 5
SCAT_U2 = 6
SCAT_U3 = 7
DIEL_REFL = 8
RR = 9
NEE_PICK = 11
NEE_U1 = 12
NEE_U2 = 13

_GOLD = 0x9E3779B9


# ---------------------------------------------------------------------------
# The triple32 stream (rt_tpu/ops/rng.py with xp=np)
# ---------------------------------------------------------------------------


def _u32(x):
    return np.asarray(x).astype(np.uint32)


def _triple32(x):
    with np.errstate(over="ignore"):
        x = _u32(x)
        x = x ^ (x >> 17)
        x = x * np.uint32(0xED5AD4BB)
        x = x ^ (x >> 11)
        x = x * np.uint32(0xAC4C1B51)
        x = x ^ (x >> 15)
        x = x * np.uint32(0x31848BAB)
        x = x ^ (x >> 14)
        return x


def _fold(state, word):
    state = _u32(state)
    word = _u32(word)
    with np.errstate(over="ignore"):
        mixed = state + word * np.uint32(_GOLD)
    return _triple32(mixed)


def _key(seed, pixel, sample, bounce, purpose):
    s = _fold(_u32(seed), pixel)
    s = _fold(s, sample)
    s = _fold(s, bounce)
    return _fold(s, purpose)


def _to_unit(bits):
    """The 24 high bits as a float32 in [0, 1)."""
    return (bits >> 8).astype(np.float32) * np.float32(1.0 / (1 << 24))


def _ball(u1, u2, u3):
    """The unit-ball map of rt_tpu's in_unit_ball (both samplers)."""
    r = np.cbrt(u1)
    cos_t = 1.0 - 2.0 * u2
    sin_t = np.sqrt(np.maximum(0.0, 1.0 - cos_t * cos_t))
    phi = 2.0 * np.pi * u3
    x = r * sin_t * np.cos(phi)
    y = r * sin_t * np.sin(phi)
    z = r * cos_t
    return np.stack([x, y, z], axis=-1).astype(np.float32)


def _disk(u1, u2):
    """The unit-disk map of rt_tpu's in_unit_disk (both samplers)."""
    r = np.sqrt(u1)
    phi = 2.0 * np.pi * u2
    return np.stack([r * np.cos(phi), r * np.sin(phi), np.zeros_like(r)],
                    axis=-1).astype(np.float32)


class _Rng:
    """The pseudo-random sampler (cfg.sampler "rng")."""

    @staticmethod
    def uniform(seed, pixel, sample, bounce, purpose):
        return _to_unit(_key(seed, pixel, sample, bounce, purpose))

    @classmethod
    def in_unit_ball(cls, seed, pixel, sample, bounce):
        return _ball(*(cls.uniform(seed, pixel, sample, bounce, p)
                       for p in (SCAT_U1, SCAT_U2, SCAT_U3)))

    @classmethod
    def in_unit_disk(cls, seed, pixel, sample, bounce):
        return _disk(*(cls.uniform(seed, pixel, sample, bounce, p)
                       for p in (LENS_U1, LENS_U2)))


# ---------------------------------------------------------------------------
# The Owen-scrambled Sobol' stream (rt_tpu/ops/qmc.py with xp=np)
# ---------------------------------------------------------------------------


def _reverse_bits(x):
    x = _u32(x)
    c = np.uint32
    x = ((x >> 1) & c(0x55555555)) | ((x & c(0x55555555)) << 1)
    x = ((x >> 2) & c(0x33333333)) | ((x & c(0x33333333)) << 2)
    x = ((x >> 4) & c(0x0F0F0F0F)) | ((x & c(0x0F0F0F0F)) << 4)
    x = ((x >> 8) & c(0x00FF00FF)) | ((x & c(0x00FF00FF)) << 8)
    return (x >> 16) | (x << 16)


def _lk(x, seed):
    with np.errstate(over="ignore"):
        x = _u32(x) + _u32(seed)
        x = x ^ (x * np.uint32(0x6C50B47C))
        x = x ^ (x * np.uint32(0xB82F1E52))
        x = x ^ (x * np.uint32(0xC7AFE638))
        x = x ^ (x * np.uint32(0x8D22F6E6))
        return x


def _nested_scramble(x, seed):
    return _reverse_bits(_lk(_reverse_bits(x), seed))


def _direction_vectors():
    """Sobol' dims 1 and 2 (Joe-Kuo initial values; dim 0 is the van der
    Corput bit reversal)."""
    dims = []
    m = [1]
    for i in range(1, 32):
        m.append((m[i - 1] << 1) ^ m[i - 1])
    dims.append(np.array([mi << (31 - i) for i, mi in enumerate(m)],
                         dtype=np.uint32))
    m = [1, 3]
    for i in range(2, 32):
        m.append((m[i - 1] << 1) ^ (m[i - 2] << 2) ^ m[i - 2])
    dims.append(np.array([mi << (31 - i) for i, mi in enumerate(m)],
                         dtype=np.uint32))
    return dims


_DIRS = _direction_vectors()


def _sobol_bits(idx, dim: int):
    idx = _u32(idx)
    if dim == 0:
        return _reverse_bits(idx)
    dirs = _DIRS[dim - 1]
    acc = np.zeros_like(idx)
    one = np.uint32(1)
    for i in range(32):
        acc = acc ^ (((idx >> np.uint32(i)) & one) * np.uint32(int(dirs[i])))
    return acc


# purpose -> (site, dim) (rt_tpu/ops/qmc.py `_SITE`)
_SITE = {
    PIXEL_U: (0, 0), PIXEL_V: (0, 1),
    LENS_U1: (1, 0), LENS_U2: (1, 1),
    SCAT_U1: (2, 0), SCAT_U2: (2, 1), SCAT_U3: (2, 2),
    DIEL_REFL: (3, 0),
    RR: (4, 0),
    NEE_PICK: (6, 0), NEE_U1: (6, 1), NEE_U2: (6, 2),
}
_QMC_TAG = 0x51D0B07
_SITE_BASE = 0x100


class _Qmc:
    """The Owen-scrambled Sobol' sampler (cfg.sampler "qmc")."""

    @staticmethod
    def uniform(seed, pixel, sample, bounce, purpose):
        purpose = int(purpose)
        if purpose not in _SITE:
            return _Rng.uniform(seed, pixel, sample, bounce, purpose)
        site, dim = _SITE[purpose]
        sk = _key(seed, pixel, _QMC_TAG, bounce, _SITE_BASE + site)
        shuf_seed, val_seed = _fold(sk, 1), _fold(sk, 2 + dim)
        idx = _nested_scramble(sample, shuf_seed)
        return _to_unit(_nested_scramble(_sobol_bits(idx, dim), val_seed))

    @classmethod
    def in_unit_ball(cls, seed, pixel, sample, bounce):
        return _ball(*(cls.uniform(seed, pixel, sample, bounce, p)
                       for p in (SCAT_U1, SCAT_U2, SCAT_U3)))

    @classmethod
    def in_unit_disk(cls, seed, pixel, sample, bounce):
        return _disk(*(cls.uniform(seed, pixel, sample, bounce, p)
                       for p in (LENS_U1, LENS_U2)))


def _sampler(name: str):
    if name == "qmc":
        return _Qmc
    if name != "rng":
        raise ValueError(f"unknown sampler {name!r} (want 'rng' or 'qmc')")
    return _Rng


# ---------------------------------------------------------------------------
# Vector helpers (rt_tpu/ops/geometry.py with xp=np)
# ---------------------------------------------------------------------------


def _dot(a, b):
    return np.sum(a * b, axis=-1)


def _reflect(v, n):
    return v - 2.0 * _dot(v, n)[..., None] * n


def _refract(uv, n, etai_over_etat):
    cos_theta = np.minimum(_dot(-uv, n), 1.0)
    r_out_perp = etai_over_etat[..., None] * (uv + cos_theta[..., None] * n)
    x = np.abs(1.0 - _dot(r_out_perp, r_out_perp))
    pos = x > 0.0
    par = np.where(pos, np.sqrt(np.where(pos, x, 1.0)), 0.0)
    return r_out_perp + (-par[..., None] * n)


def _apply_point(m, p):
    return np.einsum("...ij,...j->...i", m[..., :3, :3], p) + m[..., :3, 3]


def _apply_vec(m, v):
    return np.einsum("...ij,...j->...i", m[..., :3, :3], v)


def _apply_normal(minv, n):
    return np.einsum("...ji,...j->...i", minv[..., :3, :3], n)


def _unit(v):
    return v / np.linalg.norm(v)


# ---------------------------------------------------------------------------
# Hits, in scene order
# ---------------------------------------------------------------------------


def _hit_sphere(obj, ro, rd, t_min, t_max):
    center = np.asarray(obj["center"], np.float32)
    radius = np.float32(obj["radius"])
    oc = ro - center
    a = float(rd @ rd)
    hb = float(oc @ rd)
    c = float(oc @ oc) - radius * radius
    disc = hb * hb - a * c
    if disc < 0:
        return None
    sq = np.sqrt(disc)
    root = (-hb - sq) / a
    if root < t_min or t_max < root:
        root = (-hb + sq) / a
        if root < t_min or t_max < root:
            return None
    p = ro + root * rd
    outward = (p - center) / radius
    theta = np.arccos(np.clip(-outward[1], -1.0, 1.0))
    phi = np.arctan2(-outward[2], outward[0]) + np.pi
    return dict(t=root, p=p, outward=outward, u=phi / (2 * np.pi),
                v=theta / np.pi, mat=obj["material"])


_RECT_AXES = {"xy_rect": (2, 0, 1, "x0", "x1", "y0", "y1"),
              "xz_rect": (1, 0, 2, "x0", "x1", "z0", "z1"),
              "yz_rect": (0, 1, 2, "y0", "y1", "z0", "z1")}


def _hit_rect(obj, ro, rd, t_min, t_max):
    ka, f1, f2, a0k, a1k, b0k, b1k = _RECT_AXES[obj["type"]]
    if rd[ka] == 0.0:
        return None
    t = (obj["k"] - ro[ka]) / rd[ka]
    if t < t_min or t > t_max:
        return None
    x = ro[f1] + t * rd[f1]
    y = ro[f2] + t * rd[f2]
    if x < obj[a0k] or x > obj[a1k] or y < obj[b0k] or y > obj[b1k]:
        return None
    outward = np.zeros(3, np.float32)
    outward[ka] = 1.0
    return dict(t=t, p=ro + t * rd, outward=outward,
                u=(x - obj[a0k]) / (obj[a1k] - obj[a0k]),
                v=(y - obj[b0k]) / (obj[b1k] - obj[b0k]),
                mat=obj["material"])


def _hit_cylinder(obj, ro, rd, t_min, t_max):
    o2w, w2o = _cylinder_o2w(obj)
    oo = _apply_point(w2o, ro)
    od = _apply_vec(w2o, rd)
    radius, zmin, zmax = obj["radius"], obj["zmin"], obj["zmax"]
    a = od[0] * od[0] + od[1] * od[1]
    b = 2 * (od[0] * oo[0] + od[1] * oo[1])
    c = oo[0] * oo[0] + oo[1] * oo[1] - radius * radius
    if a == 0.0:
        return None
    delta = b * b - 4 * a * c
    if delta < 0:
        return None
    sq = np.sqrt(delta)
    t0 = -0.5 * (b - sq) / a
    t1 = -0.5 * (b + sq) / a
    t0, t1 = min(t0, t1), max(t0, t1)
    if t0 > t_max or t1 < t_min:
        return None
    t = t0
    if t0 < t_min:
        t = t1
        if t > t_max:
            return None
    op = oo + t * od
    if op[2] < zmin or op[2] > zmax:
        if t == t1:
            return None
        t = t1
        if t > t_max or t < t_min:
            return None
        op = oo + t * od
        if op[2] < zmin or op[2] > zmax:
            return None
    on = _unit(np.array([op[0], op[1], 0.0], np.float32))
    p = _apply_point(o2w, op)
    outward = _apply_normal(w2o, on)
    phi = np.arctan2(op[1], op[0]) + 2 * np.pi
    return dict(t=t, p=p, outward=outward, u=phi / (4 * np.pi),
                v=(op[2] - zmin) / (zmax - zmin), mat=obj["material"])


def _hit_triangle(obj, ro, rd, t_min, t_max):
    v1 = np.asarray(obj["v1"], np.float32)
    v2 = np.asarray(obj["v2"], np.float32)
    v3 = np.asarray(obj["v3"], np.float32)
    n = _unit(np.cross(v2 - v1, v3 - v1)).astype(np.float32)
    stored_n = n.copy()
    oc = ro - v1
    if oc @ n < 0:
        n = -n
    a = np.linalg.norm(rd)
    theta = (rd @ n) / a
    if theta >= 0:
        return None
    root = -(oc @ n) / theta / a
    if root < t_min or root > t_max:
        return None
    r = ro + root * rd
    s1 = np.cross(v2 - v1, r - v1) @ n
    s2 = np.cross(v3 - v2, r - v2) @ n
    s3 = np.cross(v1 - v3, r - v3) @ n
    if not ((s1 > 0 and s2 > 0 and s3 > 0) or (s1 < 0 and s2 < 0 and s3 < 0)):
        return None
    area2 = np.linalg.norm(np.cross(v2 - v1, v3 - v1))
    l1 = np.linalg.norm(np.cross(v2 - r, v3 - r)) / area2
    l2 = np.linalg.norm(np.cross(v3 - r, v1 - r)) / area2
    l3 = max(0.0, 1.0 - l1 - l2)
    uv1 = np.asarray(obj.get("uv1", (0, 0)), np.float32)
    uv2 = np.asarray(obj.get("uv2", (0, 0)), np.float32)
    uv3 = np.asarray(obj.get("uv3", (0, 0)), np.float32)
    uv = uv1 * l1 + uv2 * l2 + uv3 * l3
    return dict(t=root, p=r, outward=stored_n, u=uv[0], v=uv[1],
                mat=obj["material"])


_HITTERS = {"sphere": _hit_sphere, "xy_rect": _hit_rect, "xz_rect": _hit_rect,
            "yz_rect": _hit_rect, "cylinder": _hit_cylinder,
            "triangle": _hit_triangle}


def _scene_hit(sdef: SceneDef, ro, rd, t_min=1e-3):
    """Sequential closest-hit scan in object order (object.cuh:23-37):
    acceptance uses t <= closest, so a later object wins exact ties."""
    closest = np.inf
    best = None
    for obj in sdef.objects:
        rec = _HITTERS[obj["type"]](obj, ro, rd, t_min, closest)
        if rec is not None:
            closest = rec["t"]
            best = rec
    if best is not None:
        front = (rd @ best["outward"]) < 0
        best["front_face"] = front
        best["normal"] = best["outward"] if front else -best["outward"]
    return best


def _texture_value(sdef: SceneDef, tex_id, u, v, p):
    t = sdef.textures[tex_id]
    if t["type"] == "solid_color":
        return np.asarray(t["color"], np.float32)
    if t["type"] == "checker":
        sines = np.sin(10 * p[0]) * np.sin(10 * p[1]) * np.sin(10 * p[2])
        return np.asarray(t["odd"] if sines < 0 else t["even"], np.float32)
    if t["type"] == "image":
        img = sdef.images[t["image"]]
        th, tw = img.shape[:2]
        xi = min(int((u - np.floor(u)) * th), th - 1)
        yi = min(int((v - np.floor(v)) * tw), tw - 1)
        return img[xi, yi].astype(np.float32)
    raise ValueError(t["type"])


def _background(sdef: SceneDef, cfg: RenderConfig, d):
    if cfg.background_mode == "gradient":
        unit = _unit(d)
        t = 0.5 * (unit[1] + 1.0)
        return ((1 - t) * np.ones(3) + t * np.array([0.5, 0.7, 1.0])
                ).astype(np.float32)
    return np.asarray(sdef.background, np.float32)


def _host(x):
    """A table row of build_tables (a CPU tensor) as a NumPy array."""
    return x.numpy() if hasattr(x, "numpy") else np.asarray(x)


def _oracle_nee(sdef: SceneDef, tables, cfg: RenderConfig, rec, atten,
                pixel, sample, bounce, seed):
    """Scalar twin of integrator._nee_direct: area-sample one light (the
    same draws, the same (2/pi) cos^3 weighting), occlusion through the
    oracle's own sequential hit scan."""
    smp = _sampler(cfg.sampler)
    L = tables.n_lights
    u_pick = float(smp.uniform(seed, pixel, sample, bounce, NEE_PICK))
    li = min(int(u_pick * L), L - 1)
    fam = int(tables.light_fam[li])
    pid = int(tables.light_pid[li])
    u1 = float(smp.uniform(seed, pixel, sample, bounce, NEE_U1))
    u2 = float(smp.uniform(seed, pixel, sample, bounce, NEE_U2))
    phi = 2.0 * np.pi * u2
    # UV of the sampled point, per family's hit-UV convention (so image
    # and checker emission evaluate where the shadow ray lands)
    uv = (0.0, 0.0)
    if fam == 0:
        c = np.asarray(_host(tables.sph_center[pid]), np.float32)
        r = abs(float(tables.sph_radius[pid]))
        z = 1.0 - 2.0 * u1
        st = np.sqrt(max(0.0, 1.0 - z * z))
        n_l = np.array([st * np.cos(phi), st * np.sin(phi), z],
                       np.float32)
        point = c + np.float32(r) * n_l
        area = 4.0 * np.pi * r * r
        mat_id = int(tables.sph_mat[pid])
        s_phi = (np.arctan2(-n_l[2], n_l[0] if (n_l[0] or n_l[2]) else 1.0)
                 + np.pi)
        uv = (s_phi / (2 * np.pi),
              np.arccos(np.clip(-n_l[1], -1.0, 1.0)) / np.pi)
    elif fam == 1:
        ax = int(tables.rect_axis[pid])
        lo = _host(tables.rect_lo[pid])
        hi = _host(tables.rect_hi[pid])
        k = float(tables.rect_k[pid])
        f1 = 1 if ax == 0 else 0
        f2 = 1 if ax == 2 else 2
        point = np.zeros(3, np.float32)
        point[ax] = k
        point[f1] = lo[0] + u1 * (hi[0] - lo[0])
        point[f2] = lo[1] + u2 * (hi[1] - lo[1])
        n_l = np.zeros(3, np.float32)
        n_l[ax] = 1.0
        area = float((hi[0] - lo[0]) * (hi[1] - lo[1]))
        mat_id = int(tables.rect_mat[pid])
        uv = (u1, u2)
    elif fam == 2:
        r = abs(float(tables.cyl_radius[pid]))
        zmin = float(tables.cyl_zmin[pid])
        zmax = float(tables.cyl_zmax[pid])
        o2w = np.asarray(_host(tables.cyl_o2w[pid]), np.float32)
        zc = zmin + u1 * (zmax - zmin)
        po = np.array([r * np.cos(phi), r * np.sin(phi), zc], np.float32)
        point = (o2w[:3, :3] @ po + o2w[:3, 3]).astype(np.float32)
        n_l = (o2w[:3, :3]
               @ np.array([np.cos(phi), np.sin(phi), 0], np.float32))
        area = 2.0 * np.pi * r * (zmax - zmin)
        mat_id = int(tables.cyl_mat[pid])
        uv = ((np.arctan2(np.sin(phi), np.cos(phi)) + 2 * np.pi)
              / (4 * np.pi), u1)
    else:
        # triangle: uniform barycentric through the sqrt warp (the
        # integrator._nee_direct twin, the same b2 / b3 convention)
        v1 = np.asarray(_host(tables.tri_v1[pid]), np.float32)
        e1 = np.asarray(_host(tables.tri_v2[pid]), np.float32) - v1
        e2 = np.asarray(_host(tables.tri_v3[pid]), np.float32) - v1
        sq = np.sqrt(np.float32(u1))
        b2 = sq * (1.0 - np.float32(u2))
        b3 = sq * np.float32(u2)
        point = (v1 + b2 * e1 + b3 * e2).astype(np.float32)
        n_l = np.asarray(_host(tables.tri_n[pid]), np.float32)
        cr_ = np.cross(e1, e2)
        area = 0.5 * float(np.sqrt(cr_ @ cr_))
        mat_id = int(tables.tri_mat[pid])
        b1 = 1.0 - sq
        uvt = (b1 * _host(tables.tri_uv1[pid])
               + b2 * _host(tables.tri_uv2[pid])
               + b3 * _host(tables.tri_uv3[pid]))
        uv = (float(uvt[0]), float(uvt[1]))

    wi = point - rec["p"]
    d2 = max(float(wi @ wi), 1e-8)
    dist = np.sqrt(d2)
    cos_s = float(rec["normal"] @ wi) / dist
    if cos_s <= 0.0:
        return np.zeros(3, np.float32)
    cos_l = abs(float(n_l @ wi)) / dist
    srec = _scene_hit(sdef, rec["p"], wi)
    if srec is not None and srec["t"] < 1.0 - 1e-3:
        return np.zeros(3, np.float32)
    lmat = sdef.materials[mat_id]
    le = _texture_value(sdef, lmat["texture"], uv[0], uv[1], point)
    w = (cos_s ** 3 * cos_l / d2) * area * (2.0 * L / np.pi)
    return (atten * le * np.float32(w)).astype(np.float32)


def _ray_color(sdef: SceneDef, cfg: RenderConfig, ro, rd, pixel, sample,
               seed, nee_tables=None):
    smp = _sampler(cfg.sampler)
    tp = np.ones(3, np.float32)
    rgb = np.zeros(3, np.float32)
    prev_diff = False
    for bounce in range(cfg.max_depth):
        if cfg.p_rr > 0.0:
            u_rr = float(smp.uniform(seed, pixel, sample, bounce, RR))
            if u_rr > cfg.p_rr:
                return rgb
        rec = _scene_hit(sdef, ro, rd)
        if rec is None:
            return rgb + tp * _background(sdef, cfg, rd)
        mat = sdef.materials[rec["mat"]]
        em = np.zeros(3, np.float32)
        if mat["type"] == "diffuse_light":
            if nee_tables is not None and prev_diff:
                return rgb  # already counted by that bounce's light sample
            em = _texture_value(sdef, mat["texture"], rec["u"], rec["v"],
                                rec["p"])
            return rgb + tp * em

        ball = np.asarray(smp.in_unit_ball(seed, np.uint32(pixel),
                                           np.uint32(sample),
                                           np.uint32(bounce)))
        n = rec["normal"]
        if mat["type"] == "lambertian":
            d = n + ball
            if np.all(np.abs(d) < 1e-8):
                d = n
            atten = _texture_value(sdef, mat["texture"], rec["u"], rec["v"],
                                   rec["p"])
        elif mat["type"] == "metal":
            d = _reflect(_unit(rd), n) + min(mat["fuzz"], 1.0) * ball
            if d @ n <= 0:
                return rgb  # absorbed (scatter false, emitted zero)
            atten = np.asarray(mat["albedo"], np.float32)
        elif mat["type"] == "dielectric":
            ir = mat["index_of_refraction"]
            ratio = (1.0 / ir) if rec["front_face"] else ir
            ud = _unit(rd)
            cos_t = min(-(ud @ n), 1.0)
            sin_t = np.sqrt(max(0.0, 1 - cos_t * cos_t))
            refl_u = float(smp.uniform(seed, pixel, sample, bounce,
                                       DIEL_REFL))
            r0 = ((1 - ratio) / (1 + ratio)) ** 2
            schlick = r0 + (1 - r0) * (1 - cos_t) ** 5
            if ratio * sin_t > 1.0 or schlick > refl_u:
                d = _reflect(ud, n)
            else:
                d = _refract(ud[None], n[None],
                             np.asarray([ratio], np.float32))[0]
            atten = np.ones(3, np.float32)
        else:
            raise ValueError(mat["type"])

        rgb = rgb + tp * em
        if nee_tables is not None and mat["type"] == "lambertian":
            rgb = rgb + tp * _oracle_nee(sdef, nee_tables, cfg, rec,
                                         atten, pixel, sample, bounce,
                                         seed)
            prev_diff = True
        else:
            prev_diff = False
        tp = tp * atten
        if cfg.p_rr > 0.0:
            tp = tp / cfg.p_rr
        ro, rd = rec["p"], d
    if cfg.exhaust_mode == "background":
        rgb = rgb + tp * _background(sdef, cfg, rd)
    return rgb


def render_oracle(sdef: SceneDef, cfg: RenderConfig) -> np.ndarray:
    """Full-frame scalar render: the raw radiance sums [H,W,3] as a NumPy
    array, row 0 the bottom scanline (render.renderer.render's layout).
    cfg.nee runs the scalar NEE twin (the light index from
    scene/types.build_tables on the CPU, occlusion through the oracle's
    own hit scan); cfg.sampler picks the draws ("rng" or "qmc")."""
    nee_tables = None
    if bool(getattr(cfg, "nee", False)):
        from rt_tpu_torch.scene.types import build_tables

        t = build_tables(sdef, device="cpu")
        if t.n_lights > 0:
            nee_tables = t
    smp = _sampler(cfg.sampler)
    cam = sdef.camera
    origin, lower_left, horizontal, vertical, cam_u, cam_v = (
        _host(x) for x in (cam.origin, cam.lower_left, cam.horizontal,
                           cam.vertical, cam.u, cam.v))
    out = np.zeros((cfg.height, cfg.width, 3), np.float32)
    for y in range(cfg.height):
        for x in range(cfg.width):
            pixel = np.uint32(y * cfg.width + x)
            acc = np.zeros(3, np.float32)
            for s in range(cfg.samples_per_pixel):
                s32 = np.uint32(s)
                ru = float(smp.uniform(cfg.seed, pixel, s32, 0, PIXEL_U))
                rv = float(smp.uniform(cfg.seed, pixel, s32, 0, PIXEL_V))
                u = (x + ru) / (cfg.width - 1)
                v = (y + rv) / (cfg.height - 1)
                if cfg.enable_defocus:
                    disk = np.asarray(smp.in_unit_disk(cfg.seed, pixel, s32,
                                                       0))
                    rd_lens = float(cam.lens_radius) * disk
                    offset = cam_u * rd_lens[0] + cam_v * rd_lens[1]
                else:
                    offset = np.zeros(3, np.float32)
                ro = origin + offset
                rd = (lower_left + u * horizontal + v * vertical - origin
                      - offset).astype(np.float32)
                acc += _ray_color(sdef, cfg, ro.astype(np.float32), rd,
                                  pixel, s32, np.uint32(cfg.seed),
                                  nee_tables=nee_tables)
            out[y, x] = acc
    return out
