"""Plain PyTorch versions of the megakernels' per-lane math: the
unit-ball twin of csrc/rng.cuh (its uniform draw is ops/rng.uniform's
stream) and `do_bounce_plain`, the twin of csrc/bounce.cuh
(rt_tpu/ops/pallas_mega.py `_uniform` / `_unit_ball` :618-696,
`_make_background` :774, `do_bounce` :1011-1896 restricted to spheres,
solid / checker textures, no NEE, sampler "rng").

The ray state is the reference's 13 words per lane, held as one
[13, B] float32 tensor (rows `O`..`ALIVE` below): origin, direction,
throughput, accumulated radiance, alive (a float, 1.0 / 0.0, so NEE's
0.5 and 2 + p encodings fit later). Every expression is the
reference's, in the reference's order; the kernel repeats them.

`bounce_plain` returns the bounce with the intermediates its adjoint
reads (ops/adjoint_plain.py): the replay runs the forward's own
expressions, so C_after, the attenuation and P are the forward's bits.

Every operation is elementwise, so a lane's result does not depend on
the batch it sits in: the segmented trace and the queue emulation give
a single full-batch trace's bits (tests/test_torch_mega.py,
test_torch_queue.py). On the card, torch's float32 sin, cos, exp and log
are the libdevice functions the kernel calls.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from rt_tpu_torch.ops import rng
from rt_tpu_torch.ops.mega_tables import (
    S_C2R,
    S_VALID,
    X_ALB,
    X_ALB2,
    X_CHECKER,
    X_DIRECT,
    X_MTYPE,
    X_PARAM,
    X_SLOT,
    X_V,
)
from rt_tpu_torch.scene.types import (
    MAT_DIELECTRIC,
    MAT_DIFFUSE_LIGHT,
    MAT_LAMBERTIAN,
    MAT_METAL,
)

# rows of the [13, B] state
O, D, TP, C, ALIVE = 0, 3, 6, 9, 12
NSTATE = 13

INF = float("inf")
# lanes per [B, N] block of the closest-hit pass: bounds its temporaries
# to a few hundred MB at N = 512 whatever the batch
HIT_CHUNK = 1 << 16


def unit_ball(seed, pixel, sample, bounce):
    """The megakernel's unit-ball draw (pallas_mega._unit_ball): radius
    exp(log(u1)/3), not the wavefront's pow(u1, 1/3)."""
    u1 = rng.uniform(seed, pixel, sample, bounce, rng.SCAT_U1)
    u2 = rng.uniform(seed, pixel, sample, bounce, rng.SCAT_U2)
    u3 = rng.uniform(seed, pixel, sample, bounce, rng.SCAT_U3)
    r = torch.where(u1 > 0.0,
                    torch.exp(torch.log(torch.clamp(u1, min=1e-38))
                              * (1.0 / 3.0)),
                    0.0)
    cos_t = 1.0 - 2.0 * u2
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = (2.0 * math.pi) * u3
    return (r * sin_t * torch.cos(phi), r * sin_t * torch.sin(phi),
            r * cos_t)


def background(bg, grad_bg: bool, dx, dy, dz):
    """The sky seen along (dx, dy, dz) (pallas_mega._make_background):
    the constant colour bg (3 floats), or the white-to-blue gradient."""
    if not grad_bg:
        return tuple(torch.full_like(dx, v) for v in bg)
    inv = torch.rsqrt(dx * dx + dy * dy + dz * dz)
    t = 0.5 * (dy * inv + 1.0)
    return ((1.0 - t) + t * 0.5, (1.0 - t) + t * 0.7, torch.ones_like(t))


def fresh_state(ro, rd):
    """[13, B] state of new camera rays (pallas_mega._fresh_state)."""
    b = ro.shape[0]
    st = torch.empty((NSTATE, b), dtype=torch.float32, device=ro.device)
    st[O:O + 3] = ro.T
    st[D:D + 3] = rd.T
    st[TP:TP + 3] = 1.0
    st[C:C + 3] = 0.0
    st[ALIVE] = 1.0
    return st


def closest_hit(tab, ox, oy, oz, dx, dy, dz, t_min):
    """(t_best, row) per lane: the sphere pass of do_bounce
    (`_sph_chunk_math` :1067-1097 without MXU or culling). Equal t goes
    to the larger row; a lane that hits nothing reports t = inf."""
    a = dx * dx + dy * dy + dz * dz
    rd_dot_ro = dx * ox + dy * oy + dz * oz
    ro_sq = ox * ox + oy * oy + oz * oz
    inv_a = 1.0 / a
    cx, cy, cz = (tab[None, :, X_V + k] for k in range(3))
    c2r, valid = tab[None, :, S_C2R], tab[None, :, S_VALID]
    n = tab.shape[0]
    t_parts, row_parts = [], []
    for s in range(0, ox.shape[0], HIT_CHUNK):
        sl = slice(s, s + HIT_CHUNK)
        lox, loy, loz = ox[sl, None], oy[sl, None], oz[sl, None]
        ldx, ldy, ldz = dx[sl, None], dy[sl, None], dz[sl, None]
        hb = rd_dot_ro[sl, None] - (cx * ldx + cy * ldy + cz * ldz)
        c_term = (ro_sq[sl, None] - 2.0 * (cx * lox + cy * loy + cz * loz)
                  + c2r)
        disc = hb * hb - a[sl, None] * c_term
        sqrtd = torch.sqrt(torch.clamp(disc, min=0.0))
        root1 = (-hb - sqrtd) * inv_a[sl, None]
        root2 = (-hb + sqrtd) * inv_a[sl, None]
        t = torch.where(root1 >= t_min, root1,
                        torch.where(root2 >= t_min, root2, INF))
        t = torch.where((disc >= 0.0) & (valid > 0.0), t, INF)
        row = (n - 1) - torch.argmin(t.flip(-1), dim=-1)  # ties: larger
        t_parts.append(torch.gather(t, 1, row[:, None])[:, 0])
        row_parts.append(row)
    if not t_parts:
        return ox.new_empty(0), torch.empty(0, dtype=torch.long,
                                            device=ox.device)
    return torch.cat(t_parts), torch.cat(row_parts)


class Bounce(NamedTuple):
    """One bounce's new state and what its adjoint reads
    (ops/adjoint_plain.py): the lane masks, the attenuation, the
    winner's gradient slot and checker parity, and the throughput P
    before the bounce (the radiance after it is state[C:C+3])."""

    state: torch.Tensor      # [13, B] after the bounce
    scattered: torch.Tensor  # [B] bool
    emitter: torch.Tensor    # [B] bool: a light was hit
    missed: torch.Tensor     # [B] bool: the sky was hit
    is_die: torch.Tensor     # [B] bool: the winner is a dielectric
    use2: torch.Tensor       # [B] bool: checker odd parity (albedo2)
    slot: torch.Tensor       # [B] int64 gradient slot of the winner
    att: tuple               # 3 x [B] attenuation (1 for a dielectric)
    tp: tuple                # 3 x [B] throughput before the bounce


def do_bounce_plain(tab, state, pixel, sample, bounce, seed, *, t_min,
                    p_rr, grad_bg, bg):
    """Advance every lane of `state` [13, B] one bounce; returns the new
    [13, B] state. Lanes whose alive word is 0 come out unchanged.

    tab: the packed sphere table (ops/mega_tables.sphere_table).
    pixel, sample, bounce: per-lane RNG coordinates ([B] integer tensors
    or ints); seed an int. bg: the constant sky colour, 3 floats."""
    return bounce_plain(tab, state, pixel, sample, bounce, seed,
                        t_min=t_min, p_rr=p_rr, grad_bg=grad_bg,
                        bg=bg).state


def bounce_plain(tab, state, pixel, sample, bounce, seed, *, t_min, p_rr,
                 grad_bg, bg) -> Bounce:
    """do_bounce_plain with the intermediates its adjoint reads."""
    ox, oy, oz, dx, dy, dz, tpr, tpg, tpb, cr, cg, cb, alive = state.unbind(0)

    live = alive > 0.0
    if p_rr > 0.0:
        u_rr = rng.uniform(seed, pixel, sample, bounce, rng.RR)
        live = live & (u_rr <= p_rr)

    a = dx * dx + dy * dy + dz * dz
    t_best, row = closest_hit(tab, ox, oy, oz, dx, dy, dz, t_min)
    attrs = tab[row]
    v0, v1_, v2, v3 = (attrs[:, X_V + k] for k in range(4))
    direct = attrs[:, X_DIRECT] > 0.0
    w_mtype = attrs[:, X_MTYPE]
    w_checker = attrs[:, X_CHECKER]
    w_param = attrs[:, X_PARAM]
    w_ar, w_ag, w_ab = (attrs[:, X_ALB + k] for k in range(3))
    w_a2r, w_a2g, w_a2b = (attrs[:, X_ALB2 + k] for k in range(3))

    hit = torch.isfinite(t_best)
    t_safe = torch.where(hit, t_best, 1.0)
    px_ = ox + t_safe * dx
    py_ = oy + t_safe * dy
    pz_ = oz + t_safe * dz

    # outward normal (p - center) / radius; a negative radius flips it
    inv_rad = 1.0 / torch.where(v3 == 0.0, 1.0, v3)
    nx = torch.where(direct, v0, (px_ - v0) * inv_rad)
    ny2 = torch.where(direct, v1_, (py_ - v1_) * inv_rad)
    nz = torch.where(direct, v2, (pz_ - v2) * inv_rad)

    # set_face_normal (hittable.cuh:16-23)
    d_dot_n = dx * nx + dy * ny2 + dz * nz
    front = d_dot_n < 0.0
    sgn = torch.where(front, 1.0, -1.0)
    nx, ny2, nz = nx * sgn, ny2 * sgn, nz * sgn

    # checker texture (texture.cuh:44-52)
    sines = (torch.sin(10.0 * px_) * torch.sin(10.0 * py_)
             * torch.sin(10.0 * pz_))
    use2 = (w_checker > 0.0) & (sines < 0.0)
    alb_r = torch.where(use2, w_a2r, w_ar)
    alb_g = torch.where(use2, w_a2g, w_ag)
    alb_b = torch.where(use2, w_a2b, w_ab)

    is_lam = w_mtype == MAT_LAMBERTIAN
    is_met = w_mtype == MAT_METAL
    is_die = w_mtype == MAT_DIELECTRIC
    is_light = w_mtype == MAT_DIFFUSE_LIGHT

    # ---- scatter ----
    bx, by, bz = unit_ball(seed, pixel, sample, bounce)

    lam_x = nx + bx
    lam_y = ny2 + by
    lam_z = nz + bz
    degen = ((torch.abs(lam_x) < 1e-8) & (torch.abs(lam_y) < 1e-8)
             & (torch.abs(lam_z) < 1e-8))
    lam_x = torch.where(degen, nx, lam_x)
    lam_y = torch.where(degen, ny2, lam_y)
    lam_z = torch.where(degen, nz, lam_z)

    inv_len = torch.rsqrt(a)
    ux, uy, uz = dx * inv_len, dy * inv_len, dz * inv_len
    u_dot_n = ux * nx + uy * ny2 + uz * nz
    ref_x = ux - 2.0 * u_dot_n * nx
    ref_y = uy - 2.0 * u_dot_n * ny2
    ref_z = uz - 2.0 * u_dot_n * nz
    fuzz = w_param
    met_x = ref_x + fuzz * bx
    met_y = ref_y + fuzz * by
    met_z = ref_z + fuzz * bz
    met_ok = (met_x * nx + met_y * ny2 + met_z * nz) > 0.0

    ior = w_param
    ratio = torch.where(front, 1.0 / torch.where(ior == 0.0, 1.0, ior), ior)
    cos_theta = torch.clamp(-u_dot_n, max=1.0)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    cannot = ratio * sin_theta > 1.0
    r0 = (1.0 - ratio) / (1.0 + ratio)
    r0 = r0 * r0
    one_mc = 1.0 - cos_theta
    om2 = one_mc * one_mc
    schlick = r0 + (1.0 - r0) * om2 * om2 * one_mc
    u_refl = rng.uniform(seed, pixel, sample, bounce, rng.DIEL_REFL)
    choose_ref = cannot | (schlick > u_refl)
    # refract (vec3.cuh:125-131)
    rp_x = ratio * (ux + cos_theta * nx)
    rp_y = ratio * (uy + cos_theta * ny2)
    rp_z = ratio * (uz + cos_theta * nz)
    rp_l2 = rp_x * rp_x + rp_y * rp_y + rp_z * rp_z
    par = -torch.sqrt(torch.abs(1.0 - rp_l2))
    fr_x = rp_x + par * nx
    fr_y = rp_y + par * ny2
    fr_z = rp_z + par * nz
    die_x = torch.where(choose_ref, ref_x, fr_x)
    die_y = torch.where(choose_ref, ref_y, fr_y)
    die_z = torch.where(choose_ref, ref_z, fr_z)

    new_dx = torch.where(is_lam, lam_x, torch.where(is_met, met_x, die_x))
    new_dy = torch.where(is_lam, lam_y, torch.where(is_met, met_y, die_y))
    new_dz = torch.where(is_lam, lam_z, torch.where(is_met, met_z, die_z))
    att_r = torch.where(is_die, 1.0, alb_r)
    att_g = torch.where(is_die, 1.0, alb_g)
    att_b = torch.where(is_die, 1.0, alb_b)
    sc_ok = (is_met & met_ok) | (~is_met & ~is_light)

    bgr, bgg, bgb = background(bg, grad_bg, dx, dy, dz)

    scattered = live & hit & sc_ok
    emitter = live & hit & ~sc_ok & is_light
    missed = live & ~hit

    em_scale = torch.where(is_light & (scattered | emitter), 1.0, 0.0)
    cr = cr + tpr * (em_scale * alb_r + torch.where(missed, bgr, 0.0))
    cg = cg + tpg * (em_scale * alb_g + torch.where(missed, bgg, 0.0))
    cb = cb + tpb * (em_scale * alb_b + torch.where(missed, bgb, 0.0))

    comp = 1.0 / p_rr if p_rr > 0.0 else 1.0
    tp_before = (tpr, tpg, tpb)
    tpr = torch.where(scattered, tpr * att_r * comp, tpr)
    tpg = torch.where(scattered, tpg * att_g * comp, tpg)
    tpb = torch.where(scattered, tpb * att_b * comp, tpb)
    ox = torch.where(scattered, px_, ox)
    oy = torch.where(scattered, py_, oy)
    oz = torch.where(scattered, pz_, oz)
    dx = torch.where(scattered, new_dx, dx)
    dy = torch.where(scattered, new_dy, dy)
    dz = torch.where(scattered, new_dz, dz)
    alive = scattered.to(torch.float32)
    out = torch.stack([ox, oy, oz, dx, dy, dz, tpr, tpg, tpb, cr, cg, cb,
                       alive])
    return Bounce(state=out, scattered=scattered, emitter=emitter,
                  missed=missed, is_die=is_die, use2=use2,
                  slot=attrs[:, X_SLOT].long(), att=(att_r, att_g, att_b),
                  tp=tp_before)


def trace_options(tables, cfg) -> dict:
    """The per-trace scalars of a segment, a queue launch and their
    adjoints, from the scene and the configuration (exhaust_bg aside)."""
    return dict(t_min=1e-3, p_rr=float(cfg.p_rr),
                grad_bg=cfg.background_mode == "gradient",
                bg=tables.mega.bg)


def exhaust(state, lanes, bg, grad_bg: bool):
    """Credit the sky to the alive lanes among `lanes` (a bool [B] mask)
    whose depth ran out: rgb += throughput * background
    (the `exhaust_bg` epilogue, pallas_mega.py:1960-1966). In place."""
    sub = state[:, lanes]
    bgr, bgg, bgb = background(bg, grad_bg, sub[D], sub[D + 1], sub[D + 2])
    live = sub[ALIVE] > 0.0
    for k, bgk in enumerate((bgr, bgg, bgb)):
        sub[C + k] = sub[C + k] + torch.where(live, sub[TP + k] * bgk, 0.0)
    state[:, lanes] = sub
