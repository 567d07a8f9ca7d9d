"""Plain PyTorch versions of the megakernels' per-lane math: the
unit-ball twin of csrc/rng.cuh (its uniform draw is ops/rng.uniform's
stream) and `do_bounce_plain`, the twin of csrc/bounce.cuh
(rt_tpu/ops/pallas_mega.py `_uniform` / `_unit_ball` :618-696,
`_make_background` :774, `do_bounce` :1011-1896 for the four families,
solid / checker textures, no NEE, sampler "rng").

The ray state is the reference's 13 words per lane, held as one
[13, B] float32 tensor (rows `O`..`ALIVE` below): origin, direction,
throughput, accumulated radiance, alive (a float, 1.0 / 0.0, so NEE's
0.5 and 2 + p encodings fit later). Every expression is the
reference's, in the reference's order; the kernel repeats them.

`bounce_plain` returns the bounce with the intermediates its adjoint
reads (ops/adjoint_plain.py): the replay runs the forward's own
expressions, so C_after, the attenuation and P are the forward's bits.
`capture_plain`, the plain version of the tape-capture kernel
(csrc/capture.cu), records each bounce's winner code from the same
bounce. `regen_plain`, the plain version of the regeneration kernel
(csrc/regen.cu), runs the same bounce over the whole spp loop, with
each sample's camera rays from ops/camera.generate_rays.

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

from rt_tpu_torch.ops import camera, rng
from rt_tpu_torch.ops.mega_tables import (
    F_SLOT,
    R_F1,
    R_F2,
    R_HI0,
    R_HI1,
    R_K,
    R_LO0,
    R_LO1,
    R_VALID,
    S_C2R,
    S_VALID,
    T_D0,
    T_E1,
    T_E2,
    T_E3,
    T_V1,
    T_VALID,
    X_COLS,
    Y_R,
    Y_RAD2,
    Y_T,
    Y_VALID,
    Y_ZMAX,
    Y_ZMIN,
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
# lanes per [B, N] block of the sphere pass: bounds its temporaries to a
# few hundred MB at N = 512 whatever the batch; the other families take
# blocks of about as many (lane, row) pairs
HIT_CHUNK = 1 << 16
HIT_PAIRS = HIT_CHUNK * 512
# family codes of the winner (ops/intersect PTYPE_*)
FAM_SPHERE, FAM_RECT, FAM_CYLINDER, FAM_TRIANGLE = 0, 1, 2, 3


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


def _col(tab, j):
    """Column j of a family table as a [1, N] row of the [lanes, N]
    candidate blocks."""
    return tab[None, :, j]


def _odot(tab, j, vx, vy, vz):
    """(c_j vx + c_j+1 vy) + c_j+2 vz per (lane, row): the reference's
    `odot`, the row's columns j..j+2 against a lane vector."""
    return _col(tab, j) * vx + _col(tab, j + 1) * vy + _col(tab, j + 2) * vz


def _sphere_t(tab, ox, oy, oz, dx, dy, dz, a, rd_dot_ro, ro_sq, inv_a,
              t_min):
    """Candidate t per (lane, sphere) (`_sph_chunk_math` :1067-1097
    without MXU or culling); inf where there is no hit."""
    cx, cy, cz = (_col(tab, X_V + k) for k in range(3))
    hb = rd_dot_ro - (cx * dx + cy * dy + cz * dz)
    c_term = ro_sq - 2.0 * (cx * ox + cy * oy + cz * oz) + _col(tab, S_C2R)
    disc = hb * hb - a * c_term
    sqrtd = torch.sqrt(torch.clamp(disc, min=0.0))
    root1 = (-hb - sqrtd) * inv_a
    root2 = (-hb + sqrtd) * inv_a
    t = torch.where(root1 >= t_min, root1,
                    torch.where(root2 >= t_min, root2, INF))
    return torch.where((disc >= 0.0) & (_col(tab, S_VALID) > 0.0), t, INF)


def _rect_t(tab, ox, oy, oz, dx, dy, dz, t_min):
    """Candidate t per (lane, rect) (`rect_body` :1141-1163)."""
    ro_k = _odot(tab, X_V, ox, oy, oz)
    rd_k = _odot(tab, X_V, dx, dy, dz)
    rd_ok = rd_k != 0.0
    t = (_col(tab, R_K) - ro_k) / torch.where(rd_ok, rd_k, 1.0)
    x = _odot(tab, R_F1, ox, oy, oz) + t * _odot(tab, R_F1, dx, dy, dz)
    y = _odot(tab, R_F2, ox, oy, oz) + t * _odot(tab, R_F2, dx, dy, dz)
    valid = (rd_ok & (t >= t_min)
             & (x >= _col(tab, R_LO0)) & (x <= _col(tab, R_HI0))
             & (y >= _col(tab, R_LO1)) & (y <= _col(tab, R_HI1))
             & (_col(tab, R_VALID) > 0.0))
    return torch.where(valid, t, INF)


def _cyl_object_ray(col, ox, oy, oz, dx, dy, dz):
    """The ray in object space through the w2o rows (object.cuh:235-238):
    (oox, ooy, ooz, odx, ody, odz). col(j): column j of the rows."""
    def odot(j, vx, vy, vz):
        return col(j) * vx + col(j + 1) * vy + col(j + 2) * vz

    return (odot(Y_R, ox, oy, oz) + col(Y_T),
            odot(Y_R + 3, ox, oy, oz) + col(Y_T + 1),
            odot(Y_R + 6, ox, oy, oz) + col(Y_T + 2),
            odot(Y_R, dx, dy, dz),
            odot(Y_R + 3, dx, dy, dz),
            odot(Y_R + 6, dx, dy, dz))


def _cylinder_t(tab, ox, oy, oz, dx, dy, dz, t_min):
    """Candidate t per (lane, cylinder) (`cyl_body` :1165-1200): the
    radial quadratic in object space, the nearer root in the z window
    first. torch.minimum / maximum carry a NaN root through, as the
    reference's jnp.minimum / maximum (the kernel repeats that)."""
    oox, ooy, ooz, odx, ody, odz = _cyl_object_ray(
        lambda j: _col(tab, j), ox, oy, oz, dx, dy, dz)
    ac = odx * odx + ody * ody
    bc = 2.0 * (odx * oox + ody * ooy)
    cc = oox * oox + ooy * ooy - _col(tab, Y_RAD2)
    delta = bc * bc - 4.0 * ac * cc
    sq = torch.sqrt(torch.clamp(delta, min=0.0))
    a_ok = ac != 0.0
    inv2a = 1.0 / torch.where(a_ok, 2.0 * ac, 1.0)
    t0 = -(bc - sq) * inv2a
    t1 = -(bc + sq) * inv2a
    t0, t1 = torch.minimum(t0, t1), torch.maximum(t0, t1)
    zmin, zmax = _col(tab, Y_ZMIN), _col(tab, Y_ZMAX)
    z0 = ooz + t0 * odz
    z1 = ooz + t1 * odz
    ok0 = (t0 >= t_min) & (z0 >= zmin) & (z0 <= zmax) & a_ok
    ok1 = (t1 >= t_min) & (z1 >= zmin) & (z1 <= zmax) & a_ok
    t = torch.where(ok0, t0, torch.where(ok1, t1, INF))
    return torch.where((delta >= 0.0) & (_col(tab, Y_VALID) > 0.0), t, INF)


def _triangle_t(tab, ox, oy, oz, dx, dy, dz, t_min):
    """Candidate t per (lane, triangle) (`_tri_chunk_math` :1224-1267):
    the plane distance signed toward the origin's side, the three edge
    tests, and only rays heading into the plane (d_n < 0)."""
    oc_n = _odot(tab, X_V, ox, oy, oz) - _col(tab, T_D0)
    sign = torch.where(oc_n < 0.0, -1.0, 1.0)
    d_n = _odot(tab, X_V, dx, dy, dz) * sign
    oc_ns = oc_n * sign
    t = -oc_ns / torch.where(d_n != 0.0, d_n, 1.0)
    rx = ox + t * dx - _col(tab, T_V1)
    ry = oy + t * dy - _col(tab, T_V1 + 1)
    rz = oz + t * dz - _col(tab, T_V1 + 2)

    def edge_dot(j, wx, wy, wz):
        ex, ey, ez = _col(tab, j), _col(tab, j + 1), _col(tab, j + 2)
        cxp = ey * wz - ez * wy
        cyp = ez * wx - ex * wz
        czp = ex * wy - ey * wx
        return (cxp * _col(tab, X_V) + cyp * _col(tab, X_V + 1)
                + czp * _col(tab, X_V + 2))

    s1 = edge_dot(T_E1, rx, ry, rz)
    s2 = edge_dot(T_E2, rx - _col(tab, T_E1), ry - _col(tab, T_E1 + 1),
                  rz - _col(tab, T_E1 + 2))
    s3 = edge_dot(T_E3, rx + _col(tab, T_E3), ry + _col(tab, T_E3 + 1),
                  rz + _col(tab, T_E3 + 2))
    inside = (((s1 > 0) & (s2 > 0) & (s3 > 0))
              | ((s1 < 0) & (s2 < 0) & (s3 < 0)))
    valid = ((d_n < 0.0) & inside & (t >= t_min)
             & (_col(tab, T_VALID) > 0.0))
    return torch.where(valid, t, INF)


def _family_best(cand, n_rows, lanes, chunk):
    """(t_best, row) per lane of one family: cand(sl) gives the [lanes in
    sl, n_rows] candidate block; an equal t goes to the larger row."""
    t_parts, row_parts = [], []
    for s in range(0, lanes, chunk):
        t = cand(slice(s, s + chunk))
        row = (n_rows - 1) - torch.argmin(t.flip(-1), dim=-1)
        t_parts.append(torch.gather(t, 1, row[:, None])[:, 0])
        row_parts.append(row)
    return torch.cat(t_parts), torch.cat(row_parts)


def closest_hit(tab, ox, oy, oz, dx, dy, dz, t_min, fam=None):
    """(t_best, family, row) per lane: the hit pass of do_bounce over the
    spheres of `tab`, then the rects, cylinders and triangles of `fam`
    (mega_tables.Families, or None), in the reference's family order
    without MXU or culling. Within a family an equal t goes to the
    larger row; across families to the later family (`_merge`
    :753-763). A lane that hits nothing reports t = inf (family and row
    then mean nothing)."""
    lanes = ox.shape[0]
    dev = ox.device
    if lanes == 0:
        empty = torch.empty(0, dtype=torch.long, device=dev)
        return ox.new_empty(0), empty, empty
    a = dx * dx + dy * dy + dz * dz
    rd_dot_ro = dx * ox + dy * oy + dz * oz
    ro_sq = ox * ox + oy * oy + oz * oz
    inv_a = 1.0 / a
    lane = (ox, oy, oz, dx, dy, dz)

    def sph(sl):
        return _sphere_t(tab, *(v[sl, None] for v in lane), a[sl, None],
                         rd_dot_ro[sl, None], ro_sq[sl, None],
                         inv_a[sl, None], t_min)

    t_best, row = _family_best(sph, tab.shape[0], lanes, HIT_CHUNK)
    family = torch.zeros_like(row)
    if fam is None:
        return t_best, family, row
    for code, ftab, fn in ((FAM_RECT, fam.rect, _rect_t),
                           (FAM_CYLINDER, fam.cyl, _cylinder_t),
                           (FAM_TRIANGLE, fam.tri, _triangle_t)):
        n = ftab.shape[0]
        if n == 0:
            continue
        t, r = _family_best(
            lambda sl: fn(ftab, *(v[sl, None] for v in lane), t_min),
            n, lanes, max(1, HIT_PAIRS // n))
        take = (t < t_best) | (torch.isfinite(t) & (t == t_best))
        t_best = torch.where(take, t, t_best)
        family = torch.where(take, code, family)
        row = torch.where(take, r, row)
    return t_best, family, row


def winner_attrs(tab, fam, family, row, t_best, ox, oy, oz, dx, dy, dz):
    """[B, S_COLS] attribute rows of each lane's winner: the sphere
    table's row, or the winning family row's columns 0..14 with its
    gradient slot in column X_SLOT; a cylinder's v0..v2 are its world
    normal at the hit (`cyl_body` :1201-1212: the object-space radial
    direction, normalised by rsqrt, through the w2o rows transposed)."""
    if fam is None:
        return tab[row]
    attrs = tab[torch.where(family == FAM_SPHERE, row, 0)]
    for code, ftab in ((FAM_RECT, fam.rect), (FAM_CYLINDER, fam.cyl),
                       (FAM_TRIANGLE, fam.tri)):
        if ftab.shape[0] == 0:
            continue
        is_f = family == code
        w = ftab[torch.where(is_f, row, 0)]
        blk = torch.cat([w[:, :X_COLS],
                         torch.zeros_like(w[:, X_COLS:X_SLOT]),
                         w[:, F_SLOT:F_SLOT + 1]], dim=1)
        if code == FAM_CYLINDER:
            # the candidate's expressions, once per winner: the same bits
            oox, ooy, _, odx, ody, _ = _cyl_object_ray(
                lambda j: w[:, j], ox, oy, oz, dx, dy, dz)
            t_c = torch.where(torch.isfinite(t_best), t_best, 0.0)
            opx = oox + t_c * odx
            opy = ooy + t_c * ody
            ln2 = opx * opx + opy * opy
            inv_ln = torch.rsqrt(torch.where(ln2 > 0.0, ln2, 1.0))
            nox = opx * inv_ln
            noy = opy * inv_ln
            blk[:, X_V] = w[:, Y_R] * nox + w[:, Y_R + 3] * noy
            blk[:, X_V + 1] = w[:, Y_R + 1] * nox + w[:, Y_R + 4] * noy
            blk[:, X_V + 2] = w[:, Y_R + 2] * nox + w[:, Y_R + 5] * noy
        attrs = torch.where(is_f[:, None], blk, attrs)
    return attrs


class Bounce(NamedTuple):
    """One bounce's new state and what its adjoint (ops/adjoint_plain.py)
    and the tape capture (capture_plain) read: the lane masks, the
    attenuation, the winner's row, gradient slot and checker parity, and
    the throughput P before the bounce (the radiance after it is
    state[C:C+3])."""

    state: torch.Tensor      # [13, B] after the bounce
    hit: torch.Tensor        # [B] bool: a primitive was hit (roulette
                             # aside)
    family: torch.Tensor     # [B] int64 the winner's family (FAM_*)
    row: torch.Tensor        # [B] int64 the winner's row in its table
    scattered: torch.Tensor  # [B] bool
    emitter: torch.Tensor    # [B] bool: a light was hit
    missed: torch.Tensor     # [B] bool: the sky was hit
    is_die: torch.Tensor     # [B] bool: the winner is a dielectric
    use2: torch.Tensor       # [B] bool: checker odd parity (albedo2)
    slot: torch.Tensor       # [B] int64 gradient slot of the winner
    att: tuple               # 3 x [B] attenuation (1 for a dielectric)
    tp: tuple                # 3 x [B] throughput before the bounce


def do_bounce_plain(tab, state, pixel, sample, bounce, seed, *, t_min,
                    p_rr, grad_bg, bg, fam=None):
    """Advance every lane of `state` [13, B] one bounce; returns the new
    [13, B] state. Lanes whose alive word is 0 come out unchanged.

    tab: the packed sphere table (ops/mega_tables.sphere_table); fam:
    the rect, cylinder and triangle tables (mega_tables.Families) or
    None. pixel, sample, bounce: per-lane RNG coordinates ([B] integer
    tensors or ints); seed an int. bg: the constant sky colour, 3
    floats."""
    return bounce_plain(tab, state, pixel, sample, bounce, seed,
                        t_min=t_min, p_rr=p_rr, grad_bg=grad_bg,
                        bg=bg, fam=fam).state


def bounce_plain(tab, state, pixel, sample, bounce, seed, *, t_min, p_rr,
                 grad_bg, bg, fam=None) -> Bounce:
    """do_bounce_plain with the intermediates its adjoint reads."""
    ox, oy, oz, dx, dy, dz, tpr, tpg, tpb, cr, cg, cb, alive = state.unbind(0)

    live = alive > 0.0
    if p_rr > 0.0:
        u_rr = rng.uniform(seed, pixel, sample, bounce, rng.RR)
        live = live & (u_rr <= p_rr)

    a = dx * dx + dy * dy + dz * dz
    t_best, family, row = closest_hit(tab, ox, oy, oz, dx, dy, dz, t_min,
                                      fam)
    attrs = winner_attrs(tab, fam, family, row, t_best, ox, oy, oz, dx, dy,
                         dz)
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
    return Bounce(state=out, hit=hit, family=family, row=row,
                  scattered=scattered,
                  emitter=emitter,
                  missed=missed, is_die=is_die, use2=use2,
                  slot=attrs[:, X_SLOT].long(), att=(att_r, att_g, att_b),
                  tp=tp_before)


def capture_plain(tab, state, pixel, sample, seed, max_depth, *, t_min,
                  p_rr, grad_bg, bg, fam=None):
    """The plain version of the tape-capture kernel B4 (csrc/capture.cu,
    rt_tpu/ops/pallas_mega.py `_capture_kernel` :1978): trace the fresh
    rays of `state` [13, B] (pixel ids [B], one sample index) against the
    sphere table `tab` and the family tables `fam` (as do_bounce_plain)
    for max_depth bounces and return (codes [max_depth, B] int32, death
    [B] int32).

    codes[b, i] is the winner's tape code `family << 24 | row`
    (pallas_mega.py:1882-1892: FAM_* and the row in its family's table)
    when lane i, alive entering bounce b, hits, and -1 on a miss and at
    every bounce after the lane's death. A lane that roulette stops at
    bounce b still records that bounce's winner, as the reference's
    kernel evaluates the hit on every lane. death[i] is the number of
    bounces after which the lane is still alive. The row is the pid
    because the tables keep the scene's order (no Morton sort, ROADMAP
    C-3). `state` is not changed."""
    b = state.shape[1]
    dev = state.device
    codes = torch.full((max_depth, b), -1, dtype=torch.int32, device=dev)
    death = torch.zeros(b, dtype=torch.int32, device=dev)
    idx = torch.arange(b, device=dev)
    sub = state
    for k in range(max_depth):
        if idx.numel() == 0:
            break
        bn = bounce_plain(tab, sub, pixel[idx], sample, k, seed, t_min=t_min,
                          p_rr=p_rr, grad_bg=grad_bg, bg=bg, fam=fam)
        codes[k, idx] = torch.where(bn.hit, (bn.family << 24) | bn.row,
                                    -1).to(torch.int32)
        keep = bn.scattered
        idx, sub = idx[keep], bn.state[:, keep]
        death[idx] += 1
    return codes, death


def trace_options(tables, cfg) -> dict:
    """The per-trace options of a segment, a queue launch and their
    adjoints, from the scene and the configuration (exhaust_bg aside):
    the scalars and the family tables (MegaScene.fam)."""
    return dict(t_min=1e-3, p_rr=float(cfg.p_rr),
                grad_bg=cfg.background_mode == "gradient",
                bg=tables.mega.bg, fam=tables.mega.fam)


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


def regen_plain(tab, cam, state, pixel, py, samp, bvec, sample_base, seed,
                seg_iters, *, max_depth, spp, init, width, height, defocus,
                n=None, t_min=1e-3, p_rr=0.0, grad_bg=False, bg,
                exhaust_bg=False, depth=None, fam=None):
    """The plain version of one segment of the regeneration kernel B7
    (csrc/regen.cu, rt_tpu/ops/pallas_mega.py `_regen_kernel` :2288):
    lanes [0, n) of state [13, B], pixel ids `pixel` and rows `py`
    ([B] integer tensors), owe the samples [sample_base, sample_base +
    spp); samp and bvec ([B] int32) are each lane's sample and bounce
    counters. Each of at most seg_iters iterations advances the pending
    lanes (alive, or owing a sample): (1) retire a lane alive at bounce
    max_depth, crediting the sky when exhaust_bg; (2) start a dead
    lane's next sample (samp + 1, bvec 0, a fresh camera ray); (3) one
    bounce at (samp, bvec), then bvec + 1. With init, the lanes first
    take sample_base's camera rays. cam: ops/camera.camera_vec's 19
    floats. fam: the family tables, as do_bounce_plain. state, samp and
    bvec are updated in place and returned; depth, when given, gains
    each lane's bounces."""
    n = state.shape[1] if n is None else int(n)
    dev = state.device
    sub = state[:, :n]
    pix = pixel[:n].to(device=dev, dtype=torch.int64)
    pyl = py[:n].to(device=dev, dtype=torch.int64)
    pxl = pix - pyl * width
    cam_def = camera.camera_of_vec(cam, dev)
    end = int(sample_base) + int(spp)

    def rays(idx, sample):
        return camera.generate_rays(cam_def, width, height, pxl[idx],
                                    pyl[idx], sample, seed, defocus)

    if init:
        samp[:n] = int(sample_base)
        bvec[:n] = 0
        sub.copy_(fresh_state(*rays(slice(None), int(sample_base))))
    sm = samp[:n].to(torch.int64)
    bv = bvec[:n].to(torch.int64)
    for _ in range(int(seg_iters)):
        idx = torch.nonzero((sub[ALIVE] > 0.0) | (sm + 1 < end))[:, 0]
        if idx.numel() == 0:
            break
        st, s_, b_ = sub[:, idx], sm[idx], bv[idx]
        # (1) the depth ran out
        exh = (st[ALIVE] > 0.0) & (b_ >= max_depth)
        if exhaust_bg:
            exhaust(st, exh, bg, grad_bg)
        st[ALIVE] = torch.where(exh, 0.0, st[ALIVE])
        # (2) dead lanes that owe a sample start the next one
        reg = (st[ALIVE] == 0.0) & (s_ + 1 < end)
        s_ = torch.where(reg, s_ + 1, s_)
        b_ = torch.where(reg, 0, b_)
        ri = torch.nonzero(reg)[:, 0]
        if ri.numel():
            ro, rd = rays(idx[ri], s_[ri])
            st[O:O + 3, ri] = ro.T
            st[D:D + 3, ri] = rd.T
            st[TP:TP + 3, ri] = 1.0
            st[ALIVE, ri] = 1.0
        # (3) one bounce at (samp, bvec)
        li = torch.nonzero(st[ALIVE] > 0.0)[:, 0]
        if li.numel():
            st[:, li] = do_bounce_plain(
                tab, st[:, li], pix[idx[li]], s_[li], b_[li], seed,
                t_min=t_min, p_rr=p_rr, grad_bg=grad_bg, bg=bg, fam=fam)
            if depth is not None:
                depth[idx[li]] += 1
        sub[:, idx] = st
        sm[idx] = s_
        bv[idx] = b_ + 1
    samp[:n] = sm.to(samp.dtype)
    bvec[:n] = bv.to(bvec.dtype)
    return state, samp, bvec
