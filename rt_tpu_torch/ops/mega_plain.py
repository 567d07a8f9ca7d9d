"""Plain PyTorch versions of the megakernels' per-lane math: the
unit-ball twin of csrc/rng.cuh (its uniform draw is ops/rng.uniform's
stream, or under the sampler "qmc" ops/qmc.uniform's) and
`do_bounce_plain`, the twin of csrc/bounce.cuh
(rt_tpu/ops/pallas_mega.py `_uniform` / `_unit_ball` :618-696,
`_make_background` :774, `do_bounce` :1011-1896 for the four families,
solid / checker / image textures, NEE / MIS / glossy light sampling,
the samplers "rng" and "qmc", chunk culling).

Chunk culling (`cull`, mega_tables.Cull): the Morton-sorted sphere and
triangle rows are visited chunk by chunk, and each lane skips a chunk
whose box its ray does not meet at t >= t_min or meets only beyond its
closest hit so far (`closest_hit`, `_culled_best`; for a shadow ray
beyond T_HI, `shadow_occluded`): the per-lane form of the reference's
`chunk_visible` :1099-1140 and `box_visible` :845-868, which decide
for a tile of lanes at once. The kernels take the same decision in the
same chunk order, so they stay bit-equal to these versions on every
lane. A winner's tape code and MIS's emitter match name its SceneTables
row (`scene_rows`).

The ray state is the reference's 13 words per lane, held as one
[13, B] float32 tensor (rows `O`..`ALIVE` below): origin, direction,
throughput, accumulated radiance, alive (a float: 0 dead, 1 alive; under
NEE 0.5 for a lane scattered by a light-sampled bounce, under MIS 2 +
the density of that bounce's draw; every liveness test is alive > 0).
Every expression is the reference's, in the reference's order; the
kernel repeats them.

NEE (`Nee`, nee_options) follows the kernels' block (pallas_mega.py
:1487-1760, :1838-1875), not the wavefront's `_nee_direct`: the light
point from the light table's sampling block, the checker parity of the
light at the sample point, the shadow ray as `shadow_occluded`, the
twin of `_shadow_occluded` (:831-1009): an any-hit over every family
with t in [t_min, 1 - 1e-3], both ends inclusive, a sphere by the
expanded quadratic with 1 / max(a, 1e-20) multiplied in. The two forms
part on grazing shadow rays (as ROADMAP C-9 / C-10 part the engines), so
the engines are compared by images.

Image textures (`img`, mega_tables.Images, or None): the winner's (u,
v) comes once per hit from its family and row (`winner_uv`,
pallas_mega.py:1327-1390: a sphere's from its centre and radius, the
others' from their UV table rows), and a winner whose column X_IMG holds
an image id takes the atlas texel there as its albedo
(materials.texel_rows: u wraps to [0, 1) and picks the row of TH, v the
column of TW). Under NEE a light whose emission is an image takes the
texel at the light point's (u, v), derived from the sample draw in each
family's hit convention (`nee_img`, :1623-1664). The arc tangent and arc
cosine are torch.atan2 / torch.acos, which on the card are the
libdevice atan2f / acosf the kernels call, where the reference's TPU
kernel has polynomials (`_atan2` :709, `_acos` :723; within about 1e-5
rad, so a lane at a texel boundary may pick the neighbouring texel,
ROADMAP C-13).

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
from typing import NamedTuple, Optional

import torch

from rt_tpu_torch.config import nee_on
from rt_tpu_torch.ops import camera, qmc as qmc_mod, rng
from rt_tpu_torch.ops.materials import texel_rows
from rt_tpu_torch.ops.mega_tables import (
    SPH_CHUNK,
    F_SLOT,
    L_AREA,
    L_CHECKER,
    L_FAM,
    L_IMG,
    L_LE,
    L_LE2,
    L_ROW,
    L_SLOT,
    L_UV,
    MAX_LIGHT_ROWS,
    scene_for,
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
    X_IMG,
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
# lanes of a GPU warp: closest_hit.need groups lanes by it
WARP = 32
# family codes of the winner (ops/intersect PTYPE_*)
FAM_SPHERE, FAM_RECT, FAM_CYLINDER, FAM_TRIANGLE = 0, 1, 2, 3


def sampler(qmc: bool):
    """The draw module of a trace: ops/qmc.py under qmc, else ops/rng.py
    (the kernels' `qmc` flag, pallas_mega `_uniform(..., qmc)`)."""
    return qmc_mod if qmc else rng


def unit_ball(seed, pixel, sample, bounce, qmc: bool = False):
    """The megakernel's unit-ball draw (pallas_mega._unit_ball): radius
    exp(log(u1)/3), not the wavefront's pow(u1, 1/3)."""
    smp = sampler(qmc)
    u1 = smp.uniform(seed, pixel, sample, bounce, rng.SCAT_U1)
    u2 = smp.uniform(seed, pixel, sample, bounce, rng.SCAT_U2)
    u3 = smp.uniform(seed, pixel, sample, bounce, rng.SCAT_U3)
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


class Nee(NamedTuple):
    """What a bounce's light sampler reads (nee_options): the light table
    (mega_tables.light_table, one row per light) and the MIS and glossy
    flags."""

    lights: torch.Tensor     # [n_lights, NL_COLS] f32
    mis: bool = False
    glossy: bool = False


def nee_options(tables, cfg, adjoint: bool = False) -> Optional[Nee]:
    """The NEE options of a trace (None without light sampling,
    config.nee_on); adjoint: the replay's, which takes NEE without MIS
    or glossy (diff/replay.py refuses those). Under MIS every family
    table must hold fewer than MAX_LIGHT_ROWS rows, the rows the emitter
    match keys exactly (ROADMAP C-2)."""
    if not nee_on(cfg, tables):
        return None
    mis = bool(cfg.mis) and not adjoint
    if mis and max(tables.counts) >= MAX_LIGHT_ROWS:
        raise ValueError(f"mis: family rows {tables.counts}; the emitter "
                         f"match keys rows below {MAX_LIGHT_ROWS}")
    return Nee(lights=tables.mega.lights, mis=mis,
               glossy=bool(cfg.nee_glossy) and not adjoint)


T_HI = 1.0 - 1e-3   # the shadow segment's end, in units of |w|


def _sphere_shadow(tab, sx, sy, sz, wx, wy, wz, a_s, rd_ro, ro_sq, inv_a,
                   t_min):
    """Whether the shadow segment meets each sphere (`sph_shadow_math`
    :864-880): [lanes, N] bool."""
    cx, cy, cz = (_col(tab, X_V + k) for k in range(3))
    hb = rd_ro - (cx * wx + cy * wy + cz * wz)
    c_term = ro_sq - 2.0 * (cx * sx + cy * sy + cz * sz) + _col(tab, S_C2R)
    disc = hb * hb - a_s * c_term
    sqrtd = torch.sqrt(torch.clamp(disc, min=0.0))
    r1 = (-hb - sqrtd) * inv_a
    r2 = (-hb + sqrtd) * inv_a
    return ((disc >= 0.0) & (_col(tab, S_VALID) > 0.0)
            & (((r1 >= t_min) & (r1 <= T_HI))
               | ((r2 >= t_min) & (r2 <= T_HI))))


BIG = 3.0e38   # the slab test's stand-in for an unbounded axis


def _slab(o, d, lo, hi):
    """(near, far) of the slab lo <= o + t d <= hi along one axis
    (`axis_slab` :1112-1122): an axis the ray does not move along is
    all of t or none of it."""
    d_ok = d != 0.0
    inv = 1.0 / torch.where(d_ok, d, 1.0)
    near = (lo - o) * inv
    far = (hi - o) * inv
    near, far = torch.minimum(near, far), torch.maximum(near, far)
    inside = (o >= lo) & (o <= hi)
    near = torch.where(d_ok, near, torch.where(inside, -BIG, BIG))
    far = torch.where(d_ok, far, torch.where(inside, BIG, -BIG))
    return near, far


def box_span(boxes, ox, oy, oz, dx, dy, dz):
    """(tn, tf, nonempty): each lane's entry and exit t [lanes, K] of the
    K chunk boxes [K, 8] (`chunk_visible` :1099-1140), and whether each
    box holds a row ([K] bool: a chunk of pad rows has the empty box,
    which the near / far swap would turn inside out)."""
    lo, hi = boxes[None, :, 0:3], boxes[None, :, 3:6]
    n1, f1 = _slab(ox[:, None], dx[:, None], lo[..., 0], hi[..., 0])
    n2, f2 = _slab(oy[:, None], dy[:, None], lo[..., 1], hi[..., 1])
    n3, f3 = _slab(oz[:, None], dz[:, None], lo[..., 2], hi[..., 2])
    tn = torch.maximum(torch.maximum(n1, n2), n3)
    tf = torch.minimum(torch.minimum(f1, f2), f3)
    return tn, tf, boxes[:, 0] <= boxes[:, 3]


def _chunk_rows(n: int, k: int, device) -> torch.Tensor:
    """[K] rows of each chunk of SPH_CHUNK rows of an n-row table."""
    return torch.clamp(n - SPH_CHUNK * torch.arange(k, device=device),
                       max=SPH_CHUNK)


def _shadow_block(hit, vis):
    """(occluded [lanes], rows tested [lanes]) of a family's any-hit hit
    [lanes, n] whose chunks a lane visits where vis [lanes, K]: a scan in
    the kernel's order that skips the other chunks and stops at the first
    occluder."""
    n = hit.shape[1]
    if vis is None:
        any_h = hit.any(-1)
        first = torch.argmax(hit.to(torch.int8), -1) + 1
        return any_h, torch.where(any_h, first, n)
    row_vis = vis.repeat_interleave(SPH_CHUNK, dim=1)[:, :n]
    hit = hit & row_vis
    any_h = hit.any(-1)
    seen = torch.cumsum(row_vis.to(torch.int64), -1)
    first = torch.argmax(hit.to(torch.int8), -1)
    return any_h, torch.where(any_h, seen.gather(1, first[:, None])[:, 0],
                              seen[:, -1])


def shadow_occluded(tab, sx, sy, sz, wx, wy, wz, t_min, fam=None, cull=None):
    """[lanes] bool: whether anything of the sphere table `tab` or the
    family tables `fam` lies on the segment s + t w, t in [t_min, T_HI]
    (the twin of `_shadow_occluded`). A rect, cylinder or triangle
    occludes exactly when its closest-hit candidate t is at most T_HI:
    for those families the reference's any-hit tests are the candidate
    tests with that bound added. With `cull` (mega_tables.Cull) a lane
    skips a sorted family's chunk whose box the segment misses
    (`box_visible` :845-868 for one lane). shadow_occluded.rays counts
    the rays it tests and shadow_occluded.rows, per family, the rows a
    scan in the kernel's order that skips those chunks and stops at the
    first occluder tests (a bound's operation count reads them)."""
    lanes = sx.shape[0]
    shadow_occluded.rays += lanes
    occ = torch.zeros(lanes, dtype=torch.bool, device=sx.device)
    if lanes == 0:
        return occ
    a_s = wx * wx + wy * wy + wz * wz
    rd_ro = wx * sx + wy * sy + wz * sz
    ro_sq = sx * sx + sy * sy + sz * sz
    inv_a = 1.0 / torch.clamp(a_s, min=1e-20)
    lane = (sx, sy, sz, wx, wy, wz)
    boxes = ((cull.sph, None, None, cull.tri) if cull is not None
             else (None,) * 4)
    blocks = [(FAM_SPHERE, tab.shape[0], lambda sl: _sphere_shadow(
        tab, *(v[sl, None] for v in lane), a_s[sl, None], rd_ro[sl, None],
        ro_sq[sl, None], inv_a[sl, None], t_min))]
    if fam is not None:
        for code, ftab, fn in ((FAM_RECT, fam.rect, _rect_t),
                               (FAM_CYLINDER, fam.cyl, _cylinder_t),
                               (FAM_TRIANGLE, fam.tri, _triangle_t)):
            if ftab.shape[0]:
                blocks.append((code, ftab.shape[0],
                               lambda sl, ftab=ftab, fn=fn: fn(
                                   ftab, *(v[sl, None] for v in lane),
                                   t_min) <= T_HI))
    for code, n, block in blocks:
        chunk = max(1, HIT_PAIRS // n)
        hit = []
        for s in range(0, lanes, chunk):
            sl = slice(s, s + chunk)
            vis = None
            if boxes[code] is not None:
                tn, tf, nonempty = box_span(boxes[code],
                                            *(v[sl] for v in lane))
                vis = (nonempty[None, :]
                       & (tf >= torch.clamp(tn, min=t_min)) & (tn <= T_HI))
            any_h, rows = _shadow_block(block(sl), vis)
            shadow_occluded.rows[code] += int(torch.where(occ[sl], 0, rows)
                                              .sum())
            hit.append(any_h)
        occ = occ | torch.cat(hit)
    return occ


shadow_occluded.rays = 0
shadow_occluded.rows = [0, 0, 0, 0]


def _last_argmin(t):
    """(min, index) along the last axis; an equal t goes to the larger
    index."""
    n = t.shape[-1]
    row = (n - 1) - torch.argmin(t.flip(-1), dim=-1)
    return torch.gather(t, -1, row[..., None])[..., 0], row


def _family_best(cand, n_rows, lanes, chunk):
    """(t_best, row) per lane of one family: cand(sl) gives the [lanes in
    sl, n_rows] candidate block; an equal t goes to the larger row."""
    t_parts, row_parts = [], []
    for s in range(0, lanes, chunk):
        t, row = _last_argmin(cand(slice(s, s + chunk)))
        t_parts.append(t)
        row_parts.append(row)
    return torch.cat(t_parts), torch.cat(row_parts)


def _take(t, t_best):
    """Whether a candidate t replaces the running winner t_best: smaller,
    or an equal finite t from a later chunk or family (`_merge`)."""
    return (t < t_best) | (torch.isfinite(t) & (t == t_best))


def _culled_best(cand, n_rows, boxes, ray, t_min, t_best, family, row, code,
                 chunk):
    """Fold one sorted family into the running winner (t_best, family,
    row) chunk by chunk: a lane takes a chunk's winner only when the
    chunk's box is nonempty, its ray meets the box at t >= t_min, and the
    box starts no later than the lane's closest hit so far (the per-lane
    form of `chunk_visible` :1099-1140). Returns the new winner and
    the rows each lane tested [lanes]."""
    lanes = t_best.shape[0]
    k = boxes.shape[0]
    sizes = _chunk_rows(n_rows, k, t_best.device)
    outs = ([], [], [], [])
    for s in range(0, lanes, chunk):
        sl = slice(s, s + chunk)
        t = cand(sl)
        pad = k * SPH_CHUNK - n_rows
        if pad:
            t = torch.cat([t, t.new_full((t.shape[0], pad), INF)], dim=1)
        tk, rk = _last_argmin(t.view(t.shape[0], k, SPH_CHUNK))
        tn, tf, nonempty = box_span(boxes, *(v[sl] for v in ray))
        hit_box = nonempty[None, :] & (tf >= torch.clamp(tn, min=t_min))
        tb, fb, rb = t_best[sl], family[sl], row[sl]
        tested = torch.zeros_like(rb)
        need = []
        for j in range(k):
            vis = hit_box[:, j] & (tn[:, j] <= tb)
            need.append(vis)
            tested = tested + torch.where(vis, sizes[j], 0)
            take = vis & _take(tk[:, j], tb)
            tb = torch.where(take, tk[:, j], tb)
            fb = torch.where(take, code, fb)
            rb = torch.where(take, rk[:, j] + j * SPH_CHUNK, rb)
        for out, v in zip(outs, (tb, fb, rb, tested)):
            out.append(v)
        _count_warp_need(torch.stack(need, 1), code)
    return tuple(torch.cat(o) for o in outs)


def _count_warp_need(need, code):
    """Add to closest_hit.need[code][n] the (group, chunk) pairs of need
    [lanes, K] (lane visits chunk) in which n lanes of a group of 32
    consecutive lanes (the last one padded) visit the chunk: a per-lane
    row loop runs the chunk for the whole group when n > 0, n of 32
    lanes unmasked."""
    pad = -need.shape[0] % WARP
    if pad:
        need = torch.cat([need, need.new_zeros((pad, need.shape[1]))])
    per = need.view(-1, WARP, need.shape[1]).sum(1)
    hist = torch.bincount(per.flatten(), minlength=WARP + 1).tolist()
    acc = closest_hit.need[code]
    for n, v in enumerate(hist):
        acc[n] += v


def closest_hit(tab, ox, oy, oz, dx, dy, dz, t_min, fam=None, cull=None):
    """(t_best, family, row) per lane: the hit pass of do_bounce over the
    spheres of `tab`, then the rects, cylinders and triangles of `fam`
    (mega_tables.Families, or None), in the reference's family order
    without MXU. Within a family an equal t goes to the larger row;
    across families to the later family (`_merge` :753-763). With `cull`
    (mega_tables.Cull) the sorted spheres and triangles are visited
    chunk by chunk, each lane skipping the chunks its own slab test
    rejects against its closest hit so far (_culled_best). A lane that
    hits nothing reports t = inf (family and row then mean nothing).
    closest_hit.rows counts, per family, the (lane, row) pairs tested,
    and closest_hit.boxes the (lane, chunk box) pairs (a bound's
    operation count reads them); closest_hit.need, per culled family, how
    many of 32 consecutive lanes visit each chunk (_count_warp_need: an
    estimate of a warp's masked share in the kernels' per-lane loop)."""
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

    boxes = (None,) * 4
    if cull is not None:
        cull.check(tab)
        boxes = (cull.sph, None, None, cull.tri)
    if boxes[FAM_SPHERE] is None:
        t_best, row = _family_best(sph, tab.shape[0], lanes, HIT_CHUNK)
        family = torch.zeros_like(row)
        closest_hit.rows[FAM_SPHERE] += lanes * tab.shape[0]
    else:
        t_best, family, row, tested = _culled_best(
            sph, tab.shape[0], boxes[FAM_SPHERE], lane, t_min,
            ox.new_full((lanes,), INF),
            torch.zeros(lanes, dtype=torch.long, device=dev),
            torch.zeros(lanes, dtype=torch.long, device=dev), FAM_SPHERE,
            HIT_CHUNK)
        closest_hit.rows[FAM_SPHERE] += int(tested.sum())
        closest_hit.boxes += lanes * boxes[FAM_SPHERE].shape[0]
    if fam is None:
        return t_best, family, row
    for code, ftab, fn in ((FAM_RECT, fam.rect, _rect_t),
                           (FAM_CYLINDER, fam.cyl, _cylinder_t),
                           (FAM_TRIANGLE, fam.tri, _triangle_t)):
        n = ftab.shape[0]
        if n == 0:
            continue

        def cand(sl, ftab=ftab, fn=fn):
            return fn(ftab, *(v[sl, None] for v in lane), t_min)

        if boxes[code] is not None:
            t_best, family, row, tested = _culled_best(
                cand, n, boxes[code], lane, t_min, t_best, family, row, code,
                max(1, HIT_PAIRS // n))
            closest_hit.rows[code] += int(tested.sum())
            closest_hit.boxes += lanes * boxes[code].shape[0]
            continue
        t, r = _family_best(cand, n, lanes, max(1, HIT_PAIRS // n))
        closest_hit.rows[code] += lanes * n
        take = _take(t, t_best)
        t_best = torch.where(take, t, t_best)
        family = torch.where(take, code, family)
        row = torch.where(take, r, row)
    return t_best, family, row


closest_hit.rows = [0, 0, 0, 0]
closest_hit.boxes = 0
closest_hit.need = [[0] * (WARP + 1) for _ in range(4)]


def scene_rows(cull, family, row):
    """The SceneTables row [B] of each winner (family, row of its table):
    the row itself, or for a Morton-sorted family (cull, mega_tables.Cull)
    the row it was sorted from. Tape codes and MIS's emitter match name
    that row."""
    if cull is None:
        return row
    for code, rows in ((FAM_SPHERE, cull.sph_rows),
                       (FAM_TRIANGLE, cull.tri_rows)):
        if rows is not None:
            is_f = family == code
            row = torch.where(is_f, rows.long()[torch.where(is_f, row, 0)],
                              row)
    return row


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


INV_2PI = 1.0 / (2.0 * math.pi)
INV_4PI = 1.0 / (4.0 * math.pi)
INV_PI = 1.0 / math.pi


def sphere_uv(ux, uy, uz):
    """(u, v) of the unit outward offset (ux, uy, uz) of a sphere point
    (object.cuh:87-93, pallas_mega.py:1336-1344): the azimuth about y
    from -z, and the polar angle from -y, both scaled to [0, 1]."""
    az = (uz == 0.0) & (ux == 0.0)
    u = (torch.atan2(-uz, torch.where(az, 1.0, ux)) + math.pi) * INV_2PI
    return u, torch.acos(torch.clamp(-uy, -1.0, 1.0)) * INV_PI


def _rect_uv(r, px, py, pz):
    """A rect's (u, v) from its UV rows r [B, U_COLS] (:1346-1350)."""
    r_x = r[:, 0] * px + r[:, 1] * py + r[:, 2] * pz
    r_y = r[:, 3] * px + r[:, 4] * py + r[:, 5] * pz
    return (r_x - r[:, 6]) * r[:, 8], (r_y - r[:, 7]) * r[:, 9]


def _cylinder_uv(r, px, py, pz):
    """A cylinder's (u, v): the object-space hit's azimuth and its height
    in the z window (:1352-1361)."""
    c_px = r[:, 0] * px + r[:, 1] * py + r[:, 2] * pz + r[:, 9]
    c_py = r[:, 3] * px + r[:, 4] * py + r[:, 5] * pz + r[:, 10]
    c_pz = r[:, 6] * px + r[:, 7] * py + r[:, 8] * pz + r[:, 11]
    deg = (c_py == 0.0) & (c_px == 0.0)
    u = (torch.atan2(c_py, torch.where(deg, 1.0, c_px)) + 2.0 * math.pi) \
        * INV_4PI
    return u, (c_pz - r[:, 12]) * r[:, 13]


def _triangle_uv(r, px, py, pz):
    """A triangle's (u, v) by the standard barycentric weights
    (:1363-1388; Taichi's swapped weights come from
    SceneDef.taichi_tri_uv)."""
    a1x, a1y, a1z = r[:, 3] - px, r[:, 4] - py, r[:, 5] - pz   # v2 - p
    a2x, a2y, a2z = r[:, 6] - px, r[:, 7] - py, r[:, 8] - pz   # v3 - p
    a3x, a3y, a3z = r[:, 0] - px, r[:, 1] - py, r[:, 2] - pz   # v1 - p
    cx1 = a1y * a2z - a1z * a2y
    cy1 = a1z * a2x - a1x * a2z
    cz1 = a1x * a2y - a1y * a2x
    l1 = torch.sqrt(cx1 * cx1 + cy1 * cy1 + cz1 * cz1) * r[:, 9]
    cx2 = a2y * a3z - a2z * a3y
    cy2 = a2z * a3x - a2x * a3z
    cz2 = a2x * a3y - a2y * a3x
    l2 = torch.sqrt(cx2 * cx2 + cy2 * cy2 + cz2 * cz2) * r[:, 9]
    l3 = 1.0 - l1 - l2
    l3 = torch.where(l3 > 0.0, l3, 0.0)   # a NaN gives 0, as the kernels
    return (r[:, 10] * l1 + r[:, 12] * l2 + r[:, 14] * l3,
            r[:, 11] * l1 + r[:, 13] * l2 + r[:, 15] * l3)


def winner_uv(img, family, row, attrs, inv_rad, px, py, pz):
    """(u, v) [B] of each lane's winner at the hit (px, py, pz): a
    sphere's from its centre (attrs' v0..v2) and 1 / radius, a rect's,
    cylinder's or triangle's from its row of img's UV tables.
    winner_uv.texels: bounce_plain counts there, per family, the
    texel-sampled hits of the bounces it runs (the kernels' atlas reads,
    which a bound's count reads)."""
    u, v = sphere_uv((px - attrs[:, X_V]) * inv_rad,
                     (py - attrs[:, X_V + 1]) * inv_rad,
                     (pz - attrs[:, X_V + 2]) * inv_rad)
    for code, utab, fn in ((FAM_RECT, img.rect, _rect_uv),
                           (FAM_CYLINDER, img.cyl, _cylinder_uv),
                           (FAM_TRIANGLE, img.tri, _triangle_uv)):
        if utab.shape[0] == 0:
            continue
        is_f = family == code
        fu, fv = fn(utab[torch.where(is_f, row, 0)], px, py, pz)
        u = torch.where(is_f, fu, u)
        v = torch.where(is_f, fv, v)
    return u, v


winner_uv.texels = [0, 0, 0, 0]


def texels(img, img_id, u, v):
    """(rows of the flattened atlas [B] int64, -1 where img_id < 0; the
    texels' colours, 3 x [B]) of image ids img_id [B] (float) at (u,
    v)."""
    has = img_id >= 0.0
    rows = torch.where(has, texel_rows(img.atlas, torch.clamp(img_id, min=0.0),
                                       u, v), -1)
    rgb = img.atlas.reshape(-1, 3)[torch.clamp(rows, min=0)].T
    return rows, tuple(rgb)


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
    # under NEE (else None): the direct term's weight (0 where no light
    # was sampled or it was occluded), the sampled light's emission, its
    # gradient slot and its checker parity at the sample point
    okl: Optional[torch.Tensor] = None    # [B]
    le: Optional[tuple] = None            # 3 x [B]
    lslot: Optional[torch.Tensor] = None  # [B] int64
    lodd: Optional[torch.Tensor] = None   # [B] bool
    em_scale: Optional[torch.Tensor] = None  # [B] the emission's weight
    # with image textures (else None): the row of the flattened atlas the
    # winner's albedo came from (-1: not texel-sampled), and under NEE
    # the sampled light's emission's
    texel: Optional[torch.Tensor] = None    # [B] int64
    ltexel: Optional[torch.Tensor] = None   # [B] int64


def do_bounce_plain(tab, state, pixel, sample, bounce, seed, *, t_min,
                    p_rr, grad_bg, bg, fam=None, nee=None, img=None,
                    qmc=False, cull=None):
    """Advance every lane of `state` [13, B] one bounce; returns the new
    [13, B] state. Lanes whose alive word is 0 come out unchanged.

    tab: the packed sphere table (ops/mega_tables.sphere_table); fam:
    the rect, cylinder and triangle tables (mega_tables.Families) or
    None. pixel, sample, bounce: per-lane RNG coordinates ([B] integer
    tensors or ints); seed an int. bg: the constant sky colour, 3
    floats. nee: the light sampler's options (Nee), or None. img: the
    atlas and UV tables (mega_tables.Images), or None. qmc: draw from
    the scrambled Sobol' sequence (ops/qmc.py) instead of ops/rng.py.
    cull: the chunk boxes of the sorted tables (mega_tables.Cull), or
    None."""
    return bounce_plain(tab, state, pixel, sample, bounce, seed,
                        t_min=t_min, p_rr=p_rr, grad_bg=grad_bg,
                        bg=bg, fam=fam, nee=nee, img=img, qmc=qmc,
                        cull=cull).state


def bounce_plain(tab, state, pixel, sample, bounce, seed, *, t_min, p_rr,
                 grad_bg, bg, fam=None, nee=None, img=None, qmc=False,
                 cull=None) -> Bounce:
    """do_bounce_plain with the intermediates its adjoint reads."""
    ox, oy, oz, dx, dy, dz, tpr, tpg, tpb, cr, cg, cb, alive = state.unbind(0)
    smp = sampler(qmc)

    live = alive > 0.0
    if p_rr > 0.0:
        u_rr = smp.uniform(seed, pixel, sample, bounce, rng.RR)
        live = live & (u_rr <= p_rr)

    a = dx * dx + dy * dy + dz * dz
    t_best, family, row = closest_hit(tab, ox, oy, oz, dx, dy, dz, t_min,
                                      fam, cull)
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

    img_out = {}
    if img is not None:
        # image textures: the atlas texel at the winner's (u, v)
        u_w, v_w = winner_uv(img, family, row, attrs, inv_rad, px_, py_,
                             pz_)
        texel, rgb = texels(img, attrs[:, X_IMG], u_w, v_w)
        has = texel >= 0
        counts = torch.bincount(family[has & live & hit], minlength=4)
        winner_uv.texels = [a + int(b) for a, b in
                            zip(winner_uv.texels, counts.tolist())]
        alb_r = torch.where(has, rgb[0], alb_r)
        alb_g = torch.where(has, rgb[1], alb_g)
        alb_b = torch.where(has, rgb[2], alb_b)
        img_out["texel"] = texel

    is_lam = w_mtype == MAT_LAMBERTIAN
    is_met = w_mtype == MAT_METAL
    is_die = w_mtype == MAT_DIELECTRIC
    is_light = w_mtype == MAT_DIFFUSE_LIGHT

    # ---- scatter ----
    bx, by, bz = unit_ball(seed, pixel, sample, bounce, qmc)

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
    u_refl = smp.uniform(seed, pixel, sample, bounce, rng.DIEL_REFL)
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
    if nee is not None and nee.mis:
        # the balance heuristic on emission reached by a BSDF draw
        # (:1491-1515): alive = 2 + p_prev carries the previous bounce's
        # density; the emitter's light row (by its SceneTables row) gives
        # the area p_nee needs
        lights = nee.lights
        n_lights = lights.shape[0]
        srow = scene_rows(cull, family, row)
        match = ((lights[None, :, L_FAM] == family[:, None].to(torch.float32))
                 & (lights[None, :, L_ROW] == srow[:, None].to(torch.float32)))
        area_h = torch.where(match, lights[None, :, L_AREA], 0.0).sum(-1)
        vx_ = px_ - ox
        vy_ = py_ - oy
        vz_ = pz_ - oz
        d2h = torch.clamp(vx_ * vx_ + vy_ * vy_ + vz_ * vz_, min=1e-8)
        cos_lh = torch.abs(nx * vx_ + ny2 * vy_ + nz * vz_) / torch.sqrt(d2h)
        p_nh = d2h / (torch.clamp(area_h * float(n_lights), min=1e-8)
                      * torch.clamp(cos_lh, min=1e-6))
        p_prev = torch.clamp(alive - 2.0, min=0.0)
        w_bh = torch.where(p_prev > 0.0,
                           p_prev / (p_prev + p_nh + 1e-20), 1.0)
        em_scale = em_scale * w_bh
    elif nee is not None:
        # emission reached through a light-sampled bounce (alive 0.5)
        # was counted by that bounce's light sample
        em_scale = torch.where(alive == 0.5, 0.0, em_scale)
    cr = cr + tpr * (em_scale * alb_r + torch.where(missed, bgr, 0.0))
    cg = cg + tpg * (em_scale * alb_g + torch.where(missed, bgg, 0.0))
    cb = cb + tpb * (em_scale * alb_b + torch.where(missed, bgb, 0.0))

    nee_out = {}
    if nee is not None:
        # the lanes that sample a light: lambertian ones, and with
        # glossy the metal ones of fuzz > 0
        sampled = (is_lam | (is_met & (fuzz > 0.0)) if nee.glossy
                   else is_lam)
        (cr, cg, cb), nee_out = _nee_block(
            tab, fam, nee, (cr, cg, cb), (tpr, tpg, tpb),
            (alb_r, alb_g, alb_b), scattered & sampled, is_met, fuzz,
            (ref_x, ref_y, ref_z), (px_, py_, pz_), (nx, ny2, nz), pixel,
            sample, bounce, seed, t_min, img, qmc, cull)
        nee_out["em_scale"] = em_scale

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
    if nee is not None:
        if nee.mis:
            # alive = 2 + the density of the draw just taken (:1838-1866)
            ndl = torch.sqrt(new_dx * new_dx + new_dy * new_dy
                             + new_dz * new_dz)
            inl = 1.0 / torch.clamp(ndl, min=1e-12)
            csd = torch.clamp((nx * new_dx + ny2 * new_dy + nz * new_dz)
                              * inl, min=0.0)
            pb_next = (2.0 / math.pi) * csd * csd * csd
            if nee.glossy:
                cr_n = (ref_x * new_dx + ref_y * new_dy + ref_z * new_dz) \
                    * inl
                pb_next = torch.where(is_met & (fuzz > 0.0),
                                      _glossy_density(cr_n, fuzz), pb_next)
            mark = 2.0 + pb_next
        else:
            mark = torch.full_like(alive, 0.5)   # :1867-1875
        alive = torch.where(scattered, torch.where(sampled, mark, 1.0), 0.0)
    else:
        alive = scattered.to(torch.float32)
    out = torch.stack([ox, oy, oz, dx, dy, dz, tpr, tpg, tpb, cr, cg, cb,
                       alive])
    return Bounce(state=out, hit=hit, family=family, row=row,
                  scattered=scattered,
                  emitter=emitter,
                  missed=missed, is_die=is_die, use2=use2,
                  slot=attrs[:, X_SLOT].long(), att=(att_r, att_g, att_b),
                  tp=tp_before, **nee_out, **img_out)


def _glossy_density(cosr, fuzz):
    """The fuzz-ball density about the mirror direction, in the kernels'
    arithmetic (pallas_mega.py:1675-1684, :1853-1861; the wavefront's is
    render/integrator._glossy_pdf). fuzz^3 is multiplied out as
    fuzz * (fuzz * fuzz), XLA's integer_pow."""
    s2 = fuzz * fuzz - (1.0 - cosr * cosr)
    inside = (cosr > 0.0) & (s2 > 0.0) & (fuzz > 0.0)
    sq = torch.sqrt(torch.clamp(s2, min=0.0))
    f = torch.clamp(fuzz, min=1e-8)
    den = (2.0 * math.pi) * (f * (f * f))
    return torch.where(inside, sq * (3.0 * cosr * cosr + s2) / den, 0.0)


def _nee_block(tab, fam, nee: Nee, c, tp, alb, lam_lane, is_met, fuzz, ref,
               p, n, pixel, sample, bounce, seed, t_min, img=None, qmc=False,
               cull=None):
    """The kernels' NEE block (pallas_mega.py:1529-1698): sample one
    light, test its shadow segment, add tp * albedo * Le * w to the
    radiance c of the lanes lam_lane; with img, an image-textured light's
    Le is the atlas texel at the light point's (u, v) (:1623-1664).
    Returns (c, the Bounce's NEE fields)."""
    lights = nee.lights
    n_lights = lights.shape[0]
    smp = sampler(qmc)
    u_pick = smp.uniform(seed, pixel, sample, bounce, rng.NEE_PICK)
    u1 = smp.uniform(seed, pixel, sample, bounce, rng.NEE_U1)
    u2 = smp.uniform(seed, pixel, sample, bounce, rng.NEE_U2)
    li = torch.clamp((u_pick * n_lights).to(torch.int32), max=n_lights - 1)
    # [NL_COLS, B]: columns as mega_tables' module doc (the sampling
    # block at the reference's columns 9..23)
    lt = lights[li.long()].T
    fam_l, area_l = lt[L_FAM], lt[L_AREA]
    phi = (2.0 * math.pi) * u2
    cphi = torch.cos(phi)
    sphi = torch.sin(phi)
    # sphere sample
    zs = 1.0 - 2.0 * u1
    sts = torch.sqrt(torch.clamp(1.0 - zs * zs, min=0.0))
    nsx, nsy, nsz = sts * cphi, sts * sphi, zs
    spx = lt[9] + lt[12] * nsx
    spy = lt[10] + lt[12] * nsy
    spz = lt[11] + lt[12] * nsz
    # rect sample
    ra = lt[18] + u1 * lt[20]
    rb = lt[19] + u2 * lt[21]
    rpx = lt[9] * lt[22] + lt[12] * ra + lt[15] * rb
    rpy = lt[10] * lt[22] + lt[13] * ra + lt[16] * rb
    rpz = lt[11] * lt[22] + lt[14] * ra + lt[17] * rb
    # cylinder sample (o2w rows 9..17, translation 18..20)
    zc = lt[22] + u1 * lt[23]
    cox = lt[21] * cphi
    coy = lt[21] * sphi
    cpx = lt[9] * cox + lt[10] * coy + lt[11] * zc + lt[18]
    cpy = lt[12] * cox + lt[13] * coy + lt[14] * zc + lt[19]
    cpz = lt[15] * cox + lt[16] * coy + lt[17] * zc + lt[20]
    cnx = lt[9] * cphi + lt[10] * sphi
    cny = lt[12] * cphi + lt[13] * sphi
    cnz = lt[15] * cphi + lt[16] * sphi
    # triangle sample: v1 + b2 e1 + b3 e2, the sqrt barycentric warp
    sqt = torch.sqrt(u1)
    b2t = sqt * (1.0 - u2)
    b3t = sqt * u2
    tpx = lt[9] + b2t * lt[12] + b3t * lt[15]
    tpy = lt[10] + b2t * lt[13] + b3t * lt[16]
    tpz = lt[11] + b2t * lt[14] + b3t * lt[17]

    is_sl = fam_l == FAM_SPHERE
    is_rl = fam_l == FAM_RECT
    is_cl = fam_l == FAM_CYLINDER

    def by_family(sv, rv, cv, tv):
        return torch.where(is_sl, sv, torch.where(is_rl, rv,
                                                  torch.where(is_cl, cv, tv)))

    lpx = by_family(spx, rpx, cpx, tpx)
    lpy = by_family(spy, rpy, cpy, tpy)
    lpz = by_family(spz, rpz, cpz, tpz)
    lnx = by_family(nsx, lt[9], cnx, lt[18])
    lny = by_family(nsy, lt[10], cny, lt[19])
    lnz = by_family(nsz, lt[11], cnz, lt[20])

    px_, py_, pz_ = p
    nx, ny2, nz = n
    wix = lpx - px_
    wiy = lpy - py_
    wiz = lpz - pz_
    d2l = torch.clamp(wix * wix + wiy * wiy + wiz * wiz, min=1e-8)
    distl = torch.sqrt(d2l)
    cos_s = (nx * wix + ny2 * wiy + nz * wiz) / distl
    cos_lg = torch.abs(lnx * wix + lny * wiy + lnz * wiz) / distl

    need = lam_lane & (cos_s > 0.0)
    occ = torch.zeros_like(need)
    idx = torch.nonzero(need)[:, 0]
    if idx.numel():
        occ[idx] = shadow_occluded(tab, px_[idx], py_[idx], pz_[idx],
                                   wix[idx], wiy[idx], wiz[idx], t_min, fam,
                                   cull)

    # a checker light's parity at the sample point
    sin_l = (torch.sin(10.0 * lpx) * torch.sin(10.0 * lpy)
             * torch.sin(10.0 * lpz))
    use_odd = (lt[L_CHECKER] > 0.0) & (sin_l < 0.0)
    le = tuple(torch.where(use_odd, lt[L_LE2 + j], lt[L_LE + j])
               for j in range(3))
    out = {}
    if img is not None:
        # the light point's (u, v) in its family's hit convention
        s_ul, s_vl = sphere_uv(nsx, nsy, nsz)
        c_ul = (torch.atan2(sphi, cphi) + 2.0 * math.pi) * INV_4PI
        b1t = 1.0 - sqt
        t_ul = b1t * lt[L_UV] + b2t * lt[L_UV + 2] + b3t * lt[L_UV + 4]
        t_vl = b1t * lt[L_UV + 1] + b2t * lt[L_UV + 3] + b3t * lt[L_UV + 5]
        ltexel, rgb = texels(img, lt[L_IMG], by_family(s_ul, u1, c_ul, t_ul),
                             by_family(s_vl, u2, u1, t_vl))
        le = tuple(torch.where(ltexel >= 0, rgb[j], le[j]) for j in range(3))
        out["ltexel"] = ltexel

    cs_ = torch.clamp(cos_s, min=0.0)
    if nee.mis or nee.glossy:
        p_bl = (2.0 / math.pi) * cs_ * cs_ * cs_
        if nee.glossy:
            ref_x, ref_y, ref_z = ref
            cosr_l = (ref_x * wix + ref_y * wiy + ref_z * wiz) / distl
            p_bl = torch.where(is_met, _glossy_density(cosr_l, fuzz), p_bl)
        p_nl = d2l / (torch.clamp(area_l * float(n_lights), min=1e-8)
                      * torch.clamp(cos_lg, min=1e-6))
        if nee.mis:
            w_l = p_bl / (p_nl + p_bl + 1e-20)
        else:
            w_l = p_bl / torch.clamp(p_nl, min=1e-20)
    else:
        w_l = ((cs_ * cs_ * cs_ * cos_lg / d2l) * area_l
               * (2.0 * n_lights / math.pi))
    okl = torch.where(need & ~occ, w_l, 0.0)
    c = tuple(ck + tk * ak * lk * okl
              for ck, tk, ak, lk in zip(c, tp, alb, le))
    return c, dict(okl=okl, le=le, lslot=lt[L_SLOT].long(), lodd=use_odd,
                   **out)


def capture_plain(tab, state, pixel, sample, seed, max_depth, *, t_min,
                  p_rr, grad_bg, bg, fam=None, img=None, qmc=False,
                  cull=None):
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
    kernel evaluates the hit on every lane (under culling the lane
    visits the chunks its own ray meets). death[i] is the number of
    bounces after which the lane is still alive. The row is the winner's
    SceneTables row (scene_rows: a Morton-sorted row maps back to it).
    `state` is not changed. img (image textures) is taken and not read:
    no code or death depends on a texel."""
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
                          p_rr=p_rr, grad_bg=grad_bg, bg=bg, fam=fam,
                          qmc=qmc, cull=cull)
        codes[k, idx] = torch.where(
            bn.hit, (bn.family << 24) | scene_rows(cull, bn.family, bn.row),
            -1).to(torch.int32)
        keep = bn.scattered
        idx, sub = idx[keep], bn.state[:, keep]
        death[idx] += 1
    return codes, death


def trace_options(tables, cfg) -> dict:
    """The per-trace options of a segment, a queue launch and their
    adjoints, from the scene and the configuration (exhaust_bg aside):
    the scalars, the family tables (MegaScene.fam), the image atlas with
    the UV tables (MegaScene.img), the sampler and the chunk boxes
    (MegaScene.cull) of mega_tables.scene_for(tables, cfg), whose sphere
    table goes with them."""
    ms = scene_for(tables, cfg)
    return dict(t_min=1e-3, p_rr=float(cfg.p_rr),
                grad_bg=cfg.background_mode == "gradient",
                bg=ms.bg, fam=ms.fam, img=ms.img, qmc=cfg.sampler == "qmc",
                cull=ms.cull)


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
                exhaust_bg=False, depth=None, fam=None, img=None, qmc=False,
                cull=None):
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
    floats. fam, img, qmc, cull: as do_bounce_plain (qmc also for the
    camera rays). state, samp and
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
                                    pyl[idx], sample, seed, defocus,
                                    "qmc" if qmc else "rng")

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
                t_min=t_min, p_rr=p_rr, grad_bg=grad_bg, bg=bg, fam=fam,
                img=img, qmc=qmc, cull=cull)
            if depth is not None:
                depth[idx[li]] += 1
        sub[:, idx] = st
        sm[idx] = s_
        bv[idx] = b_ + 1
    samp[:n] = sm.to(samp.dtype)
    bvec[:n] = bv.to(bvec.dtype)
    return state, samp, bvec
