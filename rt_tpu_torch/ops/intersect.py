"""Closest hit over the flat SoA scene tables (rt_tpu/ops/intersect.py):
the wavefront engines' intersector.

Closest-hit semantics reproduce the reference scan, including its
tie-break: hittable_list::hit accepts a new hit when `t <= closest_so_far`
(gpu-version/object.cuh:23-37), so on an exact t tie the LATER object
wins. Within a family the reduction is "min t, ties -> larger row";
across families an equal t goes to the larger scene object index, as
rt_tpu's wavefront does (intersect.py:411-416; the megakernels break it
by the later family instead, ROADMAP C-9).

Each family's candidates are [B,N] tensors in PyTorch, in the
reference's expressions: spheres (object.cuh:47-75), axis-aligned rects
(:96-197), cylinders in object space (:233-290) and one-sided-normal
triangles (taichi-version/hittable.py:38-71). engine="pallas" runs the
sphere pass on the hand-written CUDA closest-hit kernel
(ops/cuda_intersect.py, B1; on a CPU tensor its plain version) and the
other families in PyTorch, as rt_tpu's hybrid does. traversal="bvh"
walks the threaded BVH (accel/bvh.py) of each family that carries one
(tables.bvh_for) with that family's leaf test instead, on every engine
(rt_tpu intersect.py:353-420); the walk keeps the first of equal hits in
traversal order where the scan keeps the last row. Families a scene
does not use (tables.counts) are skipped. Hit attributes are recomputed
for each ray's winner only, with an indexed gather where the reference
uses a one-hot MXU contraction. The cylinder's hit point is
o2w(w2o(o) + t w2o(d)), as rt_tpu's wavefront has it (the megakernels
take o + t d, ROADMAP C-10).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from rt_tpu_torch.ops import geometry as geom
from rt_tpu_torch.scene.types import SceneTables

INF = float("inf")

PTYPE_SPHERE = 0
PTYPE_RECT = 1
PTYPE_CYLINDER = 2
PTYPE_TRIANGLE = 3


class Hit(NamedTuple):
    hit: torch.Tensor         # [B] bool
    t: torch.Tensor           # [B] f32 (inf on miss)
    ptype: torch.Tensor       # [B] i32
    pid: torch.Tensor         # [B] i32 index within the type table
    obj: torch.Tensor         # [B] i32 original scene object index
    p: torch.Tensor           # [B,3] hit point
    normal: torch.Tensor      # [B,3] face normal (flipped toward the ray)
    front_face: torch.Tensor  # [B] bool
    u: torch.Tensor           # [B]
    v: torch.Tensor           # [B]
    mat: torch.Tensor         # [B] i32 material id


def _last_argmin(t):
    """argmin along the last dim, ties -> LARGEST index."""
    n = t.shape[-1]
    return (n - 1) - torch.argmin(t.flip(-1), dim=-1)


def _sphere_t(centers, radii, live, ro, rd, t_min):
    """Candidate t per (ray, sphere) [B,N]: the half-b quadratic, nearer
    root first (object.cuh:47-75); inf where there is no hit. The cross
    terms are written out per axis rather than as [B,3]@[3,N] products,
    so they are plain float32 on every device (no TF32 matmul path)."""
    cx, cy, cz = centers[None, :, 0], centers[None, :, 1], centers[None, :, 2]
    a = geom.length_squared(rd)[:, None]
    rd_dot_ro = geom.dot(rd, ro)[:, None]
    hb = rd_dot_ro - (rd[:, 0:1] * cx + rd[:, 1:2] * cy + rd[:, 2:3] * cz)
    ro_sq = geom.length_squared(ro)[:, None]
    c_term = (ro_sq - 2.0 * (ro[:, 0:1] * cx + ro[:, 1:2] * cy
                             + ro[:, 2:3] * cz)
              + (geom.length_squared(centers) - radii * radii)[None, :])
    disc = hb * hb - a * c_term
    sqrtd = geom.safe_sqrt(disc)
    root1 = (-hb - sqrtd) / a
    root2 = (-hb + sqrtd) / a
    t = torch.where(root1 >= t_min, root1,
                    torch.where(root2 >= t_min, root2, INF))
    t = torch.where(disc >= 0.0, t, INF)
    return torch.where(live[None, :], t, INF)


def sphere_leaf_test(tables: SceneTables, pid, ro, rd, t_min=1e-3):
    """Hit distance [B] of each ray against ONE known sphere, row pid [B]
    (rt_tpu ops/intersect.py `_sphere_leaf_test` :231-248): the half-b
    quadratic in the `oc = ro - c` form, nearer root first; inf where
    there is no hit. Differentiable in the sphere's centre and radius:
    the tape replay (diff/tape.py) recomputes each bounce's hit with it
    against the taped winner."""
    row = pid.long()
    c = geom.take_rows(tables.sph_center, row)
    r = geom.take_rows(tables.sph_radius, row)
    oc = ro - c
    a = geom.length_squared(rd)
    hb = geom.dot(oc, rd)
    ct = geom.length_squared(oc) - r * r
    disc = hb * hb - a * ct
    sqrtd = geom.safe_sqrt(disc)
    root1 = (-hb - sqrtd) / a
    root2 = (-hb + sqrtd) / a
    t = torch.where(root1 >= t_min, root1,
                    torch.where(root2 >= t_min, root2, INF))
    return torch.where(disc >= 0.0, t, INF)


def rect_leaf_test(tables: SceneTables, pid, ro, rd, t_min=1e-3):
    """Hit distance [B] of each ray against ONE known rect, row pid [B]
    (rt_tpu ops/intersect.py `_rect_leaf_test` :279-304): the constant
    and free axes picked per lane by index; inf where there is no hit.
    Differentiable in rect_k, rect_lo and rect_hi."""
    row = pid.long()
    a = tables.rect_axis[row].long()
    k = geom.take_rows(tables.rect_k, row)
    lo = geom.take_rows(tables.rect_lo, row)
    hi = geom.take_rows(tables.rect_hi, row)
    f1 = torch.where(a == 0, 1, 0)
    f2 = torch.where(a == 2, 1, 2)

    def take(v, idx):
        return torch.gather(v, 1, idx[:, None])[:, 0]

    ro_k = take(ro, a)
    rd_k = take(rd, a)
    t = geom.safe_div(k - ro_k, rd_k)
    x = take(ro, f1) + t * take(rd, f1)
    y = take(ro, f2) + t * take(rd, f2)
    valid = ((t >= t_min) & (rd_k != 0.0)
             & (x >= lo[:, 0]) & (x <= hi[:, 0])
             & (y >= lo[:, 1]) & (y <= hi[:, 1]))
    return torch.where(valid, t, INF)


def cylinder_leaf_test(tables: SceneTables, pid, ro, rd, t_min=1e-3):
    """Hit distance [B] of each ray against ONE known cylinder, row pid
    [B] (`_cylinder_leaf_test` :307-336): the ray in object space, the
    radial quadratic, the nearer root in the z window first.
    Differentiable in cyl_radius, cyl_zmin and cyl_zmax."""
    row = pid.long()
    w2o = geom.take_rows(tables.cyl_w2o, row)
    oo = geom.apply_point(w2o, ro)
    od = geom.apply_vec(w2o, rd)
    r = geom.take_rows(tables.cyl_radius, row)
    zmin = geom.take_rows(tables.cyl_zmin, row)
    zmax = geom.take_rows(tables.cyl_zmax, row)
    a = od[:, 0] ** 2 + od[:, 1] ** 2
    b = 2.0 * (od[:, 0] * oo[:, 0] + od[:, 1] * oo[:, 1])
    c = oo[:, 0] ** 2 + oo[:, 1] ** 2 - r * r
    delta = b * b - 4.0 * a * c
    sq = geom.safe_sqrt(delta)
    t0 = geom.safe_div(-0.5 * (b - sq), a)
    t1 = geom.safe_div(-0.5 * (b + sq), a)
    t0, t1 = torch.minimum(t0, t1), torch.maximum(t0, t1)

    def zok(t):
        pz = oo[:, 2] + t * od[:, 2]
        return (pz >= zmin) & (pz <= zmax)

    ok0 = (t0 >= t_min) & zok(t0) & (a != 0.0)
    ok1 = (t1 >= t_min) & zok(t1) & (a != 0.0)
    t = torch.where(ok0, t0, torch.where(ok1, t1, INF))
    return torch.where(delta >= 0.0, t, INF)


def triangle_leaf_test(tables: SceneTables, pid, ro, rd, t_min=1e-3):
    """Hit distance [B] of each ray against ONE known triangle, row pid
    [B] (`_triangle_leaf_test` :251-276): the plane distance signed
    toward the origin's side, the three strict edge tests, only rays
    heading into the plane. Differentiable in tri_v1, tri_v2 and tri_v3
    (the normal is the table's tri_n, as the reference's)."""
    row = pid.long()
    v1 = geom.take_rows(tables.tri_v1, row)
    v2 = geom.take_rows(tables.tri_v2, row)
    v3 = geom.take_rows(tables.tri_v3, row)
    n0 = geom.take_rows(tables.tri_n, row)
    oc_n = geom.dot(ro - v1, n0)
    sign = torch.where(oc_n < 0.0, -1.0, 1.0)
    d_n = geom.dot(rd, n0) * sign
    oc_n = oc_n * sign
    a = geom.length(rd)
    theta = d_n / a
    root = geom.safe_div(-oc_n, theta * a)
    r_pt = ro + root[:, None] * rd

    def side(va, vb):
        return geom.dot(geom.cross(vb - va, r_pt - va), n0)

    s1, s2, s3 = side(v1, v2), side(v2, v3), side(v3, v1)
    inside = (((s1 > 0) & (s2 > 0) & (s3 > 0))
              | ((s1 < 0) & (s2 < 0) & (s3 < 0)))
    valid = (theta < 0.0) & inside & (root >= t_min)
    return torch.where(valid, root, INF)


def _rect_free_axes(axis):
    """Const axis -> (free1, free2) ascending: 0->(1,2), 1->(0,2), 2->(0,1)."""
    f1 = torch.where(axis == 0, 1, 0)
    f2 = torch.where(axis == 2, 1, 2)
    return torch.stack([f1, f2], dim=-1)


def _rect_t(tables: SceneTables, ro, rd, t_min):
    """Candidate t per (ray, rect) [B,N], all three orientations at once
    (object.cuh:96-197): the constant axis and the free axes picked per
    row by index (the reference's one-hot products pick the same
    values)."""
    axis = tables.rect_axis.long()
    free = _rect_free_axes(axis)
    ro_k, rd_k = ro[:, axis], rd[:, axis]
    t = geom.safe_div(tables.rect_k[None, :] - ro_k, rd_k)
    x = ro[:, free[:, 0]] + t * rd[:, free[:, 0]]
    y = ro[:, free[:, 1]] + t * rd[:, free[:, 1]]
    valid = ((t >= t_min)
             & (x >= tables.rect_lo[None, :, 0])
             & (x <= tables.rect_hi[None, :, 0])
             & (y >= tables.rect_lo[None, :, 1])
             & (y <= tables.rect_hi[None, :, 1])
             & (tables.rect_obj >= 0)[None, :]
             & (rd_k != 0.0))
    return torch.where(valid, t, INF)


def _cylinder_t(tables: SceneTables, ro, rd, t_min):
    """Candidate t per (ray, cylinder) [B,N]: the ray in object space,
    the radial quadratic on (x, y), the z window with the nearer root
    first (object.cuh:233-290)."""
    w2o = tables.cyl_w2o[None]                     # [1,N,4,4]
    oo = geom.apply_point(w2o, ro[:, None, :])     # [B,N,3]
    od = geom.apply_vec(w2o, rd[:, None, :])
    a = od[..., 0] ** 2 + od[..., 1] ** 2
    b = 2.0 * (od[..., 0] * oo[..., 0] + od[..., 1] * oo[..., 1])
    c = oo[..., 0] ** 2 + oo[..., 1] ** 2 - tables.cyl_radius[None, :] ** 2
    delta = b * b - 4.0 * a * c
    sq = geom.safe_sqrt(delta)
    t0 = geom.safe_div(-0.5 * (b - sq), a)
    t1 = geom.safe_div(-0.5 * (b + sq), a)
    t0, t1 = torch.minimum(t0, t1), torch.maximum(t0, t1)

    def zok(t):
        pz = oo[..., 2] + t * od[..., 2]
        return ((pz >= tables.cyl_zmin[None, :])
                & (pz <= tables.cyl_zmax[None, :]))

    ok0 = (t0 >= t_min) & zok(t0) & (a != 0.0)
    ok1 = (t1 >= t_min) & zok(t1) & (a != 0.0)
    t = torch.where(ok0, t0, torch.where(ok1, t1, INF))
    return torch.where((delta >= 0.0) & (tables.cyl_obj >= 0)[None, :], t,
                       INF)


def _edge_inside(r_pt, v1, v2, v3, n):
    """Point-in-triangle: cross(edge, r - vi) . n of one sign for all
    three edges; strict, as the reference's `> 0`."""
    def side(va, vb):
        e = (vb - va)[None, :, :]
        w = r_pt - va[None, :, :]
        return geom.dot(geom.cross(e, w), n[None, :, :])

    s1, s2, s3 = side(v1, v2), side(v2, v3), side(v3, v1)
    return (((s1 > 0) & (s2 > 0) & (s3 > 0))
            | ((s1 < 0) & (s2 < 0) & (s3 < 0)))


def _triangle_t(tables: SceneTables, ro, rd, t_min):
    """Candidate t per (ray, triangle) [B,N] (hittable.py:38-71): the
    normal flipped toward the ray origin's side; a hit needs the ray to
    head toward the plane and the point inside all three edges."""
    v1, v2, v3 = tables.tri_v1, tables.tri_v2, tables.tri_v3
    n0 = tables.tri_n

    def dot_n(v):  # [B,3] . [N,3] -> [B,N], per axis
        return (v[:, None, 0] * n0[None, :, 0] + v[:, None, 1] * n0[None, :, 1]
                + v[:, None, 2] * n0[None, :, 2])

    oc_n = dot_n(ro) - geom.dot(v1, n0)[None, :]
    sign = torch.where(oc_n < 0.0, -1.0, 1.0)
    d_n = dot_n(rd) * sign
    oc_n = oc_n * sign
    a = geom.length(rd)[:, None]
    theta = d_n / a
    root = geom.safe_div(-oc_n, theta * a)
    r_pt = ro[:, None, :] + root[..., None] * rd[:, None, :]
    valid = ((theta < 0.0) & _edge_inside(r_pt, v1, v2, v3, n0)
             & (root >= t_min) & (tables.tri_obj >= 0)[None, :])
    return torch.where(valid, root, INF)


def _best_of(t, obj_table):
    """Per-ray (t, pid, obj) of the best candidate of one family."""
    pid = _last_argmin(t)
    tb = torch.gather(t, 1, pid[:, None])[:, 0]
    return tb, pid.to(torch.int32), obj_table[pid]


def _sphere_best(tables: SceneTables, ro, rd, t_min, engine: str):
    """Per-ray (t, pid, obj) of the closest sphere."""
    from rt_tpu_torch.ops import cuda_intersect

    fn = (cuda_intersect.sphere_closest_hit if engine == "pallas"
          else cuda_intersect.sphere_closest_hit_plain)
    t, pid = fn(tables.sph_center, tables.sph_radius, tables.sph_obj >= 0,
                ro, rd, t_min=float(t_min))
    return t, pid, tables.sph_obj[pid.long()]


# per family with a BVH: (field prefix, leaf test, the table fields the
# leaf test reads)
_BVH_LEAF = {
    "sphere": ("sph", sphere_leaf_test, ("sph_center", "sph_radius")),
    "rect": ("rect", rect_leaf_test, ("rect_k", "rect_lo", "rect_hi")),
    "cylinder": ("cyl", cylinder_leaf_test,
                 ("cyl_w2o", "cyl_radius", "cyl_zmin", "cyl_zmax")),
    "triangle": ("tri", triangle_leaf_test,
                 ("tri_v1", "tri_v2", "tri_v3", "tri_n")),
}


class _NoReverse(torch.autograd.Function):
    """Identity whose backward raises: reverse mode stops at a walked
    hit distance where the reference's lax.while_loop cannot be
    transposed, that is where a cotangent reaches it."""

    @staticmethod
    def forward(ctx, t, family):
        ctx.family = family
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        raise ValueError(
            f"traversal='bvh': reverse-mode gradients cannot pass through "
            f"the {ctx.family} BVH walk, as the reference's cannot (rt_tpu/"
            "accel/bvh.py walks with lax.while_loop, which reverse mode "
            "cannot differentiate); use traversal='linear', method "
            "'replay' or 'tape', or the finite-difference estimators")


def _best_bvh(tables: SceneTables, family: str, ro, rd, t_min):
    """Per-ray (t, pid, obj) of the closest primitive of `family` by its
    BVH walk (rt_tpu intersect.py `_best_bvh` :338-350).

    The walk runs without autograd on detached inputs; the winner's hit
    distance is then recomputed by the leaf test on the inputs as given
    (the same expression on the same values, so the same bits), and
    carries forward-mode tangents as the reference's jvp of its walk
    does. Reverse mode through the walk is refused where the reference
    refuses it, when a gradient reaches the walked t (_NoReverse); a
    gradient that reaches only the hit's attributes (or none) passes, as
    there."""
    from rt_tpu_torch.accel.bvh import traverse

    prefix, leaf, fields = _BVH_LEAF[family]
    fixed = dataclasses.replace(tables, **{
        f: getattr(tables, f).detach() for f in fields})
    t, pid = traverse(tables.bvh_arrays(prefix), ro, rd, t_min,
                      lambda p, o, d, tm: leaf(fixed, p, o, d, tm))
    t = torch.where(torch.isfinite(t), leaf(tables, pid, ro, rd, t_min), INF)
    if t.requires_grad:
        t = _NoReverse.apply(t, family)
    return t, pid, getattr(tables, f"{prefix}_obj")[pid.long()]


def intersect(tables: SceneTables, ro, rd, t_min=1e-3,
              engine: str = "plain", traversal: str = "linear") -> Hit:
    """Closest hit of rays (ro, rd) [B,3] against the scene.

    t_min defaults to the reference's shadow-acne epsilon 0.001
    (gpu-version/main.cu:45). traversal="bvh" walks the BVH of every
    family in tables.bvh_for (before the sphere kernel of "pallas", as
    the reference does)."""
    n_sph, n_rect, n_cyl, n_tri = tables.counts

    def walks(family):
        return traversal == "bvh" and family in tables.bvh_for

    cands = []
    if n_sph:
        cands.append((PTYPE_SPHERE,) + (
            _best_bvh(tables, "sphere", ro, rd, t_min) if walks("sphere")
            else _sphere_best(tables, ro, rd, t_min, engine)))
    if n_rect:
        cands.append((PTYPE_RECT,) + (
            _best_bvh(tables, "rect", ro, rd, t_min) if walks("rect")
            else _best_of(_rect_t(tables, ro, rd, t_min), tables.rect_obj)))
    if n_cyl:
        cands.append((PTYPE_CYLINDER,) + (
            _best_bvh(tables, "cylinder", ro, rd, t_min)
            if walks("cylinder") else
            _best_of(_cylinder_t(tables, ro, rd, t_min), tables.cyl_obj)))
    if n_tri:
        cands.append((PTYPE_TRIANGLE,) + (
            _best_bvh(tables, "triangle", ro, rd, t_min)
            if walks("triangle") else
            _best_of(_triangle_t(tables, ro, rd, t_min), tables.tri_obj)))

    b = ro.shape[0]
    dev = ro.device
    best_t = torch.full((b,), INF, device=dev)
    best_ptype = torch.zeros((b,), dtype=torch.int32, device=dev)
    best_pid = torch.zeros((b,), dtype=torch.int32, device=dev)
    best_obj = torch.full((b,), -1, dtype=torch.int32, device=dev)
    for ptype, t, pid, obj in cands:
        take = (t < best_t) | ((t == best_t) & (obj > best_obj))
        best_t = torch.where(take, t, best_t)
        best_ptype = torch.where(take, ptype, best_ptype)
        best_pid = torch.where(take, pid, best_pid)
        best_obj = torch.where(take, obj, best_obj)

    hit = torch.isfinite(best_t)
    return _attributes(tables, ro, rd, hit, best_t, best_ptype, best_pid,
                       best_obj)


def occluded(tables: SceneTables, ro, rd, t_max, t_min=1e-3,
             engine: str = "plain"):
    """Any-hit query of the NEE shadow ray (rt_tpu ops/intersect.py
    `occluded` :219-228): whether the closest hit lies in (t_min, t_max),
    strictly below t_max. Returns [B] bool. rd need not be normalised;
    t_max is in units of |rd|, like every other t here. It tests every
    row (no BVH), as the reference's does."""
    h = intersect(tables, ro, rd, t_min=t_min, engine=engine)
    return h.hit & (h.t < t_max)


def _sphere_attrs(tables: SceneTables, row, p_lin):
    """Outward normal, hit point, (u, v) and material of the winning
    sphere (object.cuh:67-73, UV at :87-93)."""
    sc = geom.take_rows(tables.sph_center, row)
    sr = geom.take_rows(tables.sph_radius, row)
    outward = (p_lin - sc) / torch.where(sr == 0.0, 1.0, sr)[:, None]
    cos_t = torch.clamp(-outward[:, 1], -1.0, 1.0)
    interior = torch.abs(cos_t) < 1.0
    theta = torch.where(
        interior,
        torch.acos(torch.where(interior, cos_t, 0.0)),
        torch.where(cos_t > 0.0, 0.0, math.pi))
    az_deg = (outward[:, 2] == 0.0) & (outward[:, 0] == 0.0)
    phi = torch.atan2(-outward[:, 2],
                      torch.where(az_deg, 1.0, outward[:, 0])) + math.pi
    return (outward, p_lin, phi / (2 * math.pi), theta / math.pi,
            tables.sph_mat[row])


def _rect_attrs(tables: SceneTables, row, p_lin):
    """The winning rect's (object.cuh:105-197): the constant axis as the
    normal, (u, v) across the rect's extent."""
    axis = tables.rect_axis[row].long()
    free = _rect_free_axes(axis)
    outward = torch.nn.functional.one_hot(axis, 3).to(p_lin.dtype)
    x = torch.gather(p_lin, 1, free[:, :1])[:, 0]
    y = torch.gather(p_lin, 1, free[:, 1:])[:, 0]
    lo = geom.take_rows(tables.rect_lo, row)
    hi = geom.take_rows(tables.rect_hi, row)
    return (outward, p_lin, (x - lo[:, 0]) / (hi[:, 0] - lo[:, 0]),
            (y - lo[:, 1]) / (hi[:, 1] - lo[:, 1]), tables.rect_mat[row])


def _cylinder_attrs(tables: SceneTables, row, ro, rd, t_safe):
    """The winning cylinder's (object.cuh:261-289): the hit point
    o2w(w2o(o) + t w2o(d)), the radial normal through the inverse
    transpose, (u, v) from the azimuth and the z window."""
    w2o, o2w = tables.cyl_w2o[row], tables.cyl_o2w[row]
    op = (geom.apply_point(w2o, ro)
          + t_safe[:, None] * geom.apply_vec(w2o, rd))
    on = torch.cat([op[:, :2], torch.zeros_like(op[:, :1])], dim=-1)
    on_len = geom.safe_length(on)
    on = on / torch.where(on_len == 0.0, 1.0, on_len)[:, None]
    zmin = geom.take_rows(tables.cyl_zmin, row)
    zmax = geom.take_rows(tables.cyl_zmax, row)
    deg = (op[:, 1] == 0.0) & (op[:, 0] == 0.0)
    phi = torch.atan2(op[:, 1], torch.where(deg, 1.0, op[:, 0])) \
        + 2 * math.pi
    return (geom.apply_normal(w2o, on), geom.apply_point(o2w, op),
            phi / (4 * math.pi),
            (op[:, 2] - zmin) / torch.where(zmax == zmin, 1.0, zmax - zmin),
            tables.cyl_mat[row])


def _triangle_attrs(tables: SceneTables, row, p_lin):
    """The winning triangle's (hittable.py:258-262): its geometric
    normal; (u, v) by the standard barycentric weights (the swapped
    weights of the Taichi reference come from SceneDef.taichi_tri_uv)."""
    tv1, tv2, tv3 = (geom.take_rows(tables.tri_v1, row),
                     geom.take_rows(tables.tri_v2, row),
                     geom.take_rows(tables.tri_v3, row))
    area2 = geom.safe_length(geom.cross(tv2 - tv1, tv3 - tv1))
    area2 = torch.where(area2 == 0.0, 1.0, area2)
    l1 = geom.safe_length(geom.cross(tv2 - p_lin, tv3 - p_lin)) / area2
    l2 = geom.safe_length(geom.cross(tv3 - p_lin, tv1 - p_lin)) / area2
    l3 = torch.clamp(1.0 - l1 - l2, min=0.0)
    uv = (tables.tri_uv1[row] * l1[:, None] + tables.tri_uv2[row] * l2[:, None]
          + tables.tri_uv3[row] * l3[:, None])
    return tables.tri_n[row], p_lin, uv[:, 0], uv[:, 1], tables.tri_mat[row]


def _attributes(tables: SceneTables, ro, rd, hit, t, ptype, pid, obj) -> Hit:
    """Hit-record fields for each ray's winner: each present family's
    for every lane, selected by the winner's family."""
    t_safe = torch.where(hit, t, 1.0)
    p_lin = ro + t_safe[:, None] * rd  # ray.at

    n_sph, n_rect, n_cyl, n_tri = tables.counts
    row = pid.long()

    def rows(fam):
        """The winner's row where it is of family fam, else row 0 (a row
        of another family's table may lie past this one's end)."""
        return torch.where(ptype == fam, row, 0)

    branches = []
    if n_sph:
        branches.append((PTYPE_SPHERE, _sphere_attrs(
            tables, rows(PTYPE_SPHERE), p_lin)))
    if n_rect:
        branches.append((PTYPE_RECT, _rect_attrs(
            tables, rows(PTYPE_RECT), p_lin)))
    if n_cyl:
        branches.append((PTYPE_CYLINDER, _cylinder_attrs(
            tables, rows(PTYPE_CYLINDER), ro, rd, t_safe)))
    if n_tri:
        branches.append((PTYPE_TRIANGLE, _triangle_attrs(
            tables, rows(PTYPE_TRIANGLE), p_lin)))

    if not branches:
        # empty scene: every ray misses (written out of place, so that
        # torch.func transforms can run through it)
        normal = torch.zeros_like(p_lin) + p_lin.new_tensor([0.0, 0.0, 1.0])
        zeros = torch.zeros_like(t_safe)
        return Hit(hit=torch.zeros_like(hit), t=t, ptype=ptype, pid=pid,
                   obj=obj, p=p_lin, normal=normal,
                   front_face=torch.ones_like(hit), u=zeros, v=zeros,
                   mat=torch.zeros_like(pid))

    # the last family present is the default, earlier ones selected by
    # the winner's family
    outward, p, u, v, mat = branches[-1][1]
    for fam, (o_, p_, u_, v_, m_) in reversed(branches[:-1]):
        is_f = ptype == fam
        outward = torch.where(is_f[:, None], o_, outward)
        p = torch.where(is_f[:, None], p_, p)
        u = torch.where(is_f, u_, u)
        v = torch.where(is_f, v_, v)
        mat = torch.where(is_f, m_, mat)

    # set_face_normal (hittable.cuh:16-23): flip toward the incoming ray
    front = geom.dot(rd, outward) < 0.0
    normal = torch.where(front[:, None], outward, -outward)
    return Hit(hit=hit, t=t, ptype=ptype, pid=pid, obj=obj, p=p,
               normal=normal, front_face=front, u=u, v=v,
               mat=torch.where(hit, mat, 0).to(torch.int32))
