"""Closest hit over the flat SoA scene tables (rt_tpu/ops/intersect.py).

Closest-hit semantics reproduce the reference scan, including its
tie-break: hittable_list::hit accepts a new hit when `t <= closest_so_far`
(gpu-version/object.cuh:23-37), so on an exact t tie the LATER object
wins. Reductions are therefore "min t, ties -> larger index".

engine="plain" computes the sphere candidates as [B,N] tensors in
PyTorch; engine="pallas" runs the hand-written CUDA closest-hit kernel
(ops/cuda_intersect.py), which on a CPU tensor uses the plain version.
Hit attributes are recomputed for each ray's winning sphere only, with
an indexed gather where the reference uses a one-hot MXU contraction.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from rt_tpu_torch.ops import geometry as geom
from rt_tpu_torch.scene.types import SceneTables

INF = float("inf")

PTYPE_SPHERE = 0  # family codes as rt_tpu's; rects, cylinders, triangles
                  # (1, 2, 3) come with their slice


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


def _sphere_best(tables: SceneTables, ro, rd, t_min, engine: str):
    """Per-ray (t, pid, obj) of the closest sphere."""
    from rt_tpu_torch.ops import cuda_intersect

    fn = (cuda_intersect.sphere_closest_hit if engine == "pallas"
          else cuda_intersect.sphere_closest_hit_plain)
    t, pid = fn(tables.sph_center, tables.sph_radius, tables.sph_obj >= 0,
                ro, rd, t_min=float(t_min))
    return t, pid, tables.sph_obj[pid.long()]


def intersect(tables: SceneTables, ro, rd, t_min=1e-3,
              engine: str = "plain") -> Hit:
    """Closest hit of rays (ro, rd) [B,3] against the scene.

    t_min defaults to the reference's shadow-acne epsilon 0.001
    (gpu-version/main.cu:45)."""
    b = ro.shape[0]
    dev = ro.device
    best_t = torch.full((b,), INF, device=dev)
    best_ptype = torch.zeros((b,), dtype=torch.int32, device=dev)
    best_pid = torch.zeros((b,), dtype=torch.int32, device=dev)
    best_obj = torch.full((b,), -1, dtype=torch.int32, device=dev)
    if tables.n_spheres:
        # one family in this slice; the merge is the reference's, which
        # later families join (same tie rule across families: larger obj)
        t, pid, obj = _sphere_best(tables, ro, rd, t_min, engine)
        take = (t < best_t) | ((t == best_t) & (obj > best_obj))
        best_t = torch.where(take, t, best_t)
        best_ptype = torch.where(take, PTYPE_SPHERE, best_ptype)
        best_pid = torch.where(take, pid, best_pid)
        best_obj = torch.where(take, obj, best_obj)

    hit = torch.isfinite(best_t)
    return _attributes(tables, ro, rd, hit, best_t, best_ptype, best_pid,
                       best_obj)


def _attributes(tables: SceneTables, ro, rd, hit, t, ptype, pid, obj) -> Hit:
    """Hit-record fields for each ray's winning sphere
    (object.cuh:67-73, UV at :87-93)."""
    t_safe = torch.where(hit, t, 1.0)
    p_lin = ro + t_safe[:, None] * rd  # ray.at

    if not tables.n_spheres:
        # empty scene: every ray misses (written out of place, so that
        # torch.func transforms can run through it)
        normal = torch.zeros_like(p_lin) + p_lin.new_tensor([0.0, 0.0, 1.0])
        zeros = torch.zeros_like(t_safe)
        return Hit(hit=torch.zeros_like(hit), t=t, ptype=ptype, pid=pid,
                   obj=obj, p=p_lin, normal=normal,
                   front_face=torch.ones_like(hit), u=zeros, v=zeros,
                   mat=torch.zeros_like(pid))

    row = pid.long()
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
    mat = tables.sph_mat[row]

    # set_face_normal (hittable.cuh:16-23): flip toward the incoming ray
    front = geom.dot(rd, outward) < 0.0
    normal = torch.where(front[:, None], outward, -outward)
    return Hit(hit=hit, t=t, ptype=ptype, pid=pid, obj=obj, p=p_lin,
               normal=normal, front_face=front, u=phi / (2 * math.pi),
               v=theta / math.pi,
               mat=torch.where(hit, mat, 0).to(torch.int32))
