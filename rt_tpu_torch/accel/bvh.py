"""BVH acceleration structure: host build, flat arrays, stackless walk
(the port of rt_tpu/accel/bvh.py).

The build is the reference's: median split over the longest centroid
axis, flattened in pre-order with threaded escape ("next") links, so a
walk needs one integer of state per ray (taichi-version/bvh.py:24-162).
It runs on the host, in C++ when the native library builds
(rt_tpu_torch/native/rt_native.cpp through io/native.py), else in the
same NumPy code as rt_tpu's `_python_build` (io/native.py warns once when
it falls back). The two give equal arrays except where centroids tie on
the split axis: std::nth_element and np.argpartition may order tied
primitives differently, so leaves can hold other ids; walks of either
tree give the same hit distances.

`traverse` is rt_tpu's two-phase walk (bvh.py:98-191) on torch tensors
on the rays' device: every ray carries its own node pointer `cur`; phase
A advances every lane through inner nodes and box-missed leaves with
slab tests against the running best until it stands on a box-hit leaf
(or has left the tree), phase B runs one batched leaf test, accepts a
strictly closer hit (so on an exact tie the first hit in traversal order
wins) and takes the leaf's escape link. The reference's XLA while-loops
become Python loops whose condition is a device-to-host read, one a
step. Phase A tests one box per lane a step (the reference tests the new
node's box again to decide whether the lane has settled; here a step in
which no lane moves ends the phase).

The walk records no autograd graph (the reference's lax.while_loop has
no transpose, so reverse mode cannot pass through it there either);
ops/intersect._best_bvh recomputes the winner's hit distance outside it,
which carries forward-mode tangents as the reference's jvp of the loop
does, and refuses reverse mode with a ValueError.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# the slab test's bound for a zero direction component (bvh.py:118)
BIG = 3.0e38
# phase A's "stay": a box-hit leaf
STOP = -2
# the walks' host reads of a loop condition, phase-A steps and leaf tests
# since the last reset (chip_smoke.py reads them beside its times)
COUNTS = {"host_reads": 0, "advance_steps": 0, "leaf_steps": 0}


class BVH(NamedTuple):
    """Flat threaded BVH; all arrays have 2n-1 rows (pre-order)."""

    obj_id: np.ndarray   # [M] i32, primitive id at leaves, -1 inner
    left_id: np.ndarray  # [M] i32 (== i+1 for inner nodes)
    next_id: np.ndarray  # [M] i32 escape link, -1 = done
    bmin: np.ndarray     # [M,3] f32
    bmax: np.ndarray     # [M,3] f32


def build_bvh(bmin: np.ndarray, bmax: np.ndarray) -> BVH:
    """Build from primitive AABBs [n,3]; native C++ when available."""
    bmin = np.asarray(bmin, np.float32)
    bmax = np.asarray(bmax, np.float32)
    from rt_tpu_torch.io.native import native_build_bvh

    res = native_build_bvh(bmin, bmax)
    if res is None:
        res = _python_build(bmin, bmax)
    return BVH(obj_id=res["obj_id"], left_id=res["left_id"],
               next_id=res["next_id"], bmin=res["bmin"], bmax=res["bmax"])


def _python_build(bmin: np.ndarray, bmax: np.ndarray) -> dict:
    """NumPy fallback, same layout/semantics as rt_native.cpp."""
    n = bmin.shape[0]
    m = 2 * n - 1
    centers = 0.5 * (bmin + bmax)
    obj_id = np.full(m, -1, np.int32)
    left_id = np.full(m, -1, np.int32)
    right_id = np.full(m, -1, np.int32)
    next_id = np.full(m, -1, np.int32)
    bmin_o = np.zeros((m, 3), np.float32)
    bmax_o = np.zeros((m, 3), np.float32)

    # (primitive ids, parent_next, slot) — iterative pre-order
    stack = [(np.arange(n), -1, 0)]
    while stack:
        idx, parent_next, s = stack.pop()
        bmin_o[s] = bmin[idx].min(0)
        bmax_o[s] = bmax[idx].max(0)
        next_id[s] = parent_next
        if idx.size == 1:
            obj_id[s] = idx[0]
            continue
        c = centers[idx]
        axis = int(np.argmax(c.max(0) - c.min(0)))
        half = idx.size // 2
        part = idx[np.argpartition(c[:, axis], half)]
        left_slot = s + 1
        right_slot = s + 1 + (2 * half - 1)
        left_id[s] = left_slot
        right_id[s] = right_slot
        stack.append((part[half:], parent_next, right_slot))
        stack.append((part[:half], right_slot, left_slot))
    return dict(obj_id=obj_id, left_id=left_id, right_id=right_id,
                next_id=next_id, bmin=bmin_o, bmax=bmax_o)


def traverse(bvh_arrays, ro, rd, t_min, leaf_test):
    """Vectorized stackless walk, two-phase (rt_tpu bvh.py `traverse`).

    bvh_arrays: dict of tensors on the rays' device (obj_id, left_id,
    next_id [M] integer, bmin [M,3], bmax [M,3]).
    leaf_test(prim_id [B] i64, ro, rd, t_min) -> t [B] (inf on miss):
    candidate t of primitive prim_id for each ray.

    Returns (t_best [B] f32 inf-on-miss, pid_best [B] i32), computed
    without autograd."""
    with torch.no_grad():
        return _walk(bvh_arrays, ro.detach(), rd.detach(), float(t_min),
                     leaf_test)


def _walk(bvh_arrays, ro, rd, t_min, leaf_test):
    b = ro.shape[0]
    dev = ro.device
    # +-inf where a direction component is 0. NaN hazard: when the origin
    # sits exactly ON a node's bounding plane for that axis, 0 * inf =
    # NaN would make the comparisons false and wrongly cull the subtree;
    # box_hit substitutes explicit +-BIG bounds for zero components.
    inv_d = 1.0 / rd
    zero_d = rd == 0.0
    obj_id = bvh_arrays["obj_id"].long()
    next_id = bvh_arrays["next_id"].long()
    # where a box hit leads: a leaf holds (STOP), an inner node descends
    down = torch.where(obj_id >= 0, STOP, bvh_arrays["left_id"].long())
    box = torch.cat([bvh_arrays["bmin"], bvh_arrays["bmax"]], dim=1)
    ro2, inv2 = torch.cat([ro, ro], dim=1), torch.cat([inv_d, inv_d], dim=1)
    big = torch.tensor(BIG, dtype=torch.float32, device=dev)
    tmin = torch.tensor(t_min, dtype=torch.float32, device=dev)

    def box_hit(node):
        """Slab test against the running best (bvh.py:170-193 takes the
        running closest as t_max). A zero-direction axis constrains
        nothing when the origin is inside that slab and rejects
        everything otherwise; the sentinels go in AFTER the per-axis sort
        (an empty (+BIG,-BIG) interval fed through min/max would re-sort
        into an everything interval), which also discards 0*inf NaNs.
        The node's bmin and bmax are gathered as one row of 6."""
        nb = box[node]
        t01 = (nb - ro2) * inv2
        near = torch.minimum(t01[:, :3], t01[:, 3:])
        far = torch.maximum(t01[:, :3], t01[:, 3:])
        inside = (ro >= nb[:, :3]) & (ro <= nb[:, 3:])
        near = torch.where(zero_d, torch.where(inside, -big, big), near)
        far = torch.where(zero_d, torch.where(inside, big, -big), far)
        tn = near.amax(dim=-1)
        tf = far.amin(dim=-1)
        return (tf >= torch.maximum(tn, tmin)) & (tn <= t_best)

    def advance(cur):
        """Phase A, one step: every live lane not on a box-hit leaf
        descends on a box hit and takes the escape link otherwise; moved
        says which lanes did (a step that moves none ends the phase)."""
        COUNTS["advance_steps"] += 1
        node = cur.clamp(min=0)
        nxt = torch.where(box_hit(node), down[node], next_id[node])
        moved = (cur >= 0) & (nxt != STOP)
        return torch.where(moved, nxt, cur), moved

    t_best = torch.full((b,), float("inf"), dtype=torch.float32, device=dev)
    cur = torch.zeros(b, dtype=torch.int64, device=dev)
    pid = torch.zeros(b, dtype=torch.int64, device=dev)
    while _read((cur >= 0).any()):
        # phase A to the end
        moving = True
        while moving:
            cur, moved = advance(cur)
            moving = _read(moved.any())
        # phase B: one batched leaf test for every settled lane, a
        # strictly closer hit taken, and the leaf's escape link
        COUNTS["leaf_steps"] += 1
        node = cur.clamp(min=0)
        live = cur >= 0
        prim = obj_id[node].clamp(min=0)
        t_cand = leaf_test(prim, ro, rd, t_min)
        better = live & (t_cand < t_best)
        t_best = torch.where(better, t_cand, t_best)
        pid = torch.where(better, prim, pid)
        cur = torch.where(live, next_id[node], cur)
    return t_best, pid.to(torch.int32)


def _read(flag: torch.Tensor) -> bool:
    """A loop condition read on the host (counted in COUNTS)."""
    COUNTS["host_reads"] += 1
    return bool(flag)


# ---------------------------------------------------------------------------
# per-primitive-type AABBs (for building scene BVHs), rt_tpu bvh.py:199-254
# ---------------------------------------------------------------------------


def sphere_aabbs(centers: np.ndarray, radii: np.ndarray):
    r = np.abs(np.asarray(radii, np.float32))[:, None]
    c = np.asarray(centers, np.float32)
    return c - r, c + r


def triangle_aabbs(v1: np.ndarray, v2: np.ndarray, v3: np.ndarray):
    vs = np.stack([v1, v2, v3], axis=0).astype(np.float32)
    return vs.min(0), vs.max(0)


def rect_aabbs(axis: np.ndarray, lo: np.ndarray, hi: np.ndarray,
               k: np.ndarray, pad: float = 1e-4):
    """Axis-aligned rect boxes: the constant axis gets k +- pad (a flat
    box degenerates the slab test)."""
    n = axis.shape[0]
    bmin = np.zeros((n, 3), np.float32)
    bmax = np.zeros((n, 3), np.float32)
    # free-axis mapping mirrors ops/intersect._rect_free_axes:
    # axis 0 (yz_rect) -> free (1,2); 1 (xz) -> (0,2); 2 (xy) -> (0,1)
    f1 = np.where(axis == 0, 1, 0)
    f2 = np.where(axis == 2, 1, 2)
    rows = np.arange(n)
    bmin[rows, axis] = k - pad
    bmax[rows, axis] = k + pad
    bmin[rows, f1] = lo[:, 0]
    bmax[rows, f1] = hi[:, 0]
    bmin[rows, f2] = lo[:, 1]
    bmax[rows, f2] = hi[:, 1]
    return bmin, bmax


def cylinder_aabbs(radius: np.ndarray, zmin: np.ndarray, zmax: np.ndarray,
                   o2w: np.ndarray):
    """World-space cylinder boxes: the 8 object-space box corners
    [-r,r]x[-r,r]x[zmin,zmax] through each o2w affine."""
    n = radius.shape[0]
    r = np.abs(np.asarray(radius, np.float32))
    corners = np.empty((n, 8, 3), np.float32)
    idx = 0
    for sx in (-1.0, 1.0):
        for sy in (-1.0, 1.0):
            for z in (0, 1):
                corners[:, idx, 0] = sx * r
                corners[:, idx, 1] = sy * r
                corners[:, idx, 2] = np.where(z, zmax, zmin)
                idx += 1
    rot = np.asarray(o2w, np.float32)[:, :3, :3]
    trans = np.asarray(o2w, np.float32)[:, :3, 3]
    world = np.einsum("nij,nkj->nki", rot, corners) + trans[:, None, :]
    return world.min(1), world.max(1)
