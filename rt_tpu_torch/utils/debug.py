"""Debug tooling (rt_tpu/utils/debug.py).

  - `nan_debug()`: a scope under torch.autograd.set_detect_anomaly, so a
    backward that makes a NaN raises at the op that made it.
  - `assert_finite`: walks tensors, arrays, dataclasses, dicts and
    sequences and names the field that holds a NaN or Inf.
  - `checked_intersect`: the closest hit (ops/intersect.intersect) with
    its results checked: a non-finite ray, a NaN or non-finite hit
    distance on a hit lane, or a row, object or material id out of its
    table raises. The reference does this with checkify.
  - `replay_check`: renders twice and compares bit for bit; the
    counter-based RNG makes every render a pure function of (scene,
    config), so any difference is a nondeterminism bug.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch


@contextlib.contextmanager
def nan_debug():
    """Raise at the op that makes a NaN in a backward inside the scope."""
    with torch.autograd.set_detect_anomaly(True):
        yield


def _walk(x, name):
    if isinstance(x, (torch.Tensor, np.ndarray, float, int)):
        yield name, x
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            yield from _walk(getattr(x, f.name), f"{name}.{f.name}")
    elif isinstance(x, dict):
        for k, v in x.items():
            yield from _walk(v, f"{name}[{k!r}]")
    elif isinstance(x, tuple) and hasattr(x, "_fields"):
        for k, v in zip(x._fields, x):
            yield from _walk(v, f"{name}.{k}")
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            yield from _walk(v, f"{name}[{i}]")


def assert_finite(tree, name: str = "value") -> None:
    """Raise FloatingPointError naming the first field of tree that holds
    a NaN or Inf (the negative-radiance sentinel's companion,
    gpu-version/color.cuh:49-52). Integer and bool fields pass."""
    for path, leaf in _walk(tree, name):
        t = torch.as_tensor(leaf)
        if not (t.is_floating_point() or t.is_complex()):
            continue
        bad = ~torch.isfinite(t)
        if bool(bad.any()):
            raise FloatingPointError(
                f"{path}: {int(bad.sum())} non-finite elements")


def checked_intersect(tables, ro, rd, t_min=1e-3, traversal="linear",
                      engine: str = "plain"):
    """intersect() on `traversal` ("linear", or "bvh" over the tables'
    BVHs) with its inputs and results checked; returns the Hit.
    Raises FloatingPointError on a non-finite ray or a NaN / non-finite
    hit distance or point where a lane hits, and IndexError on a row,
    object or material id outside its table. Debug only: each check
    waits for the device."""
    from rt_tpu_torch.ops import intersect as isect

    assert_finite({"ro": ro, "rd": rd}, "rays")
    hit = isect.intersect(tables, ro, rd, t_min=t_min, engine=engine,
                          traversal=traversal)
    if bool(torch.isnan(hit.t).any()):
        raise FloatingPointError("intersect: NaN hit distance")
    h = hit.hit
    if bool(h.any()):
        assert_finite({"t": hit.t[h], "p": hit.p[h],
                       "normal": hit.normal[h]}, "intersect hit")
        rows = {isect.PTYPE_SPHERE: tables.sph_obj,
                isect.PTYPE_RECT: tables.rect_obj,
                isect.PTYPE_CYLINDER: tables.cyl_obj,
                isect.PTYPE_TRIANGLE: tables.tri_obj}
        for ptype, objs in rows.items():
            on = h & (hit.ptype == ptype)
            pid = hit.pid[on]
            if pid.numel() and (int(pid.min()) < 0
                                or int(pid.max()) >= objs.shape[0]):
                raise IndexError(f"intersect: row of family {ptype} out "
                                 f"of [0, {objs.shape[0]})")
        n_mat = tables.mat_type.shape[0]
        mat = hit.mat[h]
        if int(mat.min()) < 0 or int(mat.max()) >= n_mat:
            raise IndexError(f"intersect: material out of [0, {n_mat})")
        if int(hit.obj[h].min()) < 0:
            raise IndexError("intersect: a hit lane has no scene object")
    return hit


def replay_check(render_fn, *args, **kwargs) -> bool:
    """Render twice; True when both results are equal bit for bit."""
    a = torch.as_tensor(render_fn(*args, **kwargs)).cpu()
    b = torch.as_tensor(render_fn(*args, **kwargs)).cpu()
    return bool(torch.equal(a, b))
