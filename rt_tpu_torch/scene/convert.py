"""Carry tables built by the JAX package across to this one.

`tables_from_numpy` takes the leaves of an `rt_tpu.scene.types.
SceneTables` as NumPy arrays (the caller exports them with np.asarray;
camera leaves under 'camera.<field>') and returns this package's
`SceneTables` on `device`. Leaves of families this slice does not carry
(rects, cylinders, triangles, BVHs, images, the light index) may be
present and are checked to hold no live row; a live one raises.
`params_from_numpy` carries a parameter dict of rt_tpu's diff package
(field name -> array; "camera" -> a camera whose fields are arrays)
across the same way.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Mapping

import numpy as np
import torch

from rt_tpu_torch.scene.types import TEX_IMAGE, CameraDef, SceneTables

_UNPORTED_FAMILIES = ("rect_obj", "cyl_obj", "tri_obj")


def tables_from_numpy(leaves: Mapping[str, np.ndarray],
                      device="cpu") -> SceneTables:
    for name in _UNPORTED_FAMILIES:
        if name in leaves and (np.asarray(leaves[name]) >= 0).any():
            raise NotImplementedError(
                f"{name}: only the sphere family is ported yet "
                "(ROADMAP Queue A-3)")
    if (np.asarray(leaves["tex_type"]) == TEX_IMAGE).any():
        raise NotImplementedError(
            "image textures are not ported yet (ROADMAP Queue A-4, B2(c))")

    def t(name):
        return torch.from_numpy(np.array(leaves[name])).to(device)

    cam = CameraDef(**{f.name: t(f"camera.{f.name}")
                       for f in dataclasses.fields(CameraDef)})
    tensors = {f.name: t(f.name) for f in dataclasses.fields(SceneTables)
               if f.name not in ("camera", "n_spheres")}
    n_spheres = int((np.asarray(leaves["sph_obj"]) >= 0).sum())
    return SceneTables(camera=cam, n_spheres=n_spheres, **tensors)


def params_from_numpy(params: Mapping[str, np.ndarray],
                      device="cpu") -> Dict[str, torch.Tensor]:
    """A parameter dict (field -> array, as rt_tpu.diff.inverse.
    extract_params gives it, exported with np.asarray) as float32
    tensors on `device`, for diff/inverse.py, diff/replay.py and
    diff/tape.py. Every table field carries across, the geometry's
    (sph_center, sph_radius) included; "camera" may be any object with
    CameraDef's field names as attributes or keys (rt_tpu's CameraDef,
    a dict) and becomes this package's CameraDef."""
    def t(v):
        return torch.from_numpy(np.array(v, np.float32)).to(device)

    out = {}
    for k, v in params.items():
        if k == "camera":
            get = v.get if isinstance(v, Mapping) else functools.partial(
                getattr, v)
            out[k] = CameraDef(**{f.name: t(get(f.name))
                                  for f in dataclasses.fields(CameraDef)})
        else:
            out[k] = t(v)
    return out
