"""Carry tables built by the JAX package across to this one.

`tables_from_numpy` takes the leaves of an `rt_tpu.scene.types.
SceneTables` as NumPy arrays (the caller exports them with np.asarray;
camera leaves under 'camera.<field>') and returns this package's
`SceneTables` on `device`, the four primitive families, the image
textures (tex_image and the atlas `images`) and the light index
included, and the threaded BVHs (the `*_bvh_*` leaves); the static
img_on / nee_img are derived from the leaves (scene/types.image_usage)
and so is bvh_for (`bvh_families`).
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

from rt_tpu_torch.scene.types import (
    BVH_FAMILIES,
    MAT_DIFFUSE_LIGHT,
    CameraDef,
    SceneTables,
    image_usage,
)

_FAMILIES = ("sph", "rect", "cyl", "tri")
_META = ("camera", "counts", "n_lights", "img_on", "nee_img", "bvh_for")


def bvh_families(leaves: Mapping[str, np.ndarray], counts) -> tuple:
    """The families whose `*_bvh_*` leaves hold a real BVH, in
    BVH_FAMILIES order (rt_tpu's bvh_for): a family with n live rows
    whose BVH has 2n-1 nodes, other than the dummy (one node whose box
    is all zeros, what rt_tpu stores for a family without a BVH)."""
    n_of = dict(zip(_FAMILIES, counts))
    out = []
    for name, prefix in BVH_FAMILIES:
        n = n_of[prefix]
        obj = np.asarray(leaves[f"{prefix}_bvh_obj"])
        box = np.concatenate([np.asarray(leaves[f"{prefix}_bvh_min"]),
                              np.asarray(leaves[f"{prefix}_bvh_max"])])
        if n and obj.shape[0] == 2 * n - 1 and (n > 1 or box.any()):
            out.append(name)
    return tuple(out)


def tables_from_numpy(leaves: Mapping[str, np.ndarray],
                      device="cpu") -> SceneTables:
    def t(name):
        return torch.from_numpy(np.array(leaves[name])).to(device)

    cam = CameraDef(**{f.name: t(f"camera.{f.name}")
                       for f in dataclasses.fields(CameraDef)})
    tensors = {f.name: t(f.name) for f in dataclasses.fields(SceneTables)
               if f.name not in _META}
    counts = tuple(int((np.asarray(leaves[f"{k}_obj"]) >= 0).sum())
                   for k in _FAMILIES)
    mat_type = np.asarray(leaves["mat_type"])
    n_lights = sum(int(((np.asarray(leaves[f"{k}_obj"]) >= 0)
                        & (mat_type[np.asarray(leaves[f"{k}_mat"])]
                           == MAT_DIFFUSE_LIGHT)).sum())
                   for k in _FAMILIES)
    img_on, nee_img = image_usage(
        leaves["tex_type"], leaves["mat_tex"],
        [(leaves[f"{k}_mat"], leaves[f"{k}_obj"]) for k in _FAMILIES],
        np.asarray(leaves["light_fam"])[:n_lights],
        np.asarray(leaves["light_pid"])[:n_lights])
    return SceneTables(camera=cam, counts=counts, n_lights=n_lights,
                       img_on=img_on, nee_img=nee_img,
                       bvh_for=bvh_families(leaves, counts), **tensors)


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
