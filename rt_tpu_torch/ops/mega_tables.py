"""The packed sphere table the megakernels read (rt_tpu/ops/pallas_mega.py
`_ext_block` :163, `sphere_table` :207, `_pad_rows` / `_pad_chunked`
:2798-2822, the sphere path of `_prep_scene` :2823).

One row per padded sphere slot, with the reference's column meanings
and indices (`_X_*` / `_S_*`, pallas_mega.py:85-116), so a test compares
this table with rt_tpu's column by column:

  0..2  center            3  radius (negative: hollow, normal flips)
  4     direct (0 for spheres: normal = (p - center) / radius)
  5     material type     6  checker flag     7  fuzz (metal) or IOR
  8..10 albedo (texture even colour / inline colour / 1 for glass)
  11..13 albedo2 (checker odd colour)
  14    image-texture id (-1: this slice has no image textures)
  15    |c|^2 - r^2       16 valid (1 live row, 0 pad)
  17    gradient slot: the row of the adjoint accumulators that takes
        this sphere's radiometric cotangents (the reference's column 31,
        `_SLOT_COL` :140, `_slot_ids` :199): its texture row, or
        n_tex + its material row when the material has no texture

The columns only the TPU's MXU, UV and tape-code paths read (the
reference's 17..30) are dropped. The kernels (csrc/bounce.cuh) and the
plain versions (ops/mega_plain.py, ops/adjoint_plain.py) read only this
table, in the form of `MegaScene`: built once per scene
(`SceneTables.mega`) and cut after the last live row, since the pad rows
behind it never hit.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from rt_tpu_torch.ops.camera import camera_vec
from rt_tpu_torch.scene.types import (
    MAT_DIELECTRIC,
    MAT_METAL,
    TEX_CHECKER,
    SceneTables,
)

X_V = 0
X_RAD = 3
X_DIRECT = 4
X_MTYPE, X_CHECKER, X_PARAM = 5, 6, 7
X_ALB = 8
X_ALB2 = 11
X_IMG = 14
S_C2R, S_VALID = 15, 16
X_SLOT = 17
S_COLS = 18

SPH_CHUNK = 32   # the reference's sphere chunk (pallas_mega.py:68)


def mega_supported(tables: SceneTables) -> bool:
    """The megakernels of this slice render any scene of this package
    (spheres, solid / checker textures); only an empty scene falls back,
    as in the reference (pallas_mega.py:118)."""
    return tables.n_spheres > 0


def _pad_rows(tab: torch.Tensor, chunk: int) -> torch.Tensor:
    n = tab.shape[0]
    if n % chunk:
        pad = chunk - n % chunk
        tab = torch.cat([tab, tab.new_zeros((pad, tab.shape[1]))])
    return tab


def pad_chunked(tab: torch.Tensor, max_chunk: int = SPH_CHUNK) -> torch.Tensor:
    """Pad rows so `min(rows, max_chunk)` evenly chunks them (a table at
    or under max_chunk rows is its own chunk). Pad rows are all zero, so
    their valid column is 0."""
    if tab.shape[0] <= max_chunk:
        return tab
    return _pad_rows(tab, max_chunk)


def sphere_table(tables: SceneTables) -> torch.Tensor:
    """[N, S_COLS] float32 on the tables' device (see the module doc)."""
    mat = tables.sph_mat.long()
    mtype = tables.mat_type[mat]
    tex = tables.mat_tex[mat]
    tex_safe = torch.clamp(tex, min=0).long()
    is_checker = (tex >= 0) & (tables.tex_type[tex_safe] == TEX_CHECKER)
    base = torch.where((tex >= 0)[:, None], tables.tex_color[tex_safe],
                       tables.mat_albedo[mat])
    base = torch.where((mtype == MAT_DIELECTRIC)[:, None],
                       torch.ones_like(base), base)
    param = torch.where(mtype == MAT_METAL, tables.mat_fuzz[mat],
                        torch.where(mtype == MAT_DIELECTRIC,
                                    tables.mat_ior[mat],
                                    torch.zeros_like(tables.mat_fuzz[mat])))
    c, r = tables.sph_center, tables.sph_radius
    n = c.shape[0]
    tab = torch.zeros((n, S_COLS), dtype=torch.float32, device=c.device)
    tab[:, X_V:X_V + 3] = c
    tab[:, X_RAD] = r
    tab[:, X_DIRECT] = 0.0
    tab[:, X_MTYPE] = mtype.to(torch.float32)
    tab[:, X_CHECKER] = is_checker.to(torch.float32)
    tab[:, X_PARAM] = param
    tab[:, X_ALB:X_ALB + 3] = base
    tab[:, X_ALB2:X_ALB2 + 3] = tables.tex_color2[tex_safe]
    tab[:, X_IMG] = -1.0
    tab[:, S_C2R] = (c * c).sum(-1) - r * r
    tab[:, S_VALID] = (tables.sph_obj >= 0).to(torch.float32)
    tab[:, X_SLOT] = slot_ids(tables, mat)
    return pad_chunked(tab)


def slot_ids(tables: SceneTables, mat_ids) -> torch.Tensor:
    """Per-sphere gradient-slot row (column X_SLOT), as float32."""
    n_tex = tables.tex_color.shape[0]
    tex = tables.mat_tex[mat_ids]
    return torch.where(tex >= 0, tex.long(), n_tex + mat_ids.long()).to(
        torch.float32)


@dataclasses.dataclass(frozen=True)
class MegaScene:
    """What the megakernels read of a scene: the packed table up to its
    last live sphere (live rows come first, build_tables pads behind
    them), the constant sky colour and the camera frame
    (ops/camera.camera_vec) as host floats, which the launchers pass by
    value, and the sizes of the adjoint accumulators: n_slots =
    n_tex + n_mat gradient slots, texture rows first (the reference pads
    them to 128-lane slabs; the port needs no padding)."""

    table: torch.Tensor          # [n_spheres, S_COLS] f32
    bg: Tuple[float, float, float]
    cam: Tuple[float, ...]       # 19 floats, ops/camera.camera_vec
    n_tex: int
    n_mat: int

    @property
    def n_slots(self) -> int:
        return self.n_tex + self.n_mat

    @classmethod
    def of(cls, tables: SceneTables) -> "MegaScene":
        tab = sphere_table(tables)[:max(tables.n_spheres, 1)]
        bg = tables.background.detach().to("cpu", torch.float32).tolist()
        return cls(table=tab.detach().contiguous(),
                   bg=tuple(float(v) for v in bg),
                   cam=camera_vec(tables.camera),
                   n_tex=int(tables.tex_color.shape[0]),
                   n_mat=int(tables.mat_albedo.shape[0]))
