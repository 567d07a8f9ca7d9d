"""The packed tables the megakernels read (rt_tpu/ops/pallas_mega.py
`_ext_block` :163, `sphere_table` :207, `rect_table` :221,
`cylinder_table` :245, `triangle_table` :260, `_pad_rows` /
`_pad_chunked` :2798-2822, `_prep_scene` :2823 without culling).

The sphere table has one row per padded sphere slot, with the
reference's column meanings and indices (`_X_*` / `_S_*`,
pallas_mega.py:85-116), so a test compares it with rt_tpu's column by
column:

  0..2  center            3  radius (negative: hollow, normal flips)
  4     direct (0 for spheres: normal = (p - center) / radius)
  5     material type     6  checker flag     7  fuzz (metal) or IOR
  8..10 albedo (texture even colour / inline colour / 1 for glass)
  11..13 albedo2 (checker odd colour)
  14    image-texture id: the row of the atlas a texel-sampled winner
        reads (-1: its material samples no image)
  15    |c|^2 - r^2       16 valid (1 live row, 0 pad)
  17    gradient slot: the row of the adjoint accumulators that takes
        this sphere's radiometric cotangents (the reference's column 31,
        `_SLOT_COL` :140, `_slot_ids` :199): its texture row, or
        n_tex + its material row when the material has no texture

The columns only the TPU's MXU, UV and tape-code paths read (the
reference's 17..30) are dropped.

The rect, cylinder and triangle tables keep the reference's 32 columns
as they are: 0..14 the same attribute block (v0..v2 the normal: the
constant axis's one-hot for a rect, the geometric normal for a
triangle, zeros for a cylinder, whose normal is computed per hit;
direct = 1), then per family (`_R_*`, `_Y_*`, `_T_*`, :98-116)

  rect      15 k, 16 lo0, 17 lo1, 18 hi0, 19 hi1, 20 valid,
            21..23 free-axis-1 one-hot, 24..26 free-axis-2 one-hot
  cylinder  15..23 w2o rotation rows (row-major 3x3), 24..26 w2o
            translation, 27 radius^2, 28 zmin, 29 zmax, 30 valid
  triangle  15..17 v1, 18..20 v2 - v1, 21..23 v3 - v2, 24..26 v1 - v3,
            27 v1 . n, 28 valid

and the gradient slot in column 31 (`_SLOT_COL`).

The UV tables (`rect_uv_table`, `cylinder_uv_table`,
`triangle_uv_table`, pallas_mega.py:378-428), built only for a scene
whose primitives sample image textures, give each rect, cylinder and
triangle row the parameters its hit's (u, v) needs, in the reference's
U_COLS = 17 columns (column 16 the family code):

  rect      0..2 free-axis-1 one-hot, 3..5 free-axis-2 one-hot, 6 lo0,
            7 lo1, 8 1 / (hi0 - lo0), 9 1 / (hi1 - lo1)
  cylinder  0..8 w2o rotation rows, 9..11 w2o translation, 12 zmin,
            13 1 / (zmax - zmin)
  triangle  0..8 v1, v2, v3, 9 1 / |(v2 - v1) x (v3 - v1)|, 10..15 uv1,
            uv2, uv3

(1 / x is 0 where x is 0.) A sphere's (u, v) comes from its attribute
block (centre and radius), so it has none. The kernels read the
winner's row once per hit, where the TPU extracts it by a one-hot
product per chunk.

The light table (`light_table`, NEE's: the contract of the reference's
`nee_light_table` :451-567 in the port's own layout) has one row per
emitter of the scene's light list (rt_tpu scene/types.py:645-657 puts
every live diffuse_light primitive there), NL_COLS columns:

  0 family (FAM_*)  1 area  2..4 Le even  5..7 Le odd  8 checker flag
  9..23 the family's sampling block, as the reference's
        sphere    9..11 center, 12 |r|
        rect      9..11 constant-axis one-hot (the normal), 12..14
                  free-axis-1 one-hot, 15..17 free-axis-2 one-hot,
                  18 lo0, 19 lo1, 20 hi0 - lo0, 21 hi1 - lo1, 22 k
        cylinder  9..17 o2w rotation (row-major), 18..20 o2w
                  translation, 21 |r|, 22 zmin, 23 zmax - zmin
        triangle  9..11 v1, 12..14 v2 - v1, 15..17 v3 - v1, 18..20 the
                  unit geometric normal
  24 the emission's gradient slot (the adjoints' credit to the light)
  25 the primitive's row in its family's table: with column 0 the key
     that matches a hit emitter to its light row (MIS), where the
     reference matches its tape code `pid * 4 + family` (column 32);
     the tables keep the scene's order, so the row is the pid
  26 the image-texture id of the emission (-1: none), the reference's
     column 25
  27..32 a triangle light's uv1, uv2, uv3 (zeros for the other
     families), the reference's columns 26..31: the light point's (u,
     v) for an image-textured emission

Columns 0..24 are the reference's bit for bit; 25 is the port's own, so
the reference's 25..31 sit one column later.

Areas are the reference's formulas: 4 pi r^2, the rect's extent, the
cylinder's lateral 2 pi r (zmax - zmin), half the triangle's edge cross
product's length.

Chunk culling (cfg.cull_chunks, `MegaScene.of(tables, cull=True)`,
`_prep_scene` :2873-2899) reorders the sphere rows, and the triangle
rows of a table of at least two chunks, along the Morton curve of their
centres / centroids (`sort_spheres_morton` :299, `sort_triangles_morton`
:337, `_morton3` :294: the same float32 quantisation to [0, 1023]^3, the
same stable sort, pad rows last) and gives each chunk of SPH_CHUNK
sorted rows its box (`Cull`): the kernels skip a chunk whose box a
lane's ray misses. The triangle UV rows follow the triangles' order.
Each sorted row keeps its SceneTables row in `Cull.sph_rows` /
`tri_rows` (the reference's code tables, `codes_for` :2916-2927): the
tape code of a winner and MIS's match of a hit emitter against the
light table's L_ROW name that row, not the sorted one.

The kernels
(csrc/bounce.cuh) and the plain versions (ops/mega_plain.py,
ops/adjoint_plain.py) read only these tables, in the form of
`MegaScene`: built once per scene and cull setting
(`SceneTables.mega`, `SceneTables.mega_culled`; `scene_for` picks by
cfg.cull_chunks), each cut after its last live row, since the pad rows
behind it never hit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch

from rt_tpu_torch.ops.camera import camera_vec
from rt_tpu_torch.scene.types import (
    MAT_DIELECTRIC,
    MAT_METAL,
    TEX_CHECKER,
    TEX_IMAGE,
    SceneTables,
)

FAM_SPHERE, FAM_RECT, FAM_CYLINDER, FAM_TRIANGLE = 0, 1, 2, 3

X_V = 0
X_RAD = 3
X_DIRECT = 4
X_MTYPE, X_CHECKER, X_PARAM = 5, 6, 7
X_ALB = 8
X_ALB2 = 11
X_IMG = 14
X_COLS = 15      # the attribute block every family table starts with
S_C2R, S_VALID = 15, 16
X_SLOT = 17
S_COLS = 18

SPH_CHUNK = 32   # the reference's sphere chunk (pallas_mega.py:68)

# the light table (see the module doc)
L_FAM, L_AREA, L_LE, L_LE2, L_CHECKER = 0, 1, 2, 5, 8
L_BLK = 9
L_SLOT, L_ROW = 24, 25
L_IMG, L_UV = 26, 27
NL_COLS = 33
# a light's row is matched as a float32 (column L_ROW), exact below 2^24
MAX_LIGHT_ROWS = 1 << 24

# the rect / cylinder / triangle tables (pallas_mega.py:98-140)
R_K, R_LO0, R_LO1, R_HI0, R_HI1, R_VALID = 15, 16, 17, 18, 19, 20
R_F1 = 21
R_F2 = 24
Y_R = 15
Y_T = 24
Y_RAD2, Y_ZMIN, Y_ZMAX, Y_VALID = 27, 28, 29, 30
T_V1 = 15
T_E1 = 18
T_E2 = 21
T_E3 = 24
T_D0, T_VALID = 27, 28
F_SLOT = 31
F_COLS = 32
# the UV tables (pallas_mega.py:145-151)
U_COLS = 17
U_FAM = 16


def mega_supported(tables: SceneTables) -> bool:
    """The megakernels render any scene of this package (the four
    families, solid / checker / image textures); only an empty scene
    falls back, as in the reference (pallas_mega.py:149-160)."""
    return sum(tables.counts) > 0


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


def image_ids(tables: SceneTables, tex) -> torch.Tensor:
    """The image id of texture rows `tex` [N] (-1: not an image
    texture, or tex < 0), as float32."""
    texs = torch.clamp(tex, min=0).long()
    return torch.where((tex >= 0) & (tables.tex_type[texs] == TEX_IMAGE),
                       tables.tex_image[texs], -1).to(torch.float32)


def _ext_block(tables: SceneTables, mat, n_cols: int) -> torch.Tensor:
    """[N, n_cols] zeros with the attribute columns 4..14 of rows of
    materials `mat` [N] filled (direct = 1)."""
    mat = mat.long()
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
    tab = torch.zeros((mat.shape[0], n_cols), dtype=torch.float32,
                      device=mat.device)
    tab[:, X_DIRECT] = 1.0
    tab[:, X_MTYPE] = mtype.to(torch.float32)
    tab[:, X_CHECKER] = is_checker.to(torch.float32)
    tab[:, X_PARAM] = param
    tab[:, X_ALB:X_ALB + 3] = base
    tab[:, X_ALB2:X_ALB2 + 3] = tables.tex_color2[tex_safe]
    tab[:, X_IMG] = image_ids(tables, tex)
    return tab


def sphere_table(tables: SceneTables) -> torch.Tensor:
    """[N, S_COLS] float32 on the tables' device (see the module doc)."""
    c, r = tables.sph_center, tables.sph_radius
    tab = _ext_block(tables, tables.sph_mat, S_COLS)
    tab[:, X_V:X_V + 3] = c
    tab[:, X_RAD] = r
    tab[:, X_DIRECT] = 0.0
    tab[:, S_C2R] = (c * c).sum(-1) - r * r
    tab[:, S_VALID] = (tables.sph_obj >= 0).to(torch.float32)
    tab[:, X_SLOT] = slot_ids(tables, tables.sph_mat.long())
    return pad_chunked(tab)


def rect_table(tables: SceneTables) -> torch.Tensor:
    """[Nr, F_COLS] float32: every rect row, padded ones included."""
    axis = tables.rect_axis.long()
    onehot = torch.nn.functional.one_hot
    tab = _ext_block(tables, tables.rect_mat, F_COLS)
    tab[:, X_V:X_V + 3] = onehot(axis, 3).to(torch.float32)
    tab[:, R_K] = tables.rect_k
    tab[:, R_LO0] = tables.rect_lo[:, 0]
    tab[:, R_LO1] = tables.rect_lo[:, 1]
    tab[:, R_HI0] = tables.rect_hi[:, 0]
    tab[:, R_HI1] = tables.rect_hi[:, 1]
    tab[:, R_VALID] = (tables.rect_obj >= 0).to(torch.float32)
    tab[:, R_F1:R_F1 + 3] = onehot(torch.where(axis == 0, 1, 0), 3).to(
        torch.float32)
    tab[:, R_F2:R_F2 + 3] = onehot(torch.where(axis == 2, 1, 2), 3).to(
        torch.float32)
    tab[:, F_SLOT] = slot_ids(tables, tables.rect_mat.long())
    return tab


def cylinder_table(tables: SceneTables) -> torch.Tensor:
    """[Nc, F_COLS] float32: every cylinder row, padded ones included."""
    w2o = tables.cyl_w2o
    tab = _ext_block(tables, tables.cyl_mat, F_COLS)
    tab[:, Y_R:Y_R + 9] = w2o[:, :3, :3].reshape(-1, 9)
    tab[:, Y_T:Y_T + 3] = w2o[:, :3, 3]
    tab[:, Y_RAD2] = tables.cyl_radius ** 2
    tab[:, Y_ZMIN] = tables.cyl_zmin
    tab[:, Y_ZMAX] = tables.cyl_zmax
    tab[:, Y_VALID] = (tables.cyl_obj >= 0).to(torch.float32)
    tab[:, F_SLOT] = slot_ids(tables, tables.cyl_mat.long())
    return tab


def triangle_table(tables: SceneTables) -> torch.Tensor:
    """[Nt, F_COLS] float32: every triangle row, padded ones included."""
    v1, v2, v3 = tables.tri_v1, tables.tri_v2, tables.tri_v3
    n0 = tables.tri_n
    tab = _ext_block(tables, tables.tri_mat, F_COLS)
    tab[:, X_V:X_V + 3] = n0
    tab[:, T_V1:T_V1 + 3] = v1
    tab[:, T_E1:T_E1 + 3] = v2 - v1
    tab[:, T_E2:T_E2 + 3] = v3 - v2
    tab[:, T_E3:T_E3 + 3] = v1 - v3
    tab[:, T_D0] = (v1 * n0).sum(-1)
    tab[:, T_VALID] = (tables.tri_obj >= 0).to(torch.float32)
    tab[:, F_SLOT] = slot_ids(tables, tables.tri_mat.long())
    return tab


def _safe_inv(x):
    """1 / x, 0 where x is 0 (pallas_mega.py `_safe_inv` :280)."""
    nz = x != 0.0
    return torch.where(nz, 1.0 / torch.where(nz, x, 1.0), 0.0)


def rect_uv_table(tables: SceneTables) -> torch.Tensor:
    """[Nr, U_COLS] float32 (see the module doc)."""
    axis = tables.rect_axis.long()
    onehot = torch.nn.functional.one_hot
    lo, hi = tables.rect_lo, tables.rect_hi
    tab = lo.new_zeros((axis.shape[0], U_COLS))
    tab[:, 0:3] = onehot(torch.where(axis == 0, 1, 0), 3).to(torch.float32)
    tab[:, 3:6] = onehot(torch.where(axis == 2, 1, 2), 3).to(torch.float32)
    tab[:, 6] = lo[:, 0]
    tab[:, 7] = lo[:, 1]
    tab[:, 8] = _safe_inv(hi[:, 0] - lo[:, 0])
    tab[:, 9] = _safe_inv(hi[:, 1] - lo[:, 1])
    tab[:, U_FAM] = FAM_RECT
    return tab


def cylinder_uv_table(tables: SceneTables) -> torch.Tensor:
    """[Nc, U_COLS] float32 (see the module doc)."""
    w2o = tables.cyl_w2o
    tab = w2o.new_zeros((w2o.shape[0], U_COLS))
    tab[:, 0:9] = w2o[:, :3, :3].reshape(-1, 9)
    tab[:, 9:12] = w2o[:, :3, 3]
    tab[:, 12] = tables.cyl_zmin
    tab[:, 13] = _safe_inv(tables.cyl_zmax - tables.cyl_zmin)
    tab[:, U_FAM] = FAM_CYLINDER
    return tab


def triangle_uv_table(tables: SceneTables) -> torch.Tensor:
    """[Nt, U_COLS] float32 (see the module doc)."""
    v1, v2, v3 = tables.tri_v1, tables.tri_v2, tables.tri_v3
    tab = v1.new_zeros((v1.shape[0], U_COLS))
    tab[:, 0:3] = v1
    tab[:, 3:6] = v2
    tab[:, 6:9] = v3
    cr = torch.linalg.cross(v2 - v1, v3 - v1)
    tab[:, 9] = _safe_inv(torch.sqrt((cr * cr).sum(-1)))
    tab[:, 10:12] = tables.tri_uv1
    tab[:, 12:14] = tables.tri_uv2
    tab[:, 14:16] = tables.tri_uv3
    tab[:, U_FAM] = FAM_TRIANGLE
    return tab


def slot_ids(tables: SceneTables, mat_ids) -> torch.Tensor:
    """Per-sphere gradient-slot row (column X_SLOT), as float32."""
    n_tex = tables.tex_color.shape[0]
    tex = tables.mat_tex[mat_ids]
    return torch.where(tex >= 0, tex.long(), n_tex + mat_ids.long()).to(
        torch.float32)


def light_table(tables: SceneTables) -> torch.Tensor:
    """[n_lights, NL_COLS] float32 (see the module doc); 0 rows when the
    scene has no emitter."""
    n = tables.n_lights
    fam = tables.light_fam[:n].long()
    pid = tables.light_pid[:n].long()
    dev = tables.sph_center.device

    def rows(t):
        """The lights' rows of a family table (zeros for an empty one)."""
        if t.shape[0] == 0:
            return t.new_zeros((n,) + tuple(t.shape[1:]))
        return t[torch.clamp(pid, 0, t.shape[0] - 1)]

    def pick(sph, rect, cyl, tri):
        return torch.where(fam == FAM_SPHERE, sph, torch.where(
            fam == FAM_RECT, rect, torch.where(fam == FAM_CYLINDER, cyl,
                                               tri)))

    def pick3(sph, rect, cyl, tri):
        f = fam[:, None]
        return torch.where(f == FAM_SPHERE, sph, torch.where(
            f == FAM_RECT, rect, torch.where(f == FAM_CYLINDER, cyl, tri)))

    mat = pick(rows(tables.sph_mat), rows(tables.rect_mat),
               rows(tables.cyl_mat), rows(tables.tri_mat)).long()
    tex = tables.mat_tex[mat]
    texs = torch.clamp(tex, min=0).long()
    even = torch.where((tex >= 0)[:, None], tables.tex_color[texs],
                       tables.mat_albedo[mat])
    odd = tables.tex_color2[texs]
    chk = (tex >= 0) & (tables.tex_type[texs] == TEX_CHECKER)

    r_s = torch.abs(rows(tables.sph_radius))
    lo, hi = rows(tables.rect_lo), rows(tables.rect_hi)
    r_c = torch.abs(rows(tables.cyl_radius))
    zmin = rows(tables.cyl_zmin)
    zlen = rows(tables.cyl_zmax) - zmin
    tv1 = rows(tables.tri_v1)
    te1 = rows(tables.tri_v2) - tv1
    te2 = rows(tables.tri_v3) - tv1
    tcr = torch.linalg.cross(te1, te2)
    area = pick(4.0 * math.pi * r_s * r_s,
                (hi[:, 0] - lo[:, 0]) * (hi[:, 1] - lo[:, 1]),
                2.0 * math.pi * r_c * zlen,
                0.5 * torch.sqrt((tcr * tcr).sum(-1)))

    out = torch.zeros((n, NL_COLS), dtype=torch.float32, device=dev)
    out[:, L_FAM] = fam.to(torch.float32)
    out[:, L_AREA] = area
    out[:, L_LE:L_LE + 3] = even
    out[:, L_LE2:L_LE2 + 3] = odd
    out[:, L_CHECKER] = chk.to(torch.float32)
    onehot = torch.nn.functional.one_hot
    ax = rows(tables.rect_axis).long()
    z3 = out.new_zeros((n, 3))
    z1 = out.new_zeros((n, 1))
    sph_blk = torch.cat([rows(tables.sph_center), r_s[:, None]]
                        + [z1] * 11, 1)
    rect_blk = torch.cat(
        [onehot(ax, 3).float(), onehot(torch.where(ax == 0, 1, 0), 3).float(),
         onehot(torch.where(ax == 2, 1, 2), 3).float(), lo[:, :1],
         lo[:, 1:2], (hi - lo)[:, :1], (hi - lo)[:, 1:2],
         rows(tables.rect_k)[:, None], z1], 1)
    o2w = rows(tables.cyl_o2w)
    cyl_blk = torch.cat([o2w[:, :3, :3].reshape(n, 9), o2w[:, :3, 3],
                         r_c[:, None], zmin[:, None], zlen[:, None]], 1)
    tri_blk = torch.cat([tv1, te1, te2, rows(tables.tri_n), z3], 1)
    out[:, L_BLK:L_BLK + 15] = pick3(sph_blk, rect_blk, cyl_blk, tri_blk)
    out[:, L_SLOT] = slot_ids(tables, mat)
    out[:, L_ROW] = pid.to(torch.float32)
    out[:, L_IMG] = image_ids(tables, tex)
    is_t = (fam == FAM_TRIANGLE).to(torch.float32)[:, None]
    out[:, L_UV:L_UV + 2] = rows(tables.tri_uv1) * is_t
    out[:, L_UV + 2:L_UV + 4] = rows(tables.tri_uv2) * is_t
    out[:, L_UV + 4:L_UV + 6] = rows(tables.tri_uv3) * is_t
    return out


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits to every third bit (the Morton interleave)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton3(nx, ny, nz) -> torch.Tensor:
    """The 30-bit Morton code of integer coordinates in [0, 1023]^3."""
    return (_part1by2(nz) << 2) | (_part1by2(ny) << 1) | _part1by2(nx)


def _morton_order(points, valid) -> torch.Tensor:
    """The stable order of rows along the Morton curve of their points
    [N, 3] over the valid rows' bounding box, invalid rows last."""
    v = valid[:, None]
    lo = torch.where(v, points, math.inf).amin(0)
    hi = torch.where(v, points, -math.inf).amax(0)
    # a tensor divisor: torch divides by a Python number as a product
    # with its reciprocal on the card
    span = torch.where(hi > lo, hi - lo, torch.ones_like(lo))
    q = torch.clamp((points - lo) / span * 1023.0, 0.0, 1023.0).to(
        torch.int64)
    key = morton3(q[:, 0], q[:, 1], q[:, 2])
    key = torch.where(valid, key, 1 << 30)
    return torch.argsort(key, stable=True)


def _chunk_bounds(bmin, bmax, valid, chunk: int) -> torch.Tensor:
    """[K, 8] boxes (bmin3, bmax3, 0, 0) of consecutive chunks of rows
    from the rows' own boxes bmin, bmax [N, 3] (N a multiple of chunk);
    a chunk without a valid row gets the empty box (+inf, -inf)."""
    k = bmin.shape[0] // chunk
    v = valid[:, None]
    lo = torch.where(v, bmin, math.inf).reshape(k, chunk, 3).amin(1)
    hi = torch.where(v, bmax, -math.inf).reshape(k, chunk, 3).amax(1)
    return torch.cat([lo, hi, lo.new_zeros((k, 2))], dim=1)


def sort_spheres_morton(sph_tab: torch.Tensor, chunk: int = SPH_CHUNK):
    """(sorted table, bounds [K, 8], order) of a sphere table [N, S_COLS]
    (N a multiple of chunk, or at most one chunk): the rows along the
    Morton curve of their centres, and each chunk's box of its spheres
    (centre -+ |radius|)."""
    c = sph_tab[:, X_V:X_V + 3]
    order = _morton_order(c, sph_tab[:, S_VALID] > 0.0)
    tab = sph_tab[order]
    c, r = tab[:, X_V:X_V + 3], torch.abs(tab[:, X_RAD])[:, None]
    bounds = _chunk_bounds(c - r, c + r, tab[:, S_VALID] > 0.0,
                           min(max(tab.shape[0], 1), chunk))
    return tab, bounds, order


def _tri_vertices(tab):
    v1 = tab[:, T_V1:T_V1 + 3]
    v2 = v1 + tab[:, T_E1:T_E1 + 3]
    return v1, v2, v2 + tab[:, T_E2:T_E2 + 3]


def sort_triangles_morton(tri_tab: torch.Tensor, chunk: int = SPH_CHUNK):
    """(sorted table, bounds [K, 8], order) of a triangle table [N,
    F_COLS]: sort_spheres_morton by centroid, each chunk's box that of
    its triangles' vertices."""
    v1, v2, v3 = _tri_vertices(tri_tab)
    third = torch.full((), 1.0 / 3.0, dtype=torch.float32,
                       device=tri_tab.device)
    order = _morton_order((v1 + v2 + v3) * third,
                          tri_tab[:, T_VALID] > 0.0)
    tab = tri_tab[order]
    v1, v2, v3 = _tri_vertices(tab)
    bounds = _chunk_bounds(torch.minimum(torch.minimum(v1, v2), v3),
                           torch.maximum(torch.maximum(v1, v2), v3),
                           tab[:, T_VALID] > 0.0,
                           min(max(tab.shape[0], 1), chunk))
    return tab, bounds, order


class Cull(NamedTuple):
    """The chunk boxes of a culled scene (see the module doc): sph /
    tri the [K, 8] boxes of the Morton-sorted sphere / triangle rows in
    chunks of SPH_CHUNK, from the first row (None: that family is not
    sorted); sph_rows / tri_rows [n] int32 the SceneTables row of each
    sorted row; table: the sphere table the boxes go with
    (MegaScene.table)."""

    sph: Optional[torch.Tensor]
    tri: Optional[torch.Tensor]
    sph_rows: Optional[torch.Tensor]
    tri_rows: Optional[torch.Tensor]
    table: torch.Tensor

    def check(self, tab: torch.Tensor) -> None:
        """Raise unless `tab` is the sphere table these boxes go with:
        the boxes of the sorted rows mean nothing to the rows in scene
        order (pass scene_for(tables, cfg).table with
        mega_plain.trace_options(tables, cfg))."""
        if self.sph is not None and tab.data_ptr() != self.table.data_ptr():
            raise ValueError("cull: the sphere table is not the sorted one "
                             "the chunk boxes cover (scene_for(tables, "
                             "cfg).table)")


class Images(NamedTuple):
    """What the kernels read of a scene whose primitives sample image
    textures: the atlas (SceneTables.images, every texel a float3) and
    the rect, cylinder and triangle UV tables, each cut after its
    family's last live row (possibly 0 rows)."""

    atlas: torch.Tensor  # [Ni, TH, TW, 3] f32
    rect: torch.Tensor   # [n_rects, U_COLS] f32
    cyl: torch.Tensor    # [n_cylinders, U_COLS] f32
    tri: torch.Tensor    # [n_triangles, U_COLS] f32


class Families(NamedTuple):
    """The rect, cylinder and triangle tables the kernels read beside the
    sphere table, each cut after its last live row (possibly 0 rows)."""

    rect: torch.Tensor   # [n_rects, F_COLS] f32
    cyl: torch.Tensor    # [n_cylinders, F_COLS] f32
    tri: torch.Tensor    # [n_triangles, F_COLS] f32


@dataclasses.dataclass(frozen=True)
class MegaScene:
    """What the megakernels read of a scene: the packed sphere table up
    to its last live sphere (live rows come first, build_tables pads
    behind them; one pad row, never hit, when the scene has no sphere),
    the other families' tables (`fam`, None when the scene has none of
    them, so that sphere-only scenes run the kernels without the family
    loops), the constant sky colour and the camera frame
    (ops/camera.camera_vec) as host floats, which the launchers pass by
    value, and the sizes of the adjoint accumulators: n_slots = n_tex +
    n_mat gradient slots, texture rows first (the reference pads them to
    128-lane slabs; the port needs no padding), and the atlas's shape
    (its gradient's). `lights`: the light table (light_table), None when
    the scene has no emitter. `img`: the atlas and the UV tables
    (Images), None when no primitive samples an image texture, so that
    the kernels run without the texture code. `cull`: the chunk boxes
    and SceneTables rows of the sorted families (Cull), None when
    nothing is sorted (cull=False, or a scene with no sphere and fewer
    than two triangle chunks), the tables then in scene order."""

    table: torch.Tensor          # [max(n_spheres, 1), S_COLS] f32
    fam: Optional[Families]
    bg: Tuple[float, float, float]
    cam: Tuple[float, ...]       # 19 floats, ops/camera.camera_vec
    n_tex: int
    n_mat: int
    atlas_shape: Tuple[int, ...] = (1, 1, 1, 3)
    lights: Optional[torch.Tensor] = None   # [n_lights, NL_COLS] f32
    img: Optional[Images] = None
    cull: Optional[Cull] = None

    @property
    def n_slots(self) -> int:
        return self.n_tex + self.n_mat

    @classmethod
    def of(cls, tables: SceneTables, cull: bool = False) -> "MegaScene":
        """The scene's tables; cull=True sorts them where the reference's
        _prep_scene does: the spheres when the scene has one, the
        triangles when their padded table holds at least two chunks."""
        ns, nr, nc, nt = tables.counts
        tab = sphere_table(tables)
        tri_tab = pad_chunked(triangle_table(tables))
        tri_uv = (pad_chunked(triangle_uv_table(tables)) if tables.has_images
                  else None)
        boxes = [None, None, None, None]
        if cull and ns > 0:
            tab, boxes[0], order = sort_spheres_morton(tab)
            boxes[2] = order[:ns].to(torch.int32)
        if cull and nt > 0 and tri_tab.shape[0] // min(
                tri_tab.shape[0], SPH_CHUNK) >= 2:
            tri_tab, boxes[1], order = sort_triangles_morton(tri_tab)
            boxes[3] = order[:nt].to(torch.int32)
            if tri_uv is not None:
                tri_uv = tri_uv[order]
        chunks = (-(-ns // SPH_CHUNK), -(-nt // SPH_CHUNK))
        tab = tab[:max(ns, 1)].detach().contiguous()
        cut = Cull(*(None if b is None else
                     b[:chunks[k]].detach().contiguous() if k < 2 else
                     b.detach().contiguous() for k, b in enumerate(boxes)),
                   table=tab)
        fam = None
        if tables.has_families:
            fam = Families(*(t[:n].detach().contiguous() for t, n in (
                (rect_table(tables), nr), (cylinder_table(tables), nc),
                (tri_tab, nt))))
        img = None
        if tables.has_images:
            img = Images(tables.images.detach().to(torch.float32)
                         .contiguous(),
                         *(t[:n].detach().contiguous() for t, n in (
                             (rect_uv_table(tables), nr),
                             (cylinder_uv_table(tables), nc),
                             (tri_uv, nt))))
        bg = tables.background.detach().to("cpu", torch.float32).tolist()
        return cls(table=tab, fam=fam,
                   bg=tuple(float(v) for v in bg),
                   cam=camera_vec(tables.camera),
                   n_tex=int(tables.tex_color.shape[0]),
                   n_mat=int(tables.mat_albedo.shape[0]),
                   atlas_shape=tuple(tables.images.shape),
                   lights=(light_table(tables).detach().contiguous()
                           if tables.n_lights else None),
                   img=img,
                   cull=None if all(b is None for b in boxes) else cut)


def scene_for(tables: SceneTables, cfg) -> MegaScene:
    """The MegaScene a trace under cfg reads: sorted and culled with
    cfg.cull_chunks (SceneTables.mega_culled), else in scene order
    (SceneTables.mega)."""
    return tables.mega_culled if cfg.cull_chunks else tables.mega
