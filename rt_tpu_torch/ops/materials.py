"""Materials and textures: table lookups + integer-switch dispatch
(rt_tpu/ops/materials.py:86-219, gpu-version/material.cuh:14-182,
texture.cuh:7-57).

Scatter semantics per material:
  lambertian    — dir = normal + unit-ball sample; degenerate -> normal
  metal         — dir = reflect(unit(in), n) + fuzz*ball; absorbed when
                  scattered below the horizon
  dielectric    — Schlick reflectance vs refraction with total internal
                  reflection; attenuation = 1
  diffuse_light — never scatters; emits its texture value

Textures: solid colour, checker and image (the atlas `tables.images`,
nearest texel at the hit's UV). Parameters are fetched with indexed
gathers where the reference uses one-hot MXU products (both are exact);
a texel is a row of the atlas flattened to [Ni*TH*TW, 3], gathered by
geom.take_rows, so autograd scatter-adds its gradient with index_add_.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rt_tpu_torch.ops import geometry as geom
from rt_tpu_torch.scene.types import (
    MAT_DIELECTRIC,
    MAT_DIFFUSE_LIGHT,
    MAT_LAMBERTIAN,
    MAT_METAL,
    TEX_CHECKER,
    TEX_IMAGE,
    SceneTables,
)


class Scatter(NamedTuple):
    ok: torch.Tensor           # [B] bool — False = absorbed / pure emitter
    direction: torch.Tensor    # [B,3] scattered direction (unnormalized)
    attenuation: torch.Tensor  # [B,3]


def texel_index(u, n: int):
    """The nearest texel of coordinate u along an axis of n texels: u
    wrapped to [0, 1), times n, clamped to [0, n - 1] and truncated
    (taichi material.py:137-144, rt_tpu pallas_mega.py:1397-1400); a NaN
    lands on texel 0, as the kernels' fmaxf / fminf put it."""
    f = torch.nan_to_num((u - torch.floor(u)) * float(n), nan=0.0)
    return torch.clamp(f, 0.0, float(n - 1)).to(torch.int64)


def texel_rows(images, img_id, u, v):
    """Rows of the atlas images [Ni,TH,TW,3] flattened to [Ni*TH*TW, 3]
    that (img_id, u, v) sample: u indexes the first image axis (TH), v
    the second (TW)."""
    th, tw = images.shape[1], images.shape[2]
    return ((img_id.long() * th + texel_index(u, th)) * tw
            + texel_index(v, tw))


def _texture_eval(tables: SceneTables, tex_id, u, v, p):
    """Textures [B] -> [B,3]. solid_color: constant (texture.cuh:14-31);
    checker: sin(10x)sin(10y)sin(10z) parity (texture.cuh:44-52); image:
    the atlas texel at (u, v) (texel_rows), evaluated when a live
    primitive samples an image (tables.has_images)."""
    row = torch.where(tex_id >= 0, tex_id, 0).long()
    solid = geom.take_rows(tables.tex_color, row)
    color2 = geom.take_rows(tables.tex_color2, row)
    sines = (torch.sin(10.0 * p[:, 0]) * torch.sin(10.0 * p[:, 1])
             * torch.sin(10.0 * p[:, 2]))
    checker = torch.where((sines < 0.0)[:, None], color2, solid)
    ttype = tables.tex_type[row]
    out = torch.where((ttype == TEX_CHECKER)[:, None], checker, solid)
    if tables.has_images:
        img_id = torch.clamp(tables.tex_image[row], min=0)
        image = geom.take_rows(tables.images.reshape(-1, 3),
                               texel_rows(tables.images, img_id, u, v))
        out = torch.where((ttype == TEX_IMAGE)[:, None], image, out)
    return out


def texture_value(tables: SceneTables, tex_id, u, v, p):
    return _texture_eval(tables, tex_id, u, v, p)


def _albedo_of(tables: SceneTables, row, u, v, p):
    """Texture value if the material references one, else its inline
    colour (lambertian(texture*) vs metal(color), material.cuh)."""
    tex = tables.mat_tex[row]
    from_tex = _texture_eval(tables, tex, u, v, p)
    return torch.where((tex >= 0)[:, None], from_tex,
                       geom.take_rows(tables.mat_albedo, row))


def material_albedo(tables: SceneTables, mat_id, u, v, p):
    return _albedo_of(tables, mat_id.long(), u, v, p)


def emitted(tables: SceneTables, mat_id, u, v, p):
    """diffuse_light::emitted (material.cuh:175-178); 0 for the rest."""
    row = mat_id.long()
    is_light = tables.mat_type[row] == MAT_DIFFUSE_LIGHT
    return torch.where(is_light[:, None], _albedo_of(tables, row, u, v, p),
                       torch.zeros_like(p))


def schlick(cosine, ref_idx):
    """Schlick reflectance (material.cuh:154-158). The fifth power is
    multiplied out in the order XLA's integer_pow uses: x * (x*x)^2."""
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    x = 1.0 - cosine
    x2 = x * x
    return r0 + (1.0 - r0) * (x * (x2 * x2))


def shade(tables: SceneTables, mat_id, rd, normal, front_face, u, v, p,
          ball_sample, refl_u):
    """One-pass material evaluation: (Scatter, emitted [B,3]).

    ball_sample: [B,3] unit-ball draw (shared by lambertian and metal).
    refl_u: [B] U[0,1) draw for the dielectric reflect/refract choice."""
    row = mat_id.long()
    mtype = tables.mat_type[row]
    fuzz = geom.take_rows(tables.mat_fuzz, row)
    ir = geom.take_rows(tables.mat_ior, row)
    albedo = _albedo_of(tables, row, u, v, p)

    # lambertian
    lam_dir = normal + ball_sample
    degenerate = torch.all(torch.abs(lam_dir) < 1e-8, dim=-1)
    lam_dir = torch.where(degenerate[:, None], normal, lam_dir)

    # metal
    unit_in = geom.unit(rd)
    met_dir = geom.reflect(unit_in, normal) + fuzz[:, None] * ball_sample
    met_ok = geom.dot(met_dir, normal) > 0.0

    # dielectric
    ratio = torch.where(front_face, 1.0 / torch.where(ir == 0.0, 1.0, ir), ir)
    cos_theta = torch.clamp(geom.dot(-unit_in, normal), max=1.0)
    sin_theta = geom.safe_sqrt(1.0 - cos_theta * cos_theta)
    cannot_refract = ratio * sin_theta > 1.0
    reflect_choice = cannot_refract | (schlick(cos_theta, ratio) > refl_u)
    die_dir = torch.where(reflect_choice[:, None],
                          geom.reflect(unit_in, normal),
                          geom.refract(unit_in, normal, ratio))

    is_lam = mtype == MAT_LAMBERTIAN
    is_met = mtype == MAT_METAL
    is_die = mtype == MAT_DIELECTRIC
    is_light = mtype == MAT_DIFFUSE_LIGHT

    direction = torch.where(
        is_lam[:, None], lam_dir,
        torch.where(is_met[:, None], met_dir,
                    torch.where(is_die[:, None], die_dir, normal)))
    attenuation = torch.where(
        is_die[:, None], torch.ones_like(albedo),
        torch.where(is_light[:, None], torch.zeros_like(albedo), albedo))
    ok = torch.where(is_met, met_ok, ~is_light)
    em = torch.where(is_light[:, None], albedo, torch.zeros_like(albedo))
    return Scatter(ok=ok, direction=direction, attenuation=attenuation), em


def scatter(tables, mat_id, rd, normal, front_face, u, v, p, ball_sample,
            refl_u) -> Scatter:
    """Back-compat wrapper around shade()."""
    sc, _ = shade(tables, mat_id, rd, normal, front_face, u, v, p,
                  ball_sample, refl_u)
    return sc
