"""Vector math on trailing-dim-3 float32 tensors.

The port of rt_tpu/ops/geometry.py for what the sphere slice uses. The
one-hot MXU gather there becomes plain indexing here; the 4x4 affine
transforms arrive with the cylinder family.
"""

from __future__ import annotations

import math

import torch


def dot(a, b):
    return (a * b).sum(dim=-1)


def length_squared(v):
    return dot(v, v)


def length(v):
    return torch.sqrt(length_squared(v))


def unit(v):
    return v / length(v)[..., None]


def safe_sqrt(x):
    """sqrt(max(x, 0))."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def reflect(v, n):
    """v - 2*dot(v,n)*n   (gpu-version/vec3.cuh:119)."""
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(uv, n, etai_over_etat):
    """Snell refraction of the *unit* vector uv (gpu-version/vec3.cuh:125-131)."""
    cos_theta = torch.clamp(dot(-uv, n), max=1.0)
    r_out_perp = etai_over_etat[..., None] * (uv + cos_theta[..., None] * n)
    r_out_parallel = (
        -safe_sqrt(torch.abs(1.0 - length_squared(r_out_perp)))[..., None]
        * n)
    return r_out_perp + r_out_parallel


def take_rows(table, idx):
    """table[idx] along the first axis, for the per-lane lookups of a
    parameter table by winner or material id (the reference's one-hot
    gather). index_select's backward is an index_add_ (atomic adds on
    CUDA), where indexing's backward sorts the indices and sums each
    row's duplicates serially, and half of a frame's lanes hit the
    ground sphere."""
    return torch.index_select(table, 0, idx)


def degrees_to_radians(deg):
    return deg * (math.pi / 180.0)
