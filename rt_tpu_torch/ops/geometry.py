"""Vector math on trailing-dim-3 float32 tensors, and the 4x4 affine
transforms of the cylinders (rt_tpu/ops/geometry.py).

The one-hot MXU gather there becomes plain indexing here. The host
transforms (`identity_transform` .. `compose`) build (m, m_inv) pairs of
[4, 4] NumPy float32 arrays in the reference's arithmetic, so the scene
tables compare bit for bit; `apply_point`, `apply_vec` and
`apply_normal` apply them to [..., 3] tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def dot(a, b):
    return (a * b).sum(dim=-1)


def length_squared(v):
    return dot(v, v)


def length(v):
    return torch.sqrt(length_squared(v))


def unit(v):
    return v / length(v)[..., None]


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def safe_length(v):
    """|v|, 0 where v = 0."""
    l2 = length_squared(v)
    pos = l2 > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, l2, 1.0)), 0.0)


def safe_div(num, den):
    """num / den, 0 where den = 0."""
    ok = den != 0.0
    return torch.where(ok, num / torch.where(ok, den, 1.0), 0.0)


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


# ---------------------------------------------------------------------------
# Affine transforms: (m, m_inv) pairs of [4, 4] float32 arrays, built on
# the host as the reference builds them (gpu-version/vec3.cuh:388-427:
# translate and rotate construct their analytic inverse).
# ---------------------------------------------------------------------------


def identity_transform():
    m = np.eye(4, dtype=np.float32)
    return m, m.copy()


def translate(delta):
    m = np.eye(4, dtype=np.float32)
    minv = np.eye(4, dtype=np.float32)
    m[:3, 3] = np.asarray(delta, dtype=np.float32)
    minv[:3, 3] = -np.asarray(delta, dtype=np.float32)
    return m, minv


def rotate(axis, theta):
    """Rotation by theta radians about `axis` (vec3.cuh:396-418); the
    inverse is the transpose."""
    a = np.asarray(axis, dtype=np.float64)
    a = a / np.linalg.norm(a)
    x, y, z = a
    s, c = np.sin(theta), np.cos(theta)
    m = np.eye(4, dtype=np.float32)
    m[0, 0] = x * x + (1 - x * x) * c
    m[0, 1] = x * y * (1 - c) - z * s
    m[0, 2] = x * z * (1 - c) + y * s
    m[1, 0] = x * y * (1 - c) + z * s
    m[1, 1] = y * y + (1 - y * y) * c
    m[1, 2] = y * z * (1 - c) - x * s
    m[2, 0] = x * z * (1 - c) - y * s
    m[2, 1] = y * z * (1 - c) + x * s
    m[2, 2] = z * z + (1 - z * z) * c
    return m, m.T.copy()


def scale(sx, sy, sz):
    m = np.diag(np.array([sx, sy, sz, 1.0], dtype=np.float32))
    minv = np.diag(np.array([1.0 / sx, 1.0 / sy, 1.0 / sz, 1.0],
                            dtype=np.float32))
    return m, minv


def compose(t2, t1):
    """t2 @ t1 as a (m, m_inv) pair: apply t1 first, then t2
    (transform::operator*, vec3.cuh:345-347)."""
    m2, m2i = t2
    m1, m1i = t1
    return np.asarray(m2) @ np.asarray(m1), np.asarray(m1i) @ np.asarray(m2i)


def _rows3(m, v):
    """m[..., :3, :3] @ v per axis, ((m0 v0 + m1 v1) + m2 v2)."""
    return torch.stack([m[..., i, 0] * v[..., 0] + m[..., i, 1] * v[..., 1]
                        + m[..., i, 2] * v[..., 2] for i in range(3)],
                       dim=-1)


def apply_point(m, p):
    """Transform points [..., 3] by affine matrices [..., 3 or 4, 4]
    (vec3.cuh:350-360; the bottom row is never projective)."""
    return _rows3(m, p) + m[..., :3, 3]


def apply_vec(m, v):
    return _rows3(m, v)


def apply_normal(minv, n):
    """Normals by the inverse-transpose (vec3.cuh:376-381), not
    renormalised, as the reference."""
    return _rows3(minv.transpose(-1, -2), n)


def apply_ray(m, ro, rd):
    """Transform a ray: origin as point, direction as vector (ray.cuh:25)."""
    return apply_point(m, ro), apply_vec(m, rd)
