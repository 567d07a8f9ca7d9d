"""Counter-based RNG keyed on (seed, pixel, sample, bounce, purpose).

The port of rt_tpu/ops/rng.py. Every draw is a pure hash of its
coordinates, so no generator state exists on the render path and the
integer stream is bit-identical to the reference's NumPy path
(`rt_tpu.ops.rng` with xp=np), which the tests check word for word.

torch has a uint32 dtype but almost no arithmetic on it, so words are
held in int64 in [0, 2**32) and reduced with `& 0xFFFFFFFF`. A 32x32-bit
product would overflow int64, so each multiply by a 32-bit constant is
split into its 16-bit halves: no partial product exceeds 2**48.

Arguments broadcast: each of seed / pixel / sample / bounce / purpose
may be a Python int or an integer tensor.
"""

from __future__ import annotations

import math

import torch

# Draw "purposes" — one stream per use-site per bounce (the reference's
# constants, rt_tpu/ops/rng.py:30-42).
PIXEL_U = 1
PIXEL_V = 2
LENS_U1 = 3
LENS_U2 = 4
SCAT_U1 = 5
SCAT_U2 = 6
SCAT_U3 = 7
DIEL_REFL = 8
RR = 9
SCENE_GEN = 10
NEE_PICK = 11
NEE_U1 = 12
NEE_U2 = 13

_GOLD = 0x9E3779B9  # 2**32 / golden ratio; Weyl increment for key words
_MASK = 0xFFFFFFFF


def resolve(sampler: str):
    """The draw module of a RenderConfig.sampler name (the reference's
    rng.resolve): this module for "rng" (triple32), ops/qmc.py for "qmc"
    (Owen-scrambled Sobol'). Both have uniform / in_unit_ball /
    in_unit_disk with the same arguments."""
    if sampler == "qmc":
        from rt_tpu_torch.ops import qmc

        return qmc
    if sampler != "rng":
        raise ValueError(f"unknown sampler {sampler!r} (want 'rng' or 'qmc')")
    import sys

    return sys.modules[__name__]


def _u32(x):
    """A word as int64 in [0, 2**32) (Python ints stay Python ints)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _MASK
    return int(x) & _MASK


def _mul32(x, c: int):
    """(x * c) mod 2**32 for a word x and a 32-bit constant c."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK


def triple32(x):
    """Full-avalanche 32-bit mixer (public-domain 'triple32' constants)."""
    x = _u32(x)
    x = x ^ (x >> 17)
    x = _mul32(x, 0xED5AD4BB)
    x = x ^ (x >> 11)
    x = _mul32(x, 0xAC4C1B51)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x31848BAB)
    x = x ^ (x >> 14)
    return x


def fold(state, word):
    """Absorb one 32-bit word into the hash state."""
    return triple32((_u32(state) + _mul32(_u32(word), _GOLD)) & _MASK)


def key(seed, pixel, sample, bounce, purpose):
    """The 32-bit hash (as int64) of one draw coordinate."""
    s = fold(_u32(seed), pixel)
    s = fold(s, sample)
    s = fold(s, bounce)
    s = fold(s, purpose)
    return s


def uniform(seed, pixel, sample, bounce, purpose):
    """U[0,1) float32 draw: the hash's 24 high bits, exact in float32."""
    bits = torch.as_tensor(key(seed, pixel, sample, bounce, purpose))
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def in_unit_ball(seed, pixel, sample, bounce):
    """Uniform point in the unit ball (analytic, rejection-free), [..., 3].

    torch has no cbrt; pow(u, 1/3) differs from it by ulps only."""
    u1 = uniform(seed, pixel, sample, bounce, SCAT_U1)
    u2 = uniform(seed, pixel, sample, bounce, SCAT_U2)
    u3 = uniform(seed, pixel, sample, bounce, SCAT_U3)
    r = torch.pow(u1, 1.0 / 3.0)
    cos_t = 1.0 - 2.0 * u2
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = (2.0 * math.pi) * u3
    x = r * sin_t * torch.cos(phi)
    y = r * sin_t * torch.sin(phi)
    z = r * cos_t
    return torch.stack([x, y, z], dim=-1)


def in_unit_disk(seed, pixel, sample, bounce):
    """Uniform point in the unit disk (z=0), for thin-lens defocus."""
    u1 = uniform(seed, pixel, sample, bounce, LENS_U1)
    u2 = uniform(seed, pixel, sample, bounce, LENS_U2)
    r = torch.sqrt(u1)
    phi = (2.0 * math.pi) * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi),
                        torch.zeros_like(r)], dim=-1)
