"""Owen-scrambled Sobol' sampler (QMC), the drop-in alternative to
ops/rng.py that RenderConfig.sampler = "qmc" selects.

The port of rt_tpu/ops/qmc.py, in ops/rng.py's idiom: words held in int64
in [0, 2**32), every 32x32-bit product split by rng._mul32. Its words
are bit-identical to the reference's NumPy path (`rt_tpu.ops.qmc` with
xp=np), which the tests check word for word, and to the kernels' twin
(csrc/rng.cuh `qmc_uniform`).

Each draw site (pixel jitter, lens disk, scatter ball, dielectric
choice, roulette, NEE) takes Sobol' dimensions 0..2 of its own padded
copy of the sequence. Its scramble keys come from the triple32 fold
chain of ops/rng.py with QMC_TAG in the sample's slot, so a draw stays a
pure function of (seed, pixel, sample, bounce, purpose): the sample
picks the Sobol' index instead. The index and the value each pass a
nested uniform scramble (bit reversal, a Laine-Karras permutation, bit
reversal), an Owen scramble of the base-2 digits, so every
power-of-two prefix of samples stays a (t, k, s)-net.
"""

from __future__ import annotations

import math

import torch

from rt_tpu_torch.ops import rng
from rt_tpu_torch.ops.rng import _MASK, _mul32, _u32

# the Laine-Karras multiplies (even, so x ^= x * c feeds no bit into
# itself)
_LK = (0x6C50B47C, 0xB82F1E52, 0xC7AFE638, 0x8D22F6E6)


def reverse_bits(x):
    """Bit-reverse a word (5-step butterfly)."""
    x = _u32(x)
    x = ((x >> 1) & 0x55555555) | ((x & 0x55555555) << 1)
    x = ((x >> 2) & 0x33333333) | ((x & 0x33333333) << 2)
    x = ((x >> 4) & 0x0F0F0F0F) | ((x & 0x0F0F0F0F) << 4)
    x = ((x >> 8) & 0x00FF00FF) | ((x & 0x00FF00FF) << 8)
    return ((x >> 16) | (x << 16)) & _MASK


def _lk(x, seed):
    """The Laine-Karras permutation of a bit-reversed word, offset by
    the seed."""
    x = (_u32(x) + _u32(seed)) & _MASK
    for c in _LK:
        x = x ^ _mul32(x, c)
    return x


def nested_scramble(x, seed):
    """Owen scramble of a word's digits: output bit b depends only on
    input bits >= b."""
    return reverse_bits(_lk(reverse_bits(x), seed))


def _direction_vectors():
    """Direction vectors (v_i = m_i << (31 - i)) of Sobol' dimensions 1
    and 2 (dimension 0 is the bit reversal): x + 1 with m = [1], and
    x^2 + x + 1 with m = [1, 3], the Joe-Kuo initial values."""
    m = [1]
    for i in range(1, 32):
        m.append((m[i - 1] << 1) ^ m[i - 1])
    d1 = tuple((mi << (31 - i)) & _MASK for i, mi in enumerate(m))
    m = [1, 3]
    for i in range(2, 32):
        m.append((m[i - 1] << 1) ^ (m[i - 2] << 2) ^ m[i - 2])
    d2 = tuple((mi << (31 - i)) & _MASK for i, mi in enumerate(m))
    return d1, d2


DIRS = _direction_vectors()


def sobol_bits(idx, dim: int):
    """The Sobol' point (a word) of sample index idx in dimension 0-2."""
    idx = _u32(idx)
    if dim == 0:
        return reverse_bits(idx)
    acc = idx * 0 if isinstance(idx, torch.Tensor) else 0
    for i, v in enumerate(DIRS[dim - 1]):
        acc = acc ^ (((idx >> i) & 1) * v)
    return acc


# purpose -> (site, dim): each site is one padded low-dimensional slice
_SITE = {
    rng.PIXEL_U: (0, 0), rng.PIXEL_V: (0, 1),
    rng.LENS_U1: (1, 0), rng.LENS_U2: (1, 1),
    rng.SCAT_U1: (2, 0), rng.SCAT_U2: (2, 1), rng.SCAT_U3: (2, 2),
    rng.DIEL_REFL: (3, 0),
    rng.RR: (4, 0),
    rng.NEE_PICK: (6, 0), rng.NEE_U1: (6, 1), rng.NEE_U2: (6, 2),
}

# the word in the key chain's sample slot for site keys (the scramble
# must not vary per sample; it also keeps site keys apart from rng's)
QMC_TAG = 0x51D0B07
_SITE_BASE = 0x100  # site ids lie above every rng purpose id


def site_seeds(seed, pixel, bounce, site: int, dim: int):
    """(shuffle seed, value seed) of one (pixel, bounce, site, dim)."""
    sk = rng.key(seed, pixel, QMC_TAG, bounce, _SITE_BASE + site)
    return rng.fold(sk, 1), rng.fold(sk, 2 + dim)


def uniform(seed, pixel, sample, bounce, purpose):
    """U[0,1) float32 draw with rng.uniform's signature, from the
    scrambled Sobol' sequence. A purpose outside the sites (SCENE_GEN)
    takes rng.uniform's draw."""
    purpose = int(purpose)
    if purpose not in _SITE:
        return rng.uniform(seed, pixel, sample, bounce, purpose)
    site, dim = _SITE[purpose]
    shuf, val = site_seeds(seed, pixel, bounce, site, dim)
    idx = nested_scramble(sample, shuf)
    bits = torch.as_tensor(nested_scramble(sobol_bits(idx, dim), val))
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def in_unit_ball(seed, pixel, sample, bounce):
    """A point of the unit ball by rng.in_unit_ball's map, from the
    scatter site's three dimensions; pow(u, 1/3) for the reference's
    cbrt, as rng.in_unit_ball."""
    u1 = uniform(seed, pixel, sample, bounce, rng.SCAT_U1)
    u2 = uniform(seed, pixel, sample, bounce, rng.SCAT_U2)
    u3 = uniform(seed, pixel, sample, bounce, rng.SCAT_U3)
    r = torch.pow(u1, 1.0 / 3.0)
    cos_t = 1.0 - 2.0 * u2
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = (2.0 * math.pi) * u3
    return torch.stack([r * sin_t * torch.cos(phi),
                        r * sin_t * torch.sin(phi), r * cos_t], dim=-1)


def in_unit_disk(seed, pixel, sample, bounce):
    """A point of the unit disk (z = 0) for thin-lens defocus, from the
    lens site's two dimensions."""
    u1 = uniform(seed, pixel, sample, bounce, rng.LENS_U1)
    u2 = uniform(seed, pixel, sample, bounce, rng.LENS_U2)
    r = torch.sqrt(u1)
    phi = (2.0 * math.pi) * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi),
                        torch.zeros_like(r)], dim=-1)
