"""rt_tpu_torch.ops.rng against rt_tpu.ops.rng's NumPy path: the integer
stream must be bit-identical, the float warps equal within 1e-6. Also:
the port imports with JAX (and the JAX package, and Pillow) blocked."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rt_tpu.ops import rng as jrng
from rt_tpu_torch.ops import rng as trng

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's default of one thread per core in each of them
# oversubscribes the CPU many times over.
torch.set_num_threads(1)

EDGE = np.array([0, 1, 0xFFFFFFFF, 0x7FFFFFFF, 0x80000000], np.uint64)


def _words(n=100_000, seed=0):
    rs = np.random.default_rng(seed)
    w = rs.integers(0, 2**32, n, dtype=np.uint64)
    return np.concatenate([EDGE, w]).astype(np.uint32)


def _t(x):
    return torch.from_numpy(x.astype(np.int64)) if isinstance(x, np.ndarray) else x


W = _words()
# (seed, pixel, sample, bounce, purpose): every coordinate takes the
# edge words and 1e5 random ones in some case
COORDS = {
    "pixel": (42, W, 3, 5, jrng.SCAT_U1),
    "seed+sample": (W, 7, W[::-1].copy(), 1, jrng.PIXEL_U),
    "bounce+purpose": (0xFFFFFFFF, 0, 0, W, W[::-1].copy()),
    "all": (W, W[::-1].copy(), W, np.roll(W, 1), np.roll(W, 2)),
}


@pytest.mark.parametrize("case", sorted(COORDS))
def test_key_bit_identical(case):
    args = COORDS[case]
    want = np.asarray(jrng.key(np, *args)).astype(np.int64)
    got = trng.key(*map(_t, args))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", sorted(COORDS))
def test_uniform_bit_identical(case):
    args = COORDS[case]
    want = jrng.uniform(np, *args)
    got = trng.uniform(*map(_t, args))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_triple32_and_fold_bit_identical():
    np.testing.assert_array_equal(trng.triple32(_t(W)).numpy(),
                                  np.asarray(jrng.triple32(np, W), np.int64))
    np.testing.assert_array_equal(
        trng.fold(_t(W), _t(W[::-1].copy())).numpy(),
        np.asarray(jrng.fold(np, W, W[::-1].copy()), np.int64))


def test_scalar_coordinates():
    """Python-int coordinates give the same words as tensors do."""
    for pixel in (0, 1, 0xFFFFFFFF, 123456789):
        want = int(jrng.key(np, 5, np.uint32(pixel), 2, 3, 4))
        assert int(trng.key(5, pixel, 2, 3, 4)) == want
        assert int(trng.key(5, torch.tensor([pixel]), 2, 3, 4)[0]) == want


def test_int32_pixels_match():
    """int32 pixel ids (what the renderer's tiles hold) hash like uint32."""
    pix = np.arange(0, 2**31 - 1, 2**31 // 1000, dtype=np.int64)
    want = jrng.uniform(np, 9, pix.astype(np.uint32), 1, 2, jrng.RR)
    got = trng.uniform(9, torch.from_numpy(pix.astype(np.int32)), 1, 2, jrng.RR)
    np.testing.assert_array_equal(got.numpy(), want)


def test_purpose_constants_match():
    names = [n for n in dir(jrng) if n.isupper() and not n.startswith("_")
             and isinstance(getattr(jrng, n), int)]
    assert names
    for n in names:
        assert getattr(trng, n) == getattr(jrng, n), n


@pytest.mark.parametrize("fn", ["in_unit_ball", "in_unit_disk"])
def test_warps_within_1e6(fn):
    want = getattr(jrng, fn)(np, 3, W, 2, 1)
    got = getattr(trng, fn)(3, _t(W), 2, 1)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert float(got.norm(dim=-1).max()) <= 1.0 + 1e-6


def test_port_imports_without_jax():
    """Every module of rt_tpu_torch imports with jax, jaxlib, rt_tpu and
    PIL blocked — the card's machine has none of them."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'jaxlib', 'rt_tpu', 'PIL'):\n"
        "    sys.modules[m] = None\n"
        "import rt_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(rt_tpu_torch.__path__,"
        " 'rt_tpu_torch.') if m.name != 'rt_tpu_torch.__main__']\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'rt_tpu.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print(len(mods))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 15
