"""The plain version of the tape-capture kernel B4 (rt_tpu_torch's
ops/mega_plain.capture_plain, reached through ops/cuda_mega.mega_capture
on CPU tensors) against rt_tpu's Pallas capture kernel
(ops/pallas_mega.mega_capture, `_capture_kernel` :1978) in interpret
mode, as tests/test_tape.py runs it on the CPU, on tests/test_tape.py's
mixed scene at 24x16, with and without roulette, cull_chunks=False on
rt_tpu's side (ROADMAP C-3).

Codes must be equal on every lane alive entering its bounce (the kernel
stops writing codes for a tile once it is dead, so a dead lane may hold
a stale code there and -1 here), and the death counts on every lane.
The CUDA kernel is held against the plain version bit for bit on the
card (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest

from rt_tpu.ops import pallas_mega as jmega
from rt_tpu.ops.camera import generate_rays as jrays
from rt_tpu_torch.ops import cuda_mega, rng
from test_torch_tape import W, H, alive_entering, mixed_scene, pixels, \
    port_rays


@pytest.mark.parametrize("p_rr", [0.0, 0.9])
def test_plain_capture_matches_pallas_capture(p_rr):
    jt, jcfg, tt, cfg = mixed_scene(max_depth=6, p_rr=p_rr)
    px, py = (jnp.asarray(x) for x in pixels())
    jpix = (py * W + px).astype(jnp.int32)
    jro, jrd = jrays(jt.camera, W, H, px, py, jnp.zeros(W * H, jnp.uint32),
                     jnp.uint32(0), False)
    jcodes, jdeath = jmega.mega_capture(jt, jcfg, jro, jrd, jpix,
                                        jnp.uint32(0), jnp.uint32(0))
    jcodes, jdeath = np.asarray(jcodes), np.asarray(jdeath)

    pix, ro, rd = port_rays(tt, cfg)
    before = cuda_mega.mega_capture.launches
    codes, death = cuda_mega.mega_capture(tt, cfg, ro, rd, pix, 0, 0)
    assert cuda_mega.mega_capture.launches == before  # CPU: plain version
    codes, death = codes.numpy(), death.numpy()
    assert codes.dtype == np.int32 and death.dtype == np.int32
    assert codes.shape == (cfg.max_depth, W * H)

    live = np.arange(cfg.max_depth)[:, None] <= death[None, :]
    np.testing.assert_array_equal(death, jdeath)
    assert (codes[live] == jcodes[live]).all()
    assert (codes[~live] == -1).all()
    # roulette: a lane it stops at bounce b still records b's winner
    if p_rr:
        b = np.arange(cfg.max_depth)
        u = np.stack([rng.uniform(0, pix, 0, int(k), rng.RR).numpy()
                      for k in b])
        stopped = live & (u > p_rr)
        assert (death[None, :] == b[:, None])[stopped].all()
        assert (codes[stopped] >= 0).any()
    # the death counts are the integrator's alive chain
    _, chain = alive_entering(tt, cfg, pix, ro, rd)
    np.testing.assert_array_equal(death, chain.numpy())
