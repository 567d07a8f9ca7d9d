"""The plain version of the regeneration kernel B7 (rt_tpu_torch's
ops/mega_plain.regen_plain, reached through ops/cuda_mega.mega_regen on
CPU tensors) against rt_tpu's Pallas regen kernel
(ops/pallas_mega.mega_regen, `_regen_kernel` :2288) in interpret mode,
as tests/test_mega.py runs it on the CPU, with cull_chunks=False on
rt_tpu's side (ROADMAP C-3), at 32x24, spp 2, depth 6.

Per lane, after a capped segment and after a whole one: the radiance,
the sample counter and the alive word, on >= 99% of lanes. XLA-CPU's
sin, cos, exp, log and rsqrt round a few ulps from torch's, which the
bounces carry on: on the Cornell scene the radiance agrees within 1e-5
(the tape tests' tolerance) on every lane; on the cover scene (the
defocus disk, the checker's sines, the gradient sky) 96% of lanes agree
within 1e-5 and 99.2% within 1e-4, as the port's per-sample megakernel
trace agrees with rt_tpu's (96.6% and 99.3%; tests/test_torch_mega.py
gates it at 1e-4), so the cover scene is held at 1e-4. The init
segment's camera rays are held against rt_tpu's generate_rays within
1e-5 (the defocus disk's sin and cos). The CUDA kernel is held against
the plain version bit for bit on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt_tpu.ops import pallas_mega as jmega
from rt_tpu.ops.camera import generate_rays as jrays
from rt_tpu_torch.ops import cuda_mega, mega_plain
from test_torch_regen import _scene

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's default of one thread per core in each of them
# oversubscribes the CPU many times over.
torch.set_num_threads(1)

W, H, SPP, DEPTH = 32, 24, 2, 6
SEED, BASE = 3, 5


def _jax_regen(jt, cj, seg_iters):
    """rt_tpu's mega_regen over the frame's pixels (padded to its
    2048-lane tile with pixel 0), from an init segment: (radiance
    [W*H, 3], samp, bvec, alive)."""
    cj = cj.replace(cull_chunks=False)
    (tbl, sph, rect, cyl, tri, sbnd, tbnd, sph_co, uv, atlas, counts,
     kw) = jmega._prep_scene(jt, cj)
    b = W * H
    bp = -(-b // jmega.RAY_TILE) * jmega.RAY_TILE
    pix = np.zeros(bp, np.int32)
    pix[:b] = np.arange(b)
    pix = jnp.asarray(pix)
    zeros = jnp.zeros((bp,), jnp.float32)
    zi = jnp.zeros((bp,), jnp.int32)
    st, samp, bvec = jmega.mega_regen(
        sph, rect, cyl, tri, sbnd, tbnd, sph_co, uv, atlas, counts,
        tbl.background, jmega.camera_vec(tbl.camera), (zeros,) * 13, pix,
        pix // W, zi, zi, jnp.int32(BASE), jnp.int32(SEED),
        jnp.int32(seg_iters), max_depth=DEPTH, spp=SPP, init=True, width=W,
        height=H, defocus=bool(cj.enable_defocus),
        exhaust_bg=cj.exhaust_mode == "background", **kw)
    rgb = np.stack([np.asarray(c)[:b] for c in st[9:12]], -1)
    return (rgb, np.asarray(samp)[:b], np.asarray(bvec)[:b],
            np.asarray(st[12])[:b])


def _port_regen(tt, cfg, seg_iters):
    cfg = cfg.replace(cull_chunks=False)  # _jax_regen's
    b = W * H
    pix = torch.arange(b, dtype=torch.int32)
    state = torch.zeros((13, b))
    samp = torch.zeros(b, dtype=torch.int32)
    bvec = torch.zeros(b, dtype=torch.int32)
    before = cuda_mega.mega_regen.launches
    cuda_mega.mega_regen(
        tt.mega.table, tt.mega.cam, state, pix, pix // W, samp, bvec, BASE,
        SEED, seg_iters, max_depth=DEPTH, spp=SPP, init=True, width=W,
        height=H, defocus=cfg.enable_defocus,
        exhaust_bg=cfg.exhaust_mode == "background",
        **mega_plain.trace_options(tt, cfg))
    assert cuda_mega.mega_regen.launches == before  # CPU: plain version
    return (state[mega_plain.C:mega_plain.C + 3].T.numpy(), samp.numpy(),
            bvec.numpy(), state[mega_plain.ALIVE].numpy())


@pytest.mark.parametrize("seg_iters", [5, SPP * (DEPTH + 1)],
                         ids=["capped", "whole"])
@pytest.mark.parametrize("name,extra,atol", [
    ("cover", {}, 1e-4),
    ("cornell", dict(exhaust_mode="background", background_mode="gradient"),
     1e-5),
], ids=["cover", "cornell_lens_exhaust"])
def test_plain_regen_matches_pallas_regen(name, extra, atol, seg_iters):
    tt, cfg, jt, cj = _scene(name, jax_too=True, width=W, height=H, spp=SPP,
                             max_depth=DEPTH)
    cfg, cj = cfg.replace(**extra), cj.replace(**extra)
    j_rgb, j_samp, j_bvec, j_alive = _jax_regen(jt, cj, seg_iters)
    t_rgb, t_samp, t_bvec, t_alive = _port_regen(tt, cfg, seg_iters)
    ok = ((np.abs(t_rgb - j_rgb) <= atol).all(-1) & (t_samp == j_samp)
          & (t_alive == j_alive))
    assert ok.mean() >= 0.99, ok.mean()
    # a lane still pending runs every iteration in both, so its bounce
    # counter agrees too (a finished lane's stops counting in the port)
    pending = (j_alive > 0) | (j_samp + 1 < BASE + SPP)
    assert (t_bvec == j_bvec)[pending & ok].all()
    if seg_iters == SPP * (DEPTH + 1):
        assert not pending.any() and (t_samp == BASE + SPP - 1).all()
    else:
        assert pending.any()
    assert float(t_rgb.max()) > 0.0


@pytest.mark.parametrize("name", ["cover", "cornell"])
def test_init_camera_rays_match_jax_generate_rays(name):
    """The init segment's rays (a zero-iteration segment) against rt_tpu's
    generate_rays at sample BASE, within 1e-5 (XLA-CPU's sin and cos of
    the defocus disk)."""
    tt, cfg, jt, cj = _scene(name, jax_too=True, width=W, height=H, spp=SPP,
                             max_depth=DEPTH)
    jt = jax.tree.map(jnp.asarray, jt)
    pix = np.arange(W * H, dtype=np.int32)
    jro, jrd = jrays(jt.camera, W, H, jnp.asarray(pix % W),
                     jnp.asarray(pix // W), BASE, SEED, cj.enable_defocus)
    b = W * H
    state = torch.zeros((13, b))
    samp = torch.zeros(b, dtype=torch.int32)
    tpix = torch.from_numpy(pix)
    cuda_mega.mega_regen(tt.mega.table, tt.mega.cam, state, tpix, tpix // W,
                         samp, samp.clone(), BASE, SEED, 0, max_depth=DEPTH,
                         spp=SPP, init=True, width=W, height=H,
                         defocus=cfg.enable_defocus, bg=tt.mega.bg)
    np.testing.assert_allclose(state[0:3].T.numpy(), np.asarray(jro),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(state[3:6].T.numpy(), np.asarray(jrd),
                               rtol=0, atol=1e-5)
    assert cfg.enable_defocus and (samp == BASE).all()
