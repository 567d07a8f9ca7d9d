"""rt_tpu_torch's QMC sampler (sampler="qmc": ops/qmc.py, its draws in the
plain engine, the plain versions of the kernels B2, B4, B5 and B7, and
the path replay) against rt_tpu's on the same inputs.

The words are held bit for bit against rt_tpu.ops.qmc with xp=np, for
every purpose, at sample indices past 2^16 and 2^31. The unit ball and
disk within 1e-6 (the port's pow(u, 1/3) for numpy's cbrt, torch's sin
and cos for numpy's). The engines run as tests/test_qmc.py runs them on
the CPU (rt_tpu's Pallas kernels in interpret mode), per lane with the
tolerances of the port's rng comparisons (tests/test_torch_mega.py,
test_torch_tape_pallas.py, test_torch_regen_pallas.py), cull_chunks off
on both sides so that only the sampler differs from those tests. The
CUDA kernels are held against these plain versions bit for bit on the
card (tests/test_torch_cuda.py, chip_smoke.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt_tpu.diff.replay import make_replay_loss_fn as jreplay_loss
from rt_tpu.ops import camera as jcamera
from rt_tpu.ops import pallas_mega as jmega
from rt_tpu.ops import qmc as jqmc
from rt_tpu.ops import rng as jrng
from rt_tpu.render import integrator as jintegrator
from rt_tpu.render import renderer as jrenderer
from rt_tpu.render.oracle import render_oracle
from rt_tpu.scene import builders as jbuilders
from rt_tpu.scene import types as jtypes
from rt_tpu_torch import config as tconfig
from rt_tpu_torch.config import RenderConfig
from rt_tpu_torch.ops import camera as tcamera
from rt_tpu_torch.ops import cuda_mega, qmc, rng
from rt_tpu_torch.render import renderer as trenderer
from rt_tpu_torch.scene import builders as tbuilders
from rt_tpu_torch.scene import types as ttypes
from rt_tpu_torch.scene.convert import params_from_numpy
from test_torch_adjoint import (assert_grads_close, jparams, make_scene,
                                pixels, port_grads)
from test_torch_regen_pallas import _jax_regen, _port_regen
from test_torch_tape import W as TW, H as TH, mixed_scene, pixels as tpix

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's default of one thread per core in each of them
# oversubscribes the CPU many times over.
torch.set_num_threads(1)

PURPOSES = sorted(jqmc._SITE) + [jrng.SCENE_GEN]


def _coords(n=3000, seed=0):
    """Seeded (pixel, sample, bounce) words: samples below 2^16, past it
    and past 2^31."""
    rs = np.random.default_rng(seed)
    pix = rs.integers(0, 1 << 31, n).astype(np.uint32)
    smp = np.concatenate([rs.integers(0, 1 << 16, n // 3),
                          rs.integers(1 << 16, 1 << 31, n // 3),
                          rs.integers(1 << 31, 1 << 32, n - 2 * (n // 3))]
                         ).astype(np.uint32)
    bounce = rs.integers(0, 64, n).astype(np.uint32)
    return pix, smp, bounce


def _t(x):
    return torch.from_numpy(x.astype(np.int64))


@pytest.mark.parametrize("purpose", PURPOSES)
def test_qmc_words_match_jax(purpose):
    """uniform's float32 bits equal rt_tpu.ops.qmc.uniform(np, ...) on
    every lane; a purpose outside the sites takes rng.uniform's draw."""
    pix, smp, bounce = _coords()
    want = jqmc.uniform(np, 7, pix, smp, bounce, purpose)
    got = qmc.uniform(7, _t(pix), _t(smp), _t(bounce), purpose).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    if purpose == jrng.SCENE_GEN:
        np.testing.assert_array_equal(
            got, rng.uniform(7, _t(pix), _t(smp), _t(bounce), purpose))


def test_qmc_scramble_and_sobol_words_match_jax():
    """The building blocks word for word: bit reversal, the nested
    scramble, the Sobol' points of dimensions 0-2, the site seeds."""
    pix, smp, bounce = _coords(2000, seed=1)
    np.testing.assert_array_equal(qmc.reverse_bits(_t(smp)).numpy(),
                                  jqmc.reverse_bits(np, smp))
    np.testing.assert_array_equal(
        qmc.nested_scramble(_t(smp), _t(pix)).numpy(),
        jqmc.nested_scramble(np, smp, pix))
    for dim in range(3):
        np.testing.assert_array_equal(qmc.sobol_bits(_t(smp), dim).numpy(),
                                      jqmc.sobol_bits(np, smp, dim))
    for a, b in zip(qmc.site_seeds(3, _t(pix), _t(bounce), 6, 2),
                    jqmc.site_seeds(np, 3, pix, bounce, 6, 2)):
        np.testing.assert_array_equal(a.numpy(), b)
    assert qmc.DIRS == tuple(tuple(int(v) for v in d) for d in jqmc._DIRS)


@pytest.mark.parametrize("fn", ["in_unit_ball", "in_unit_disk"])
def test_qmc_ball_and_disk_match_jax(fn):
    """The ball (pow for cbrt) and the disk within 1e-6, and the ball's
    points inside the unit ball."""
    pix, smp, bounce = _coords(2000, seed=2)
    want = getattr(jqmc, fn)(np, 5, pix, smp, bounce)
    got = getattr(qmc, fn)(5, _t(pix), _t(smp), _t(bounce)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (np.linalg.norm(got, axis=-1) <= 1.0 + 1e-6).all()


def test_resolve_and_config_take_qmc():
    assert rng.resolve("qmc") is qmc and rng.resolve("rng") is rng
    with pytest.raises(ValueError):
        rng.resolve("sobol")
    tconfig.check_supported(RenderConfig(sampler="qmc", engine="mega"))
    with pytest.raises(ValueError):
        tconfig.check_supported(RenderConfig(sampler="halton"))


def _three_sphere(w, h):
    sj, _ = jbuilders.three_sphere_scene(width=w, height=h)
    st, _ = tbuilders.three_sphere_scene(width=w, height=h)
    return sj, jtypes.build_tables(sj), ttypes.build_tables(st)


def test_plain_engine_qmc_matches_jax_xla_and_oracle(images_close):
    """The plain engine under qmc against rt_tpu's "xla" engine (per
    pixel within 1e-4 on >= 99% of pixels) and its scalar oracle
    (images_close), at 24x14, spp 4, depth 5, the gradient sky
    (tests/test_qmc.py:126-161)."""
    sj, jt, tt = _three_sphere(24, 14)
    from rt_tpu.config import RenderConfig as JConfig

    jcfg = JConfig(width=24, height=14, samples_per_pixel=4, max_depth=5,
                   background_mode="gradient", sampler="qmc", engine="xla",
                   loop="while")
    cfg = RenderConfig(**{**dataclasses.asdict(jcfg), "engine": "plain"})
    want = np.asarray(jrenderer.render(jt, jcfg))
    got = trenderer.render(tt, cfg, device="cpu").numpy()
    diff = np.abs(got - want).max(-1) / 4
    assert np.mean(diff <= 1e-4) >= 0.99, np.mean(diff <= 1e-4)
    images_close(got, render_oracle(sj, jcfg), 4)
    # the sampler changes the image: qmc is not rng
    other = trenderer.render(tt, cfg.replace(sampler="rng"), device="cpu")
    assert not torch.equal(other, torch.from_numpy(got))


@pytest.mark.parametrize("name", ["cover", "lights_nee_mis"])
def test_plain_mega_qmc_matches_pallas_mega(name, images_close):
    """The plain B2 (mega_trace on the CPU) under qmc against rt_tpu's
    trace(engine="mega") in interpret mode, per lane within 1e-4 on >=
    99% of lanes (tests/test_torch_mega.py's gate), at 24x16, depth 4,
    spp 1; the cover scene's camera with rt_tpu's generate_rays under
    qmc."""
    from rt_tpu.config import RenderConfig as JConfig
    from test_torch_nee import light_scene

    w, h = 24, 16
    if name == "cover":
        sj, cj = jbuilders.cover_scene(width=w, height=h, spp=1, max_depth=4,
                                       grid=3)
        st, _ = tbuilders.cover_scene(width=w, height=h, spp=1, max_depth=4,
                                      grid=3)
        jt, tt = jtypes.build_tables(sj), ttypes.build_tables(st)
        cj = cj.replace(sampler="qmc", cull_chunks=False)
    else:
        jt, tt = light_scene(jtypes, w, h), light_scene(ttypes, w, h)
        cj = JConfig(width=w, height=h, samples_per_pixel=1, max_depth=4,
                     loop="while", cull_chunks=False, nee=True, mis=True,
                     sampler="qmc")
    cfg = RenderConfig(**{**dataclasses.asdict(cj), "engine": "mega"})
    px = np.tile(np.arange(w, dtype=np.int32), h)
    py = np.repeat(np.arange(h, dtype=np.int32), w)
    pix = (py * w + px).astype(np.uint32)
    jtd = jax.tree.map(jnp.asarray, jt)
    ro, rd = jcamera.generate_rays(jtd.camera, w, h, jnp.asarray(px),
                                   jnp.asarray(py), 0, 0, cj.enable_defocus,
                                   "qmc")
    want = np.asarray(jintegrator.trace(jtd, cj.replace(engine="mega"), ro,
                                        rd, jnp.asarray(pix), 0, 0))
    got = cuda_mega.mega_trace(tt, cfg, torch.from_numpy(np.array(ro)),
                               torch.from_numpy(np.array(rd)),
                               torch.from_numpy(pix.astype(np.int64)), 0,
                               0).numpy()
    diff = np.abs(got - want).max(-1)
    assert np.mean(diff <= 1e-4) >= 0.99, np.mean(diff <= 1e-4)
    assert np.isfinite(got).all() and got.max() > 0.0
    images_close(got.reshape(h, w, 3), want.reshape(h, w, 3), spp=1)


def test_plain_capture_qmc_matches_pallas_capture():
    """The plain B4 under qmc against rt_tpu's Pallas capture in
    interpret mode: equal codes on every lane alive entering its bounce
    and equal death counts (tests/test_torch_tape_pallas.py's check), on
    the mixed scene at 24x16, depth 6."""
    jt, jcfg, tt, cfg = mixed_scene(max_depth=6, p_rr=0.0)
    jcfg = jcfg.replace(sampler="qmc", cull_chunks=False)
    cfg = cfg.replace(sampler="qmc", cull_chunks=False)
    px, py = (jnp.asarray(x) for x in tpix())
    jpix = (py * TW + px).astype(jnp.int32)
    jro, jrd = jcamera.generate_rays(jt.camera, TW, TH, px, py,
                                     jnp.zeros(TW * TH, jnp.uint32),
                                     jnp.uint32(0), False, "qmc")
    jcodes, jdeath = (np.asarray(x) for x in jmega.mega_capture(
        jt, jcfg, jro, jrd, jpix, jnp.uint32(0), jnp.uint32(0)))
    pix = torch.arange(TW * TH)
    ro, rd = tcamera.generate_rays(tt.camera, TW, TH, pix % TW, pix // TW, 0,
                                   0, False, "qmc")
    codes, death = (x.numpy() for x in cuda_mega.mega_capture(
        tt, cfg, ro, rd, pix, 0, 0))
    live = np.arange(cfg.max_depth)[:, None] <= death[None, :]
    np.testing.assert_array_equal(death, jdeath)
    assert (codes[live] == jcodes[live]).all()
    # qmc draws other directions than rng: other codes
    rng_codes, _ = cuda_mega.mega_capture(tt, cfg.replace(sampler="rng"), ro,
                                          rd, pix, 0, 0)
    assert not np.array_equal(rng_codes.numpy(), codes)


def test_plain_regen_qmc_matches_pallas_regen():
    """The plain B7 under qmc (its camera rays too) against rt_tpu's
    Pallas regen kernel in interpret mode over a whole segment at 32x24,
    spp 2, depth 6: radiance within 1e-5, sample counter and alive word
    on >= 99% of lanes (tests/test_torch_regen_pallas.py's Cornell
    gate)."""
    from test_torch_regen import _scene

    tt, cfg, jt, cj = _scene("cornell", jax_too=True, width=32, height=24,
                             spp=2, max_depth=6)
    cfg = cfg.replace(sampler="qmc", cull_chunks=False)
    cj = cj.replace(sampler="qmc")
    iters = 2 * 7
    j_rgb, j_samp, _, j_alive = _jax_regen(jt, cj, iters)
    t_rgb, t_samp, _, t_alive = _port_regen(tt, cfg, iters)
    ok = ((np.abs(t_rgb - j_rgb) <= 1e-5).all(-1) & (t_samp == j_samp)
          & (t_alive == j_alive))
    assert ok.mean() >= 0.99, ok.mean()
    assert float(t_rgb.max()) > 0.0


@pytest.mark.parametrize("kernel", [False, True], ids=["xla", "pallas"])
def test_replay_grads_qmc_match_jax(kernel):
    """The port's path replay under qmc (engine mega: the plain B5 on
    the CPU) against rt_tpu's replay under qmc: its XLA per-bounce replay
    and its Pallas adjoint B5 in interpret mode, at 12x8, depth 4, spp 2,
    per field within 1e-5 + 1e-3 max|g| (tests/test_torch_adjoint.py's
    tolerance)."""
    jt, jcfg, tt, cfg = make_scene(12, 8, 4, seed=7)
    jcfg = jcfg.replace(sampler="qmc",
                        engine="mega" if kernel else "xla")
    cfg = cfg.replace(sampler="qmc", engine="mega", cull_chunks=False)
    px, py = pixels(12, 8)
    tgt = np.random.RandomState(4).rand(px.shape[0], 3).astype(np.float32)
    jp = jparams(jt)
    lj, gj = jax.value_and_grad(jreplay_loss(
        jt, jcfg, 2, jnp.asarray(px), jnp.asarray(py), jnp.asarray(tgt),
        bwd_kernel=kernel))(jp)
    lt, gt = port_grads(tt, cfg, px, py, tgt, params_from_numpy(jp))
    np.testing.assert_allclose(lt, float(lj), rtol=1e-4)
    assert_grads_close(gj, gt, ("qmc", kernel))
