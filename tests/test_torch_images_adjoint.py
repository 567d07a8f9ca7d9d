"""The gradients of the image atlas ("images"): the path replay's (the
plain version of the adjoint kernels B5 and B6, ops/adjoint_plain's atlas
credit, reached through diff/replay.make_replay_loss_fn with engine
"mega" and "queue" on the CPU) against rt_tpu's Pallas adjoint kernels
with bwd_kernel=True in interpret mode (its in-kernel atlas adjoint,
pallas_mega.py:1741-1790) and against the port's own method "ad"; the
tape's (diff/tape.make_tape_loss_fn, autograd through its texel gather)
against rt_tpu's make_tape_loss_fn; the texture recovery of
tests/test_diff.py::test_replay_recovers_image_texture; and `fit
--fields images` through the CLI on the CPU.

Scenes: tests/test_torch_images.py's (two 16x16 images on all four
families, image-textured sphere and triangle lights; 16x12, depth 3,
spp 1), and the recovery test's 8x8 texture on an xy_rect. rt_tpu's
replay keeps its kernel path at these atlas sizes (adjoint_atlas_ok).
Tolerance per field |a - b| <= 1e-5 + 1e-3 max|a| (the reference's
between its replay and its kernels); a lane whose UV lies within the
reference polynomials' 1e-5 of a texel boundary sends its cotangent to
the neighbouring texel (ROADMAP C-13), which this scene's lanes do not.
The CUDA kernels are held against adjoint_plain on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt_tpu.config import RenderConfig as JConfig
from rt_tpu.diff import tape as jtape
from rt_tpu.diff.replay import make_replay_loss_fn as jreplay_loss
from rt_tpu.scene import types as jtypes
from rt_tpu_torch import cli
from rt_tpu_torch.config import RenderConfig
from rt_tpu_torch.diff import inverse as tinverse
from rt_tpu_torch.diff import tape as ttape
from rt_tpu_torch.render.renderer import render as trender
from rt_tpu_torch.scene import types as ttypes
from rt_tpu_torch.scene.convert import params_from_numpy
from test_torch_adjoint import pixels, port_grads
from test_torch_images import both_tables, textured_demo

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's default of one thread per core in each of them
# oversubscribes the CPU many times over.
torch.set_num_threads(1)

W, H = 16, 12
FIELDS = ("images", "tex_color", "mat_albedo", "background")


def _cfgs(engine="mega", **kw):
    jcfg = JConfig(width=W, height=H, samples_per_pixel=1, max_depth=3,
                   engine=engine, loop="while", cull_chunks=False, **kw)
    return jcfg, RenderConfig(**dataclasses.asdict(jcfg))


def _target(b, seed):
    return np.random.default_rng(seed).uniform(0.0, 0.8, (b, 3)).astype(
        np.float32)


def _close(want, got, label, fields=FIELDS):
    for k in fields:
        a = np.asarray(want[k], np.float64)
        b = np.asarray(got[k].detach(), np.float64)
        assert a.shape == b.shape, (label, k)
        mag = max(np.abs(a).max(), 1e-12)
        err = np.abs(a - b).max()
        assert err <= 1e-5 + 1e-3 * mag, (label, k, err, mag)


@pytest.mark.parametrize("engine,nee", [("mega", False), ("queue", True)])
def test_replay_images_matches_pallas_adjoint(engine, nee):
    """The port's replay (the plain adjoint with the atlas credit) against
    rt_tpu's B5 / B6 in interpret mode, every REPLAY_FIELD; with nee the
    image lights' Le cotangent goes to their texels."""
    jt, tt = both_tables(w=W, h=H)
    jcfg, cfg = _cfgs(engine, nee=nee)
    px, py = pixels(W, H)
    tgt = _target(px.shape[0], 2)
    jp = {k: jnp.asarray(getattr(jt, k), jnp.float32) for k in FIELDS}
    lj, gj = jax.value_and_grad(jreplay_loss(
        jt, jcfg, 1, jnp.asarray(px), jnp.asarray(py), jnp.asarray(tgt),
        bwd_kernel=True))(jp)
    lt, gt = port_grads(tt, cfg, px, py, tgt, params_from_numpy(jp), spp=1)
    np.testing.assert_allclose(lt, float(lj), rtol=1e-5)
    _close(gj, gt, f"{engine} nee={nee}")
    assert float(gt["images"].abs().max()) > 0
    if nee:
        # a light's texels take the direct term's emission credit
        assert int(tt.light_fam[0]) == 0   # the sphere light
        mat = int(tt.sph_mat[int(tt.light_pid[0])])
        light = int(tt.tex_image[int(tt.mat_tex[mat])])
        assert float(gt["images"][light].abs().max()) > 0


def _rect_scene(mod, img, spp=4, depth=3):
    """tests/test_diff.py::test_replay_recovers_image_texture's scene: an
    image-textured xy_rect before a grey sky."""
    s = mod.SceneDef(width=48, height=27, samples_per_pixel=spp,
                     max_depth=depth, background=(0.8, 0.8, 0.9))
    m = s.add_lambertian(s.add_image_texture(img))
    s.add_rect("xy_rect", -1.2, 1.2, -0.7, 0.7, -1.0, m)
    s.set_camera((0, 0, 1.2), (0, 0, -1), (0, 1, 0), 60, 0.0)
    return s


def test_replay_images_matches_ad():
    """The exact replay's atlas gradient on B6's plain version against
    autograd through the port's plain wavefront engine (its texel gather
    is geom.take_rows, whose backward is index_add_)."""
    img = np.random.default_rng(3).random((8, 8, 3)).astype(np.float32)
    tt = ttypes.build_tables(_rect_scene(ttypes, img))
    cfg = RenderConfig(width=48, height=27, samples_per_pixel=2,
                       max_depth=3)
    px, py = pixels(48, 27)
    tgt = _target(px.shape[0], 4)
    p0 = {k: getattr(tt, k) for k in FIELDS}
    lr, gr = port_grads(tt, cfg.replace(engine="queue"), px, py, tgt, p0,
                        spp=2)
    p = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
    la = tinverse.make_loss_fn(tt, cfg, 2)(
        p, torch.from_numpy(px).long(), torch.from_numpy(py).long(),
        torch.from_numpy(tgt))
    la.backward()
    np.testing.assert_allclose(lr, float(la.detach()), rtol=1e-5)
    _close({k: v.grad.numpy() for k, v in p.items()}, gr, "ad")
    assert int((gr["images"].abs().sum(-1) > 0).sum()) >= 40


def test_tape_images_matches_rt_tpu():
    """The tape's atlas gradient (autograd through the known-winner
    replay's texel gather) against rt_tpu's make_tape_loss_fn, with the
    image lights under nee."""
    jt, tt = both_tables(w=W, h=H)
    jcfg, cfg = _cfgs("xla", nee=True)
    cfg = cfg.replace(engine="plain")
    px, py = pixels(W, H)
    tgt = _target(px.shape[0], 5)
    fields = ("images", "tex_color")
    jp = {k: jnp.asarray(getattr(jt, k), jnp.float32) for k in fields}
    lj, gj = jax.value_and_grad(jtape.make_tape_loss_fn(
        jt, jcfg, 1, jnp.asarray(px), jnp.asarray(py), jnp.asarray(tgt)))(
            jp)
    p = {k: v.clone().requires_grad_(True)
         for k, v in params_from_numpy(jp).items()}
    loss = ttape.make_tape_loss_fn(tt, cfg, 1, torch.from_numpy(px),
                                   torch.from_numpy(py),
                                   torch.from_numpy(tgt))(p)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(lj), rtol=1e-5)
    _close(gj, {k: v.grad for k, v in p.items()}, "tape", fields)
    assert float(p["images"].grad.abs().max()) > 0


def test_replay_recovers_image_texture():
    """tests/test_diff.py::test_replay_recovers_image_texture on the
    port: recover an 8x8 texture on a rect from a target render with
    fit(method="replay", fields=("images",)); only texels some path
    sampled train, so the check masks by where they moved. The forward
    runs on engine "mega" and the backward on its adjoint (the plain
    versions of B2 and B5 here)."""
    rs = np.random.RandomState(3)
    true_img = rs.rand(8, 8, 3).astype(np.float32)
    cfg = RenderConfig(width=48, height=27, samples_per_pixel=4,
                       max_depth=3, engine="mega")
    target = trender(ttypes.build_tables(_rect_scene(ttypes, true_img)),
                     cfg, device="cpu") / cfg.samples_per_pixel
    init = np.full_like(true_img, 0.5)
    rec, hist = tinverse.fit(ttypes.build_tables(_rect_scene(ttypes, init)),
                             cfg, target.numpy(), fields=("images",), spp=4,
                             steps=80, learning_rate=5e-2, method="replay",
                             device="cpu")
    assert hist[-1] < hist[0] * 0.1
    got = rec["images"][0, :8, :8]
    moved = np.abs(got - init).max(axis=-1) > 1e-3
    assert moved.sum() >= 20
    err = np.abs(got - true_img).max(axis=-1)
    assert np.median(err[moved]) < 0.1


@pytest.mark.parametrize("method", ["replay", "tape"])
def test_cli_fit_images_on_cpu(tmp_path, capsys, method):
    """`fit -f <textured demo copy> --fields images` on the CPU, with the
    replay and the tape: exit 0 (the loss fell), the recovered atlas of
    the scene's shape."""
    # the after.png render runs at the scene's spp: a small one here
    path = textured_demo(str(tmp_path), size=8, samples_per_pixel=2)
    from rt_tpu_torch.scene.parser import parse_scene

    sd, _ = parse_scene(path)
    tt = ttypes.build_tables(sd)
    img = tt.images.clone()
    img[0] = img[0] * 0.5 + 0.25   # the sphere's texture to recover
    cfg = RenderConfig(width=24, height=16, samples_per_pixel=2, max_depth=3)
    sd.resize(24, 16)
    target = trender(dataclasses.replace(ttypes.build_tables(sd), images=img),
                     cfg, device="cpu") / 2.0
    np.savez(str(tmp_path / "t.npz"), img=target.numpy())
    out = str(tmp_path / "out")
    rc = cli.main(["fit", "-f", path, "--target", str(tmp_path / "t.npz"),
                   "--fields", "images", "-spp", "2", "--steps", "3", "-d",
                   "3", "--lr", "0.05", "--method", method, "--device",
                   "cpu", "--out", out])
    text = capsys.readouterr().out
    assert rc == 0, text
    rec = np.load(os.path.join(out, "recovered.npz"))
    assert rec["images"].shape == tuple(tt.images.shape)
