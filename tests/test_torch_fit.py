"""The common-random-numbers finite-difference estimators of
rt_tpu_torch's diff/inverse.py (fd_gradient under fit_fd and
fit_hybrid, camera_loss under fit_camera), its differentiable
ops/camera.make_camera, and the CLI's `fit`, against rt_tpu on the CPU.

The FD gradient of a step is deterministic (every probe traces the same
random streams), so the port's equals rt_tpu's on the same scene, seed
and parameters within 1e-4 relative: rt_tpu's side is built from its own
helpers (diff/inverse._stack_fd_probes and render_block, its fit_fd /
fit_camera step without the Adam update) on engine "xla", the port's on
"plain". The scenes hold a rect light, so the estimators run on family
scenes; the components include a rect's plane. The CLI cases mirror
tests/test_cli.py:263-457 at small sizes (each must exit 0, the loss
having fallen, and write recovered.npz and after.png), and the
emission recovery mirrors tests/test_diff.py:597 with a rect light."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt_tpu.config import RenderConfig as JConfig
from rt_tpu.diff import inverse as jinverse
from rt_tpu.ops.camera import make_camera_jnp
from rt_tpu.render.renderer import render_block as jrender_block
from rt_tpu.scene import types as jtypes
from rt_tpu_torch import cli
from rt_tpu_torch.config import RenderConfig
from rt_tpu_torch.diff import inverse
from rt_tpu_torch.ops.camera import make_camera
from rt_tpu_torch.render.renderer import render
from rt_tpu_torch.scene import types as ttypes
from rt_tpu_torch.scene.parser import scene_to_dict

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's default of one thread per core in each of them
# oversubscribes the CPU many times over.
torch.set_num_threads(1)

W, H, SPP, DEPTH = 32, 18, 4, 3


def lit_scene(mod, cx=0.0, emission=(3.0, 2.5, 2.0), lookfrom=(0, 0.3, 1),
              color=(0.7, 0.2, 0.2), w=W, h=H):
    """A red sphere on a grey ground under an emissive xz_rect, with a
    gradient-free constant sky (tests/test_diff.py:132-146 plus the
    light)."""
    s = mod.SceneDef(width=w, height=h, samples_per_pixel=SPP,
                     max_depth=DEPTH, background=(0.5, 0.6, 0.7))
    s.add_sphere((cx, 0, -1), 0.5, s.add_lambertian_color(color))
    s.add_sphere((0, -100.5, -1), 100,
                 s.add_lambertian_color((0.6, 0.6, 0.6)))
    s.add_rect("xz_rect", -0.8, 0.6, -1.6, -0.4, 1.1,
               s.add_diffuse_light_color(emission))
    s.set_camera(lookfrom, (0, 0, -1), (0, 1, 0), 50, 0.0)
    return s


def _cfgs(**over):
    jcfg = JConfig(width=W, height=H, samples_per_pixel=SPP,
                   max_depth=DEPTH, loop="while", engine="xla").replace(
                       **over)
    cfg = RenderConfig(**{**dataclasses.asdict(jcfg), "engine": "plain"})
    return jcfg, cfg


def _pixels():
    pix = np.arange(W * H, dtype=np.int32)
    return pix % W, pix // W


def _target(**kw):
    """The true scene's mean radiance [H,W,3] over the fits' own samples,
    as the reference's tests render their targets."""
    _, cfg = _cfgs()
    t = ttypes.build_tables(lit_scene(ttypes, **kw))
    return (render(t, cfg, device="cpu") / SPP).numpy()


def _jax_losses(jt, jcfg, tgt, probes_of):
    """rt_tpu's probe losses (its fit_fd / fit_camera step)."""
    px, py = (jnp.asarray(x) for x in _pixels())

    def loss_of(tbl):
        acc = jrender_block(tbl, jcfg, px, py, jnp.uint32(0), SPP,
                            jnp.uint32(jcfg.seed), W, H)
        return jnp.mean((acc / jnp.float32(SPP) - jnp.asarray(
            tgt.reshape(-1, 3))) ** 2)

    return np.asarray(jax.lax.map(lambda p: loss_of(probes_of(p)),
                                  probes_of.stack))


def test_fd_gradient_matches_rt_tpu():
    """fit_fd's first-step FD gradient (a sphere's x and the rect light's
    plane), and the unperturbed loss, against rt_tpu's."""
    fd_params = {"sph_center": [(0, 0)], "rect_k": [0]}
    eps = 2e-2
    tgt = _target(cx=0.15)
    jcfg, cfg = _cfgs()
    jt = jax.tree_util.tree_map(jnp.asarray,
                                jtypes.build_tables(lit_scene(jtypes)))
    tt = ttypes.build_tables(lit_scene(ttypes))
    flat = jinverse._flatten_fd_components(fd_params)
    params = {f: jnp.asarray(getattr(jt, f), jnp.float32) for f in fd_params}

    def probes_of(pp):
        return jinverse.apply_params(jt, pp)

    probes_of.stack = jinverse._stack_fd_probes(params, flat, eps,
                                                base_row=True)
    losses = _jax_losses(jt, jcfg, tgt, probes_of)
    want = [(losses[2 * j] - losses[2 * j + 1]) / (2 * eps)
            for j in range(len(flat))]

    px, py, tg = inverse._frame(cfg, tgt, torch.device("cpu"))

    def loss_of(pp):
        return inverse._render_loss(inverse.apply_params(tt, pp), cfg, px,
                                    py, tg, SPP)

    p0 = {f: getattr(tt, f) for f in fd_params}
    grads = inverse.fd_gradient(loss_of, p0,
                                inverse._flatten_fd_components(fd_params),
                                eps)
    got = [float(grads["sph_center"][0, 0]), float(grads["rect_k"][0])]
    assert all(abs(g) > 1e-4 for g in want), want
    np.testing.assert_allclose(got, want, rtol=1e-4)
    np.testing.assert_allclose(float(loss_of(p0)), losses[-1], rtol=1e-5)
    # the gradient is zero off the listed components
    assert float(grads["sph_center"].abs().sum()) == abs(got[0])

    # fit_fd's first step: the unperturbed loss, then Adam's first move
    # of lr * g / (|g| + 1e-8) per component
    rec, hist = inverse.fit_fd(tt, cfg, tgt, fd_params, spp=SPP, steps=1,
                               learning_rate=0.01, eps=eps, device="cpu")
    np.testing.assert_allclose(hist[0], losses[-1], rtol=1e-5)
    np.testing.assert_allclose(
        [rec["sph_center"][0, 0], rec["rect_k"][0]],
        [float(p0["sph_center"][0, 0]) - 0.01 * np.sign(got[0]),
         float(p0["rect_k"][0]) - 0.01 * np.sign(got[1])], atol=1e-6)


def test_fit_fd_recovers_a_sphere_position():
    """test_fd_position_recovery at 32x18: from x = -0.1 to the target's
    0.15 (the silhouette term detached estimators miss)."""
    _, cfg = _cfgs()
    tt = ttypes.build_tables(lit_scene(ttypes, cx=-0.1))
    rec, hist = inverse.fit_fd(tt, cfg, _target(cx=0.15),
                               {"sph_center": [(0, 0)]}, spp=SPP, steps=25,
                               learning_rate=3e-2, device="cpu")
    assert hist[-1] < hist[0] * 0.5, hist
    assert abs(rec["sph_center"][0, 0] - 0.15) < 0.05, rec["sph_center"][0]


def test_fit_hybrid_moves_albedo_and_position():
    """fit_hybrid: the path replay for the sphere's colour and central
    differences for its x, in one Adam loop; the first step's x moves
    by lr against the sign of fd_gradient's estimate, and both move
    toward the target's."""
    _, cfg = _cfgs()
    tt = ttypes.build_tables(lit_scene(ttypes, cx=-0.1))
    tgt = _target(cx=0.15)
    px, py, tg = inverse._frame(cfg, tgt, torch.device("cpu"))
    g = inverse.fd_gradient(
        lambda pp: inverse._render_loss(inverse.apply_params(tt, pp), cfg,
                                        px, py, tg, SPP),
        {"sph_center": tt.sph_center}, [("sph_center", (0, 0))], 2e-2)
    rec1, _ = inverse.fit_hybrid(tt, cfg, tgt, ("tex_color",),
                                 {"sph_center": [(0, 0)]}, spp=SPP, steps=1,
                                 device="cpu")
    np.testing.assert_allclose(
        rec1["sph_center"][0, 0],
        -0.1 - 3e-2 * np.sign(float(g["sph_center"][0, 0])), atol=1e-6)
    np.testing.assert_array_equal(rec1["sph_center"][1:],
                                  tt.sph_center[1:].numpy())
    rec, hist = inverse.fit_hybrid(tt, cfg, tgt, ("tex_color",),
                                   {"sph_center": [(0, 0)]}, spp=SPP,
                                   steps=15, device="cpu")
    assert hist[-1] < hist[0] * 0.5, hist
    assert abs(rec["sph_center"][0, 0] - 0.15) < 0.1


def test_make_camera_matches_rt_tpu_and_its_gradient():
    """ops/camera.make_camera against rt_tpu's make_camera_jnp: the frame
    within 1e-6, and the gradient of a scalar of the frame in lookfrom,
    vfov and aperture within 1e-5 relative."""
    args = ([0.3, 0.4, 1.2], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0], 47.0, 1.6,
            0.1)
    cam = make_camera(*(torch.tensor(a, dtype=torch.float32)
                        if isinstance(a, list) else a for a in args))
    jcam = make_camera_jnp(*args)
    for f in dataclasses.fields(cam):
        np.testing.assert_allclose(getattr(cam, f.name).numpy(),
                                   np.asarray(getattr(jcam, f.name)),
                                   rtol=1e-6, atol=1e-6, err_msg=f.name)

    def jscalar(lf, fov, ap):
        c = make_camera_jnp(lf, jnp.asarray(args[1]), jnp.asarray(args[2]),
                            fov, 1.6, ap)
        return (jnp.sum(c.lower_left * c.horizontal) + jnp.sum(c.vertical)
                + c.lens_radius)

    want = jax.grad(jscalar, argnums=(0, 1, 2))(
        jnp.asarray(args[0], jnp.float32), jnp.float32(47.0),
        jnp.float32(0.1))
    lf = torch.tensor(args[0], requires_grad=True)
    fov = torch.tensor(47.0, requires_grad=True)
    ap = torch.tensor(0.1, requires_grad=True)
    c = make_camera(lf, torch.tensor(args[1]), torch.tensor(args[2]), fov,
                    1.6, ap)
    ((c.lower_left * c.horizontal).sum() + c.vertical.sum()
     + c.lens_radius).backward()
    for a, b in zip(want, (lf.grad, fov.grad, ap.grad)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-7)


def test_camera_fd_gradient_matches_rt_tpu():
    """fit_camera's first-step FD gradient in lookfrom (its probes through
    make_camera) against rt_tpu's (make_camera_jnp), and one step's
    move."""
    tgt = _target(lookfrom=(0.05, 0.33, 1.0))
    jcfg, cfg = _cfgs()
    s_t = lit_scene(ttypes)
    tt = ttypes.build_tables(s_t)
    p = s_t.camera_params
    init = {"lookfrom": p["lookfrom"], "lookat": p["lookat"],
            "vup": p["vup"], "vfov_deg": p["vfov"],
            "aperture": p["aperture"]}
    eps = 2e-3
    raw0, _, loss_of = inverse.camera_loss(tt, cfg, tgt, init, spp=SPP,
                                           device="cpu")
    got = [float(inverse.fd_gradient(loss_of, {"raw": raw0},
                                     [("raw", (j,))], eps)["raw"][j])
           for j in range(3)]

    jt = jax.tree_util.tree_map(jnp.asarray,
                                jtypes.build_tables(lit_scene(jtypes)))
    raw = jnp.asarray(init["lookfrom"], jnp.float32)
    rows = jnp.stack([raw.at[j].add(s * eps) for j in range(3)
                      for s in (1, -1)])

    def probes_of(lf):
        cam = make_camera_jnp(lf, jnp.asarray(init["lookat"], jnp.float32),
                              jnp.asarray(init["vup"], jnp.float32),
                              init["vfov_deg"], W / H, init["aperture"])
        return dataclasses.replace(jt, camera=cam)

    probes_of.stack = rows
    losses = _jax_losses(jt, jcfg, tgt, probes_of)
    want = [(losses[2 * j] - losses[2 * j + 1]) / (2 * eps)
            for j in range(3)]
    assert sum(abs(g) > 1e-4 for g in want) >= 2, (want, got)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    rec, _ = inverse.fit_camera(tt, cfg, tgt, init, spp=SPP, steps=1,
                                learning_rate=1e-3, device="cpu")
    np.testing.assert_allclose(
        rec["lookfrom"], np.asarray(init["lookfrom"]) - 1e-3 * np.sign(got),
        atol=1e-6)
    assert np.sign(got).tolist() == np.sign(want).tolist()


def test_fit_camera_recovers_lookfrom_and_refuses_unknown_names():
    """test_fit_camera_recovers_lookfrom at 32x18: from an offset of up
    to 0.05, 12 steps cut the loss 20x and the largest offset to under
    0.03."""
    _, cfg = _cfgs()
    tt = ttypes.build_tables(lit_scene(ttypes))
    tgt = _target()
    init = {"lookfrom": np.asarray([0.04, 0.27, 1.05], np.float32),
            "lookat": (0, 0, -1), "vup": (0, 1, 0), "vfov_deg": 50.0,
            "aperture": 0.0}
    rec, hist = inverse.fit_camera(tt, cfg, tgt, init, spp=SPP, steps=12,
                                   learning_rate=1e-2, device="cpu")
    assert hist[-1] < hist[0] * 0.05, hist
    assert np.abs(rec["lookfrom"] - np.array([0, 0.3, 1.0])).max() < 0.03, \
        rec["lookfrom"]
    with pytest.raises(ValueError, match="recover must be among"):
        inverse.fit_camera(tt, cfg, tgt, init, recover=("vup",), steps=1,
                           device="cpu")


def test_fit_recovers_rect_light_emission():
    """test_inverse_render_recovers_light_emission with the light a rect:
    the replay trains its emission through its texture row (the rect
    table's gradient slot) from (1, 1, 1)."""
    true_em = (3.0, 2.5, 2.0)
    _, cfg = _cfgs()
    tt = ttypes.build_tables(lit_scene(ttypes, emission=true_em))
    tgt = (render(tt, cfg, device="cpu") / SPP).numpy()
    li = int(tt.mat_tex[tt.rect_mat[0]])
    assert li == int(tt.mega.fam.rect[0, 31])
    wrong = tt.tex_color.clone()
    wrong[li] = 1.0
    rec, hist = inverse.fit(dataclasses.replace(tt, tex_color=wrong), cfg,
                            tgt, fields=("tex_color",), spp=SPP, steps=40,
                            learning_rate=8e-2, method="replay",
                            device="cpu")
    assert hist[-1] < hist[0] * 0.1, hist
    assert np.abs(rec["tex_color"][li] - np.asarray(true_em)).max() < 0.3


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    """The guess scene as JSON (the sphere's colour and the light's
    emission wrong) and the target .npz of the true scene seen from a
    pose 0.05 to the side, so every method, --camera included, has
    something to recover."""
    d = tmp_path_factory.mktemp("fit")
    s = lit_scene(ttypes, emission=(2.4, 2.0, 1.6), color=(0.3, 0.5, 0.4))
    path = str(d / "guess.json")
    with open(path, "w") as f:
        json.dump(scene_to_dict(s), f)
    tgt = _target(lookfrom=(0.05, 0.3, 1.0))
    np.savez_compressed(str(d / "t.npz"), img=tgt.astype(np.float32))
    return d, path, str(d / "t.npz")


@pytest.mark.parametrize("extra", [
    [], ["--engine", "mega"], ["--method", "ad"],
    ["--method", "tape", "--fields", "rect_k,sph_radius,tex_color"],
    ["--fd", "sph_center:0,0"], ["--camera", "lookfrom", "--lr", "4e-3"]],
    ids=["replay", "mega", "ad", "tape", "fd", "camera"])
def test_cli_fit_exits_0_and_writes_its_files(cli_files, extra, capsys):
    d, scene, target = cli_files
    out = str(d / ("out_" + "_".join(extra).replace("-", "")
                   .replace(",", "_").replace(":", "_")))
    rc = cli.main(["fit", "-f", scene, "--target", target, "--fields",
                   "tex_color", "-spp", "4", "--steps", "4", "-d", "3",
                   "--device", "cpu", "--out", out] + extra)
    text = capsys.readouterr().out
    assert rc == 0, text
    assert text.startswith("loss: ") and "wrote " in text
    rec = np.load(os.path.join(out, "recovered.npz"))
    assert len(rec.files) > 0
    assert os.path.getsize(os.path.join(out, "after.png")) > 0


@pytest.mark.parametrize("flag,item", [("--sharded", "A-9")])
def test_cli_fit_refuses_what_is_not_ported(cli_files, flag, item, capsys):
    """fit --sharded (ROADMAP item A-9, once refused) without torchrun:
    a world of one on the CPU, its slab the frame padded to 128-pixel
    lanes with the pad rows masked, so its recovered fields are the
    unsharded fit's within rtol 1e-5 / atol 1e-7."""
    d, scene, target = cli_files
    base = ["fit", "-f", scene, "--target", target, "--fields", "tex_color",
            "-spp", "2", "--steps", "2", "-d", "3", "--device", "cpu"]
    outs = {}
    for extra in ([flag], []):
        out = str(d / ("sharded" if extra else "unsharded"))
        assert cli.main(base + ["--out", out] + extra) == 0
        outs[bool(extra)] = np.load(os.path.join(out, "recovered.npz"))
    assert "loss: " in capsys.readouterr().out
    assert outs[True].files == outs[False].files == ["tex_color"]
    np.testing.assert_allclose(outs[True]["tex_color"],
                               outs[False]["tex_color"], rtol=1e-5,
                               atol=1e-7)
