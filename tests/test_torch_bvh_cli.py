"""`render --bvh` and the gradient entry points under traversal="bvh" in
rt_tpu_torch, against rt_tpu on the CPU.

The kernels read no BVH, in rt_tpu as in the port: `render --bvh` on the
queue engine (its plain version here) writes the same PNG as without
the flag, and the regen render (engine "mega", regen=True) of tables
with BVHs under traversal "bvh" equals the one without, bit for bit.
The plain engine walks them: `render --engine plain --bvh` exits 0, and
its radiance is within images_close of the linear frame.

Gradients: the port accepts traversal "bvh" where rt_tpu runs it.
rt_tpu's walk is a lax.while_loop, which reverse mode cannot
differentiate: "ad" raises where the loss's gradient reaches a walked
hit distance (a sphere centre, or metal fuzz, which bends the ray whose
later bounces read the gradient sky) and runs where it does not (a
texture colour); the path replay, its geom_spec tangent replay (forward
mode), the tape (a replay against the captured winners), fit_fd and
fit_camera (forward only) run. rt_tpu's side of "ad", "replay" and
"tape" is traced abstractly (jax.eval_shape of the gradient, where a
while_loop refuses reverse mode), its fit_fd and fit_camera run one
step; the port runs one step of each, and raises ValueError where
rt_tpu raises. (One case differs and is left out: rt_tpu's "ad" of
mat_albedo raises too, because its material rows pack albedo beside
fuzz in one array, which gives the fuzz a zero tangent; the port's rows
are separate tensors, and its "ad" of mat_albedo runs.)"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt_tpu.config import RenderConfig as JConfig
from rt_tpu.diff import inverse as jinverse
from rt_tpu.diff import replay as jreplay
from rt_tpu.diff import tape as jtape
from rt_tpu.scene import types as jtypes
from rt_tpu_torch import cli
from rt_tpu_torch.config import RenderConfig
from rt_tpu_torch.diff import inverse
from rt_tpu_torch.io.image import read_png
from rt_tpu_torch.render.renderer import render
from rt_tpu_torch.scene import parser as tparser
from rt_tpu_torch.scene import types as ttypes

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's default of one thread per core in each of them
# oversubscribes the CPU many times over.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(ROOT, "scenes", "demo_scene.json")
ALL = ("sphere", "rect", "cylinder", "triangle")
W, H = 8, 6


def _render_cli(tmp_path, name, *extra):
    out = tmp_path / f"{name}.png"
    rc = cli.main(["render", "-f", DEMO, "-w", "32", "--height", "18",
                   "-spp", "2", "-d", "4", "--device", "cpu", "-o",
                   str(out), "--log", str(tmp_path / "t.log"), *extra])
    assert rc == 0
    return read_png(str(out))


def test_render_bvh_on_queue_and_regen_is_bit_equal(tmp_path):
    """B3 (the CLI's default queue) and B7 read no BVH."""
    np.testing.assert_array_equal(_render_cli(tmp_path, "bvh", "--bvh"),
                                  _render_cli(tmp_path, "lin"))
    sdef, cfg = tparser.parse_scene(DEMO)
    sdef.resize(32, 18)
    cfg = cfg.replace(width=32, height=18, samples_per_pixel=2, max_depth=4,
                      engine="mega", regen=True)
    with_bvh = ttypes.build_tables(sdef, bvh_types=ALL)
    assert with_bvh.bvh_for == ("sphere", "rect", "cylinder")
    a = render(with_bvh, cfg.replace(traversal="bvh"), device="cpu")
    b = render(ttypes.build_tables(sdef), cfg, device="cpu")
    assert torch.equal(a, b)


def test_render_plain_bvh_is_close_to_linear(tmp_path, images_close):
    got = _render_cli(tmp_path, "pb", "--engine", "plain", "--bvh")
    assert got.shape == (18, 32, 3) and got.max() > 0
    sdef, cfg = tparser.parse_scene(DEMO)
    sdef.resize(32, 18)
    cfg = cfg.replace(width=32, height=18, samples_per_pixel=2, max_depth=4,
                      engine="plain")
    tables = ttypes.build_tables(sdef, bvh_types=ALL)
    walked = render(tables, cfg.replace(traversal="bvh"), device="cpu")
    scanned = render(tables, cfg, device="cpu")
    images_close(walked.numpy(), scanned.numpy(), 2)


def _scene(mod):
    """A lambertian and a metal sphere on a ground sphere, every BVH."""
    s = mod.SceneDef(width=W, height=H, samples_per_pixel=1, max_depth=2,
                     background=(0.5, 0.6, 0.7))
    s.add_sphere((0, 0, -1), 0.5, s.add_lambertian_color((0.7, 0.2, 0.2)))
    s.add_sphere((0.9, 0, -1.3), 0.4, s.add_metal((0.8, 0.7, 0.6), 0.2))
    s.add_sphere((0, -100.5, -1), 100,
                 s.add_lambertian_color((0.6, 0.6, 0.6)))
    s.set_camera((0, 0.3, 1), (0, 0, -1), (0, 1, 0), 50, 0.0)
    return s


@pytest.fixture(scope="module")
def problem():
    """rt_tpu's tables, config and target, and the port's."""
    jt = jtypes.build_tables(_scene(jtypes), bvh_types=ALL)
    jcfg = JConfig(width=W, height=H, samples_per_pixel=1, max_depth=3,
                   engine="xla", loop="while", traversal="bvh",
                   background_mode="gradient")
    tt = ttypes.build_tables(_scene(ttypes), bvh_types=ALL)
    cfg = RenderConfig(**{**dataclasses.asdict(jcfg), "engine": "plain"})
    tgt = np.full((H, W, 3), 0.3, np.float32)
    return jt, jcfg, tt, cfg, tgt



CAMERA = {"lookfrom": [0.1, 0.3, 1.0], "lookat": [0.0, 0.0, -1.0],
          "vup": [0.0, 1.0, 0.0], "vfov_deg": 50.0, "aperture": 0.0}


def _rt_tpu_runs(case, fields, geom_spec, jt, jcfg, tgt):
    """Whether rt_tpu takes the entry point with its BVH walk."""
    pix = np.arange(W * H, dtype=np.int32)
    px, py = jnp.asarray(pix % W), jnp.asarray(pix // W)
    rows = jnp.asarray(tgt.reshape(-1, 3))
    params = jinverse.extract_params(jt, fields)
    try:
        if case == "ad":
            loss = jinverse.make_loss_fn(jt, jcfg, 1)
            jax.eval_shape(jax.grad(loss), params, px, py, rows)
        elif case == "replay":
            loss = jreplay.make_replay_loss_fn(jt, jcfg, 1, px, py, rows,
                                               geom_spec=geom_spec)
            jax.eval_shape(jax.grad(loss), params)
        elif case == "tape":
            loss = jtape.make_tape_loss_fn(jt, jcfg, 1, px, py, rows)
            jax.eval_shape(jax.grad(loss), params)
        elif case == "fd":
            jinverse.fit_fd(jt, jcfg, tgt, {"sph_center": [(0, 0)]}, spp=1,
                            steps=1)
        else:
            jinverse.fit_camera(jt, jcfg, tgt, CAMERA, spp=1, steps=1)
    except Exception as e:  # noqa: BLE001 - jax raises several types
        assert "while_loop" in str(e), e
        return False
    return True


def _port(case, fields, geom_spec, tt, cfg, tgt):
    if case in ("ad", "replay", "tape"):
        _, hist = inverse.fit(tt, cfg, tgt, fields=fields, spp=1, steps=1,
                              method=case, geom_spec=geom_spec,
                              device="cpu")
    elif case == "fd":
        _, hist = inverse.fit_fd(tt, cfg, tgt, {"sph_center": [(0, 0)]},
                                 spp=1, steps=1, device="cpu")
    else:
        _, hist = inverse.fit_camera(tt, cfg, tgt, CAMERA, spp=1, steps=1,
                                     device="cpu")
    assert np.isfinite(hist).all()


# (case, fields, geom_spec, rt_tpu runs it, the port runs it). The two
# differ in one case, ROADMAP C-14: "ad" of mat_albedo, which rt_tpu
# refuses because its packed material rows carry a (zero) tangent of
# the albedo into the fuzz that bends the next ray and so into its
# walk; the port's rows are separate tensors and no gradient reaches
# its walk
@pytest.mark.parametrize("case,fields,geom_spec,rt_tpu_runs,runs", [
    ("ad", ("tex_color",), None, True, True),
    ("ad", ("sph_center",), None, False, False),
    ("ad", ("mat_fuzz",), None, False, False),
    ("ad", ("mat_albedo",), None, False, True),
    ("replay", ("tex_color",), None, True, True),
    ("replay", ("tex_color", "sph_center"), {"sph_center": [(0, 0)]}, True,
     True),
    ("tape", ("sph_center", "mat_albedo"), None, True, True),
    ("fd", ("sph_center",), None, True, True),
    ("camera", (), None, True, True),
])
def test_gradients_take_bvh_where_rt_tpu_does(case, fields, geom_spec,
                                              rt_tpu_runs, runs, problem):
    jt, jcfg, tt, cfg, tgt = problem
    assert _rt_tpu_runs(case, fields, geom_spec, jt, jcfg, tgt) \
        is rt_tpu_runs
    if runs:
        _port(case, fields, geom_spec, tt, cfg, tgt)
    else:
        with pytest.raises(ValueError, match="BVH walk"):
            _port(case, fields, geom_spec, tt, cfg, tgt)
