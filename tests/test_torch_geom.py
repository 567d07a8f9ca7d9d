"""rt_tpu_torch's forward-mode tangent replay (diff/replay.py, geom_spec)
against rt_tpu's make_replay_loss_fn(geom_spec=..., geom_tape=...) and
against the port's own autograd (method="ad"), on the CPU.

Tolerances are the reference's (tests/test_diff.py:366-372, 662-667):
per component |a - b| <= 1e-8 + 1e-2 |a| against reverse mode through
the full loop, and 1e-6 + 4e-2 |a| between the taped-winner and the
full-intersect tangent replays (the leaf test is another float
formulation of the same hit). The radiometric field that rides along
is held to rtol 2e-4, atol 2e-6, as there.

Against rt_tpu the scene is tests/test_tape.py's mixed scene, where
every lane takes the same path in both packages. On the reference's
cover scene (32x24, grid 3) a pixel takes another path in the two
packages (an ulp of rt_tpu's batched XLA dot flips a decision, ROADMAP
C-4), and that one pixel moves single components by as much as the
tolerance; the port's own estimators are compared there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt_tpu.diff.replay import make_replay_loss_fn as jreplay_loss
from rt_tpu_torch.config import RenderConfig
from rt_tpu_torch.diff import inverse as tinverse
from rt_tpu_torch.diff import replay as treplay
from rt_tpu_torch.render.renderer import render, render_block
from rt_tpu_torch.scene.builders import cover_scene
from rt_tpu_torch.scene.types import (MAT_DIELECTRIC, MAT_METAL,
                                      SceneDef, build_tables)
from test_torch_tape import mixed_scene, pixels

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's default of one thread per core in each of them
# oversubscribes the CPU many times over.
torch.set_num_threads(1)


def _perturbed(tables, die, as_jax=False):
    """The reference test's start point: sphere 0 moved up 0.05 and
    grown 0.02, the glass IOR up 0.1 (so every gradient is nonzero)."""
    c = np.array(tables.sph_center, np.float32)
    r = np.array(tables.sph_radius, np.float32)
    ior = np.array(tables.mat_ior, np.float32)
    c[0, 1] += 0.05
    r[0] += 0.02
    ior[die] += 0.1
    p = {"sph_center": c, "sph_radius": r, "mat_ior": ior,
         "mat_fuzz": np.array(tables.mat_fuzz, np.float32),
         "tex_color": np.array(tables.tex_color, np.float32)}
    if as_jax:
        return {k: jnp.asarray(v) for k, v in p.items()}
    return {k: torch.from_numpy(v).requires_grad_(True)
            for k, v in p.items()}


def _rows(tables):
    mt = np.asarray(tables.mat_type)
    return (int(np.nonzero(mt == MAT_METAL)[0][-1]),
            int(np.nonzero(mt == MAT_DIELECTRIC)[0][-1]))


def _spec(met, die):
    return {"sph_center": [(0, 0), (0, 1)], "sph_radius": [(0,)],
            "mat_fuzz": [(met,)], "mat_ior": [(die,)]}


def _port_replay(tt, cfg, spp, px, py, tgt, spec, geom_tape, die):
    p = _perturbed(tt, die)
    loss = treplay.make_replay_loss_fn(
        tt, cfg, spp, torch.from_numpy(px), torch.from_numpy(py),
        torch.from_numpy(tgt), geom_spec=spec, geom_tape=geom_tape)(p)
    loss.backward()
    return {k: v.grad.numpy() for k, v in p.items()}


def _check(want, got, spec, rel, abs_):
    checked = nonzero = 0
    for f, idxs in spec.items():
        for idx in idxs:
            a, b = float(want[f][idx]), float(got[f][idx])
            assert abs(a - b) <= abs_ + rel * abs(a), (f, idx, a, b)
            checked += 1
            nonzero += a != 0.0
    assert checked == 5 and nonzero >= 3  # the chains actually fire


@pytest.mark.parametrize("geom_tape", [False, True])
def test_geom_tangent_matches_rt_tpu(geom_tape):
    """The tangent replay against rt_tpu's, both with the taped winner
    (geom_tape=True; the capture on the CPU is the wavefront's on both
    sides) or both with the full intersect, at 24x16, depth 6, spp 2."""
    jt, jcfg, tt, cfg = mixed_scene(max_depth=6)
    met, die = _rows(tt)
    px, py = pixels()
    tgt = np.random.RandomState(4).uniform(0.0, 0.6, (px.shape[0], 3)
                                           ).astype(np.float32)
    spec = _spec(met, die)
    gj = jax.grad(jreplay_loss(
        jt, jcfg.replace(engine="xla", loop="while"), 2, jnp.asarray(px),
        jnp.asarray(py), jnp.asarray(tgt), geom_spec=spec,
        geom_tape=geom_tape))(_perturbed(jt, die, as_jax=True))
    got = _port_replay(tt, cfg.replace(engine="queue"), 2, px, py, tgt,
                       spec, geom_tape, die)
    _check(gj, got, spec, 1e-2, 1e-8)
    np.testing.assert_allclose(got["tex_color"], np.asarray(gj["tex_color"]),
                               rtol=2e-4, atol=2e-6)
    # components outside geom_spec take no gradient
    assert np.abs(got["sph_center"][1:]).max() == 0.0


def _cover():
    """The reference test's scene: cover_scene at 32x24, grid 3, depth 8,
    its target the spp-2 render of the true scene."""
    sdef, cfg = cover_scene(width=32, height=24, spp=1, max_depth=8, grid=3)
    tt = build_tables(sdef)
    px, py = pixels_of(cfg)
    tgt = render_block(tt, cfg.replace(engine="plain"), torch.from_numpy(px),
                       torch.from_numpy(py), 0, 2, cfg.seed, cfg.width,
                       cfg.height) / 2
    return tt, cfg, px, py, tgt.numpy()


def pixels_of(cfg):
    pix = np.arange(cfg.width * cfg.height, dtype=np.int32)
    return pix % cfg.width, pix // cfg.width


def test_geom_tangent_matches_port_ad():
    """On the cover scene: the tangent replay (full intersect) against
    the port's reverse mode through the plain engine. (The radiometric
    field beside it replays on the megakernels' bounce, whose unit ball
    rounds otherwise than the plain engine's; it is held to the plain
    engine in tests/test_torch_diff.py.)"""
    tt, cfg, px, py, tgt = _cover()
    met, die = _rows(tt)
    spec = _spec(met, die)
    pa = _perturbed(tt, die)
    tinverse.make_loss_fn(tt, cfg, 2)(
        pa, torch.from_numpy(px), torch.from_numpy(py),
        torch.from_numpy(tgt)).backward()
    want = {k: v.grad.numpy() for k, v in pa.items()}
    got = _port_replay(tt, cfg.replace(engine="plain"), 2, px, py, tgt,
                       spec, False, die)
    _check(want, got, spec, 1e-2, 1e-8)


def test_geom_tape_matches_full_intersect():
    """On the cover scene: the tangent replay against the taped winner
    (geom_tape=True) against the full-intersect one."""
    tt, cfg, px, py, tgt = _cover()
    met, die = _rows(tt)
    spec = _spec(met, die)
    g = {tape: _port_replay(tt, cfg.replace(engine="queue"), 2, px, py,
                            tgt, spec, tape, die)
         for tape in (False, True)}
    _check(g[False], g[True], spec, 4e-2, 1e-6)


def test_geom_spec_fit_loss_falls():
    """fit(method="replay", geom_spec=...) moves only the selected
    components, and the loss falls: tests/test_tape.py's fuzz-and-IOR
    scene (two balls against the gradient sky, where the interior chain
    is the whole gradient), from fuzz 0.4 and IOR 1.1, three steps."""
    s = SceneDef(width=64, height=36, samples_per_pixel=4, max_depth=8,
                 background=(0.7, 0.8, 1.0))
    s.add_sphere((-0.9, 0, -2), 0.8, s.add_dielectric(1.5))
    s.add_sphere((0.9, 0, -2), 0.8, s.add_metal((0.8, 0.7, 0.6), 0.15))
    s.set_camera(lookfrom=(0, 0, 1), lookat=(0, 0, -2), vup=(0, 1, 0),
                 vfov_deg=50.0, aperture=0.0)
    cfg = RenderConfig(width=64, height=36, samples_per_pixel=4,
                       max_depth=8, background_mode="gradient",
                       engine="queue")
    tt = build_tables(s)
    target = render(tt, cfg, device="cpu").numpy() / 4.0
    init = {"mat_fuzz": tt.mat_fuzz.clone(), "mat_ior": tt.mat_ior.clone()}
    init["mat_fuzz"][1] = 0.4
    init["mat_ior"][0] = 1.1
    got, hist = tinverse.fit(tt, cfg, target, spp=4, steps=3,
                             learning_rate=3e-2, init_params=init,
                             method="replay",
                             geom_spec={"mat_fuzz": [(1,)],
                                        "mat_ior": [(0,)]},
                             device="cpu")
    assert hist[0] > hist[1] > hist[2], hist
    assert got["mat_fuzz"][1] < 0.4 and got["mat_ior"][0] > 1.1
    moved = np.abs(got["mat_fuzz"] - init["mat_fuzz"].numpy())
    assert np.delete(moved, 1).max() == 0.0
