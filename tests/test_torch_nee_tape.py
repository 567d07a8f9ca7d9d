"""The winner tape with next-event estimation (diff/tape.py: the capture
without light sampling, the replay adding each bounce's direct term
under nee, mis and nee_glossy) against rt_tpu's tape and against the
port's own trace and method "ad": the replay per lane
(tests/test_tape.py::test_tape_replay_nee_matches_trace), and the
gradients of make_tape_vg (the death-sorted step of fit(method="tape"),
on the plain version of the capture kernel B4) against rt_tpu's
make_tape_loss_fn (tests/test_mis.py::
test_mis_tape_gradient_matches_scan_ad) and the port's "ad".

Scene: tests/test_torch_nee.py's (four light families, a checker light,
a fuzzy metal and a glass sphere), 24x16, depth 4, cull_chunks=False on
rt_tpu's side (ROADMAP C-3). Tolerances: per lane 1e-4 against the
port's trace (on this scene rt_tpu's own replay parts from its trace by
up to 6.7e-5 on 14 of 384 lanes: the leaf tests against the batched
candidates in the last bits, as ROADMAP C-11 under the gradient sky),
1e-4 against rt_tpu's replay and 1e-5 on >= 99% of its lanes (they part
by 4.5e-5 on one lane); gradients per
field |a - b| <= 1e-5 + 2e-3 max|a| (tests/test_mis.py:174). Under
nee_glossy rt_tpu's tape gradients of the geometry and fuzz fields are
NaN (its glossy density's sqrt at the cone's edge, ROADMAP C-12); the
port's are finite, so those fields are held against the port's "ad"
only."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt_tpu.config import RenderConfig as JConfig
from rt_tpu.diff import tape as jtape
from rt_tpu.ops.camera import generate_rays as jrays
from rt_tpu.scene import types as jtypes
from rt_tpu_torch.config import RenderConfig
from rt_tpu_torch.diff import inverse as tinverse
from rt_tpu_torch.diff import tape as ttape
from rt_tpu_torch.ops.camera import generate_rays
from rt_tpu_torch.render.integrator import trace
from rt_tpu_torch.scene import types as ttypes
from rt_tpu_torch.scene.convert import params_from_numpy
from test_torch_nee import FLAGS, light_scene

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's default of one thread per core in each of them
# oversubscribes the CPU many times over.
torch.set_num_threads(1)

W, H = 24, 16
FIELDS = ("tex_color", "mat_albedo", "mat_fuzz", "sph_center", "sph_radius",
          "rect_lo")


@pytest.fixture(scope="module")
def scenes():
    jt = jax.tree_util.tree_map(jnp.asarray, light_scene(jtypes, W, H))
    return jt, light_scene(ttypes, W, H)


def configs(**kw):
    jcfg = JConfig(width=W, height=H, samples_per_pixel=1, max_depth=4,
                   loop="scan", cull_chunks=False, **kw)
    return jcfg, RenderConfig(**{**dataclasses.asdict(jcfg), "loop": "while",
                                 "engine": "plain"})


def pixels():
    pix = np.arange(W * H, dtype=np.int32)
    return pix % W, pix // W


@pytest.mark.parametrize("flags", ["nee", "mis_glossy"])
def test_tape_replay_nee_matches_trace_and_rt_tpu(scenes, flags):
    jt, tt = scenes
    jcfg, cfg = configs(**FLAGS[flags])
    px, py = (jnp.asarray(x) for x in pixels())
    jpix = (py * W + px).astype(jnp.uint32)
    js = jnp.zeros(W * H, jnp.uint32)
    seed = jnp.uint32(0)
    jro, jrd = jrays(jt.camera, W, H, px, py, js, seed, False)
    jcodes = jtape.capture_tape(jt, jcfg, jro, jrd, jpix, js, seed)
    want = np.asarray(jtape.replay_tape(jt, jcfg, jro, jrd, jcodes, jpix,
                                        js, seed))
    tpx, tpy = (torch.from_numpy(np.array(x)).long() for x in (px, py))
    ro, rd = generate_rays(tt.camera, W, H, tpx, tpy, 0, 0, False)
    pix = tpy * W + tpx
    codes = ttape.capture_tape(tt, cfg, ro, rd, pix, 0, 0)
    # winner codes do not depend on light sampling
    assert torch.equal(codes, ttape.capture_tape(
        tt, cfg.replace(nee=False), ro, rd, pix, 0, 0))
    got = ttape.replay_tape(tt, cfg, ro, rd, codes, pix, 0, 0).numpy()
    err = np.abs(got - want).max(-1)
    assert err.max() <= 1e-4 and (err <= 1e-5).mean() >= 0.99
    err = np.abs(got - trace(tt, cfg, ro, rd, pix, 0, 0).numpy()).max(-1)
    assert err.max() <= 1e-4
    assert got.max() > 0


def _close(want, got, label):
    for k in want:
        a = np.asarray(want[k], np.float64)
        b = np.asarray(got[k], np.float64)
        mag = max(np.abs(a).max(), 1e-10)
        assert np.abs(a - b).max() <= 1e-5 + 2e-3 * mag, (label, k)


@pytest.mark.parametrize("flags", ["nee", "mis", "mis_glossy"])
def test_tape_vg_nee_matches_rt_tpu_and_ad(scenes, flags):
    jt, tt = scenes
    jcfg, cfg = configs(**FLAGS[flags])
    px, py = pixels()
    tgt = np.random.RandomState(0).rand(W * H, 3).astype(np.float32)
    p0 = {f: jnp.asarray(getattr(jt, f), jnp.float32) for f in FIELDS}
    gj = jax.grad(jtape.make_tape_loss_fn(jt, jcfg, 1, px, py, tgt))(p0)
    pt = params_from_numpy({k: np.asarray(v) for k, v in p0.items()})
    step = ttape.make_tape_vg(tt, cfg, torch.from_numpy(px),
                              torch.from_numpy(py), torch.from_numpy(tgt),
                              min_width=64)
    _, gv = step(pt)
    for k, v in gv.items():
        assert bool(torch.isfinite(v).all()), k
    fin = {k: v for k, v in gj.items() if bool(jnp.isfinite(v).all())}
    assert set(fin) == (set(FIELDS) if flags != "mis_glossy" else
                        {"tex_color", "mat_albedo"})
    _close(fin, {k: gv[k].numpy() for k in fin}, "rt_tpu")
    pa = {k: v.clone().requires_grad_(True) for k, v in pt.items()}
    tinverse.make_loss_fn(tt, cfg, 1)(
        pa, torch.from_numpy(px), torch.from_numpy(py),
        torch.from_numpy(tgt)).backward()
    _close({k: v.grad.numpy() for k, v in pa.items()},
           {k: v.numpy() for k, v in gv.items()}, "ad")
    assert float(gv["tex_color"].abs().max()) > 0
