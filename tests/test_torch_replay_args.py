"""The replay's interface against rt_tpu's (diff/replay.py), on the CPU.

make_replay_render / make_replay_loss_fn take the reference's parameters
in the reference's positional order: one tuple of arguments passed by
position to rt_tpu's make_replay_loss_fn and to the port's gives losses
and gradients within the tolerance of tests/test_torch_adjoint.py, and
the port's positional call equals its keyword call bit for bit.
bwd_engine picks the adjoint (None: the forward engine's; "plain" /
"xla" / "pallas": the plain adjoint; "mega" / "queue": B5 / B6, whose
plain version runs on the CPU), and bwd_early_exit stops the plain
adjoint's and the tangent replay's loops once every lane is dead: the
gradients are the same bits either way, as a dead lane credits nothing.
16x12, depth 6 (12 with roulette 0.5 in the plain adjoint's count),
spp 1.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt_tpu.diff.replay import make_replay_loss_fn as jreplay_loss
from rt_tpu_torch.diff import replay as treplay
from rt_tpu_torch.ops import adjoint_plain, cuda_mega, cuda_queue
from rt_tpu_torch.ops.camera import generate_rays
from test_torch_adjoint import make_scene

# One intra-op thread: the suite runs in several worker processes at
# once (as the other port test files).
torch.set_num_threads(1)

W, H, DEPTH = 16, 12, 6
SPEC = {"sph_center": [(0, 0), (2, 1)], "sph_radius": [(1,)]}
FIELDS = ("tex_color", "tex_color2", "mat_albedo")


@pytest.fixture(scope="module")
def scene():
    # the gradient sky: geometry moves the radiance (tests/test_diff.py)
    jt, jcfg, tt, cfg = make_scene(W, H, DEPTH, background="gradient")
    pix = np.arange(W * H, dtype=np.int32)
    tgt = np.full((W * H, 3), 0.25, np.float32)
    return jt, jcfg, tt, cfg, pix % W, pix // W, tgt


def _port(tt, cfg, px, py, tgt, fields, *args, **kw):
    p = {k: getattr(tt, k).clone().requires_grad_(True) for k in fields}
    loss = treplay.make_replay_loss_fn(
        tt, cfg, 1, torch.from_numpy(px), torch.from_numpy(py),
        torch.from_numpy(tgt), *args, **kw)(p)
    loss.backward()
    return loss.detach(), {k: v.grad for k, v in p.items()}


def _equal(a, b):
    assert torch.equal(a[0], b[0])
    assert a[1].keys() == b[1].keys()
    for k in a[1]:
        assert torch.equal(a[1][k], b[1][k]), k


def _close(want, got):
    """rt_tpu's (loss, grads) against the port's: the loss within rtol
    1e-4, each gradient within 1e-5 + 1e-3 max|g| (as
    tests/test_torch_adjoint.py), and nonzero."""
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-4)
    for k, gj in want[1].items():
        a = np.asarray(gj, np.float64)
        b = got[1][k].numpy().astype(np.float64)
        assert np.abs(a).max() > 0, k
        assert np.abs(a - b).max() <= 1e-5 + 1e-3 * np.abs(a).max(), k


def test_reference_positional_order(scene):
    """bwd_engine, geom_spec, bwd_depth, n_valid, bwd_early_exit,
    bwd_kernel, geom_tape by position: the port's loss and gradients
    equal its keyword call's, and without geom_spec rt_tpu's within the
    adjoint tests' tolerance."""
    jt, jcfg, tt, cfg, px, py, tgt = scene
    fields = ("mat_albedo", "tex_color", "sph_center", "sph_radius")
    _equal(_port(tt, cfg, px, py, tgt, fields,
                 None, SPEC, 4, W * H - 5, True, False, False),
           _port(tt, cfg, px, py, tgt, fields, bwd_engine=None,
                 geom_spec=SPEC, bwd_depth=4, n_valid=W * H - 5,
                 bwd_early_exit=True, bwd_kernel=False, geom_tape=False))
    args = ("xla", None, 4, W * H - 5, True, False, False)
    jp = {k: jnp.asarray(getattr(jt, k), jnp.float32) for k in FIELDS}
    _close(jax.jit(jax.value_and_grad(jreplay_loss(
        jt, jcfg.replace(engine="xla"), 1, jnp.asarray(px), jnp.asarray(py),
        jnp.asarray(tgt), *args)))(jp),
        _port(tt, cfg, px, py, tgt, FIELDS, *args))


@pytest.fixture(scope="module")
def default_grads(scene):
    _, _, tt, cfg, px, py, tgt = scene
    return _port(tt, cfg.replace(engine="queue"), px, py, tgt, FIELDS)


@pytest.mark.parametrize("bwd_engine", ["plain", "xla", "pallas", "mega",
                                        "queue"])
def test_bwd_engine_keeps_the_gradients(scene, default_grads, bwd_engine):
    """Every bwd_engine gives the bits of bwd_engine=None on the CPU,
    where all run the plain adjoint (tests/test_torch_adjoint.py holds
    that against rt_tpu's replay)."""
    _, _, tt, cfg, px, py, tgt = scene
    _equal(_port(tt, cfg.replace(engine="queue"), px, py, tgt, FIELDS,
                 bwd_engine), default_grads)
    assert all(g.abs().max() > 0 for g in default_grads[1].values())


def test_bwd_engine_picks_the_adjoint(scene):
    _, _, tt, cfg, px, py, _ = scene
    picks = {None: cuda_queue.queue_trace_adjoint,
             "mega": cuda_mega.mega_trace_adjoint,
             "queue": cuda_queue.queue_trace_adjoint}
    for e in (None, "mega", "queue", "plain", "xla", "pallas"):
        a = treplay.make_replay_render(tt, cfg.replace(engine="queue"), 1,
                                       px, py, e).adjoint
        if e in picks:
            assert a is picks[e], e
        else:
            assert isinstance(a, functools.partial), e
            assert a.func is adjoint_plain.trace_adjoint_plain, e
    with pytest.raises(ValueError, match="bwd_engine"):
        treplay.make_replay_render(tt, cfg, 1, px, py, "cuda")
    with pytest.raises(ValueError, match="no adjoint kernel"):
        treplay.make_replay_render(tt, cfg, 1, px, py, "xla",
                                   bwd_kernel=True)


@pytest.mark.parametrize("geom_tape", [False, True])
def test_bwd_early_exit_is_bit_equal(scene, geom_tape, monkeypatch):
    """bwd_early_exit on and off under roulette 0.4, where every lane is
    dead before bounce DEPTH: equal losses and gradients, radiometric
    (plain adjoint) and geometric (tangent replay), the early exit's
    tangent replay running fewer bounces."""
    _, _, tt, cfg, px, py, tgt = scene
    cfg = cfg.replace(p_rr=0.4)
    fields = ("mat_albedo", "tex_color", "sph_center", "sph_radius")
    push, pushes = treplay._push, []

    def counted(*args):
        pushes.append(1)
        return push(*args)

    monkeypatch.setattr(treplay, "_push", counted)
    runs, bounces = [], []
    for early in (False, True):
        n = len(pushes)
        runs.append(_port(tt, cfg, px, py, tgt, fields, "plain", SPEC,
                          bwd_early_exit=early, geom_tape=geom_tape))
        bounces.append(len(pushes) - n)
    _equal(runs[0], runs[1])
    assert bounces[0] == DEPTH > bounces[1] > 0


def test_plain_adjoint_runs_depth_bwd_bounces_without_early_exit(scene):
    """The loop runs depth_bwd bounces without the early exit, and stops
    at the last live lane's death with it, crediting the same bits."""
    _, _, tt, cfg, px, py, tgt = scene
    cfg = cfg.replace(p_rr=0.5, max_depth=12)
    pix = torch.from_numpy(py * W + px).long()
    ro, rd = generate_rays(tt.camera, W, H, torch.from_numpy(px),
                           torch.from_numpy(py), 0, 0, False)
    L = torch.ones((W * H, 3))
    g = torch.full((W * H, 3), 0.5)
    out = []
    for early in (False, True):
        st = {}
        out.append((adjoint_plain.trace_adjoint_plain(
            tt, cfg, ro, rd, pix, 0, 0, L, g, 12, False, early_exit=early,
            stats=st), st))
    (full, s_full), (early, s_early) = out
    assert s_full["bounces"] == 12 > s_early["bounces"]
    assert s_full["ray_bounces"] == s_early["ray_bounces"]
    for k in full:
        assert torch.equal(full[k], early[k]), k
