"""rt_tpu_torch's differentiable rendering (diff/inverse.py, diff/replay.py)
against rt_tpu's diff package on the same scene, pixels, target and
parameters, on the CPU: method "ad" (autograd through the plain engine)
against rt_tpu's scan AD (make_loss_fn), the replay against the port's
own autograd, the loss values, and short fits whose loss falls.

Gradient tolerance per field: |a - b| <= 1e-5 + 1e-3 max|a|, the
reference's own between its estimators (tests/test_diff.py:567, 886).
Scene and helpers: tests/test_torch_adjoint.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt_tpu.diff.inverse import make_loss_fn as jloss_fn
from rt_tpu_torch.diff import inverse as tinverse
from rt_tpu_torch.diff import replay as treplay
from rt_tpu_torch.render.renderer import render
from rt_tpu_torch.scene.convert import params_from_numpy
from test_torch_adjoint import (FIELDS, assert_grads_close, jparams,
                                make_scene, pixels, port_grads)


def _target(n, seed=6):
    return np.random.RandomState(seed).uniform(0.0, 0.6, (n, 3)).astype(
        np.float32)


@pytest.mark.parametrize("background", ["constant", "gradient"])
def test_ad_matches_jax_scan_ad(background):
    """method "ad": loss and gradients of every ported field through the
    port's plain engine against rt_tpu's reverse mode through its scan
    loop (XLA engine), at 32x24, depth 5, spp 2."""
    jt, jcfg, tt, cfg = make_scene(32, 24, 5, background=background)
    px, py = pixels(32, 24)
    tgt = _target(px.shape[0])
    jp = jparams(jt)
    lj, gj = jax.value_and_grad(jloss_fn(jt, jcfg, 2))(
        jp, jnp.asarray(px), jnp.asarray(py), jnp.asarray(tgt))
    p = {k: v.requires_grad_(True) for k, v in params_from_numpy(jp).items()}
    lt = tinverse.make_loss_fn(tt, cfg, 2)(
        p, torch.from_numpy(px), torch.from_numpy(py), torch.from_numpy(tgt))
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    # the gradient sky does not read the background colour: no gradient
    got = {k: torch.zeros_like(v) if v.grad is None else v.grad
           for k, v in p.items()}
    assert (p["background"].grad is None) == (background == "gradient")
    assert_grads_close(gj, got, background)


@pytest.mark.parametrize("variant", ["exact", "exhaust"])
def test_replay_matches_port_ad(variant):
    """The replay (engine queue, plain adjoint on the CPU) against the
    port's own autograd through the plain engine: the suffix identity
    against the chain rule, on one package."""
    over = ({"exhaust_mode": "background", "max_depth": 3}
            if variant == "exhaust" else {})
    jt, _, tt, cfg = make_scene(24, 16, 5, seed=8)
    cfg = cfg.replace(**over)
    px, py = pixels(24, 16)
    tgt = _target(px.shape[0], seed=9)
    params = params_from_numpy(jparams(jt))
    ad = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    la = tinverse.make_loss_fn(tt, cfg, 2)(
        ad, torch.from_numpy(px), torch.from_numpy(py), torch.from_numpy(tgt))
    la.backward()
    lr, gr = port_grads(tt, cfg.replace(engine="queue"), px, py, tgt,
                        params)
    np.testing.assert_allclose(lr, float(la.detach()), rtol=1e-4)
    assert_grads_close({k: v.grad.numpy() for k, v in ad.items()}, gr,
                       variant)


def test_replay_truncation_is_a_small_bias():
    """bwd_depth truncates the replay only: the loss is the exact one,
    and the gradient moves by little (the reference measured ~0.4% on
    the cover scene at 8 of 50 bounces)."""
    jt, _, tt, cfg = make_scene(24, 16, 6, seed=8)
    cfg = cfg.replace(engine="mega")
    px, py = pixels(24, 16)
    tgt = _target(px.shape[0], seed=9)
    params = params_from_numpy(jparams(jt))
    le, ge = port_grads(tt, cfg, px, py, tgt, params)
    lt, gt = port_grads(tt, cfg, px, py, tgt, params, bwd_depth=3)
    assert lt == le
    for k in FIELDS:
        mag = float(ge[k].abs().max())
        assert float((ge[k] - gt[k]).abs().max()) <= 0.2 * mag + 1e-6, k


def test_replay_keeps_or_recomputes_radiance(monkeypatch):
    """Above STORE_L_MAX floats the backward recomputes each sample's
    radiance instead of keeping it: the same gradients."""
    jt, _, tt, cfg = make_scene(16, 12, 4, seed=8)
    cfg = cfg.replace(engine="queue")
    px, py = pixels(16, 12)
    tgt = _target(px.shape[0])
    params = params_from_numpy(jparams(jt))
    _, kept = port_grads(tt, cfg, px, py, tgt, params)
    monkeypatch.setattr(treplay, "STORE_L_MAX", 0)
    _, again = port_grads(tt, cfg, px, py, tgt, params)
    for k in FIELDS:
        assert torch.equal(kept[k], again[k]), k


@pytest.mark.parametrize("method", ["replay", "ad"])
def test_fit_loss_falls(method):
    """fit from perturbed albedos against the target rendered from the
    true scene on the same samples (resample=False): the loss falls."""
    jt, _, tt, cfg = make_scene(16, 12, 4, seed=12)
    cfg = cfg.replace(engine="queue", samples_per_pixel=1)
    target = render(tt, cfg, device="cpu").numpy()
    rs = np.random.RandomState(13)
    init = {"mat_albedo": tt.mat_albedo * torch.from_numpy(
                rs.uniform(0.5, 1.5, tuple(tt.mat_albedo.shape))
                .astype(np.float32)),
            "tex_color": tt.tex_color.clone()}
    got, hist = tinverse.fit(tt, cfg, target, spp=1, steps=4,
                             learning_rate=0.05, init_params=init,
                             method=method, device="cpu")
    assert len(hist) == 4 and np.isfinite(hist).all()
    assert hist[-1] < hist[0], hist
    assert got["mat_albedo"].shape == tuple(tt.mat_albedo.shape)
    assert np.isfinite(got["mat_albedo"]).all()


def test_fit_resample_moves_the_samples():
    """resample=True renders another sample window every step."""
    _, _, tt, cfg = make_scene(8, 6, 3, seed=12)
    cfg = cfg.replace(engine="mega", samples_per_pixel=1)
    target = np.zeros((6, 8, 3), np.float32)
    kw = dict(fields=("tex_color",), spp=1, steps=2, learning_rate=0.0,
              method="replay", device="cpu")
    _, fixed = tinverse.fit(tt, cfg, target, **kw)
    _, moved = tinverse.fit(tt, cfg, target, resample=True, **kw)
    assert fixed[0] == fixed[1] == moved[0] != moved[1]


def test_fit_rejects_tape_and_unknown_methods():
    _, _, tt, cfg = make_scene(8, 6, 2)
    target = np.zeros((6, 8, 3), np.float32)
    with pytest.raises(NotImplementedError, match="B4"):
        tinverse.fit(tt, cfg, target, method="tape", device="cpu")
    with pytest.raises(ValueError):
        tinverse.fit(tt, cfg, target, method="fd", device="cpu")


def test_apply_params_builds_fresh_packed_tables():
    """A parameter step must not reuse the packed table of the tables
    before it (SceneTables.mega is cached per instance)."""
    _, _, tt, _ = make_scene(8, 6, 2)
    old = tt.mega.table.clone()
    new = tinverse.apply_params(tt, {"mat_albedo": tt.mat_albedo * 0.5})
    assert new.mega is not tt.mega
    assert not torch.equal(new.mega.table, old)
    assert torch.equal(tt.mega.table, old)
    assert tinverse.extract_params(new, ("mat_albedo",))["mat_albedo"] \
        is new.mat_albedo


def test_params_from_numpy_carries_rt_tpu_params():
    jt, _, tt, _ = make_scene(8, 6, 2)
    got = params_from_numpy({k: np.asarray(v) for k, v in
                             jparams(jt).items()})
    for k in FIELDS:
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], getattr(tt, k)), k


def test_scan_loop_message_names_the_route():
    from rt_tpu_torch.config import check_supported

    _, _, _, cfg = make_scene(8, 6, 2)
    with pytest.raises(NotImplementedError, match="autograd"):
        check_supported(dataclasses.replace(cfg, loop="scan"))


def test_port_and_scripts_import_no_jax():
    """No import statement of the port, chip_smoke.py or profile_torch.py
    (at module level or inside a function) names jax, jaxlib or rt_tpu:
    the card's machine runs them without the reference."""
    import ast
    import pathlib

    root = pathlib.Path(__file__).resolve().parent.parent
    files = sorted((root / "rt_tpu_torch").rglob("*.py"))
    files += [root / "chip_smoke.py", root / "profile_torch.py"]
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            bad += [f"{path.name}: {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "rt_tpu")]
    assert len(files) > 30 and not bad, bad
