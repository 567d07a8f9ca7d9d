"""Adaptive sampling (rt_tpu_torch's render/adaptive.py) and
render_pixels with per-lane sample starts, against rt_tpu's. The budget
arithmetic is integer, so the total spend n.sum() equals rt_tpu's for the
same arguments whatever the images; the means agree within the
reference's own engine-to-engine bound (tests/test_adaptive.py:128-160:
5e-3 on >= 98% of pixels)."""

import numpy as np
import pytest
import torch

from rt_tpu.render import adaptive as jadaptive
from rt_tpu.scene import builders as jbuilders
from rt_tpu.scene import types as jtypes
from rt_tpu_torch.render import renderer as trenderer
from rt_tpu_torch.render.adaptive import adaptive_mean, render_adaptive
from rt_tpu_torch.scene import builders as tbuilders
from rt_tpu_torch.scene import types as ttypes

# One intra-op thread: the suite runs in several worker processes at
# once (as the other port test files).
torch.set_num_threads(1)

CPU = "cpu"
W, H = 32, 18
# the reference's allocation-agreement arguments (test_adaptive.py:137)
ARGS = dict(spp_base=4, rounds=2, batch_samples=2)
SPPS = (5, 8, 12, 32)


@pytest.fixture(scope="module")
def port_scene():
    sdef, cfg = tbuilders.three_sphere_scene(width=W, height=H, spp=12,
                                             max_depth=4)
    return ttypes.build_tables(sdef), cfg.replace(engine="plain")


@pytest.fixture(scope="module")
def jax_runs():
    """rt_tpu's render_adaptive (xla) at each spp of SPPS."""
    sdef, cfg = jbuilders.three_sphere_scene(width=W, height=H, spp=12,
                                             max_depth=4)
    tables = jtypes.build_tables(sdef)
    return {spp: jadaptive.render_adaptive(
        tables, cfg.replace(engine="xla", samples_per_pixel=spp), **ARGS)
        for spp in SPPS}


@pytest.fixture(scope="module")
def port_runs(port_scene):
    tables, cfg = port_scene
    return {(e, spp): render_adaptive(
        tables, cfg.replace(engine=e, samples_per_pixel=spp), device=CPU,
        **ARGS) for e in ("plain", "queue") for spp in SPPS}


@pytest.mark.parametrize("spp", SPPS)
def test_spend_equals_jax(port_runs, jax_runs, spp):
    """n.sum() equals rt_tpu's exactly on both engines, never undershoots
    the nominal budget by more than the lane padding, and overshoots it by
    at most one 128-lane pad a round (tests/test_adaptive.py:27-40,
    111-127)."""
    want = int(jax_runs[spp][1].sum())
    budget = spp * W * H
    pad = ARGS["rounds"] * 128 * ARGS["batch_samples"]
    for e in ("plain", "queue"):
        acc, n = port_runs[(e, spp)]
        assert int(n.sum()) == want, (e, spp)
        assert budget - pad <= int(n.sum()) <= budget + pad
        assert n.min() >= 2 and np.isfinite(acc).all()


@pytest.mark.parametrize("engine", ["plain", "queue"])
def test_means_agree_with_jax(port_runs, jax_runs, engine):
    """The port's allocation and mean against rt_tpu's (xla): the means
    within 5e-3 on >= 98% of pixels (the reference's engine-to-engine
    bound), and the allocations equal but for ranking ties."""
    a_j, n_j = jax_runs[12]
    a_t, n_t = port_runs[(engine, 12)]
    diff = np.abs(adaptive_mean(a_t, n_t) - adaptive_mean(a_j, n_j))
    assert float((diff.max(axis=-1) > 5e-3).mean()) <= 0.02
    assert float((n_t != n_j).mean()) <= 0.02


def test_deterministic(port_scene, port_runs):
    tables, cfg = port_scene
    a, n = render_adaptive(tables, cfg.replace(samples_per_pixel=8),
                           device=CPU, **ARGS)
    a0, n0 = port_runs[("plain", 8)]
    np.testing.assert_array_equal(a, a0)
    np.testing.assert_array_equal(n, n0)


def test_odd_spp_budget_exact(port_scene):
    """Odd spp and odd spp_base (tests/test_adaptive.py:111-127): the base
    pass renders 2 * (spp_base // 2) samples and the budget counts them."""
    tables, cfg = port_scene
    acc, n = render_adaptive(tables, cfg.replace(samples_per_pixel=5),
                             spp_base=3, rounds=2, batch_samples=1,
                             device=CPU)
    budget = 5 * W * H
    assert budget - 2 * 128 <= int(n.sum()) <= budget + 2 * 128
    assert n.min() >= 2


def test_estimator_consistent(port_scene, port_runs):
    """The adaptive mean converges to the uniform render's image: against
    a spp-64 truth, its RMSE is within 1.5x the uniform render's at the
    same budget (tests/test_adaptive.py:48-65)."""
    tables, cfg = port_scene
    truth = trenderer.render(tables, cfg.replace(samples_per_pixel=64,
                                                 seed=77),
                             device=CPU).numpy() / 64.0
    uni = trenderer.render(tables, cfg.replace(samples_per_pixel=12),
                           device=CPU).numpy() / 12.0
    acc, n = port_runs[("plain", 12)]
    ada = adaptive_mean(acc, n)

    def rmse(a):
        return float(np.sqrt(np.mean((a - truth) ** 2)))

    assert rmse(ada) < 1.5 * rmse(uni)


@pytest.mark.parametrize("engine", ["plain", "queue"])
def test_render_pixels_per_lane_starts_bit_equal(port_scene, engine):
    """render_pixels on 301 pixels (not a multiple of any block), in an
    unsorted order, each with its own start in [0, 5) and 3 samples,
    equals the per-sample full-frame renders of those pixels summed in
    sample order, bit for bit (queue: the plain B3's per-lane refill)."""
    tables, cfg = port_scene
    cfg = cfg.replace(engine=engine)
    rs = np.random.default_rng(3)
    sel = rs.choice(W * H, 301, replace=False)
    px, py = sel % W, sel // W
    starts = rs.integers(0, 5, sel.size)
    k = 3
    got = trenderer.render_pixels(tables, cfg, px, py,
                                  torch.from_numpy(starts), k, cfg.seed, W,
                                  H, device=CPU)
    per = torch.stack([trenderer.render(
        tables, cfg.replace(samples_per_pixel=1), sample_offset=s,
        device=CPU)[py, px] for s in range(int(starts.max()) + k)])
    want = torch.zeros((sel.size, 3))
    lanes = torch.arange(sel.size)
    for i in range(k):
        want = want + per[torch.from_numpy(starts) + i, lanes]
    assert torch.equal(got, want)
    # a scalar start is the same as a vector of equal starts
    one = trenderer.render_pixels(tables, cfg, px, py, 2, k, cfg.seed, W,
                                  H, device=CPU)
    vec = trenderer.render_pixels(tables, cfg, px, py,
                                  np.full(sel.size, 2), k, cfg.seed, W, H,
                                  device=CPU)
    assert torch.equal(one, vec)
