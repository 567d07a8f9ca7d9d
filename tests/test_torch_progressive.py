"""Progressive rendering with checkpoint / resume (rt_tpu_torch's
render/progressive.py), render's samples_per_launch and pixel-order
cache, and utils/metrics.py, against rt_tpu's. A resumed render with
one-sample passes adds the samples in render's order and is bit-equal to
the one-shot render; longer passes are held at the reference's
tolerance (tests/test_progressive.py: rtol 1e-6, atol 1e-6)."""

import os

import numpy as np
import pytest
import torch

from rt_tpu.render import progressive as jprogressive
from rt_tpu.scene import builders as jbuilders
from rt_tpu.scene import types as jtypes
from rt_tpu.utils import metrics as jmetrics
from rt_tpu_torch.render import renderer as trenderer
from rt_tpu_torch.render.progressive import Checkpoint, render_progressive
from rt_tpu_torch.scene import builders as tbuilders
from rt_tpu_torch.scene import types as ttypes
from rt_tpu_torch.utils import metrics as tmetrics

# One intra-op thread: the suite runs in several worker processes at
# once (as the other port test files).
torch.set_num_threads(1)

CPU = "cpu"


@pytest.fixture(scope="module")
def scene():
    """three_sphere_scene at 32x18, spp 8, depth 4 (the reference's
    progressive test size) on the port's plain engine."""
    sdef, cfg = tbuilders.three_sphere_scene(width=32, height=18, spp=8,
                                             max_depth=4)
    return ttypes.build_tables(sdef), cfg.replace(engine="plain")


@pytest.fixture(scope="module")
def oneshot(scene):
    tables, cfg = scene
    return {e: trenderer.render(tables, cfg.replace(engine=e), device=CPU)
            for e in ("plain", "queue")}


@pytest.mark.parametrize("engine", ["plain", "queue"])
def test_progressive_equals_oneshot_and_resume_is_bit_equal(
        scene, oneshot, engine, tmp_path):
    """Three-sample passes at the reference's tolerance; a render stopped
    at 4 samples and resumed to 8, both with one-sample passes, equal to
    the one-shot render bit for bit (queue: the plain B3)."""
    tables, cfg = scene
    cfg = cfg.replace(engine=engine)
    ref = oneshot[engine]
    acc, done = render_progressive(tables, cfg, samples_per_pass=3,
                                   device=CPU)
    assert done == cfg.samples_per_pixel
    np.testing.assert_allclose(acc.numpy(), ref.numpy(), rtol=1e-6,
                               atol=1e-6)

    ck = str(tmp_path / "ck.npz")
    render_progressive(tables, cfg.replace(samples_per_pixel=4),
                       checkpoint_path=ck, checkpoint_every=2,
                       samples_per_pass=1, device=CPU)
    assert Checkpoint.load(ck).samples_done == 4
    acc, done = render_progressive(tables, cfg, checkpoint_path=ck,
                                   checkpoint_every=4, samples_per_pass=1,
                                   device=CPU)
    assert done == cfg.samples_per_pixel
    assert torch.equal(acc, ref)
    assert Checkpoint.load(ck).samples_done == cfg.samples_per_pixel


@pytest.mark.parametrize("change", [dict(seed=123), dict(sampler="qmc"),
                                    dict(nee=True)],
                         ids=["seed", "sampler", "nee"])
def test_checkpoint_rejects_another_config(scene, tmp_path, change):
    tables, cfg = scene
    ck = str(tmp_path / "ck.npz")
    render_progressive(tables, cfg.replace(samples_per_pixel=2),
                       checkpoint_path=ck, checkpoint_every=2, device=CPU)
    with pytest.raises(ValueError, match="does not match"):
        render_progressive(tables, cfg.replace(**change),
                           checkpoint_path=ck, device=CPU)


def test_checkpoint_rejects_other_tables(scene, tmp_path):
    tables, cfg = scene
    ck = str(tmp_path / "ck.npz")
    render_progressive(tables, cfg.replace(samples_per_pixel=2),
                       checkpoint_path=ck, checkpoint_every=2, device=CPU)
    moved = ttypes.SceneTables(**{
        **{f: getattr(tables, f) for f in tables.__dataclass_fields__},
        "sph_radius": tables.sph_radius * 1.5})
    with pytest.raises(ValueError, match="does not match"):
        render_progressive(moved, cfg, checkpoint_path=ck, device=CPU)


def test_callback_fires_per_pass(scene):
    tables, cfg = scene
    seen = []
    render_progressive(tables, cfg, samples_per_pass=2, device=CPU,
                       callback=lambda img, s: seen.append(
                           (s, tuple(img.shape))))
    assert seen == [(s, (18, 32, 3)) for s in (2, 4, 6, 8)]


def test_checkpoint_save_ignores_stale_tmp(tmp_path):
    """Stale files at the temp names a crashed writer leaves (the old
    `.tmp` and the current `.tmp.npz`) are never promoted over fresh
    data."""
    path = str(tmp_path / "ck.npz")
    for stale in (path + ".tmp", path + ".tmp.npz"):
        with open(stale, "w") as f:
            f.write("stale garbage from a crashed writer")
    fresh = np.full((2, 2, 3), 7.0, np.float32)
    Checkpoint(fresh, 5, "fp").save(path)
    loaded = Checkpoint.load(path)
    assert loaded.samples_done == 5 and loaded.fingerprint == "fp"
    np.testing.assert_array_equal(loaded.pixel_sum, fresh)
    # the reference reads the port's checkpoint file: the same keys
    ref = jprogressive.Checkpoint.load(path)
    assert ref.samples_done == 5
    np.testing.assert_array_equal(ref.pixel_sum, fresh)


def test_checkpoint_temp_name_is_the_writers(tmp_path):
    """The temp file carries the writer's pid: another process's temp
    file at the same path is neither promoted nor removed, and the save
    leaves no temp file of its own."""
    path = str(tmp_path / "ck.npz")
    foreign = f"{path}.{os.getpid() + 1}.tmp.npz"
    with open(foreign, "w") as f:
        f.write("another writer's half-written file")
    Checkpoint(np.ones((2, 2, 3), np.float32), 3, "fp").save(path)
    assert Checkpoint.load(path).samples_done == 3
    assert sorted(os.listdir(tmp_path)) == sorted(
        ["ck.npz", os.path.basename(foreign)])


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("engine", ["plain", "queue"])
def test_samples_per_launch_is_bit_equal(scene, oneshot, k, engine):
    """Every split of the spp loop into launches adds the samples in the
    one-shot render's order (one launch of 8 samples over one tile),
    here over 1, 2 and 5 tiles (rays_per_batch 1024)."""
    tables, cfg = scene
    cfg = cfg.replace(engine=engine, rays_per_batch=1024)
    img = trenderer.render(tables, cfg, device=CPU, samples_per_launch=k)
    assert torch.equal(img, oneshot[engine])


def test_render_progress_prints_tiles(scene, oneshot, capsys):
    tables, cfg = scene
    img = trenderer.render(tables, cfg.replace(rays_per_batch=256),
                           device=CPU, progress=True)
    out = capsys.readouterr().out
    assert "tile 3/3" in out and out.endswith("\n")
    assert torch.equal(img, oneshot["plain"])


def test_tables_to_same_device_is_self(scene):
    """SceneTables.to (and CameraDef.to) return the same object when
    every tensor is on that device already, so the packed tables cached
    on it serve every pass; the device pixel order is cached per (w, h,
    device)."""
    tables, _ = scene
    assert tables.to("cpu") is tables
    assert tables.to(torch.device("cpu")) is tables
    assert tables.camera.to("cpu") is tables.camera
    a = trenderer._device_order(32, 18, "cpu")
    assert trenderer._device_order(32, 18, "cpu") is a
    px, py, pix, pix_long = a
    want = trenderer._block_order(32, 18)
    for got, w in zip((px, py, pix), want):
        np.testing.assert_array_equal(got.numpy(), w)
    assert torch.equal(pix_long, pix.long())


def test_progressive_matches_jax(images_close):
    """The port's render_progressive (plain) against rt_tpu's (xla) on
    three_sphere_scene(32, 18, spp 8, depth 4), one-sample passes."""
    sj, cj = jbuilders.three_sphere_scene(width=32, height=18, spp=8,
                                          max_depth=4)
    st, ct = tbuilders.three_sphere_scene(width=32, height=18, spp=8,
                                          max_depth=4)
    acc_j, done_j = jprogressive.render_progressive(
        jtypes.build_tables(sj), cj.replace(engine="xla"))
    acc_t, done_t = render_progressive(
        ttypes.build_tables(st), ct.replace(engine="plain"), device=CPU)
    assert done_j == done_t == 8
    images_close(acc_t.numpy(), np.asarray(acc_j), spp=8)


def test_render_stats_and_metrics_match_jax():
    kw = dict(width=100, height=50, spp=4, max_depth=8, seconds=2.0,
              engine="mega")
    t, j = tmetrics.RenderStats(**kw), jmetrics.RenderStats(**kw)
    assert t.paths == j.paths == 100 * 50 * 4
    assert t.paths_per_s == j.paths_per_s
    assert t.log_line() == j.log_line().replace("rt_tpu,", "rt_tpu_torch,")
    assert t.log_line().startswith("rt_tpu_torch, width 100")
    assert t.log_line("x") == j.log_line("x")
    assert t.to_json() == j.to_json()

    m = tmetrics.Metrics(sync=True)
    with m.phase("parse"):
        pass
    with m.phase("render", result=torch.zeros(2)):
        pass
    m.add("launches", 3)
    s = m.summary()
    assert set(s) == {"phase.parse.s", "phase.render.s", "count.launches"}
    assert s["count.launches"] == 3
    tmetrics.device_sync(torch.zeros(1))   # a no-op on the CPU
    tmetrics.device_sync({"a": torch.zeros(1)})


def test_profile_writes_a_chrome_trace(tmp_path):
    d = str(tmp_path / "prof")
    with tmetrics.profile(d) as prof:
        torch.ones(4).sum()
    assert prof is not None
    import json

    with open(tmp_path / "prof" / "trace.json") as f:
        assert "traceEvents" in json.load(f)
    with tmetrics.profile(None) as none:
        assert none is None
