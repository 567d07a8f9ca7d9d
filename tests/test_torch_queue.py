"""rt_tpu_torch's persistent-queue path (ops/cuda_queue: kernel B3's plain
emulation and the queue engine) against its megakernel path and against
rt_tpu's engine="queue"; the CLI's default engine; and the new modules'
imports.

rt_tpu's queue runs as its own tests run it on the CPU (the Pallas kernel
in interpret mode). The CUDA kernel itself is held against
queue_trace_plain on the card by tests/test_torch_cuda.py."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rt_tpu.render import renderer as jrenderer
from rt_tpu.scene import builders as jbuilders
from rt_tpu.scene import types as jtypes
from rt_tpu_torch import cli as tcli
from rt_tpu_torch.config import RenderConfig
from rt_tpu_torch.ops import camera as tcamera
from rt_tpu_torch.ops import cuda_mega, cuda_queue
from rt_tpu_torch.render import renderer as trenderer
from rt_tpu_torch.scene import builders as tbuilders
from rt_tpu_torch.scene import types as ttypes

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's default of one thread per core in each of them
# oversubscribes the CPU many times over.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_cfg(cj, **kw):
    return RenderConfig(**{**dataclasses.asdict(cj), **kw})


def _rays(tt, cfg, w, h, sample, per_lane=False):
    px = torch.arange(w * h) % w
    py = torch.arange(w * h) // w
    if per_lane:  # adaptive sampling's per-lane sample indices
        sample = torch.from_numpy(
            np.random.default_rng(3).integers(0, 7, w * h))
    ro, rd = tcamera.generate_rays(tt.camera, w, h, px, py, sample, 0,
                                   cfg.enable_defocus)
    return ro, rd, py * w + px, sample


@pytest.fixture(scope="module")
def cover():
    sdef, cfg = tbuilders.cover_scene(width=32, height=18, spp=1,
                                      max_depth=10, grid=3)
    return ttypes.build_tables(sdef), cfg


@pytest.mark.parametrize("pool", [64, 1000])
@pytest.mark.parametrize("steps", [1, 7, 0])
def test_queue_plain_bit_equal_to_mega(cover, steps, pool):
    """Per lane, the queue's result is mega_trace's, bit for bit, for any
    step budget per launch and any pool size; every lane completes once,
    and both count the same ray-bounces."""
    tt, cfg = cover
    cfg = cfg.replace(p_rr=0.8, exhaust_mode="background", queue_steps=steps)
    ro, rd, pix, s = _rays(tt, cfg, 32, 18, 1)
    sm, sq = {}, {}
    ref = cuda_mega.mega_trace(tt, cfg, ro, rd, pix, s, 5, stats=sm)
    got = cuda_queue.queue_trace(tt, cfg, ro, rd, pix, s, 5, stats=sq,
                                 pool_lanes=pool, check_once=True)
    assert torch.equal(got, ref)
    assert sq["ray_bounces"] == sm["ray_bounces"] > 32 * 18
    launches = sq["launches"]
    if steps == 0:
        assert launches == 1
    else:  # a launch of `steps` steps cannot retire the whole batch
        assert launches >= (32 * 18 // pool) // steps


def test_queue_per_lane_samples_match_mega(cover):
    tt, cfg = cover
    ro, rd, pix, s = _rays(tt, cfg, 32, 18, None, per_lane=True)
    ref = cuda_mega.mega_trace(tt, cfg.replace(compact_every=2,
                                               compact_group=8),
                               ro, rd, pix, s, 1)
    got = cuda_queue.queue_trace(tt, cfg.replace(queue_steps=3), ro, rd,
                                 pix, s, 1, pool_lanes=100)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("name,kw,size", [
    ("cover_scene", dict(grid=3), dict(width=48, height=27, spp=2,
                                       max_depth=6)),
    ("cornell_spheres_scene", {}, dict(width=24, height=24, spp=2,
                                       max_depth=6)),
])
def test_queue_render_matches_jax_queue(name, kw, size, images_close):
    """The port's render(engine="queue") against rt_tpu's, with rt_tpu's
    defaults (cull_chunks on: the compare is by images_close, C-3)."""
    sj, cj = getattr(jbuilders, name)(**kw, **size)
    st, _ = getattr(tbuilders, name)(**kw, **size)
    cj = cj.replace(engine="queue")
    img_j = np.asarray(jrenderer.render(jtypes.build_tables(sj), cj))
    stats = {}
    img_t = trenderer.render(ttypes.build_tables(st), _port_cfg(cj),
                             device="cpu", stats=stats)
    assert stats["launches"] == size["spp"]  # one per trace at budget 0
    images_close(img_t.numpy(), img_j, spp=size["spp"])


def test_empty_scene_falls_back_to_pallas():
    s = ttypes.SceneDef(width=8, height=4, background=(0.2, 0.3, 0.4))
    s.set_camera((0, 0, 1), (0, 0, 0), (0, 1, 0), 40.0, 0.0)
    tt = ttypes.build_tables(s)
    cfg = RenderConfig(width=8, height=4, samples_per_pixel=2, max_depth=3)
    for engine in ("queue", "mega"):
        stats = {}
        img = trenderer.render(tt, cfg.replace(engine=engine), device="cpu",
                               stats=stats)
        assert "launches" not in stats and stats["bounces"] == 2
        torch.testing.assert_close(
            img, torch.tensor([0.4, 0.6, 0.8]).expand(4, 8, 3))


def test_cli_default_engine_is_queue(tmp_path, capsys, monkeypatch):
    out = str(tmp_path / "c.png")
    assert tcli.main(["render", "--coded", "cornell", "-w", "16",
                      "--height", "16", "-spp", "1", "-d", "4", "-o", out,
                      "--device", "cpu"]) == 0
    assert "engine queue" in capsys.readouterr().out
    ns = {}
    real = trenderer.render

    def spy(tables, cfg, **kw):
        ns["cfg"] = cfg
        return real(tables, cfg, **kw)

    monkeypatch.setattr(trenderer, "render", spy)
    tcli.main(["render", "--coded", "cover", "-w", "8", "--height", "6",
               "-spp", "1", "-d", "16", "-o", out, "--device", "cpu",
               "--engine", "mega"])
    assert ns["cfg"].engine == "mega"
    assert ns["cfg"].compact_schedule == (2, 3, 5, 10)
    assert ns["cfg"].compact_group == 16


def test_new_modules_import_without_jax():
    """The port's new modules import with JAX and rt_tpu absent from
    sys.modules afterwards, and with both blocked."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'rt_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import rt_tpu_torch.ops.mega_tables, rt_tpu_torch.ops.mega_plain\n"
        "import rt_tpu_torch.ops.cuda_mega, rt_tpu_torch.ops.cuda_queue\n"
        "import rt_tpu_torch.render.integrator, rt_tpu_torch.cli\n"
        "import rt_tpu_torch.ops.camera, rt_tpu_torch.render.renderer\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'rt_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
