"""loop "scan" and the engine name "xla" in rt_tpu_torch, on the CPU.

loop "scan" runs the wavefront engines' fixed trip of max_depth bounces
with no host read a bounce (rt_tpu/render/integrator.py:444-452): dead
lanes pass through unchanged, so the frame is the "while" loop's bit for
bit, on "plain" and "pallas" (the plain version of B1 here), with NEE,
Russian roulette and the exhaust credit; the kernel engines ignore it.
"xla", rt_tpu's name of the plain wavefront engine, renders the bits of
"plain" in the library, the capture and the CLI. A config carried over
from rt_tpu field by field (engine "xla", loop "scan") renders within
images_close of rt_tpu's frame of it, and method "ad" differentiates the
scan to the "while" loop's gradients bit for bit. All at 48x27 or less,
spp <= 2, depth <= 6 (the bit-equal cases at 32x18, spp 1).
"""

import dataclasses

import numpy as np
import pytest
import torch

from rt_tpu.config import RenderConfig as JConfig
from rt_tpu.render import renderer as jrenderer
from rt_tpu.scene import builders as jbuilders
from rt_tpu.scene import types as jtypes
from rt_tpu_torch import cli as tcli
from rt_tpu_torch.config import RenderConfig, engine_name
from rt_tpu_torch.diff import inverse as tinverse
from rt_tpu_torch.diff.tape import capture_tape
from rt_tpu_torch.io.image import read_png
from rt_tpu_torch.ops.camera import generate_rays
from rt_tpu_torch.render.renderer import render
from rt_tpu_torch.scene import builders as tbuilders
from rt_tpu_torch.scene import types as ttypes
from rt_tpu_torch.scene.convert import tables_from_numpy
from test_torch_render import jax_leaves

# One intra-op thread: the suite runs in several worker processes at
# once (as the other port test files).
torch.set_num_threads(1)

W, H, SPP, DEPTH = 48, 27, 2, 6


def _cover(lights=False, width=32, height=18):
    """cover_scene at width x height, spp 1, depth DEPTH."""
    sdef, cfg = tbuilders.cover_scene(width=width, height=height, spp=1,
                                      max_depth=DEPTH, lights=lights)
    return ttypes.build_tables(sdef), cfg


@pytest.fixture(scope="module")
def cover():
    return _cover()


VARIANTS = {
    "default": {},
    "exhaust_rr": {"exhaust_mode": "background", "p_rr": 0.8},
    "gradient_qmc": {"background_mode": "gradient", "sampler": "qmc"},
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("engine", ["plain", "pallas"])
def test_scan_is_bit_equal_to_while(cover, engine, variant):
    """The fixed trip renders the "while" loop's frame bit for bit and
    runs max_depth bounces a trace, the "while" loop as many or fewer."""
    tables, cfg = cover
    cfg = cfg.replace(engine=engine, **VARIANTS[variant])
    sw, ss = {}, {}
    want = render(tables, cfg.replace(loop="while"), device="cpu", stats=sw)
    got = render(tables, cfg.replace(loop="scan"), device="cpu", stats=ss)
    assert torch.equal(got, want)
    assert ss["bounces"] == DEPTH
    assert sw["bounces"] <= ss["bounces"]


@pytest.mark.parametrize("engine", ["plain", "pallas"])
def test_scan_runs_on_after_every_lane_died(cover, engine):
    """Roulette 0.4: every lane is dead before bounce DEPTH, so the
    "while" loop stops there, and the fixed trip runs its DEPTH bounces
    to the same bits."""
    tables, cfg = cover
    cfg = cfg.replace(engine=engine, p_rr=0.4)
    sw, ss = {}, {}
    want = render(tables, cfg.replace(loop="while"), device="cpu", stats=sw)
    got = render(tables, cfg.replace(loop="scan"), device="cpu", stats=ss)
    assert torch.equal(got, want)
    assert sw["bounces"] < ss["bounces"] == DEPTH


def test_scan_under_nee_is_bit_equal_to_while():
    tables, cfg = _cover(lights=True)
    cfg = cfg.replace(engine="plain", nee=True, mis=True)
    assert torch.equal(render(tables, cfg.replace(loop="scan"), device="cpu"),
                       render(tables, cfg, device="cpu"))


@pytest.mark.parametrize("engine", ["mega", "queue"])
def test_kernel_engines_ignore_loop(cover, engine):
    tables, cfg = cover
    cfg = cfg.replace(engine=engine)
    assert torch.equal(render(tables, cfg.replace(loop="scan"), device="cpu"),
                       render(tables, cfg, device="cpu"))


@pytest.mark.parametrize("loop", ["while", "scan"])
def test_xla_is_bit_equal_to_plain(cover, loop):
    tables, cfg = cover
    cfg = cfg.replace(loop=loop)
    assert engine_name("xla") == "plain" and engine_name("mega") == "mega"
    assert torch.equal(render(tables, cfg.replace(engine="xla"), device="cpu"),
                       render(tables, cfg.replace(engine="plain"),
                              device="cpu"))


def test_capture_takes_xla(cover):
    tables, cfg = cover
    w, h = cfg.width, cfg.height
    pix = torch.arange(w * h)
    ro, rd = generate_rays(tables.camera, w, h, pix % w, pix // w, 0, 0,
                           False)
    codes = [capture_tape(tables, cfg, ro, rd, pix, 0, 0, engine=e)
             for e in ("xla", "plain")]
    assert torch.equal(codes[0], codes[1])
    with pytest.raises(ValueError, match="capture engine"):
        capture_tape(tables, cfg, ro, rd, pix, 0, 0, engine="cuda")


def test_carried_over_rt_tpu_scan_config_matches_rt_tpu(images_close):
    """rt_tpu's default config at a small size, carried over field by
    field (engine "xla"), with loop "scan": the port's frame against
    rt_tpu's frame of the same config."""
    sj, _ = jbuilders.cover_scene(width=W, height=H, spp=SPP,
                                  max_depth=DEPTH)
    jt = jtypes.build_tables(sj)
    jcfg = JConfig(width=W, height=H, samples_per_pixel=SPP,
                   max_depth=DEPTH, loop="scan")
    assert jcfg.engine == "xla"
    cfg = RenderConfig(**dataclasses.asdict(jcfg))
    assert cfg.engine == "xla" and cfg.loop == "scan"
    tt = tables_from_numpy(jax_leaves(jt))
    got = render(tt, cfg, device="cpu")
    assert torch.equal(got, render(tt, cfg.replace(loop="while"),
                                   device="cpu"))
    images_close(got.numpy(), np.asarray(jrenderer.render(jt, jcfg)), SPP)


def test_default_rt_tpu_config_renders():
    """RenderConfig(**asdict(rt_tpu's default)) renders: every field's
    default value is one the port takes."""
    cfg = RenderConfig(**dataclasses.asdict(JConfig()))
    assert cfg.engine == "xla"
    tables, _ = _cover(width=16, height=9)
    img = render(tables, cfg.replace(width=16, height=9, samples_per_pixel=1,
                                     max_depth=3), device="cpu")
    assert img.shape == (9, 16, 3) and bool(torch.isfinite(img).all())
    assert RenderConfig().background_tuple((1, 0.5, 0)) == (1.0, 0.5, 0.0)


def test_ad_gradients_under_scan_equal_while(cover):
    """method "ad" takes the caller's loop: autograd through the fixed
    trip gives the "while" loop's loss and gradients bit for bit."""
    tables, cfg = cover
    cfg = cfg.replace(background_mode="gradient")
    w, h = cfg.width, cfg.height
    pix = torch.arange(w * h)
    tgt = torch.full((w * h, 3), 0.3)
    out = []
    for loop in ("while", "scan"):
        p = {k: getattr(tables, k).clone().requires_grad_(True)
             for k in ("mat_albedo", "sph_center")}
        loss = tinverse.make_loss_fn(tables, cfg.replace(loop=loop), 1)(
            p, pix % w, pix // w, tgt)
        loss.backward()
        out.append((loss.detach(), {k: v.grad for k, v in p.items()}))
    assert torch.equal(out[0][0], out[1][0])
    for k in out[0][1]:
        assert torch.equal(out[0][1][k], out[1][1][k]), k
        assert out[0][1][k].abs().max() > 0, k


def test_cli_engine_xla_writes_the_plain_png(tmp_path, capsys):
    size = ["--coded", "cover", "-w", "32", "--height", "18", "-spp", "1",
            "-d", "4", "--device", "cpu", "--log", str(tmp_path / "t.log")]
    for e in ("xla", "plain"):
        assert tcli.main(["render", "--engine", e, "-o",
                          str(tmp_path / f"{e}.png")] + size) == 0
    assert "engine xla" in capsys.readouterr().out
    np.testing.assert_array_equal(read_png(str(tmp_path / "xla.png")),
                                  read_png(str(tmp_path / "plain.png")))
