"""The slice end to end: rt_tpu_torch's trace / render / film / PNG / CLI
against rt_tpu's on the same scenes and seeds, at the small sizes the
reference's own tests use. Images compare with the outlier-tolerant
images_close of tests/conftest.py."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rt_tpu.io import image as jimage
from rt_tpu.ops import camera as jcamera
from rt_tpu.render import film as jfilm
from rt_tpu.render import integrator as jintegrator
from rt_tpu.render import renderer as jrenderer
from rt_tpu.scene import builders as jbuilders
from rt_tpu.scene import types as jtypes
from rt_tpu_torch import cli as tcli
from rt_tpu_torch.config import RenderConfig
from rt_tpu_torch.io import image as timage
from rt_tpu_torch.ops import camera as tcamera
from rt_tpu_torch.render import film as tfilm
from rt_tpu_torch.render import integrator as tintegrator
from rt_tpu_torch.render import renderer as trenderer
from rt_tpu_torch.scene import builders as tbuilders
from rt_tpu_torch.scene import types as ttypes
from rt_tpu_torch.scene.convert import tables_from_numpy

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's default of one thread per core in each of them
# oversubscribes the CPU many times over.
torch.set_num_threads(1)

SIZE = dict(width=48, height=27, spp=2, max_depth=8)
SCENES = {"cover_grid4": ("cover_scene", dict(grid=4)),
          "cover": ("cover_scene", {}),
          "three_sphere": ("three_sphere_scene", {})}


def _scene(name, **size):
    fn, kw = SCENES[name]
    sj, cj = getattr(jbuilders, fn)(**kw, **size)
    st, _ = getattr(tbuilders, fn)(**kw, **size)
    return jtypes.build_tables(sj), cj, ttypes.build_tables(st)


def jax_leaves(tables):
    """A JAX SceneTables' leaves as NumPy, camera under 'camera.<field>'."""
    out = {}
    for f in dataclasses.fields(tables):
        if f.metadata.get("static"):
            continue
        val = getattr(tables, f.name)
        if f.name == "camera":
            for cf in dataclasses.fields(val):
                out[f"camera.{cf.name}"] = np.asarray(getattr(val, cf.name))
        else:
            out[f.name] = np.asarray(val)
    return out


def _port_cfg(cj, **kw):
    return RenderConfig(**{**dataclasses.asdict(cj), **kw})


@pytest.mark.parametrize("name", ["cover_grid4", "three_sphere"])
def test_render_pallas_matches_jax_pallas(name, images_close):
    """The port's engine="pallas" (the plain kernel version on the CPU)
    against rt_tpu's engine="pallas" (the Pallas kernel in interpret
    mode), 48x27, spp 2, depth 8."""
    jt, cj, tt = _scene(name, **SIZE)
    img_j = np.asarray(jrenderer.render(jt, cj.replace(engine="pallas")))
    img_t = trenderer.render(tt, _port_cfg(cj, engine="pallas"),
                             device="cpu")
    assert img_t.shape == (27, 48, 3) and img_t.dtype == torch.float32
    images_close(img_t.numpy(), img_j, spp=2)


@pytest.mark.parametrize("name", sorted(SCENES))
@pytest.mark.parametrize("engine", ["plain", "pallas"])
def test_render_matches_jax_xla(name, engine, images_close):
    """Both port engines against rt_tpu's engine="xla", whose sphere pass
    the plain version mirrors, 48x27, spp 2, depth 8. The full 488-sphere
    cover scene is held here: against rt_tpu's Pallas interpret run its
    grazing-lane outliers reach 1.08% of pixels, where rt_tpu's own two
    engines differ on 0.54% (ROADMAP C-5)."""
    jt, cj, tt = _scene(name, **SIZE)
    img_j = np.asarray(jrenderer.render(jt, cj.replace(engine="xla")))
    img_t = trenderer.render(tt, _port_cfg(cj, engine=engine), device="cpu")
    images_close(img_t.numpy(), img_j, spp=2)


def test_render_carried_tables_match_jax(images_close):
    """rt_tpu's own tables carried across with tables_from_numpy: the
    sphere-only Cornell scene (emissive spheres, RR p=0.9, black sky),
    which no port builder makes, renders as rt_tpu renders it."""
    sj, cj = jbuilders.cornell_spheres_scene(width=32, height=32, spp=2,
                                             max_depth=6)
    jt = jtypes.build_tables(sj)
    tt = tables_from_numpy(jax_leaves(jt))
    img_j = np.asarray(jrenderer.render(jt, cj.replace(engine="xla")))
    img_t = trenderer.render(tt, _port_cfg(cj, engine="pallas"),
                             device="cpu")
    assert float(img_t.max()) > 1.0  # lights were hit
    images_close(img_t.numpy(), img_j, spp=2)


@pytest.mark.parametrize("opts", [
    dict(p_rr=0.9),
    dict(exhaust_mode="background", max_depth=3),
    dict(background_mode="constant", seed=5),
], ids=["rr", "exhaust_bg", "constant_bg_seed5"])
def test_render_options_match_jax(opts, images_close):
    jt, cj, tt = _scene("cover_grid4", width=32, height=18, spp=2,
                        max_depth=6)
    cj = cj.replace(engine="xla", **opts)
    img_j = np.asarray(jrenderer.render(jt, cj))
    img_t = trenderer.render(tt, _port_cfg(cj, engine="plain"), device="cpu")
    images_close(img_t.numpy(), img_j, spp=2)


def test_trace_per_lane_matches_jax():
    """One sample of camera rays through trace(): per-lane radiance equal
    except on the rare lanes an ulp flips a discrete decision."""
    jt, cj, tt = _scene("cover_grid4", width=40, height=30, spp=1,
                        max_depth=8)
    jt = jax.tree.map(jnp.asarray, jt)
    px = np.tile(np.arange(40, dtype=np.int32), 30)
    py = np.repeat(np.arange(30, dtype=np.int32), 40)
    pix = (py * 40 + px).astype(np.uint32)
    ro, rd = jcamera.generate_rays(jt.camera, 40, 30, jnp.asarray(px),
                                   jnp.asarray(py), 0, 0, True)
    rgb_j = np.asarray(jintegrator.trace(jt, cj.replace(engine="xla"), ro,
                                         rd, jnp.asarray(pix), 0, 0))
    stats = {}
    ro_t, rd_t = tcamera.generate_rays(tt.camera, 40, 30,
                                       torch.from_numpy(px),
                                       torch.from_numpy(py), 0, 0, True)
    rgb_t = tintegrator.trace(tt, _port_cfg(cj, engine="plain"), ro_t, rd_t,
                              torch.from_numpy(pix.astype(np.int64)), 0, 0,
                              stats=stats).numpy()
    diff = np.abs(rgb_t - rgb_j).max(-1)
    assert (diff > 1e-4).mean() <= 0.01, (diff > 1e-4).mean()
    assert 1 <= stats["bounces"] <= 8


def test_stats_count_bounces():
    _, cj, tt = _scene("three_sphere", width=16, height=9, spp=3,
                       max_depth=4)
    stats = {}
    trenderer.render(tt, _port_cfg(cj, engine="pallas"), device="cpu",
                     stats=stats)
    assert 3 <= stats["bounces"] <= 3 * 4


def test_tiling_and_sample_offset_do_not_change_image():
    """Tiles, samples per launch and sample offsets only regroup the same
    counter-RNG draws: the image is the same sum."""
    _, cj, tt = _scene("cover_grid4", width=24, height=16, spp=4,
                       max_depth=4)
    cfg = _port_cfg(cj, engine="plain")
    whole = trenderer.render(tt, cfg, device="cpu")
    # 4 tiles of 100 pixels, one sample per launch
    tiled = trenderer.render(tt, cfg.replace(rays_per_batch=100),
                             device="cpu")
    np.testing.assert_allclose(tiled.numpy(), whole.numpy(), rtol=1e-6,
                               atol=1e-6)
    first = trenderer.render(tt, cfg.replace(samples_per_pixel=2),
                             device="cpu")
    second = trenderer.render(tt, cfg.replace(samples_per_pixel=2),
                              sample_offset=2, device="cpu")
    np.testing.assert_allclose((first + second).numpy(), whole.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_render_defaults_to_cuda():
    _, cj, tt = _scene("three_sphere", width=8, height=4, spp=1,
                       max_depth=2)
    if torch.cuda.is_available():
        assert trenderer.render(tt, _port_cfg(cj)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trenderer.render(tt, _port_cfg(cj))


def test_block_order_matches_jax():
    for w, h in ((48, 27), (130, 70)):
        for a, b in zip(trenderer._block_order(w, h),
                        jrenderer._block_order(w, h)):
            np.testing.assert_array_equal(a, b)


def test_film_matches_jax():
    rs = np.random.default_rng(0)
    img = (rs.random((9, 16, 3)) * 3 - 0.2).astype(np.float32)
    for gamma in (False, True):
        np.testing.assert_array_equal(
            tfilm.finalize(torch.from_numpy(img), 3, gamma),
            jfilm.finalize(img, 3, gamma))
    assert tfilm.to_ppm(torch.from_numpy(img), 3) == jfilm.to_ppm(img, 3)
    np.testing.assert_array_equal(tfilm.finalize(img, 3, gamma=False),
                                  jfilm.to_png_u8(img, 3))
    np.testing.assert_array_equal(tfilm.to_png_u8(img, 3),
                                  jfilm.to_png_u8(img, 3))
    assert tfilm.negative_pixels(img) == jfilm.negative_pixels(img) > 0


def test_png_bytes_match_jax_and_read_back(tmp_path):
    rs = np.random.default_rng(1)
    u8 = rs.integers(0, 256, (7, 5, 3), dtype=np.uint8)
    assert timage.png_bytes(u8) == jimage.png_bytes(u8)
    p = str(tmp_path / "x.png")
    timage.write_image(p, u8)
    np.testing.assert_array_equal(timage.read_png(p), u8)
    np.testing.assert_array_equal(jimage.read_png(p), u8)
    q = str(tmp_path / "x.ppm")
    timage.write_image(q, u8)
    jq = str(tmp_path / "j.ppm")
    with open(jq, "w") as f:
        f.write("P3\n5 7\n255\n")
        f.writelines(f"{r} {g} {b}\n" for r, g, b in u8.reshape(-1, 3))
    assert open(q).read() == open(jq).read()
    # JPEG through Pillow, byte for byte as rt_tpu's writer
    timage.write_image(str(tmp_path / "x.jpg"), u8)
    jimage.write_image(str(tmp_path / "j.jpg"), u8)
    assert (tmp_path / "x.jpg").read_bytes() == \
        (tmp_path / "j.jpg").read_bytes()
    bad = bytearray(open(p, "rb").read())
    bad[20] ^= 0xFF  # inside IHDR
    (tmp_path / "bad.png").write_bytes(bytes(bad))
    with pytest.raises(ValueError, match="CRC"):
        timage.read_png(str(tmp_path / "bad.png"))


@pytest.mark.parametrize("ext", ["png", "ppm"])
def test_cli_render_on_cpu(tmp_path, capsys, ext):
    out = str(tmp_path / f"cover.{ext}")
    rc = tcli.main(["render", "--coded", "cover", "-w", "24", "--height",
                    "16", "-spp", "1", "-d", "3", "-o", out,
                    "--device", "cpu", "--engine", "pallas"])
    assert rc == 0
    assert "wrote" in capsys.readouterr().out
    if ext == "png":
        assert timage.read_png(out).shape == (16, 24, 3)
    else:
        assert open(out).read().startswith("P3\n24 16\n255\n")


def test_cli_matches_library_render(tmp_path):
    """The CLI's PNG is the library render's finalize, byte for byte."""
    out = str(tmp_path / "three.png")
    tcli.main(["render", "--coded", "three_sphere", "-w", "20", "--height",
               "12", "-spp", "2", "-d", "4", "--seed", "3", "-o", out,
               "--device", "cpu"])
    st, cfg = tbuilders.three_sphere_scene(width=20, height=12, spp=2,
                                           max_depth=4)
    st.resize()
    img = trenderer.render(ttypes.build_tables(st),
                           cfg.replace(seed=3, engine="queue"), device="cpu")
    np.testing.assert_array_equal(timage.read_png(out),
                                  tfilm.finalize(img, 2, gamma=False))
