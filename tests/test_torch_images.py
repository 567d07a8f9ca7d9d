"""Image textures in rt_tpu_torch against rt_tpu: the loader
(scene/assets.load_image_texture), the atlas and image ids in the tables
(build_tables, tables_from_numpy), the parser's `"image" {file}`, the
textured Taichi mesh (builders.mesh_scene(texture_path=...), with and
without taichi_tri_uv), the texture lookup (ops/materials), the plain
wavefront engine against rt_tpu's engine "xla" per lane and against its
NumPy oracle, and `render -f` / `--taichi-uv` on a textured JSON scene on
the CPU.

Scene (`textured_scene`, built with each package's own SceneDef): two
16x16 image textures made from a seed with numpy, on a sphere, both rect
orientations, a cylinder and a triangle, beside a checker ground, a
fuzzy metal and a glass sphere; with lights, an image-textured sphere
light and an image-textured triangle light (NEE's `nee_img`). Per lane:
rtol 1e-4 / atol 1e-5 on >= 99% of lanes (XLA-CPU and torch round sin,
cos, atan2 and the dot products' sums in their own ways, and an ulp that
moves a lane across a texel or a checker square moves it by more). The
plain versions of the kernels: tests/test_torch_images_pallas.py; the
gradients: tests/test_torch_images_adjoint.py."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt_tpu.config import RenderConfig as JConfig
from rt_tpu.ops import camera as jcamera
from rt_tpu.ops import materials as jmaterials
from rt_tpu.render import integrator as jintegrator
from rt_tpu.scene import assets as jassets
from rt_tpu.scene import builders as jbuilders
from rt_tpu.scene import parser as jparser
from rt_tpu.scene import types as jtypes
from rt_tpu_torch import cli
from rt_tpu_torch.config import RenderConfig
from rt_tpu_torch.io.image import write_png
from rt_tpu_torch.ops import materials as tmaterials
from rt_tpu_torch.render import integrator as tintegrator
from rt_tpu_torch.render.renderer import render as trender
from rt_tpu_torch.scene import assets as tassets
from rt_tpu_torch.scene import builders as tbuilders
from rt_tpu_torch.scene import parser as tparser
from rt_tpu_torch.scene import types as ttypes
from rt_tpu_torch.scene.convert import tables_from_numpy
from test_torch_scene import jax_leaves

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's default of one thread per core in each of them
# oversubscribes the CPU many times over.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(ROOT, "scenes", "demo_scene.json")
MESH = os.path.join(ROOT, "scenes", "plane441.obj")
W, H = 24, 16
SEED = 3


def images(size=16, seed=7):
    """Two [size, size, 3] float32 textures in [0, 1) from a seed."""
    rs = np.random.default_rng(seed)
    return (rs.random((size, size, 3)).astype(np.float32),
            rs.random((size, size, 3)).astype(np.float32))


def textured_scene(mod, w=W, h=H, depth=4, spp=1, lights=True, size=16):
    """The module doc's scene as `mod`'s (rt_tpu's or the port's types
    module) SceneDef."""
    a, b = images(size)
    s = mod.SceneDef(width=w, height=h, samples_per_pixel=spp,
                     max_depth=depth, background=(0.2, 0.25, 0.3))
    ta, tb = s.add_image_texture(a), s.add_image_texture(b)
    ma, mb = s.add_lambertian(ta), s.add_lambertian(tb)
    s.add_sphere((0, 0, -2), 0.5, ma)
    s.add_sphere((0, -100.5, -2), 100, s.add_lambertian(
        s.add_checker((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))))
    s.add_rect("xy_rect", -2, 2, -1, 2, -3.5, mb)
    s.add_rect("yz_rect", -1, 1, -3, -1, 1.8, ma)
    s.add_cylinder(0.25, -0.3, 0.3, mb, rotate=((1, 0, 0), 90.0),
                   translate=(0.9, -0.2, -1.6))
    s.add_triangle((0.4, -0.5, -1.2), (0.9, -0.5, -1.4), (0.6, 0.2, -1.3),
                   ma, uv1=(0, 0), uv2=(1, 0), uv3=(0, 1))
    s.add_sphere((-0.9, -0.2, -1.5), 0.3, s.add_metal((0.8, 0.8, 0.7), 0.3))
    s.add_sphere((-0.4, -0.3, -1.2), 0.2, s.add_dielectric(1.5))
    if lights:
        s.add_sphere((1.6, 0.4, -1.4), 0.25, s.add_diffuse_light(tb))
        s.add_triangle((-2.2, 0.1, -2.6), (-1.4, 0.1, -3.0),
                       (-1.8, 1.0, -2.8), s.add_diffuse_light(ta),
                       uv1=(0.1, 0.2), uv2=(0.9, 0.1), uv3=(0.5, 0.8))
    s.set_camera((0, 0.3, 1.2), (0, 0, -2), (0, 1, 0), 55, 0.0)
    return s


def both_tables(**kw):
    """(rt_tpu's tables on the device, the port's tables)."""
    jt = jax.tree_util.tree_map(jnp.asarray,
                                jtypes.build_tables(textured_scene(jtypes,
                                                                   **kw)))
    return jt, ttypes.build_tables(textured_scene(ttypes, **kw))


def configs(**kw):
    """(rt_tpu's config, the port's), cull_chunks off on rt_tpu's side
    (ROADMAP C-3)."""
    jcfg = JConfig(width=W, height=H, samples_per_pixel=1, max_depth=4,
                   engine="xla", loop="while", cull_chunks=False, **kw)
    return jcfg, RenderConfig(**{**dataclasses.asdict(jcfg),
                                 "engine": "plain"})


def lanes_close(got, want, frac=0.99):
    ok = (np.abs(got - want) <= 1e-5 + 1e-4 * np.abs(want)).all(-1)
    assert ok.mean() >= frac, ok.mean()


def textured_demo(dirname, size=32, seed=11, **settings):
    """A copy of scenes/demo_scene.json in dirname with an image texture
    on the blue lambertian sphere and on the xz_rect light (two PNGs of
    size x size from a seed, written beside it); settings replace its
    top-level values (samples_per_pixel, ...). Returns its path."""
    data = json.loads(open(DEMO).read())
    data.update(settings)
    rs = np.random.default_rng(seed)
    for name in ("sphere.png", "light.png"):
        write_png(os.path.join(dirname, name),
                  rs.integers(0, 256, (size, size, 3), dtype=np.uint8))
    tex = data["texture"]["data"]
    tex += [{"type": "image", "file": "sphere.png"},
            {"type": "image", "file": "light.png"}]
    data["material"]["data"][1]["texture"] = len(tex) - 2
    data["material"]["data"][4]["texture"] = len(tex) - 1
    path = os.path.join(dirname, "textured.json")
    with open(path, "w") as f:
        json.dump(data, f)
    return path


def _write_filtered_png(path, u8):
    """u8 [H,W,3] as a PNG whose odd rows use the Up filter (2) and even
    rows after the first the Average filter (3)."""
    import struct
    import zlib

    raw = u8.reshape(u8.shape[0], -1).astype(np.int64)
    rows = [b"\x00" + u8[0].tobytes()]
    for y in range(1, raw.shape[0]):
        up = raw[y - 1]
        if y % 2:
            f, out = 2, raw[y] - up
        else:
            left = np.concatenate([np.zeros(3, np.int64), raw[y, :-3]])
            f, out = 3, raw[y] - (left + up) // 2
        rows.append(bytes([f]) + (out & 0xFF).astype(np.uint8).tobytes())

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    h, w = u8.shape[:2]
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n"
                 + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                 + chunk(b"IDAT", zlib.compress(b"".join(rows)))
                 + chunk(b"IEND", b""))


def test_load_image_texture_matches_rt_tpu(tmp_path):
    """A PNG written from numpy by the port's writer, one with the Up and
    Average row filters, PNGs that Pillow writes (RGB with its Sub and
    Paeth filters, RGBA) and a JPEG, each loaded by both packages: the
    same float32 bits."""
    from PIL import Image

    rs = np.random.default_rng(2)
    u8 = rs.integers(0, 256, (9, 13, 3), dtype=np.uint8)
    # a smooth image, so that Pillow's encoder picks the predicting
    # filters (Sub, Up, Average, Paeth) on its rows
    yy, xx = np.mgrid[0:9, 0:13]
    smooth = np.stack([xx * 19, yy * 27, (xx + yy) * 9], -1).astype(np.uint8)
    paths = [str(tmp_path / "own.png")]
    write_png(paths[0], u8)
    # the Up and Average filters, which Pillow does not pick here, written
    # by hand on alternate rows of a copy of own.png
    paths.append(str(tmp_path / "up_avg.png"))
    _write_filtered_png(paths[-1], u8)
    for name, arr, mode in (("pil.png", smooth, "RGB"),
                            ("pil_rgba.png", np.concatenate(
                                [smooth, smooth[..., :1]], -1), "RGBA"),
                            ("pil.jpg", u8, "RGB")):
        Image.fromarray(arr, mode).save(str(tmp_path / name))
        paths.append(str(tmp_path / name))
    for p in paths:
        got = tassets.load_image_texture(p)
        want = jassets.load_image_texture(p)
        assert got.dtype == np.float32 and got.shape == want.shape, p
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tassets.load_image_texture(paths[0]),
                                  u8.astype(np.float32) / 255.0)
    np.testing.assert_array_equal(tassets.load_image_texture(paths[1]),
                                  u8.astype(np.float32) / 255.0)
    np.testing.assert_array_equal(tassets.load_image_texture(paths[2]),
                                  smooth.astype(np.float32) / 255.0)


@pytest.mark.parametrize("lights", [False, True])
def test_build_tables_match_rt_tpu_with_images(lights):
    """Every leaf (tex_image and the atlas images included) of the port's
    build_tables equals rt_tpu's carried across by tables_from_numpy, bit
    for bit; img_on and nee_img too."""
    sj = textured_scene(jtypes, lights=lights)
    jt = jtypes.build_tables(sj)
    carried = tables_from_numpy(jax_leaves(jt))
    own = ttypes.build_tables(textured_scene(ttypes, lights=lights))
    a, b = carried.leaves(), own.leaves()
    assert sorted(a) == sorted(b)
    for k in ("tex_image", "images"):
        assert k in a
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert torch.equal(a[k], b[k]), k
    assert own.images.shape == (2, 16, 16, 3)
    assert carried.img_on == own.img_on == tuple(jt.img_on)
    assert carried.nee_img == own.nee_img == bool(jt.nee_img) == lights
    assert own.img_on == ("cylinder", "rect", "sphere", "triangle")


def test_parser_image_file_matches_rt_tpu(tmp_path):
    """`"image" {file}` relative to the scene's directory: the textured
    demo copy parses to rt_tpu's tables bit for bit; a second image of
    another size is refused by both."""
    path = textured_demo(str(tmp_path))
    sj, cj = jparser.parse_scene(path)
    st, ct = tparser.parse_scene(path)
    assert st.textures == sj.textures
    a = tables_from_numpy(jax_leaves(jtypes.build_tables(sj))).leaves()
    b = ttypes.build_tables(st).leaves()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    tt = ttypes.build_tables(st)
    assert tt.images.shape == (2, 32, 32, 3)
    assert tt.img_on == ("rect", "sphere") and tt.nee_img
    write_png(str(tmp_path / "small.png"), np.zeros((4, 4, 3), np.uint8))
    data = json.loads(open(path).read())
    data["texture"]["data"].append({"type": "image", "file": "small.png"})
    for parse, build in ((jparser.parse_scene_dict, jtypes.build_tables),
                         (tparser.parse_scene_dict, ttypes.build_tables)):
        with pytest.raises(ValueError, match="one size"):
            build(parse(data, base_dir=str(tmp_path))[0])


@pytest.mark.parametrize("taichi_uv", [False, True])
def test_mesh_scene_texture_matches_rt_tpu(tmp_path, taichi_uv):
    """The reference's textured Taichi scene: mesh_scene(texture_path=)
    with and without taichi_tri_uv (which swaps the uv1 / uv3 columns at
    table build and nowhere else), leaf by leaf against rt_tpu's."""
    png = str(tmp_path / "tex.png")
    write_png(png, np.random.default_rng(5).integers(0, 256, (8, 8, 3),
                                                     dtype=np.uint8))
    sj, cj = jbuilders.mesh_scene(MESH, texture_path=png)
    st, ct = tbuilders.mesh_scene(MESH, texture_path=png)
    sj.taichi_tri_uv = st.taichi_tri_uv = taichi_uv
    assert st.objects == sj.objects and st.textures == sj.textures
    a = tables_from_numpy(jax_leaves(jtypes.build_tables(sj))).leaves()
    tt = ttypes.build_tables(st)
    b = tt.leaves()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert tt.img_on == ("triangle",) and tt.counts == (3, 0, 0, 800)
    plain = ttypes.build_tables(tbuilders.mesh_scene(MESH,
                                                     texture_path=png)[0])
    swapped = torch.equal(tt.tri_uv1, plain.tri_uv3)
    assert swapped == taichi_uv
    assert dataclasses.asdict(ct) == dataclasses.asdict(
        cj.replace(engine="plain"))


def test_texture_values_match_rt_tpu():
    """materials.material_albedo / emitted at random (u, v) (outside [0,
    1) too, so the wrap is exercised) and hit points, for every material
    row, against rt_tpu's: the same texel, bit for bit."""
    jt, tt = both_tables()
    rs = np.random.default_rng(9)
    n = 4096
    mat = rs.integers(0, tt.mat_type.shape[0], n).astype(np.int32)
    u = rs.uniform(-2.0, 3.0, n).astype(np.float32)
    v = rs.uniform(-2.0, 3.0, n).astype(np.float32)
    p = rs.normal(0, 2, (n, 3)).astype(np.float32)
    for fn in ("material_albedo", "emitted"):
        want = np.asarray(getattr(jmaterials, fn)(
            jt, jnp.asarray(mat), jnp.asarray(u), jnp.asarray(v),
            jnp.asarray(p)))
        got = getattr(tmaterials, fn)(
            tt, torch.from_numpy(mat), torch.from_numpy(u),
            torch.from_numpy(v), torch.from_numpy(p)).numpy()
        np.testing.assert_array_equal(got, want)
    rows = tmaterials.texel_rows(tt.images, torch.zeros(3, dtype=torch.long),
                                 torch.tensor([0.0, 0.999999, -0.25]),
                                 torch.tensor([1.0, float("nan"), 0.5]))
    assert rows.tolist() == [0, 15 * 16, 12 * 16 + 8]


@pytest.mark.parametrize("flags", ["none", "nee"])
def test_plain_engine_matches_xla_per_lane(flags):
    """Two samples' camera rays through rt_tpu's trace(engine="xla") and
    the port's trace(engine="plain"), per lane; with nee the image
    lights' Le is the texel at the light point's (u, v)."""
    jt, tt = both_tables()
    jcfg, cfg = configs(**({"nee": True} if flags == "nee" else {}))
    pix = np.arange(W * H, dtype=np.int32)
    px, py = pix % W, pix // W
    for s in (0, 1):
        ro, rd = jcamera.generate_rays(jt.camera, W, H, jnp.asarray(px),
                                       jnp.asarray(py), s, SEED, False)
        want = np.asarray(jintegrator.trace(
            jt, jcfg, ro, rd, jnp.asarray(pix.astype(np.uint32)), s, SEED))
        got = tintegrator.trace(
            tt, cfg, torch.from_numpy(np.array(ro)),
            torch.from_numpy(np.array(rd)),
            torch.from_numpy(pix.astype(np.int64)), s, SEED).numpy()
        lanes_close(got, want)
        assert want.max() > 0


def test_plain_engine_matches_oracle(images_close):
    """The plain engine against rt_tpu's NumPy oracle (render/oracle.py
    `_texture_value`) by images_close, with nee on the image lights."""
    from rt_tpu.render.oracle import render_oracle

    sj = textured_scene(jtypes, spp=2)
    jcfg, cfg = configs(nee=True)
    jcfg = jcfg.replace(samples_per_pixel=2)
    ref = render_oracle(sj, jcfg)
    got = trender(ttypes.build_tables(textured_scene(ttypes, spp=2)),
                  cfg.replace(samples_per_pixel=2), device="cpu").numpy()
    images_close(got, ref, 2)
    assert ref.max() > 0


@pytest.mark.parametrize("extra", [[], ["--taichi-uv", "--nee"]])
def test_cli_render_textured_json(tmp_path, capsys, extra):
    """`render -f` on the textured demo copy on the CPU (engine queue's
    plain version), and with --taichi-uv and --nee: exit 0 and the
    image of the plain engine's, by images_close."""
    path = textured_demo(str(tmp_path))
    out = str(tmp_path / "t.ppm")
    rc = cli.main(["render", "-f", path, "-w", "24", "--height", "16",
                   "-spp", "2", "-d", "4", "--device", "cpu", "-o", out]
                  + extra)
    assert rc == 0
    text = capsys.readouterr().out
    assert text.startswith("wrote ") and "engine queue" in text
    vals = np.array(open(out).read().split()[4:], dtype=np.float64)
    assert vals.size == 24 * 16 * 3 and vals.max() > 0
