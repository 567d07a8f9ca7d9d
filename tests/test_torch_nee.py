"""Next-event estimation, MIS and glossy light sampling in rt_tpu_torch's
plain wavefront engine (render/integrator.py `_nee_direct`,
`_glossy_pdf`, `_prim_area`, the prev_diff carry) against rt_tpu's
engine "xla" on the same camera rays, and against rt_tpu's NumPy oracle;
the rule that a scene without lights renders as without nee, the
renderer's regen routing under nee, and the CLI's --nee / --mis /
--nee-glossy and `fit --nee` on the CPU.

Scene (`light_scene`, built with each package's own builders): the four
light families of tests/test_nee.py's `_light_scene` (a sphere, an
xz_rect, a cylinder and a triangle light over a lambertian sphere on a
lambertian ground), the sphere light checker-textured, plus a fuzzy
metal sphere (the glossy sampler's lanes) and a glass sphere, 24x16,
depth 4. Per lane: rtol 1e-4 / atol 1e-5 on >= 99% of lanes (XLA-CPU
and torch round sin, cos and the dot products' sums in their own ways,
and an ulp that flips a grazing shadow ray or a checker square moves a
lane by more). The plain versions of the kernels B2 / B3:
tests/test_torch_nee_pallas.py; the gradients:
test_torch_nee_adjoint.py, test_torch_nee_tape.py."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt_tpu.config import RenderConfig as JConfig
from rt_tpu.ops import camera as jcamera
from rt_tpu.render import integrator as jintegrator
from rt_tpu.scene import types as jtypes
from rt_tpu_torch import cli
from rt_tpu_torch.config import RenderConfig
from rt_tpu_torch.ops import cuda_mega
from rt_tpu_torch.render import integrator as tintegrator
from rt_tpu_torch.render.renderer import render as trender
from rt_tpu_torch.scene import types as ttypes

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's default of one thread per core in each of them
# oversubscribes the CPU many times over.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(ROOT, "scenes", "demo_scene.json")
W, H = 24, 16
SEED = 3

FLAGS = {"nee": dict(nee=True), "mis": dict(nee=True, mis=True),
         "glossy": dict(nee=True, nee_glossy=True),
         "mis_glossy": dict(nee=True, mis=True, nee_glossy=True)}


def light_scene(mod, w=W, h=H, depth=4):
    """The module doc's scene, built with `mod` (rt_tpu's or the port's
    types module)."""
    s = mod.SceneDef(width=w, height=h, samples_per_pixel=2, max_depth=depth,
                     background=(0.0, 0.0, 0.0))
    s.add_sphere((0, 0, -2), 0.5, s.add_lambertian_color((0.6, 0.4, 0.3)))
    s.add_sphere((0, -100.5, -2), 100,
                 s.add_lambertian_color((0.5, 0.5, 0.55)))
    s.add_sphere((1.6, 0.4, -1.4), 0.25, s.add_diffuse_light(
        s.add_checker((8.0, 3.0, 3.0), (3.0, 8.0, 3.0))))
    s.add_rect("xz_rect", -0.8, 0.8, -2.8, -1.2, 2.0,
               s.add_diffuse_light_color((6.0, 5.5, 5.0)))
    s.add_cylinder(0.2, -0.3, 0.3, s.add_diffuse_light_color((2.0, 4.0, 8.0)),
                   rotate=((1, 0, 0), 90.0), translate=(-1.5, 0.6, -2.0))
    s.add_triangle((-2.2, 0.1, -2.6), (-1.4, 0.1, -3.0), (-1.8, 1.0, -2.8),
                   s.add_diffuse_light_color((7.0, 2.0, 6.0)))
    s.add_sphere((-0.9, -0.2, -1.5), 0.3, s.add_metal((0.8, 0.8, 0.7), 0.3))
    s.add_sphere((0.9, -0.25, -1.4), 0.25, s.add_dielectric(1.5))
    s.set_camera((0, 0.4, 1.2), (0, 0, -2), (0, 1, 0), 55, 0.0)
    return mod.build_tables(s)


def configs(**kw):
    """(rt_tpu's config, the port's) of the scene, cull_chunks off on
    rt_tpu's side (ROADMAP C-3)."""
    jcfg = JConfig(width=W, height=H, samples_per_pixel=2, max_depth=4,
                   engine="xla", loop="while", cull_chunks=False, **kw)
    return jcfg, RenderConfig(**{**dataclasses.asdict(jcfg),
                                 "engine": "plain"})


def pixels():
    pix = np.arange(W * H, dtype=np.int32)
    return pix % W, pix // W


def lanes_close(got, want, frac=0.99):
    ok = (np.abs(got - want) <= 1e-5 + 1e-4 * np.abs(want)).all(-1)
    assert ok.mean() >= frac, ok.mean()


@pytest.fixture(scope="module")
def scenes():
    jt = jax.tree_util.tree_map(jnp.asarray, light_scene(jtypes))
    tt = light_scene(ttypes)
    assert tt.n_lights == jt.n_lights == 4
    return jt, tt


@pytest.mark.parametrize("flags", sorted(FLAGS))
def test_plain_engine_matches_xla_per_lane(scenes, flags):
    """Two samples' camera rays through rt_tpu's trace(engine="xla") and
    the port's trace(engine="plain"), per lane (the wavefront's shadow
    ray is ops/intersect.occluded: the closest hit, strictly below
    t_max, as rt_tpu's)."""
    jt, tt = scenes
    jcfg, cfg = configs(**FLAGS[flags])
    px, py = pixels()
    pix = (py * W + px).astype(np.uint32)
    for s in (0, 1):
        ro, rd = jcamera.generate_rays(jt.camera, W, H, jnp.asarray(px),
                                       jnp.asarray(py), s, SEED, False)
        want = np.asarray(jintegrator.trace(jt, jcfg, ro, rd,
                                            jnp.asarray(pix), s, SEED))
        got = tintegrator.trace(
            tt, cfg, torch.from_numpy(np.array(ro)),
            torch.from_numpy(np.array(rd)),
            torch.from_numpy(pix.astype(np.int64)), s, SEED).numpy()
        lanes_close(got, want)
        assert want.max() > 0


def test_nee_changes_the_image(scenes):
    """On this scene every flag set is a different estimator: the images
    differ from the plain one, and mis / glossy from nee alone."""
    _, tt = scenes
    imgs = {k: trender(tt, configs(**kw)[1], device="cpu")
            for k, kw in (("plain", {}), *FLAGS.items())}
    for k in FLAGS:
        assert not torch.equal(imgs[k], imgs["plain"]), k
    assert not torch.equal(imgs["mis"], imgs["nee"])
    assert not torch.equal(imgs["glossy"], imgs["nee"])
    for k, img in imgs.items():
        assert bool(torch.isfinite(img).all()) and float(img.min()) >= 0, k


def test_glossy_pdf_and_prim_area_match_rt_tpu(scenes):
    jt, tt = scenes
    rs = np.random.RandomState(0)
    cosr = rs.uniform(-0.2, 1, 4096).astype(np.float32)
    fz = rs.uniform(0, 1, 4096).astype(np.float32)
    fz[:64] = 0.0
    want = np.asarray(jintegrator._glossy_pdf(jnp.asarray(cosr),
                                              jnp.asarray(fz)))
    got = tintegrator._glossy_pdf(torch.from_numpy(cosr),
                                  torch.from_numpy(fz)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert (want > 0).mean() > 0.1
    ptype = np.repeat(np.arange(4, dtype=np.int32), 3)
    pid = np.tile(np.arange(3, dtype=np.int32), 4)
    pid = np.minimum(pid, np.array(tt.counts)[ptype] - 1)
    want = np.asarray(jintegrator._prim_area(jt, jnp.asarray(ptype),
                                             jnp.asarray(pid)))
    got = tintegrator._prim_area(tt, torch.from_numpy(ptype),
                                 torch.from_numpy(pid)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert (got > 0).all()


def test_glossy_pdf_integrates_to_one():
    """The fuzz-ball density integrates to 1 over the sphere
    (tests/test_glossy_nee.py:57)."""
    for fz in (0.15, 0.4, 0.8):
        th = np.linspace(0.0, np.pi, 20001).astype(np.float32)
        p = tintegrator._glossy_pdf(torch.from_numpy(np.cos(th)),
                                    torch.full((th.shape[0],), fz)).numpy()
        total = float(np.trapezoid(p * np.sin(th) * 2.0 * np.pi, th))
        assert abs(total - 1.0) < 2e-3, (fz, total)


def test_nee_without_lights_is_identical():
    """tests/test_nee.py::test_nee_without_lights_is_identical: with no
    emitter nee / mis / nee_glossy change nothing, on every engine."""
    s = ttypes.SceneDef(width=32, height=24, samples_per_pixel=4,
                        max_depth=4, background=(0.6, 0.7, 0.9))
    s.add_sphere((0, 0, -1), 0.5, s.add_lambertian_color((0.5, 0.3, 0.2)))
    s.add_sphere((0, -100.5, -1), 100,
                 s.add_lambertian_color((0.6, 0.6, 0.6)))
    s.add_sphere((1, 0, -1), 0.5, s.add_metal((0.8, 0.8, 0.8), 0.3))
    s.set_camera((0, 0, 1), (0, 0, -1), (0, 1, 0), 45, 0.0)
    tt = ttypes.build_tables(s)
    assert tt.n_lights == 0
    for engine in ("plain", "queue", "mega"):
        cfg = RenderConfig(width=32, height=24, samples_per_pixel=4,
                           max_depth=4, engine=engine)
        a = trender(tt, cfg, device="cpu")
        b = trender(tt, cfg.replace(nee=True, mis=True, nee_glossy=True),
                    device="cpu")
        assert torch.equal(a, b), engine


def test_nee_matches_scalar_oracle(images_close):
    """tests/test_nee.py::test_nee_matches_scalar_oracle: the plain
    engine against rt_tpu's NumPy oracle (render/oracle.py `_oracle_nee`)
    on the reference's own light scene, by images_close."""
    from rt_tpu.render.oracle import render_oracle
    from test_nee import _light_scene

    sdef, jcfg = _light_scene()
    jcfg = jcfg.replace(width=24, height=16, samples_per_pixel=2,
                        max_depth=4, nee=True)
    sdef.width, sdef.height = 24, 16
    ref = render_oracle(sdef, jcfg)
    tt = ttypes.build_tables(_port_light_scene())
    got = trender(tt, RenderConfig(**{**dataclasses.asdict(jcfg),
                                      "engine": "plain"}),
                  device="cpu").numpy()
    images_close(got, ref, jcfg.samples_per_pixel)
    assert ref.max() > 0


def _port_light_scene():
    """tests/test_nee.py's `_light_scene` at 24x16, with the port's
    builders."""
    s = ttypes.SceneDef(width=24, height=16, samples_per_pixel=2,
                        max_depth=4, background=(0.0, 0.0, 0.0))
    s.add_sphere((0, 0, -2), 0.5, s.add_lambertian_color((0.6, 0.4, 0.3)))
    s.add_sphere((0, -100.5, -2), 100,
                 s.add_lambertian_color((0.5, 0.5, 0.55)))
    s.add_sphere((1.6, 0.4, -1.4), 0.25,
                 s.add_diffuse_light_color((8.0, 3.0, 3.0)))
    s.add_rect("xz_rect", -0.8, 0.8, -2.8, -1.2, 2.0,
               s.add_diffuse_light_color((6.0, 5.5, 5.0)))
    s.add_cylinder(0.2, -0.3, 0.3, s.add_diffuse_light_color((2.0, 4.0, 8.0)),
                   rotate=((1, 0, 0), 90.0), translate=(-1.5, 0.6, -2.0))
    s.add_triangle((-2.2, 0.1, -2.6), (-1.4, 0.1, -3.0), (-1.8, 1.0, -2.8),
                   s.add_diffuse_light_color((7.0, 2.0, 6.0)))
    s.set_camera((0, 0.4, 1.2), (0, 0, -2), (0, 1, 0), 55, 0.0)
    return s


def test_regen_stays_off_under_nee(scenes):
    """render(engine="mega", regen=True) with nee traces on the
    segmented megakernel, as the reference routes it
    (rt_tpu/render/renderer.py:116-119): the regen kernel's plain
    version runs no segment and the image is the mega render's."""
    _, tt = scenes
    cfg = configs(nee=True)[1].replace(engine="mega")
    want = trender(tt, cfg, device="cpu")
    before = cuda_mega.mega_regen.launches
    stats = {}
    got = trender(tt, cfg.replace(regen=True), device="cpu", stats=stats)
    assert torch.equal(got, want)
    assert stats["launches"] > 0 and cuda_mega.mega_regen.launches == before


@pytest.mark.parametrize("flags", [["--nee"], ["--mis", "--nee-glossy"]],
                         ids=["nee", "mis_glossy"])
def test_cli_render_nee(tmp_path, capsys, flags):
    """`render -f scenes/demo_scene.json --nee` (and --mis --nee-glossy,
    which imply --nee) on the CPU: exit 0, a finite image, and the
    flags in the summary line."""
    out = str(tmp_path / "d.ppm")
    rc = cli.main(["render", "-f", DEMO, "-w", "24", "--height", "14",
                   "-spp", "2", "-d", "4", "--device", "cpu", "-o", out]
                  + flags)
    text = capsys.readouterr().out
    assert rc == 0 and os.path.getsize(out) > 0
    assert "nee" in text and ("mis" in text) == ("--mis" in flags)
    vals = np.array(open(out).read().split()[4:], dtype=np.float64)
    assert np.isfinite(vals).all() and vals.max() > 0


def test_cli_fit_nee(tmp_path, capsys):
    """`fit -f scenes/demo_scene.json --nee` on the CPU (the plain
    engine, method replay): exit 0, the loss falls."""
    from rt_tpu_torch.config import RenderConfig as TC
    from rt_tpu_torch.scene.parser import parse_scene
    from rt_tpu_torch.scene.types import build_tables

    sdef, cfg = parse_scene(DEMO)
    sdef.width, sdef.height = 16, 9
    sdef.resize()
    tt = build_tables(sdef)
    tc = tt.tex_color.clone()
    tc[3] = tc[3] * 0.8
    img = trender(dataclasses.replace(tt, tex_color=tc),
                  TC(width=16, height=9, samples_per_pixel=4, max_depth=3,
                     nee=True), device="cpu") / 4
    np.savez(tmp_path / "t.npz", img=img.numpy())
    rc = cli.main(["fit", "-f", DEMO, "--target", str(tmp_path / "t.npz"),
                   "--fields", "tex_color", "-spp", "2", "--steps", "3",
                   "-d", "3", "--nee", "--device", "cpu", "--out",
                   str(tmp_path / "fit")])
    text = capsys.readouterr().out
    assert rc == 0, text
    assert tt.n_lights == 1


@pytest.mark.parametrize("how", ["fd", "camera", "ad", "tape_mis"])
def test_fit_estimators_take_nee(scenes, how):
    """fit_fd and fit_camera (CRN probes on the NEE forward), fit with
    "ad" and with the tape under mis + nee_glossy: one step on the CPU,
    finite losses and a recovered value."""
    from rt_tpu_torch.diff import inverse

    _, tt = scenes
    cfg = configs(nee=True)[1].replace(width=12, height=8,
                                       engine="queue", max_depth=3)
    tgt = trender(tt, cfg, device="cpu").numpy() / 2
    if how == "fd":
        rec, hist = inverse.fit_fd(tt, cfg, tgt, {"sph_center": [(0, 0)]},
                                   spp=1, steps=1, device="cpu")
    elif how == "camera":
        init = {"lookfrom": [0.02, 0.4, 1.2], "lookat": [0.0, 0.0, -2.0],
                "vup": [0.0, 1.0, 0.0], "vfov_deg": 55.0, "aperture": 0.0}
        rec, hist = inverse.fit_camera(tt, cfg, tgt, init, spp=1, steps=1,
                                       device="cpu")
    else:
        c = cfg if how == "ad" else cfg.replace(mis=True, nee_glossy=True)
        rec, hist = inverse.fit(
            tt, c, tgt, fields=("tex_color", "sph_radius"), spp=1, steps=1,
            method="ad" if how == "ad" else "tape", device="cpu")
    assert len(hist) >= 1 and all(np.isfinite(hist))
    assert all(np.isfinite(np.asarray(v, np.float64)).all()
               for k, v in rec.items() if not isinstance(v, tuple))


def test_light_table_matches_rt_tpu(scenes):
    """The kernels' light table (ops/mega_tables.light_table) against
    rt_tpu's nee_light_table (pallas_mega.py:451): columns 0-24 (family,
    area, Le even / odd, checker flag, the sampling block, the gradient
    slot) bit for bit; the port's column 25 is the row that, with the
    family, keys MIS's emitter match where the reference keys pid * 4 +
    family (its column 32)."""
    from rt_tpu.ops import pallas_mega as jmega

    jt, tt = scenes
    want = np.asarray(jmega.nee_light_table(jt))[:tt.n_lights]
    got = tt.mega.lights.numpy()
    np.testing.assert_array_equal(got[:, :25], want[:, :25])
    np.testing.assert_array_equal(got[:, 25] * 4 + got[:, 0], want[:, 32])
    assert got[:, 8].sum() == 1  # the checker-textured sphere light
