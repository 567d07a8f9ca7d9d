"""rt_tpu_torch's scalar NumPy oracle (render/oracle.py) against rt_tpu's
render/oracle.py bit for bit, and against the port's plain engine.

Every scene of tests/test_integrator_oracle.py at 16x9, spp 2, built by
each package's own builders, goes through both oracles, with both
samplers: the port's NumPy twins of rt_tpu's triple32 and Sobol' draws
and of its vector helpers must give the same bits. The port's plain
engine is held to the port's oracle with images_close at the
reference's oracle sizes.
"""

import numpy as np
import pytest
import torch

from rt_tpu.render.oracle import render_oracle as jrender_oracle
from rt_tpu.scene import builders as jbuilders
from rt_tpu.scene import types as jtypes
from rt_tpu_torch.config import RenderConfig
from rt_tpu_torch.render.oracle import render_oracle
from rt_tpu_torch.render.renderer import render
from rt_tpu_torch.scene import builders as tbuilders
from rt_tpu_torch.scene import types as ttypes

# One intra-op thread: the suite runs in several worker processes at
# once (as the other port test files).
torch.set_num_threads(1)

SIZE = dict(width=16, height=9, spp=2)


def _triangle(types):
    s = types.SceneDef(width=16, height=9, samples_per_pixel=2, max_depth=4,
                       background=(0.7, 0.8, 1.0))
    m = s.add_lambertian_color((0.6, 0.3, 0.2))
    g = s.add_lambertian_color((0.5, 0.5, 0.5))
    s.add_sphere((0, -100.5, -1), 100, g)
    s.add_triangle((-1, 0, -2), (1, 0, -2), (0, 1.5, -2), m,
                   uv1=(0, 0), uv2=(1, 0), uv3=(0.5, 1))
    s.set_camera((0, 0.5, 2), (0, 0.5, -1), (0, 1, 0), 45, 0.0)
    return s, dict(max_depth=4)


def _textures(types):
    teximg = np.random.RandomState(0).rand(8, 8, 3).astype(np.float32)
    s = types.SceneDef(width=16, height=9, samples_per_pixel=2, max_depth=4,
                       background=(0.7, 0.8, 1.0))
    mc = s.add_lambertian(s.add_checker((0.2, 0.3, 0.1), (0.9, 0.9, 0.9)))
    mi = s.add_lambertian(s.add_image_texture(teximg))
    s.add_sphere((0, -100.5, -1), 100, mc)
    s.add_sphere((0, 0, -1), 0.5, mi)
    s.set_camera((0, 0, 1), (0, 0, -1), (0, 1, 0), 45, 0.0)
    return s, dict(max_depth=4)


def _built(fn, *args, **kw):
    def make(types):
        builders = jbuilders if types is jtypes else tbuilders
        sdef, cfg = getattr(builders, fn)(*args, **kw)
        return sdef, {f: getattr(cfg, f) for f in (
            "max_depth", "background_mode", "p_rr")}
    return make


# name -> (scene of a package's types, config changes)
SCENES = {
    "three_sphere": (_built("three_sphere_scene", max_depth=6, **SIZE), {}),
    "cover_gradient_sky": (_built("cover_scene", max_depth=5, grid=2,
                                  **SIZE), {}),
    "lights_rect_cylinder_nee": (_built("cover_scene", max_depth=5, grid=2,
                                        lights=True, **SIZE),
                                 dict(nee=True)),
    "cornell_russian_roulette": (_built("cornell_spheres_scene",
                                        max_depth=6, **SIZE), {}),
    "defocus": (_built("cover_scene", max_depth=4, grid=1, **SIZE),
                dict(enable_defocus=True)),
    "exhaust_background": (_built("three_sphere_scene", max_depth=2,
                                  **SIZE),
                           dict(exhaust_mode="background")),
    "triangle_mesh": (_triangle, {}),
    "checker_and_image_textures": (_textures, {}),
    "qmc_lights_nee_defocus": (_built("cover_scene", max_depth=5, grid=2,
                                      lights=True, **SIZE),
                               dict(sampler="qmc", nee=True,
                                    enable_defocus=True)),
    "qmc_cornell_russian_roulette": (_built("cornell_spheres_scene",
                                            max_depth=6, **SIZE),
                                     dict(sampler="qmc")),
}


def _cfgs(name):
    make, extra = SCENES[name]
    sj, base = make(jtypes)
    st, _ = make(ttypes)
    kw = dict(width=16, height=9, samples_per_pixel=2, **base, **extra)
    from rt_tpu.config import RenderConfig as JConfig

    return sj, JConfig(**kw), st, RenderConfig(**kw)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_oracle_matches_rt_tpu_oracle_bit_for_bit(name):
    sj, cj, st, ct = _cfgs(name)
    want = jrender_oracle(sj, cj)
    got = render_oracle(st, ct)
    assert got.dtype == np.float32 and got.shape == (9, 16, 3)
    np.testing.assert_array_equal(got, want)
    assert want.max() > 0


@pytest.mark.parametrize("name,size", [
    ("three_sphere", dict(width=24, height=14, spp=4, max_depth=6)),
    ("lights_nee", dict(width=20, height=12, spp=3, max_depth=5, grid=2,
                        lights=True))])
def test_plain_engine_matches_the_oracle(name, size, images_close):
    """tests/test_integrator_oracle.py's three-sphere and lights cases
    for the port: its plain engine against its own oracle."""
    if name == "three_sphere":
        sdef, cfg = tbuilders.three_sphere_scene(**size)
    else:
        sdef, cfg = tbuilders.cover_scene(**size)
        cfg = cfg.replace(nee=True)
    img = render(ttypes.build_tables(sdef), cfg.replace(engine="plain"),
                 device="cpu").numpy()
    images_close(img, render_oracle(sdef, cfg), cfg.samples_per_pixel)
