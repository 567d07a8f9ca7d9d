"""Rects, cylinders and triangles in rt_tpu_torch's wavefront engines and
packed tables, against rt_tpu on the same inputs.

The JAX side runs as its own tests run it on the CPU: intersect and the
renderer with engine="xla". Tolerances: hit masks, families and rows
agree on >= 99.9% of random rays; t within rtol 2e-4 / atol 1e-4 (as
tests/test_pallas.py), the hit point, normal and (u, v) within 1e-3 on
the lanes whose winner agrees (XLA-CPU's einsum sums the cylinder's 3x3
products in its own order and its atan2 rounds otherwise than torch's);
materials, object ids and face sides exactly there. Images of the plain
engine against rt_tpu's "xla" by images_close (1% of pixels beyond
2e-3, an outlier at most 0.5 or the scene's brightest emission, see the
test). The packed family tables equal rt_tpu's bit for bit."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt_tpu.ops import intersect as jintersect
from rt_tpu.ops import pallas_mega as jmega
from rt_tpu.render.renderer import render as jrender
from rt_tpu.scene import builders as jbuilders
from rt_tpu.scene import parser as jparser
from rt_tpu.scene import types as jtypes
from rt_tpu_torch.config import RenderConfig
from rt_tpu_torch.ops import cuda_intersect, mega_tables
from rt_tpu_torch.ops import intersect as tintersect
from rt_tpu_torch.render.renderer import render as trender
from rt_tpu_torch.scene import builders as tbuilders
from rt_tpu_torch.scene import parser as tparser
from rt_tpu_torch.scene import types as ttypes

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's default of one thread per core in each of them
# oversubscribes the CPU many times over.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(ROOT, "scenes", "demo_scene.json")
MESH = os.path.join(ROOT, "scenes", "plane441.obj")


def all_families(mod):
    """Every primitive family with solid and checker textures, an
    emissive rect, and all three rect orientations (the shape of
    tests/test_queue.py's scene without its image texture), built with
    `mod` (rt_tpu's or the port's types module)."""
    s = mod.SceneDef(width=32, height=24, samples_per_pixel=2, max_depth=6,
                     background=(0.2, 0.25, 0.3))
    s.add_sphere((0, 0, -2), 0.5, s.add_lambertian_color((0.5, 0.4, 0.3)))
    s.add_sphere((0, -100.5, -2), 100,
                 s.add_lambertian(
                     s.add_checker((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))))
    s.add_sphere((-1.1, 0, -2), 0.5, s.add_dielectric(1.5))
    s.add_rect("xz_rect", -1, 1, -3, -1, 2.0,
               s.add_diffuse_light_color((3.0, 2.8, 2.5)))
    s.add_rect("xy_rect", -2, 2, -1, 2, -3.5,
               s.add_lambertian(s.add_checker((0.8, 0.1, 0.1),
                                              (0.1, 0.1, 0.8))))
    s.add_rect("yz_rect", -1, 1, -3, -1, 1.8,
               s.add_metal((0.8, 0.8, 0.9), 0.2))
    s.add_cylinder(0.25, -0.3, 0.3, s.add_metal((0.9, 0.7, 0.4), 0.1))
    s.add_cylinder(0.2, -0.5, 0.5, s.add_dielectric(1.4),
                   rotate=((1, 0, 0), 90.0), translate=(0.9, -0.2, -1.6))
    tri_mat = s.add_lambertian_color((0.8, 0.2, 0.2))
    s.add_triangle((0.4, -0.5, -1.2), (0.9, -0.5, -1.4), (0.6, 0.2, -1.3),
                   tri_mat, uv1=(0, 0), uv2=(1, 0), uv3=(0, 1))
    s.add_triangle((-0.9, -0.4, -1.0), (-0.3, -0.45, -1.1),
                   (-0.6, 0.3, -0.9), tri_mat)
    s.set_camera((0, 0.3, 1.2), (0, 0, -2), (0, 1, 0), 55, 0.0)
    return s


def _rays(n, seed):
    """Random rays around the scene: origins near the camera, directions
    toward the primitives with a spread."""
    rs = np.random.default_rng(seed)
    ro = (rs.normal(0, 0.6, (n, 3)) + [0, 0.2, 0.5]).astype(np.float32)
    tgt = rs.normal(0, 0.8, (n, 3)) + [0, 0, -2]
    rd = (tgt - ro).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return ro, rd


@pytest.mark.parametrize("engine", ["plain", "pallas"])
def test_intersect_matches_jax_xla(engine):
    jt = jtypes.build_tables(all_families(jtypes))
    tt = ttypes.build_tables(all_families(ttypes))
    assert tt.counts == (3, 3, 2, 2)
    ro, rd = _rays(4096, seed=1)
    hj = jintersect.intersect(jt, jnp.asarray(ro), jnp.asarray(rd),
                              engine="xla")
    before = cuda_intersect.sphere_closest_hit.launches
    ht = tintersect.intersect(tt, torch.from_numpy(ro), torch.from_numpy(rd),
                              engine=engine)
    assert cuda_intersect.sphere_closest_hit.launches == before  # CPU
    hit = np.asarray(hj.hit)
    ptype = np.asarray(hj.ptype)
    for fam in range(4):  # every family wins somewhere
        assert (hit & (ptype == fam)).sum() > 20, fam
    same = ((ht.hit.numpy() == hit) & (ht.ptype.numpy() == ptype)
            & (ht.pid.numpy() == np.asarray(hj.pid)))
    assert same.mean() >= 0.999, same.mean()
    both = same & hit
    tj, tg = np.asarray(hj.t)[both], ht.t.numpy()[both]
    np.testing.assert_allclose(tg, tj, rtol=2e-4, atol=1e-4)
    for f in ("obj", "mat", "front_face"):
        np.testing.assert_array_equal(getattr(ht, f).numpy()[both],
                                      np.asarray(getattr(hj, f))[both], f)
    for f in ("p", "normal", "u", "v"):
        np.testing.assert_allclose(getattr(ht, f).numpy()[both],
                                   np.asarray(getattr(hj, f))[both],
                                   rtol=1e-3, atol=1e-3, err_msg=f)
    miss = ~hit & same
    for f in ("pid", "obj", "mat", "ptype"):
        np.testing.assert_array_equal(getattr(ht, f).numpy()[miss],
                                      np.asarray(getattr(hj, f))[miss], f)


@pytest.mark.parametrize("family", ["rect", "cylinder", "triangle"])
def test_family_candidates_match_jax(family):
    """The [B, N] candidate t of each family against rt_tpu's, per (ray,
    row): misses exactly, t within rtol 2e-4 / atol 1e-4."""
    jt = jtypes.build_tables(all_families(jtypes))
    tt = ttypes.build_tables(all_families(ttypes))
    ro, rd = _rays(1024, seed=2)
    fn = {"rect": "_rect_t", "cylinder": "_cylinder_t",
          "triangle": "_triangle_t"}[family]
    want = np.asarray(getattr(jintersect, fn)(jt, jnp.asarray(ro),
                                              jnp.asarray(rd), 1e-3))
    got = getattr(tintersect, fn)(tt, torch.from_numpy(ro),
                                  torch.from_numpy(rd), 1e-3).numpy()
    fin = np.isfinite(want)
    assert fin.sum() > 50
    assert np.mean(fin == np.isfinite(got)) >= 0.999
    ok = fin & np.isfinite(got)
    np.testing.assert_allclose(got[ok], want[ok], rtol=2e-4, atol=1e-4)


def test_rect_only_scene():
    """A scene with no sphere: every table but the rects' is padding."""
    def build(mod):
        s = mod.SceneDef(width=8, height=8, background=(0.1, 0.1, 0.1))
        s.add_rect("xy_rect", -1, 1, -1, 1, -2,
                   s.add_lambertian_color((0.5, 0.5, 0.5)))
        s.set_camera((0, 0, 1), (0, 0, -1), (0, 1, 0), 60, 0.0)
        return s

    jt = jtypes.build_tables(build(jtypes))
    tt = ttypes.build_tables(build(ttypes))
    assert tt.counts == (0, 1, 0, 0) and mega_tables.mega_supported(tt)
    ro, rd = _rays(256, seed=3)
    hj = jintersect.intersect(jt, jnp.asarray(ro), jnp.asarray(rd))
    ht = tintersect.intersect(tt, torch.from_numpy(ro), torch.from_numpy(rd))
    np.testing.assert_array_equal(ht.hit.numpy(), np.asarray(hj.hit))
    assert ht.hit.any()
    ms = tt.mega
    assert ms.table.shape == (1, mega_tables.S_COLS)
    assert float(ms.table[0, mega_tables.S_VALID]) == 0.0
    assert ms.fam.rect.shape == (1, mega_tables.F_COLS)
    assert ms.fam.cyl.shape[0] == ms.fam.tri.shape[0] == 0


def _scene(name, w, h, spp, depth):
    if name == "demo":
        sj, cj = jparser.parse_scene(DEMO)
        st, _ = tparser.parse_scene(DEMO)
        sj.resize(w, h)
        st.resize(w, h)
        cj = cj.replace(width=w, height=h, samples_per_pixel=spp,
                        max_depth=depth)
    else:
        fn, kw = {"dna": ("dna_scene", {}),
                  "cover_lights": ("cover_scene", dict(lights=True, grid=3)),
                  "mesh": ("mesh_scene", dict(obj_path=MESH))}[name]
        size = dict(width=w, height=h, spp=spp, max_depth=depth)
        sj, cj = getattr(jbuilders, fn)(**kw, **size)
        st, _ = getattr(tbuilders, fn)(**kw, **size)
    cfg = RenderConfig(**dataclasses.asdict(cj.replace(engine="plain")))
    return jtypes.build_tables(sj), cj, ttypes.build_tables(st), cfg


@pytest.mark.parametrize("name", ["demo", "dna", "cover_lights", "mesh"])
def test_plain_engine_image_matches_jax_xla(name, images_close):
    """images_close's bound on an outlier pixel (0.5) is raised to the
    scene's brightest emission where that is larger: an outlier is a
    path that an ulp sends to a light in one engine and past it in the
    other, and the pixel then moves by up to that emission. (rt_tpu's
    own "xla" render and its eager bounce part that way: under jit the
    t of a hit on the radius-1000 ground sphere rounds one ulp off, and
    on cover_scene(lights=True) at 48x27 one of 1,296 pixels then sees
    the (4, 4, 4) light through another checker square, by 1.6.)"""
    jt, cj, tt, cfg = _scene(name, 48, 27, 2, 6)
    img_j = np.asarray(jrender(jt, cj.replace(engine="xla")))
    img_t = trender(tt, cfg, device="cpu").numpy()
    assert np.isfinite(img_t).all() and img_t.max() > 0
    lights = tt.mat_tex[tt.mat_type == ttypes.MAT_DIFFUSE_LIGHT].long()
    emission = float(tt.tex_color[lights].max()) if lights.numel() else 0.0
    images_close(img_t, img_j, spp=2, outlier_atol=max(0.5, emission))


def test_hybrid_engine_image_matches_plain(images_close):
    """engine="pallas" (kernel B1's plain version for the spheres on the
    CPU, PyTorch for the other families) against engine="plain"."""
    _, _, tt, cfg = _scene("demo", 32, 18, 2, 6)
    stats = {}
    img_h = trender(tt, cfg.replace(engine="pallas"), device="cpu",
                    stats=stats).numpy()
    img_p = trender(tt, cfg, device="cpu").numpy()
    assert stats["bounces"] > 0
    images_close(img_h, img_p, spp=2)


@pytest.mark.parametrize("name", ["all_families", "demo", "dna", "mesh"])
def test_family_tables_match_jax(name):
    """rect_table / cylinder_table / triangle_table equal rt_tpu's on
    every column and row, bit for bit; MegaScene keeps the live rows."""
    if name == "all_families":
        jt = jtypes.build_tables(all_families(jtypes))
        tt = ttypes.build_tables(all_families(ttypes))
    else:
        jt, _, tt, _ = _scene(name, 16, 9, 1, 2)
    jtd = jax.tree.map(jnp.asarray, jt)
    ms = tt.mega
    assert (ms.fam is None) == (not any(tt.counts[1:]))
    for fam, jfn, tfn, n in (
            ("rect", jmega.rect_table, mega_tables.rect_table, tt.counts[1]),
            ("cyl", jmega.cylinder_table, mega_tables.cylinder_table,
             tt.counts[2]),
            ("tri", jmega.triangle_table, mega_tables.triangle_table,
             tt.counts[3])):
        want = np.asarray(jfn(jtd))
        got = tfn(tt)
        assert got.dtype == torch.float32
        assert got.shape == (want.shape[0], mega_tables.F_COLS)
        np.testing.assert_array_equal(got.numpy(), want)
        if ms.fam is not None:
            live = getattr(ms.fam, fam)
            assert live.shape == (n, mega_tables.F_COLS)
            assert torch.equal(live, got[:n])
            assert bool((got[n:, [mega_tables.R_VALID, mega_tables.Y_VALID,
                                  mega_tables.T_VALID][
                ("rect", "cyl", "tri").index(fam)]] == 0).all())
