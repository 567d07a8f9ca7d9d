"""The path-replay backward on scenes with rects, cylinders and triangles:
the plain version of the adjoint kernels B5 and B6 (ops/adjoint_plain,
reached through diff/replay.make_replay_loss_fn with engine "mega" and
"queue" on the CPU) against rt_tpu's XLA per-bounce replay (against its
Pallas adjoint kernels: tests/test_torch_families_adjoint_pallas.py);
then the tangent replay (geom_spec) on the taped winners of such a
scene.

Scene: the reference's rect-lit scene (tests/test_diff.py:535-548: four
spheres, one a checker ground, lit by an emissive xy_rect) plus a
lambertian cylinder and a metal triangle, built with each package's own
builders, 32x24, depth 6, spp 2, cull_chunks=False on rt_tpu's side
(ROADMAP C-3). Variants are the reference's (tests/test_diff.py:553-558):
compact2, trunc3, exhaust.
Tolerance per field |a - b| <= 1e-5 + 1e-3 max|a|, the reference's
between its replay and its kernels. A family row's cotangents land in
its gradient slot (the family tables' column 31): the rect light's
emission in its texture row. The CUDA kernels are held against
adjoint_plain on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt_tpu.config import RenderConfig as JConfig
from rt_tpu.diff.replay import make_replay_loss_fn as jreplay_loss
from rt_tpu.scene import types as jtypes
from rt_tpu_torch.config import RenderConfig
from rt_tpu_torch.diff import replay as treplay
from rt_tpu_torch.diff import tape as ttape
from rt_tpu_torch.ops.camera import generate_rays
from rt_tpu_torch.scene import types as ttypes
from rt_tpu_torch.scene.convert import params_from_numpy
from test_torch_adjoint import FIELDS, assert_grads_close, jparams, \
    pixels, port_grads

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's default of one thread per core in each of them
# oversubscribes the CPU many times over.
torch.set_num_threads(1)

VARIANTS = {"compact2": ({"compact_every": 2}, {}),
            "trunc3": ({}, {"bwd_depth": 3}),
            "exhaust": ({"exhaust_mode": "background", "max_depth": 3}, {})}


def _build(mod, w, h, depth):
    s = mod.SceneDef(width=w, height=h, samples_per_pixel=2,
                     max_depth=depth, background=(0.4, 0.5, 0.6))
    s.add_sphere((0, 0, -1.5), 0.5, s.add_lambertian_color((0.7, 0.2, 0.2)))
    s.add_sphere((-1.1, 0, -1.5), 0.5, s.add_metal((0.8, 0.7, 0.6), 0.2))
    s.add_sphere((1.1, 0, -1.5), 0.5, s.add_dielectric(1.5))
    ck = s.add_checker((0.9, 0.9, 0.9), (0.1, 0.2, 0.1))
    s.add_sphere((0, -100.5, -1.5), 100, s.add_lambertian(ck))
    s.add_rect("xy_rect", -0.5, 0.5, 0.8, 1.4, -2.5,
               s.add_diffuse_light_color((4.0, 3.5, 3.0)))
    s.add_cylinder(0.15, -0.35, 0.35, s.add_lambertian_color((0.3, 0.6, 0.3)),
                   rotate=((0, 0, 1), 90.0), translate=(0.55, -0.35, -0.9))
    s.add_triangle((-0.75, -0.5, -0.8), (-0.2, -0.5, -0.95),
                   (-0.5, 0.05, -0.9), s.add_metal((0.6, 0.6, 0.8), 0.1))
    s.set_camera((0, 0.3, 1.2), (0, 0, -1.5), (0, 1, 0), 55, 0.0)
    return mod.build_tables(s)


def rect_lit(w, h, depth=6, **over):
    """(rt_tpu's tables and config, the port's) of the module doc's
    scene; `over` replaces config fields on both sides."""
    jcfg = JConfig(width=w, height=h, samples_per_pixel=2, max_depth=depth,
                   loop="while", cull_chunks=False).replace(**over)
    cfg = RenderConfig(**{**dataclasses.asdict(jcfg), "engine": "plain"})
    return _build(jtypes, w, h, depth), jcfg, _build(ttypes, w, h, depth), cfg


def _target(n, seed):
    return np.random.RandomState(seed).uniform(0.0, 0.6, (n, 3)).astype(
        np.float32)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_plain_adjoint_matches_xla_replay_on_families(variant):
    """Against rt_tpu's XLA per-bounce replay (its forward on "xla"), at
    32x24. On the CPU both engines replay on the one plain adjoint, whose
    bits do not depend on the forward's engine: compact2 runs "mega"
    (its segments), the others "queue"."""
    engine = "mega" if variant == "compact2" else "queue"
    over, kw = VARIANTS[variant]
    jt, jcfg, tt, cfg = rect_lit(32, 24, **over)
    px, py = pixels(32, 24)
    tgt = np.full((px.shape[0], 3), 0.2, np.float32)
    jp = jparams(jt)
    lj, gj = jax.value_and_grad(jreplay_loss(
        jt, jcfg.replace(engine="xla"), 2, jnp.asarray(px), jnp.asarray(py),
        jnp.asarray(tgt), bwd_kernel=False, **kw))(jp)
    lt, gt = port_grads(tt, cfg.replace(engine=engine), px, py, tgt,
                        params_from_numpy(jp), **kw)
    np.testing.assert_allclose(lt, float(lj), rtol=1e-4)
    assert_grads_close(gj, gt, (engine, variant))


def test_rect_light_emission_lands_in_its_texture_row():
    """The rect light's emission cotangent g * P goes to its texture row
    (the rect table's gradient slot, column 31), the cylinder's and the
    triangle's attenuation cotangents to their material or texture rows,
    and every row no path reaches takes exactly zero."""
    _, _, tt, cfg = rect_lit(32, 24)
    ms = tt.mega
    slots = {fam: int(tab[0, 31]) for fam, tab in zip(
        ("rect", "cyl", "tri"), ms.fam)}
    light_row = int(tt.mat_tex[tt.rect_mat[0]])
    assert slots["rect"] == light_row
    px, py = pixels(32, 24)
    tgt = np.full((px.shape[0], 3), 0.2, np.float32)
    p0 = {k: getattr(tt, k) for k in FIELDS}
    _, g = port_grads(tt, cfg.replace(engine="queue"), px, py, tgt, p0)
    acc = torch.cat([g["tex_color"], g["mat_albedo"]])  # by slot
    hit = acc.abs().amax(-1) > 0.0
    for fam, slot in slots.items():
        assert hit[slot], (fam, slot)
    # the slots no winner of any family names take nothing
    named = set(ms.table[:, 17].long().tolist()) | set(slots.values())
    for slot in range(ms.n_slots):
        if slot not in named:
            assert not hit[slot], slot
    # the odd checker colour: only the ground's texture row
    odd = g["tex_color2"].abs().amax(-1) > 0.0
    assert odd.tolist() == [r == int(ms.table[3, 17])
                            for r in range(odd.shape[0])]


def _spec(tt):
    mt = tt.mat_type
    met = int(torch.nonzero(mt == ttypes.MAT_METAL)[0, 0])
    die = int(torch.nonzero(mt == ttypes.MAT_DIELECTRIC)[0, 0])
    return {"sph_center": [(0, 0), (0, 1)], "sph_radius": [(0,)],
            "mat_fuzz": [(met,)], "mat_ior": [(die,)]}


def test_geom_tape_tangents_match_rt_tpu_on_families():
    """The tangent replay (geom_spec) with each bounce's hit recomputed
    against the taped winner, of any family, against rt_tpu's
    (geom_tape=True; the capture on the CPU is the wavefront's on both
    sides) at 24x16, depth 6, spp 2, on the rect-lit scene under the
    gradient sky (under a constant sky and constant emission these
    chains carry no interior gradient); the tolerance of
    tests/test_torch_geom.py (1e-8 + 1e-2 |a|)."""
    jt, jcfg, tt, cfg = rect_lit(24, 16, background_mode="gradient")
    spec = _spec(tt)
    px, py = pixels(24, 16)
    tgt = _target(px.shape[0], 4)
    pj = {k: jnp.asarray(getattr(jt, k), jnp.float32)
          for k in ("sph_center", "sph_radius", "mat_fuzz", "mat_ior",
                    "tex_color")}
    pj["sph_center"] = pj["sph_center"].at[0, 1].add(0.05)
    gj = jax.grad(jreplay_loss(
        jt, jcfg.replace(engine="xla"), 2, jnp.asarray(px), jnp.asarray(py),
        jnp.asarray(tgt), geom_spec=spec, geom_tape=True))(pj)
    p = {k: v.clone().requires_grad_(True)
         for k, v in params_from_numpy({k: np.asarray(v)
                                        for k, v in pj.items()}).items()}
    treplay.make_replay_loss_fn(
        tt, cfg.replace(engine="queue"), 2, torch.from_numpy(px),
        torch.from_numpy(py), torch.from_numpy(tgt), geom_spec=spec,
        geom_tape=True)(p).backward()
    nonzero = 0
    for f, idxs in spec.items():
        for idx in idxs:
            a, b = float(gj[f][idx]), float(p[f].grad[idx])
            assert abs(a - b) <= 1e-8 + 1e-2 * abs(a), (f, idx, a, b)
            nonzero += a != 0.0
    assert nonzero >= 3
    np.testing.assert_allclose(p["tex_color"].grad.numpy(),
                               np.asarray(gj["tex_color"]), rtol=2e-4,
                               atol=2e-6)
    # the taped winners span every family on this scene
    pix = torch.arange(24 * 16)
    ro, rd = generate_rays(tt.camera, 24, 16, pix % 24, pix // 24, 0, 0,
                           False)
    codes = ttape.capture_tape(tt, cfg, ro, rd, pix, 0, 0)
    assert set((codes[codes >= 0] >> 24).tolist()) == {0, 1, 2, 3}
