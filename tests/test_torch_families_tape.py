"""The winner tape on a scene of every primitive family: the plain version
of the capture kernel B4 (ops/mega_plain.capture_plain, through
ops/cuda_mega.mega_capture on CPU tensors), the wavefront capture, the
replay against the known winners (the per-lane leaf tests
ops/intersect.rect_leaf_test, cylinder_leaf_test, triangle_leaf_test)
and the tape gradients of the rect, cylinder and triangle fields, against
rt_tpu on the same scene.

Scene: tests/test_tape.py's `_all_families_scene` (a sphere, a textured
xy_rect, a rotated metal cylinder, a triangle, an emissive xz_rect and a
ground sphere) with a checker in place of its image texture (image
textures are not ported, ROADMAP Queue B2(c)), built with each package's
own builders, 24x16, depth 5; rt_tpu's side runs cull_chunks=False
(ROADMAP C-3). Tolerances as tests/test_torch_tape.py: codes equal on
every lane alive entering its bounce and death counts equal; radiance per
lane within 1e-5; gradients |a - b| <= 1e-4 max|a| per field, and zero
where rt_tpu's is zero (tests/test_tape.py:159-190). B4 itself is held
against its plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt_tpu.config import RenderConfig as JConfig
from rt_tpu.diff import tape as jtape
from rt_tpu.ops import pallas_mega as jmega
from rt_tpu.ops.camera import generate_rays as jrays
from rt_tpu.render.integrator import RayState as JRayState
from rt_tpu.render.integrator import _bounce as jbounce
from rt_tpu.scene import types as jtypes
from rt_tpu_torch.config import RenderConfig
from rt_tpu_torch.diff import inverse as tinverse
from rt_tpu_torch.diff import tape as ttape
from rt_tpu_torch.ops import cuda_mega, intersect, rng
from rt_tpu_torch.ops.camera import generate_rays
from rt_tpu_torch.render.integrator import trace
from rt_tpu_torch.scene import types as ttypes
from rt_tpu_torch.scene.convert import params_from_numpy
from test_torch_tape import alive_entering, assert_close_per_field

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's default of one thread per core in each of them
# oversubscribes the CPU many times over.
torch.set_num_threads(1)

W, H = 24, 16
GEOM = ("rect_k", "rect_lo", "rect_hi", "cyl_radius", "cyl_zmin",
        "cyl_zmax", "tri_v1", "tri_v2", "tri_v3")


def _build(mod, max_depth):
    s = mod.SceneDef(width=W, height=H, samples_per_pixel=2,
                     max_depth=max_depth, background=(0.3, 0.35, 0.4))
    s.add_sphere((0, 0.2, -2), 0.5, s.add_lambertian_color((0.6, 0.3, 0.2)))
    s.add_rect("xy_rect", -1.5, 0.5, -1, 1, -3.2,
               s.add_lambertian(s.add_checker((1.0, 0.5, 0.0),
                                              (0.0, 0.5, 1.0))))
    s.add_cylinder(0.3, -0.5, 0.5, s.add_metal((0.8, 0.8, 0.7), 0.2),
                   rotate=((0, 1, 0), 30.0), translate=(1.2, 0, -2.2))
    s.add_triangle((-1.8, -0.5, -1.5), (-0.8, -0.5, -1.8), (-1.3, 0.7, -1.6),
                   s.add_lambertian_color((0.2, 0.5, 0.7)))
    s.add_rect("xz_rect", -0.6, 0.6, -2.6, -1.6, 1.6,
               s.add_diffuse_light_color((4.0, 4.0, 4.0)))
    s.add_sphere((0, -100.6, -2), 100,
                 s.add_lambertian_color((0.5, 0.5, 0.5)))
    s.set_camera(lookfrom=(0, 0.3, 1.5), lookat=(0, 0, -2), vup=(0, 1, 0),
                 vfov_deg=55.0, aperture=0.0)
    return mod.build_tables(s)


def families_scene(max_depth=5, background_mode="constant", p_rr=0.0,
                   exhaust_mode="black"):
    """(rt_tpu's tables and config, the port's) of the module doc's
    scene."""
    jcfg = JConfig(width=W, height=H, samples_per_pixel=2,
                   max_depth=max_depth, loop="scan", cull_chunks=False,
                   background_mode=background_mode, p_rr=p_rr,
                   exhaust_mode=exhaust_mode)
    cfg = RenderConfig(**{**dataclasses.asdict(jcfg), "loop": "while",
                          "engine": "plain"})
    jt = jax.tree_util.tree_map(jnp.asarray, _build(jtypes, max_depth))
    return jt, jcfg, _build(ttypes, max_depth), cfg


def _jax_rays(jt):
    pix = np.arange(W * H, dtype=np.int32)
    px, py = jnp.asarray(pix % W), jnp.asarray(pix // W)
    js = jnp.zeros(W * H, jnp.uint32)
    ro, rd = jrays(jt.camera, W, H, px, py, js, jnp.uint32(0), False)
    return (py * W + px), js, ro, rd


def _port_rays(tt):
    pix = torch.arange(W * H)
    ro, rd = generate_rays(tt.camera, W, H, pix % W, pix // W, 0, 0, False)
    return pix, ro, rd


def _jax_alive_chain(jt, jcfg, pix, js, ro, rd):
    """rt_tpu's integrator: [depth, B] alive entering each bounce, and
    the death counts."""
    b = ro.shape[0]
    st = JRayState(o=ro, d=rd, throughput=jnp.ones((b, 3), jnp.float32),
                   rgb=jnp.zeros((b, 3), jnp.float32),
                   alive=jnp.ones((b,), bool))
    alive, death = [], np.zeros(b, np.int32)
    for i in range(jcfg.max_depth):
        alive.append(np.asarray(st.alive))
        st = jbounce(jt, jcfg, st, pix.astype(jnp.uint32), js,
                     jnp.uint32(0), jnp.uint32(i))
        death += np.asarray(st.alive).astype(np.int32)
    return np.stack(alive), death


@pytest.mark.parametrize("p_rr", [0.0, 0.9])
def test_plain_capture_matches_pallas_and_wavefront_capture(p_rr):
    """The plain B4 against rt_tpu's Pallas capture (interpret mode) and
    its wavefront capture (engine "xla"): equal codes, `family << 24 |
    row`, on every lane alive entering its bounce, with every family
    among them, and death counts equal to both the Pallas capture's and
    rt_tpu's alive chain."""
    jt, jcfg, tt, cfg = families_scene(max_depth=6, p_rr=p_rr)
    jpix, js, jro, jrd = _jax_rays(jt)
    jcodes, jdeath = jmega.mega_capture(jt, jcfg, jro, jrd, jpix,
                                        jnp.uint32(0), jnp.uint32(0))
    jcodes, jdeath = np.asarray(jcodes), np.asarray(jdeath)
    jwave = np.asarray(jtape.capture_tape(
        jt, jcfg, jro, jrd, jpix.astype(jnp.uint32), js, jnp.uint32(0),
        engine="xla"))
    jalive, jchain = _jax_alive_chain(jt, jcfg, jpix, js, jro, jrd)

    pix, ro, rd = _port_rays(tt)
    before = cuda_mega.mega_capture.launches
    codes, death = cuda_mega.mega_capture(tt, cfg, ro, rd, pix, 0, 0)
    assert cuda_mega.mega_capture.launches == before  # CPU: plain version
    codes, death = codes.numpy(), death.numpy()
    live = np.arange(cfg.max_depth)[:, None] <= death[None, :]
    np.testing.assert_array_equal(death, jdeath)
    np.testing.assert_array_equal(death, jchain)
    assert (codes[live] == jcodes[live]).all()
    assert (codes[jalive] == jwave[jalive]).all()
    assert (codes[~live] == -1).all()
    fams = set((codes[live & (codes >= 0)] >> 24).tolist())
    assert fams == {0, 1, 2, 3}, fams
    if p_rr:  # roulette: a lane it stops still records its winner
        u = np.stack([rng.uniform(0, pix, 0, k, rng.RR).numpy()
                      for k in range(cfg.max_depth)])
        assert (codes[live & (u > p_rr)] >= 0).any()


@pytest.mark.parametrize("p_rr", [0.0, 0.9])
def test_wavefront_capture_matches_rt_tpu_on_families(p_rr):
    """The port's wavefront capture (engine "plain") against rt_tpu's on
    every lane alive entering its bounce; on those lanes it equals the
    plain B4's codes too."""
    jt, jcfg, tt, cfg = families_scene(max_depth=6, p_rr=p_rr)
    jpix, js, jro, jrd = _jax_rays(jt)
    want = np.asarray(jtape.capture_tape(
        jt, jcfg, jro, jrd, jpix.astype(jnp.uint32), js, jnp.uint32(0),
        engine="xla"))
    pix, ro, rd = _port_rays(tt)
    got = ttape.capture_tape(tt, cfg, ro, rd, pix, 0, 0).numpy()
    alive = alive_entering(tt, cfg, pix, ro, rd)[0].numpy()
    assert (got[alive] == want[alive]).all()
    b4 = ttape.capture_tape(tt, cfg, ro, rd, pix, 0, 0,
                            engine="mega").numpy()
    assert (b4[alive] == got[alive]).all()
    assert len(set((got[alive & (got >= 0)] >> 24).tolist())) == 4


@pytest.mark.parametrize("kw", [
    {}, {"p_rr": 0.9}, {"exhaust_mode": "background", "max_depth": 3}])
def test_tape_replay_matches_trace_on_families(kw):
    """replay_tape of each capture (the wavefront's and the plain B4's)
    against the port's trace and rt_tpu's replay of its own tape, per
    lane within 1e-5 (test_tape_replay_matches_trace)."""
    jt, jcfg, tt, cfg = families_scene(**kw)
    jpix, js, jro, jrd = _jax_rays(jt)
    jpix = jpix.astype(jnp.uint32)
    jcodes = jtape.capture_tape(jt, jcfg, jro, jrd, jpix, js, jnp.uint32(0))
    want = np.asarray(jtape.replay_tape(jt, jcfg, jro, jrd, jcodes, jpix,
                                        js, jnp.uint32(0)))
    pix, ro, rd = _port_rays(tt)
    ref = trace(tt, cfg, ro, rd, pix, 0, 0).numpy()
    for engine in ("plain", "mega"):
        codes = ttape.capture_tape(tt, cfg, ro, rd, pix, 0, 0, engine=engine)
        got = ttape.replay_tape(tt, cfg, ro, rd, codes, pix, 0, 0).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5,
                                   err_msg=engine)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5,
                                   err_msg=engine)


@pytest.mark.parametrize("kw", [{}, {"p_rr": 0.9},
                                {"exhaust_mode": "background",
                                 "max_depth": 3}],
                         ids=["default", "rr", "exhaust"])
def test_tape_replay_matches_rt_tpu_under_the_gradient_sky(kw):
    """ROADMAP C-11: under the gradient sky the replay parts from the
    trace by up to ~4e-5 on a few lanes, in the port and in rt_tpu alike
    (the leaf tests against the batched candidates in the last bits), so
    the constant-sky test above keeps the reference's sky. Here the
    port's replay of its wavefront tape is held against rt_tpu's replay
    of its tape, per lane within 1e-5, under the gradient sky."""
    jt, jcfg, tt, cfg = families_scene(background_mode="gradient", **kw)
    jpix, js, jro, jrd = _jax_rays(jt)
    jpix = jpix.astype(jnp.uint32)
    jcodes = jtape.capture_tape(jt, jcfg, jro, jrd, jpix, js, jnp.uint32(0))
    want = np.asarray(jtape.replay_tape(jt, jcfg, jro, jrd, jcodes, jpix,
                                        js, jnp.uint32(0)))
    pix, ro, rd = _port_rays(tt)
    codes = ttape.capture_tape(tt, cfg, ro, rd, pix, 0, 0)
    got = ttape.replay_tape(tt, cfg, ro, rd, codes, pix, 0, 0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert got.max() > 0


def test_leaf_tests_match_the_family_candidates():
    """Each family's leaf test against the winning row gives the closest
    hit's t on the lanes that family wins (the batched candidate pass of
    ops/intersect.intersect), and inf on a row the ray misses."""
    _, _, tt, _ = families_scene()
    rs = np.random.default_rng(3)
    n = 4096
    ro = torch.from_numpy((rs.normal(0, 0.5, (n, 3)) + [0, 0.2, 0.8])
                          .astype(np.float32))
    tgt = torch.from_numpy((rs.normal(0, 0.9, (n, 3)) + [0, 0, -2.2])
                           .astype(np.float32))
    rd = tgt - ro
    hit = intersect.intersect(tt, ro, rd)
    for pt, leaf in ((intersect.PTYPE_RECT, intersect.rect_leaf_test),
                     (intersect.PTYPE_CYLINDER, intersect.cylinder_leaf_test),
                     (intersect.PTYPE_TRIANGLE,
                      intersect.triangle_leaf_test)):
        won = hit.hit & (hit.ptype == pt)
        assert int(won.sum()) > 30, pt
        t = leaf(tt, hit.pid[won], ro[won], rd[won])
        np.testing.assert_allclose(t.numpy(), hit.t[won].numpy(),
                                   rtol=2e-5, atol=1e-5, err_msg=str(pt))
    far = torch.zeros(8, 3)
    up = torch.tensor([[0.0, 0.0, 1.0]]).repeat(8, 1)
    for leaf in (intersect.rect_leaf_test, intersect.cylinder_leaf_test,
                 intersect.triangle_leaf_test):
        assert torch.isinf(leaf(tt, torch.zeros(8, dtype=torch.int32), far,
                                up)).all()


def _grads(tt, cfg, p0, tgt, how):
    p = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
    pix = torch.arange(W * H)
    px, py, tgt_t = pix % W, pix // W, torch.from_numpy(tgt.copy())
    if how == "tape":
        loss = ttape.make_tape_loss_fn(tt, cfg, 2, px, py, tgt_t)(p)
    else:
        loss = tinverse.make_loss_fn(tt, cfg, 2)(p, px, py, tgt_t)
    loss.backward()
    # a field that acts only through comparisons or unused (u, v) is not
    # in the graph at all: its gradient is zero, as jax.grad gives it
    return {k: (torch.zeros_like(v) if v.grad is None else v.grad).numpy()
            for k, v in p.items()}


def test_tape_gradients_of_rect_cylinder_triangle_fields():
    """test_tape_gradients_extended_geometry: the port's tape against
    rt_tpu's make_tape_render and against the port's method="ad", for
    every rect, cylinder and triangle field and the texture rows; where
    rt_tpu's gradient is zero (fields that act only through a piecewise
    constant texture lookup), the port's is zero too."""
    jt, jcfg, tt, cfg = families_scene()
    jcfg = jcfg.replace(background_mode="gradient")
    cfg = cfg.replace(background_mode="gradient")
    fields = GEOM + ("tex_color",)
    p0 = {f: jnp.asarray(getattr(jt, f), jnp.float32) for f in fields}
    pix = np.arange(W * H, dtype=np.int32)
    img_fn = jtape.make_tape_render(jt, jcfg, 2, jnp.asarray(pix % W),
                                    jnp.asarray(pix // W))
    tgt = jax.lax.stop_gradient(img_fn(p0)) * 0.9
    gj = jax.grad(lambda p: jnp.mean((img_fn(p) - tgt) ** 2))(p0)
    tgt = np.asarray(tgt)
    pt = params_from_numpy({k: np.asarray(v) for k, v in p0.items()})
    tape_g = _grads(tt, cfg, pt, tgt, "tape")
    ad_g = _grads(tt, cfg, pt, tgt, "ad")
    nonzero = {f for f in fields if np.abs(np.asarray(gj[f])).max() > 0.0}
    assert nonzero >= {"rect_k", "cyl_radius", "tri_v1", "tex_color"}
    assert_close_per_field(gj, tape_g, sorted(nonzero))
    assert_close_per_field(ad_g, tape_g, sorted(nonzero))
    for f in set(fields) - nonzero:
        assert np.abs(tape_g[f]).max() == 0.0, f
        assert np.abs(ad_g[f]).max() == 0.0, f


@pytest.mark.parametrize("spp", [1, 2])
def test_tape_vg_matches_tape_loss_on_families(spp):
    """make_tape_vg (the B4 capture, lanes sorted by death, widths cut to
    the live prefix) against make_tape_loss_fn's full-width replay on the
    family scene (test_tape_vg_matches_tape_loss's tolerances)."""
    _, _, tt, cfg = families_scene()
    cfg = cfg.replace(background_mode="gradient")
    fields = ("rect_k", "cyl_radius", "tri_v1", "tex_color", "mat_albedo")
    pix = torch.arange(W * H)
    p = {f: getattr(tt, f).clone().requires_grad_(True) for f in fields}
    with torch.no_grad():
        tgt = ttape.make_tape_render(tt, cfg, spp, pix % W, pix // W)(
            {k: v.detach() for k, v in p.items()}) * 0.85
    loss = ttape.make_tape_loss_fn(tt, cfg, spp, pix % W, pix // W, tgt)(p)
    loss.backward()
    vg = ttape.make_tape_vg(tt, cfg, pix % W, pix // W, tgt, spp=spp,
                            min_width=64)
    before = cuda_mega.mega_capture.launches
    loss_v, grads = vg({k: v.detach() for k, v in p.items()})
    assert cuda_mega.mega_capture.launches == before  # CPU: plain version
    np.testing.assert_allclose(float(loss_v), float(loss.detach()),
                               rtol=2e-3)
    for k in fields:
        a, b = p[k].grad.numpy(), grads[k].numpy()
        scale = np.abs(a).max()
        assert scale > 0.0, k
        np.testing.assert_allclose(b, a, rtol=0, atol=2e-4 * scale,
                                   err_msg=k)


def test_capture_code_holds_rows_below_two_to_the_24(monkeypatch):
    """The code keeps the family in bits 24+, so every family's table
    must hold fewer than MAX_CODE_ROWS rows; a larger one, in any family,
    raises before tracing (shown with the bound lowered to the scene's
    largest tables: 2 sphere and 2 rect rows)."""
    _, _, tt, cfg = families_scene()
    assert cuda_mega.MAX_CODE_ROWS == 1 << 24
    assert [tt.mega.table.shape[0]] + [t.shape[0] for t in tt.mega.fam] \
        == [2, 2, 1, 1]
    pix, ro, rd = _port_rays(tt)
    monkeypatch.setattr(cuda_mega, "MAX_CODE_ROWS", 2)
    codes, _ = cuda_mega.mega_capture(tt, cfg, ro, rd, pix, 0, 0)
    assert ((codes >> 24) == 1).any()  # a rect row took its code
    monkeypatch.setattr(cuda_mega, "MAX_CODE_ROWS", 1)
    with pytest.raises(ValueError, match="tape code"):
        cuda_mega.mega_capture(tt, cfg, ro, rd, pix, 0, 0)
