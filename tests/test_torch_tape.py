"""rt_tpu_torch's winner tape (diff/tape.py) against rt_tpu's on the CPU:
the wavefront capture, the replay per lane, the gradients of every
ported TAPE_FIELDS entry against rt_tpu's make_tape_render and against
the port's own method="ad", the segmentation, a finite difference, the
field checks, the death-sorted step make_tape_vg, and fit(method="tape").

Scene: tests/test_tape.py's `_mixed_scene` (one sphere of every
material, a checker ground, the gradient sky), built with each
package's own builders, 24x16, depth 4-6, spp <= 3; rt_tpu's side runs
cull_chunks=False (ROADMAP C-3). Tolerances: per lane 1e-5 (the
reference's replay-vs-trace bound); gradients |a - b| <= 1e-4 max|a|
per field (tests/test_tape.py:148-153); make_tape_vg against the
full-width loss rtol 2e-3, atol 2e-4 max|g| (tests/test_tape.py:440).
The capture kernel B4 itself is held against its plain version on the
card (tests/test_torch_cuda.py) and against rt_tpu's Pallas kernel in
tests/test_torch_tape_pallas.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt_tpu.config import RenderConfig as JConfig
from rt_tpu.diff import tape as jtape
from rt_tpu.ops.camera import generate_rays as jrays
from rt_tpu.scene import types as jtypes
from rt_tpu_torch.config import RenderConfig
from rt_tpu_torch.diff import inverse as tinverse
from rt_tpu_torch.diff import tape as ttape
from rt_tpu_torch.ops.camera import generate_rays
from rt_tpu_torch.render.integrator import RayState, _bounce, trace
from rt_tpu_torch.render.renderer import render
from rt_tpu_torch.scene import types as ttypes
from rt_tpu_torch.scene.convert import params_from_numpy

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's default of one thread per core in each of them
# oversubscribes the CPU many times over.
torch.set_num_threads(1)

W, H = 24, 16
FIELDS = ("mat_albedo", "mat_fuzz", "mat_ior", "tex_color", "tex_color2",
          "sph_center", "sph_radius")


def _build(types, max_depth):
    s = types.SceneDef(width=W, height=H, samples_per_pixel=2,
                       max_depth=max_depth, background=(0.7, 0.8, 1.0))
    lam = s.add_lambertian_color((0.5, 0.3, 0.2))
    met = s.add_metal((0.8, 0.7, 0.6), 0.3)
    die = s.add_dielectric(1.5)
    chk = s.add_lambertian(s.add_checker((0.2, 0.3, 0.1), (0.9, 0.9, 0.9)))
    s.add_sphere((0, 0, -1), 0.5, lam)
    s.add_sphere((-1.0, 0, -1), 0.5, met)
    s.add_sphere((1.0, 0, -1), 0.5, die)
    s.add_sphere((0, -100.5, -1), 100, chk)
    s.set_camera(lookfrom=(0, 0, 1), lookat=(0, 0, -1), vup=(0, 1, 0),
                 vfov_deg=45.0, aperture=0.0)
    return types.build_tables(s)


def mixed_scene(max_depth=4, background_mode="gradient", p_rr=0.0,
                exhaust_mode="black"):
    """(rt_tpu's tables and config, the port's): tests/test_tape.py's
    _mixed_scene in both packages."""
    jcfg = JConfig(width=W, height=H, samples_per_pixel=2,
                   max_depth=max_depth, loop="scan", cull_chunks=False,
                   background_mode=background_mode, p_rr=p_rr,
                   exhaust_mode=exhaust_mode)
    cfg = RenderConfig(**{**dataclasses.asdict(jcfg), "loop": "while",
                          "engine": "plain"})
    jt = jax.tree_util.tree_map(jnp.asarray, _build(jtypes, max_depth))
    return jt, jcfg, _build(ttypes, max_depth), cfg


def pixels():
    pix = np.arange(W * H, dtype=np.int32)
    return pix % W, pix // W


def port_rays(tt, cfg, sample=0):
    px, py = (torch.from_numpy(x).long() for x in pixels())
    ro, rd = generate_rays(tt.camera, W, H, px, py, sample, cfg.seed,
                           cfg.enable_defocus)
    return py * W + px, ro, rd


def alive_entering(tt, cfg, pix, ro, rd):
    """[depth, B] bool: the integrator's lanes alive entering each
    bounce, and their death counts [B]."""
    b = ro.shape[0]
    st = RayState(ro, rd, torch.ones(b, 3), torch.zeros(b, 3),
                  torch.ones(b, dtype=torch.bool))
    rows = []
    for i in range(cfg.max_depth):
        rows.append(st.alive)
        st = _bounce(tt, cfg, st, pix, 0, cfg.seed, i)
    return torch.stack(rows), torch.stack(rows[1:] + [st.alive]).sum(0)


def assert_close_per_field(want, got, fields, rel=1e-4):
    for k in fields:
        a = np.asarray(want[k], np.float64)
        b = np.asarray(got[k], np.float64)
        scale = np.abs(a).max()
        assert scale > 0.0, f"{k}: reference gradient unexpectedly zero"
        np.testing.assert_allclose(b, a, rtol=0, atol=rel * scale,
                                   err_msg=k)


@pytest.mark.parametrize("kw", [{}, {"p_rr": 0.9}])
def test_capture_matches_rt_tpu_wavefront(kw):
    """The port's wavefront capture against rt_tpu's (engine "xla"): equal
    codes on every lane alive entering its bounce."""
    jt, jcfg, tt, cfg = mixed_scene(max_depth=6, **kw)
    px, py = (jnp.asarray(x) for x in pixels())
    jpix = (py * W + px).astype(jnp.uint32)
    jsample = jnp.zeros(W * H, jnp.uint32)
    jro, jrd = jrays(jt.camera, W, H, px, py, jsample, jnp.uint32(0), False)
    want = np.asarray(jtape.capture_tape(jt, jcfg, jro, jrd, jpix, jsample,
                                         jnp.uint32(0), engine="xla"))
    pix, ro, rd = port_rays(tt, cfg)
    got = ttape.capture_tape(tt, cfg, ro, rd, pix, 0, 0).numpy()
    alive, _ = alive_entering(tt, cfg, pix, ro, rd)
    alive = alive.numpy()
    assert got.dtype == np.int32 and got.shape == want.shape
    assert (got[alive] == want[alive]).all()
    assert (got[alive] >= 0).any() and (got[alive] == -1).any()


@pytest.mark.parametrize("kw", [
    {}, {"p_rr": 0.9}, {"exhaust_mode": "background", "max_depth": 3}])
def test_replay_matches_rt_tpu_and_trace(kw):
    """The port's replay of its own tape against rt_tpu's replay of its
    tape, and against the port's plain trace, per lane within 1e-5."""
    jt, jcfg, tt, cfg = mixed_scene(**kw)
    px, py = (jnp.asarray(x) for x in pixels())
    jpix = (py * W + px).astype(jnp.uint32)
    js = jnp.zeros(W * H, jnp.uint32)
    seed = jnp.uint32(0)
    jro, jrd = jrays(jt.camera, W, H, px, py, js, seed, False)
    jcodes = jtape.capture_tape(jt, jcfg, jro, jrd, jpix, js, seed)
    want = np.asarray(jtape.replay_tape(jt, jcfg, jro, jrd, jcodes, jpix,
                                        js, seed))
    pix, ro, rd = port_rays(tt, cfg)
    codes = ttape.capture_tape(tt, cfg, ro, rd, pix, 0, 0)
    got = ttape.replay_tape(tt, cfg, ro, rd, codes, pix, 0, 0)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), trace(tt, cfg, ro, rd, pix, 0,
                                                  0).numpy(),
                               rtol=0, atol=1e-5)


def _jax_tape_grads(jt, jcfg, p0, spp=2):
    px, py = (jnp.asarray(x) for x in pixels())
    img_fn = jtape.make_tape_render(jt, jcfg, spp, px, py)
    tgt = jax.lax.stop_gradient(img_fn(p0)) * 0.9
    g = jax.grad(lambda p: jnp.mean((img_fn(p) - tgt) ** 2))(p0)
    return np.asarray(tgt), g


def _port_tape_grads(tt, cfg, p, tgt, spp=2, **kw):
    px, py = pixels()
    loss = ttape.make_tape_loss_fn(tt, cfg, spp, torch.from_numpy(px),
                                   torch.from_numpy(py),
                                   torch.from_numpy(tgt.copy()), **kw)(p)
    loss.backward()
    return float(loss.detach())


def _port_ad_grads(tt, cfg, p, tgt, spp=2):
    px, py = (torch.from_numpy(x) for x in pixels())
    loss = tinverse.make_loss_fn(tt, cfg, spp)(p, px, py,
                                               torch.from_numpy(tgt.copy()))
    loss.backward()
    return float(loss.detach())


def _leaf_params(src, fields):
    return {k: v.clone().requires_grad_(True)
            for k, v in params_from_numpy(
                {k: np.asarray(src[k]) for k in fields}).items()}


def test_tape_gradients_match_rt_tpu_and_port_ad():
    """Every ported field class at once (albedo, emission textures, fuzz,
    IOR, sphere centres and radii): the port's tape against rt_tpu's
    tape and against the port's autograd through the plain engine."""
    jt, jcfg, tt, cfg = mixed_scene()
    p0 = {f: jnp.asarray(getattr(jt, f), jnp.float32) for f in FIELDS}
    tgt, gj = _jax_tape_grads(jt, jcfg, p0)
    pt = _leaf_params(p0, FIELDS)
    _port_tape_grads(tt, cfg, pt, tgt)
    tape_g = {k: v.grad.numpy() for k, v in pt.items()}
    assert_close_per_field(gj, tape_g, FIELDS)
    pa = _leaf_params(p0, FIELDS)
    _port_ad_grads(tt, cfg, pa, tgt)
    assert_close_per_field({k: v.grad.numpy() for k, v in pa.items()},
                           tape_g, FIELDS)


def test_tape_camera_gradient_matches_rt_tpu_and_port_ad():
    """The camera as one parameter: primary rays are generated inside the
    differentiable region, so every CameraDef field takes a gradient
    through the hit-point chains."""
    jt, jcfg, tt, cfg = mixed_scene()
    tgt, gj = _jax_tape_grads(jt, jcfg, {"camera": jt.camera})
    fields = [f.name for f in dataclasses.fields(ttypes.CameraDef)]

    def port_cam():
        cam = params_from_numpy({"camera": jt.camera})["camera"]
        return {"camera": ttypes.CameraDef(**{
            f: getattr(cam, f).requires_grad_(True) for f in fields})}

    def grad(p, f):  # a field no ray reads (no defocus) takes none
        x = getattr(p["camera"], f)
        return (torch.zeros_like(x) if x.grad is None else x.grad).numpy()

    pt, pa = port_cam(), port_cam()
    _port_tape_grads(tt, cfg, pt, tgt)
    _port_ad_grads(tt, cfg, pa, tgt)
    nonzero = 0
    for f in fields:
        a = np.asarray(getattr(gj["camera"], f), np.float64)
        scale = max(np.abs(a).max(), 1e-12)
        nonzero += scale > 1e-12
        np.testing.assert_allclose(grad(pt, f), a, rtol=0,
                                   atol=1e-4 * scale, err_msg=f)
        np.testing.assert_allclose(grad(pt, f), grad(pa, f), rtol=0,
                                   atol=1e-4 * scale, err_msg=f)
    assert nonzero >= 4


def test_tape_segmentation_invariant():
    """The two-level recomputation must not change the gradient."""
    _, _, tt, cfg = mixed_scene(max_depth=6)
    tgt = np.zeros((W * H, 3), np.float32)
    grads = []
    for seg in (1, 3, None):
        p = {"sph_center": tt.sph_center.clone().requires_grad_(True),
             "mat_albedo": tt.mat_albedo.clone().requires_grad_(True)}
        _port_tape_grads(tt, cfg, p, tgt, segment=seg)
        grads.append({k: v.grad for k, v in p.items()})
    for g in grads[1:]:
        for k in g:
            torch.testing.assert_close(g[k], grads[0][k], rtol=0, atol=1e-7)


def test_tape_keeps_or_recaptures_codes(monkeypatch):
    """Above STORE_TAPE_MAX codes each sample's replay captures again
    under its checkpoint instead of keeping the codes: the same
    gradients."""
    _, _, tt, cfg = mixed_scene()
    tgt = np.zeros((W * H, 3), np.float32)
    grads = []
    for limit in (ttape.STORE_TAPE_MAX, 0):
        monkeypatch.setattr(ttape, "STORE_TAPE_MAX", limit)
        p = {"sph_radius": tt.sph_radius.clone().requires_grad_(True),
             "tex_color": tt.tex_color.clone().requires_grad_(True)}
        _port_tape_grads(tt, cfg, p, tgt)
        grads.append({k: v.grad for k, v in p.items()})
    for k in grads[0]:
        assert torch.equal(grads[0][k], grads[1][k]), k


def test_tape_gradient_matches_finite_difference():
    """The whole tape loss (capture, replay, sample mean) against central
    differences on tex_color, a radiometric chain (a geometry parameter
    would also move silhouettes, which no detached estimator sees)."""
    _, _, tt, cfg = mixed_scene()
    px, py = (torch.from_numpy(x) for x in pixels())
    img0 = ttape.make_tape_render(tt, cfg, 2, px, py)(
        {"tex_color": tt.tex_color})
    loss = ttape.make_tape_loss_fn(tt, cfg, 2, px, py, img0.detach() * 0.8)
    p = {"tex_color": tt.tex_color.clone().requires_grad_(True)}
    loss(p).backward()
    eps = 1e-3
    for i, c in [(0, 0), (0, 2), (1, 1)]:
        hi, lo = tt.tex_color.clone(), tt.tex_color.clone()
        hi[i, c] += eps
        lo[i, c] -= eps
        with torch.no_grad():
            fd = (float(loss({"tex_color": hi}))
                  - float(loss({"tex_color": lo}))) / (2 * eps)
        got = float(p["tex_color"].grad[i, c])
        assert abs(got - fd) <= max(2e-5, 0.05 * abs(fd)), (i, c, got, fd)


# "images" raised NotImplementedError until image textures were ported;
# its case keeps the refusal's values (and so its id) and checks that it
# is taken now: both tape paths run and give the atlas's shape
# (tests/test_torch_images_adjoint.py holds its values)
@pytest.mark.parametrize("field,err,match", [
    ("cyl_w2o", ValueError, "tape gradients cover"),
    ("images", NotImplementedError, r"B2\(c\)")])
def test_tape_refuses_unknown_and_unported_fields(field, err, match):
    _, _, tt, cfg = mixed_scene()
    px, py = (torch.from_numpy(x) for x in pixels())
    tgt = torch.zeros((W * H, 3))
    loss = ttape.make_tape_loss_fn(tt, cfg, 1, px, py, tgt)
    if field == "images":
        # the scene samples no image: the loss runs, the atlas's gradient
        # is zero
        p = getattr(tt, field).clone().requires_grad_(True)
        assert bool(torch.isfinite(loss({field: p})))
        _, grads = ttape.make_tape_vg(tt, cfg, px, py, tgt)({field: p})
        assert grads[field].shape == p.shape and not bool(grads[field].any())
    else:
        with pytest.raises(err, match=match):
            loss({field: torch.zeros(3)})
        with pytest.raises(err, match=match):
            ttape.make_tape_vg(tt, cfg, px, py, tgt)({field: torch.zeros(3)})
    assert (field in ttape.TAPE_FIELDS) == (field != "cyl_w2o")
    assert ttape.TAPE_FIELDS == jtape.TAPE_FIELDS


def test_tape_refuses_nee():
    """The tape refused cfg.nee until light sampling was ported; it takes
    it now (tests/test_torch_nee_tape.py holds its gradients). On a scene
    without lights nee changes nothing: the capture and the replay equal
    the ones without it bit for bit."""
    _, _, tt, cfg = mixed_scene()
    assert tt.n_lights == 0
    pix, ro, rd = port_rays(tt, cfg)
    codes = ttape.capture_tape(tt, cfg, ro, rd, pix, 0, 0)
    c_nee = cfg.replace(nee=True, mis=True)
    assert torch.equal(ttape.capture_tape(tt, c_nee, ro, rd, pix, 0, 0),
                       codes)
    assert torch.equal(ttape.replay_tape(tt, c_nee, ro, rd, codes, pix, 0, 0),
                       ttape.replay_tape(tt, cfg, ro, rd, codes, pix, 0, 0))


@pytest.mark.parametrize("spp", [1, 3])
def test_tape_vg_matches_tape_loss(spp):
    """The death-sorted shrinking replay (forced to shrink: min_width 64
    of 384 lanes) against the full-width tape loss over the same capture
    (the plain version of B4 here)."""
    _, _, tt, cfg = mixed_scene(max_depth=6)
    px, py = (torch.from_numpy(x) for x in pixels())
    target = torch.from_numpy(np.random.RandomState(spp).rand(
        W * H, 3).astype(np.float32))
    fields = ("sph_center", "sph_radius", "mat_albedo", "mat_fuzz",
              "mat_ior", "tex_color")
    p = {f: getattr(tt, f).clone().requires_grad_(True) for f in fields}
    loss = ttape.make_tape_loss_fn(tt, cfg, spp, px, py, target,
                                   tape_engine="mega")(p)
    loss.backward()
    step = ttape.make_tape_vg(tt, cfg, px, py, target, min_width=64,
                              spp=spp)
    times = {}
    vl, vg = step({f: getattr(tt, f) for f in fields}, times=times)
    assert min(times["widths"]) < W * H  # the replay did shrink
    np.testing.assert_allclose(float(vl), float(loss.detach()), rtol=2e-4)
    for f in fields:
        a = p[f].grad
        assert bool(torch.isfinite(vg[f]).all()), f
        torch.testing.assert_close(vg[f], a, rtol=2e-3,
                                   atol=2e-4 * float(a.abs().max()) + 1e-12)


def test_fit_tape_loss_falls():
    """fit(method="tape") on the CPU from perturbed albedos and metal fuzz
    against the target rendered from the true scene on the same samples
    (make_tape_vg: this scene is a megakernel scene)."""
    _, _, tt, cfg = mixed_scene(max_depth=4)
    cfg = cfg.replace(samples_per_pixel=1)
    target = render(tt, cfg, device="cpu").numpy()
    init = {"mat_albedo": tt.mat_albedo * 0.7,
            "mat_fuzz": tt.mat_fuzz + 0.1}
    got, hist = tinverse.fit(tt, cfg, target, spp=1, steps=3,
                             learning_rate=0.02, init_params=init,
                             method="tape", device="cpu")
    assert len(hist) == 3 and np.isfinite(hist).all()
    assert hist[0] > hist[1] > hist[2], hist
    assert got["mat_fuzz"].shape == tuple(tt.mat_fuzz.shape)
