"""rt_tpu_torch's path-replay backward on the CPU (ops/adjoint_plain: the
plain version of the adjoint kernels B5 and B6, reached through
diff/replay.make_replay_loss_fn with engine "queue" and "mega") against
rt_tpu's make_replay_loss_fn on the same scene, pixels, target and
parameters.

The reference here is rt_tpu's XLA per-bounce replay (bwd_kernel=False,
its forward on engine "xla"); tests/test_torch_adjoint_pallas.py holds
the same against rt_tpu's Pallas adjoint kernels. Tolerance per field: |a - b| <= 1e-5 + 1e-3 max|a|, the reference's own
between its replay and its kernels (tests/test_diff.py:567, 886). The
port replays with the megakernels' bounce, whose unit ball
(exp(log u / 3)) and Schlick product round otherwise than the XLA
wavefront's, so an ulp can move a rare path; and sums are taken in
another order. The CUDA kernels are held against adjoint_plain on the
card by tests/test_torch_cuda.py."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rt_tpu.config import RenderConfig as JConfig
from rt_tpu.diff.replay import make_replay_loss_fn as jreplay_loss
from rt_tpu.scene.types import SceneDef, build_tables
from rt_tpu_torch.config import RenderConfig
from rt_tpu_torch.diff import replay as treplay
from rt_tpu_torch.ops import adjoint_plain, camera, cuda_mega, cuda_queue
from rt_tpu_torch.ops import mega_tables
from rt_tpu_torch.scene.convert import params_from_numpy, tables_from_numpy

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's default of one thread per core in each of them
# oversubscribes the CPU many times over.
torch.set_num_threads(1)

FIELDS = ("tex_color", "tex_color2", "mat_albedo", "background")


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


def make_scene(w, h, depth, seed=5, background="constant"):
    """A light sphere, a checker ground, lambertian, metal and dielectric
    spheres, with seeded colours: rt_tpu's tables and config, and the
    port's, carried across."""
    rs = np.random.RandomState(seed)
    s = SceneDef(width=w, height=h, samples_per_pixel=2, max_depth=depth,
                 background=tuple(rs.uniform(0.3, 0.7, 3)))
    s.add_sphere((0, 0, -1.5), 0.5,
                 s.add_lambertian_color(tuple(rs.uniform(0.2, 0.9, 3))))
    s.add_sphere((-1.1, 0, -1.5), 0.5,
                 s.add_metal(tuple(rs.uniform(0.5, 0.9, 3)), 0.2))
    s.add_sphere((1.1, 0, -1.5), 0.5, s.add_dielectric(1.5))
    ck = s.add_checker(tuple(rs.uniform(0.6, 0.9, 3)),
                       tuple(rs.uniform(0.1, 0.3, 3)))
    s.add_sphere((0, -100.5, -1.5), 100, s.add_lambertian(ck))
    s.add_sphere((0.45, 0.75, -1.9), 0.3,
                 s.add_diffuse_light_color(tuple(rs.uniform(2, 4, 3))))
    s.set_camera((0, 0.3, 1.2), (0, 0, -1.5), (0, 1, 0), 55, 0.0)
    jcfg = JConfig(width=w, height=h, samples_per_pixel=2, max_depth=depth,
                   loop="while", cull_chunks=False,
                   background_mode=background)
    jt = build_tables(s)
    tt = tables_from_numpy(jax_leaves(jt))
    cfg = RenderConfig(**{**dataclasses.asdict(jcfg), "engine": "plain"})
    return jt, jcfg, tt, cfg


def jparams(jt):
    return {k: jnp.asarray(getattr(jt, k), jnp.float32) for k in FIELDS}


def pixels(w, h):
    pix = np.arange(w * h, dtype=np.int32)
    return pix % w, pix // w


def assert_grads_close(want, got, label):
    """Per field: max |want - got| <= 1e-5 + 1e-3 max|want| (see the
    module doc)."""
    for k in FIELDS:
        a = np.asarray(want[k], np.float64)
        b = got[k].detach().numpy().astype(np.float64)
        assert a.shape == b.shape, (label, k)
        mag = max(np.abs(a).max(), 1e-12)
        err = np.abs(a - b).max()
        assert err <= 1e-5 + 1e-3 * mag, (label, k, err, mag)


def port_grads(tt, cfg, px, py, tgt, params, spp=2, **kw):
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss = treplay.make_replay_loss_fn(tt, cfg, spp, torch.from_numpy(px),
                                       torch.from_numpy(py),
                                       torch.from_numpy(tgt), **kw)(p)
    loss.backward()
    return float(loss.detach()), {k: v.grad for k, v in p.items()}


VARIANTS = {"exact": ({}, {}),
            "trunc3": ({}, {"bwd_depth": 3}),
            "exhaust": ({"exhaust_mode": "background", "max_depth": 3}, {})}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("engine", ["queue", "mega"])
def test_plain_adjoint_matches_xla_replay(engine, variant):
    """The port's replay (engine queue / mega; on the CPU the plain
    adjoint) against rt_tpu's XLA per-bounce replay, at 32x24, depth 6,
    spp 2, on every ported field."""
    jt, jcfg, tt, cfg = make_scene(32, 24, 6)
    over, kw = VARIANTS[variant]
    jcfg, cfg = jcfg.replace(**over), cfg.replace(**over)
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
    # every kind of slot took a cotangent: the light's emission, the
    # checker's odd colour, the materials and the sky
    for k in FIELDS:
        assert float(gt[k].abs().max()) > 0.0, k


def _one_sample(w=24, h=16, depth=5, **over):
    _, _, tt, cfg = make_scene(w, h, depth, seed=3)
    cfg = cfg.replace(**over)
    pix = torch.arange(w * h)
    ro, rd = camera.generate_rays(tt.camera, w, h, pix % w, pix // w, 0, 0,
                                  cfg.enable_defocus)
    L = cuda_queue.queue_trace(tt, cfg, ro, rd, pix, 0, 0)
    g = torch.from_numpy(np.random.RandomState(4).normal(
        0, 1, (w * h, 3)).astype(np.float32))
    return tt, cfg, ro, rd, pix, L, g


def test_adjoint_routes_and_layout():
    """Both wrappers take the plain version for CPU tensors and launch no
    kernel; they give one gradient dict of the reference's shapes; the
    gradient sky takes no background gradient."""
    tt, cfg, ro, rd, pix, L, g = _one_sample()
    before = (cuda_mega.mega_adjoint_segment.launches,
              cuda_queue.queue_adjoint_launch.launches)
    stats = {}
    gm = cuda_mega.mega_trace_adjoint(tt, cfg, ro, rd, pix, 0, 0, L, g, 5,
                                      False, stats=stats)
    gq = cuda_queue.queue_trace_adjoint(tt, cfg, ro, rd, pix, 0, 0, L, g, 5,
                                        False)
    assert (cuda_mega.mega_adjoint_segment.launches,
            cuda_queue.queue_adjoint_launch.launches) == before
    assert stats["ray_bounces"] >= ro.shape[0]
    for k in FIELDS:
        assert gm[k].shape == getattr(tt, k).shape, k
        assert torch.equal(gm[k], gq[k]), k
    ms = tt.mega
    assert ms.n_slots == tt.tex_color.shape[0] + tt.mat_albedo.shape[0]
    sky = cfg.replace(background_mode="gradient")
    gs = cuda_mega.mega_trace_adjoint(tt, sky, ro, rd, pix, 0, 0, L, g, 5,
                                      False)
    assert torch.equal(gs["background"], torch.zeros(3))


def test_adjoint_lane_sums_match_autograd_per_sample():
    """One sample's plain adjoint equals autograd of sum(g * L) through
    the port's own plain engine (same pixels, same RNG streams) within
    the module's tolerance: the suffix identity on this package alone."""
    tt, cfg, ro, rd, pix, _, g = _one_sample(engine="plain")
    params = {k: getattr(tt, k).clone().requires_grad_(True) for k in FIELDS}
    from rt_tpu_torch.diff.inverse import apply_params
    from rt_tpu_torch.render.integrator import trace

    tbl = apply_params(tt, params)
    L = trace(tbl, cfg, ro, rd, pix, 0, 0)
    (g * L).sum().backward()
    got = adjoint_plain.trace_adjoint_plain(tt, cfg, ro, rd, pix, 0, 0,
                                            L.detach(), g, cfg.max_depth,
                                            False)
    assert_grads_close({k: params[k].grad.numpy() for k in FIELDS}, got,
                       "autograd")


def test_slot_column_routes_textures_then_materials():
    """A textured sphere's slot is its texture row; an untextured one's is
    n_tex + its material row (pallas_mega._slot_ids)."""
    _, _, tt, _ = make_scene(8, 6, 2)
    tab = tt.mega.table
    slot = tab[:, mega_tables.X_SLOT].long()
    mat = tt.sph_mat[:tt.n_spheres].long()
    tex = tt.mat_tex[mat].long()
    want = torch.where(tex >= 0, tex, tt.tex_color.shape[0] + mat)
    assert torch.equal(slot, want)
    assert int(slot.max()) < tt.mega.n_slots


# the ids are the ones these cases had while geometry fields and the image
# atlas raised NotImplementedError; now a GEOM_FIELDS entry outside
# geom_spec is a ValueError, as in the reference, and "images" is taken
# (err None: the replay runs and its gradient has the atlas's shape)
@pytest.mark.parametrize("field,err", [
    pytest.param("images", None, id="images-NotImplementedError"),
    pytest.param("sph_center", ValueError,
                 id="sph_center-NotImplementedError"),
    pytest.param("mat_fuzz", ValueError, id="mat_fuzz-NotImplementedError"),
    pytest.param("camera", ValueError, id="camera-ValueError")])
def test_replay_rejects_unported_fields(field, err):
    _, _, tt, cfg = make_scene(8, 6, 2)
    img_fn = treplay.make_replay_render(tt, cfg, 1, torch.arange(4),
                                        torch.zeros(4, dtype=torch.long))
    if err is None:
        p = getattr(tt, field).clone().requires_grad_(True)
        img_fn({field: p}).sum().backward()
        assert p.grad.shape == p.shape and bool(torch.isfinite(p.grad).all())
        return
    with pytest.raises(err):
        img_fn({field: torch.zeros(3)})


def test_replay_rejects_tangents_and_nee():
    """geom_spec runs (tests/test_torch_geom.py) but refuses a field
    outside GEOM_FIELDS, a component outside its table, and a geom_spec
    field missing from params. NEE runs (tests/test_torch_nee_adjoint.py),
    but with mis or nee_glossy the replay refuses it with ValueError, as
    the reference's does (rt_tpu/diff/replay.py:204-210)."""
    _, _, tt, cfg = make_scene(8, 6, 2)
    px = torch.arange(4)
    with pytest.raises(ValueError, match="GEOM_FIELDS|must be in"):
        treplay.make_replay_render(tt, cfg, 1, px, px,
                                   geom_spec={"tex_color": [(0, 0)]})
    with pytest.raises(ValueError, match="out of bounds"):
        treplay.make_replay_render(tt, cfg, 1, px, px,
                                   geom_spec={"sph_center": [(0, 3)]})
    img_fn = treplay.make_replay_render(tt, cfg, 1, px, px,
                                        geom_spec={"sph_center": [(0, 0)]})
    with pytest.raises(ValueError, match="not in params"):
        img_fn({"tex_color": tt.tex_color})
    assert tt.n_lights == 1
    treplay.make_replay_render(tt, cfg.replace(nee=True), 1, px, px)
    for kw in (dict(mis=True), dict(nee_glossy=True)):
        with pytest.raises(ValueError, match="mis / nee_glossy"):
            treplay.make_replay_render(tt, cfg.replace(nee=True, **kw), 1,
                                       px, px)


def test_check_table_takes_large_tables():
    """ROADMAP C-7: the kernels stage the first rows in shared memory and
    read the rest from global memory, so the wrappers take tables past
    the old 11,622-row refusal."""
    tab = torch.zeros((12_500, mega_tables.S_COLS))
    cuda_mega.check_table(tab, torch.device("cpu"))
    with pytest.raises(ValueError):
        cuda_mega.check_table(tab[:0], torch.device("cpu"))
