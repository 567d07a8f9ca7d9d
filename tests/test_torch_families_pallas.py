"""The plain versions of kernels B2, B3 and B7 on scenes with rects,
cylinders and triangles (rt_tpu_torch's ops/mega_plain closest_hit over
the four families, reached through cuda_mega.mega_trace,
cuda_queue.queue_trace and cuda_mega.mega_regen on CPU tensors) against
rt_tpu's Pallas kernels in interpret mode, as tests/test_mega.py runs
them on the CPU, with cull_chunks=False on rt_tpu's side (its chunk
culling sorts the sphere and the triangle chunks, ROADMAP C-3).

Per lane: the radiance within 1e-4 on >= 99% of lanes, as
tests/test_torch_mega.py holds the sphere scenes (XLA-CPU's sin, rsqrt,
exp and log round a few ulps from torch's, and an ulp that flips a
checker square or a grazing hit moves a lane by more); B7's sample
counter and alive word exactly on those lanes. Then the port's own
engines against its plain wavefront engine by images_close, the regen
frame against the mega frame bit for bit. The capture B4 and the
adjoints B5 / B6 on these scenes: tests/test_torch_families_tape.py,
test_torch_families_adjoint.py. The CUDA kernels are held against these
plain versions bit for bit on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt_tpu.ops import camera as jcamera
from rt_tpu.ops import pallas_mega as jmega
from rt_tpu.render import integrator as jintegrator
from rt_tpu_torch.ops import cuda_mega, cuda_queue, mega_plain, mega_tables
from rt_tpu_torch.render.renderer import render as trender
from test_torch_families import _scene

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's default of one thread per core in each of them
# oversubscribes the CPU many times over.
torch.set_num_threads(1)

W, H = 32, 18
SEED, BASE = 3, 5


@pytest.fixture(scope="module")
def demo():
    return _scene("demo", W, H, 2, 6)


@pytest.mark.parametrize("name", ["demo", "cover_lights", "mesh"])
def test_plain_b2_b3_match_pallas_mega_per_lane(name):
    """One sample's camera rays through rt_tpu's trace(engine="mega",
    cull_chunks=False) and the port's mega_trace and queue_trace (their
    plain versions on the CPU; the queue's step budget of 3 resumes
    lanes across launches)."""
    jt, cj, tt, cfg = _scene(name, W, H, 1, 6)
    cj = cj.replace(engine="mega", cull_chunks=False)
    cfg = cfg.replace(cull_chunks=False)
    px = np.tile(np.arange(W, dtype=np.int32), H)
    py = np.repeat(np.arange(H, dtype=np.int32), W)
    pix = (py * W + px).astype(np.uint32)
    jtd = jax.tree.map(jnp.asarray, jt)
    ro, rd = jcamera.generate_rays(jtd.camera, W, H, jnp.asarray(px),
                                   jnp.asarray(py), 1, SEED,
                                   cj.enable_defocus)
    rgb_j = np.asarray(jintegrator.trace(jtd, cj, ro, rd, jnp.asarray(pix),
                                         1, SEED))
    args = (torch.from_numpy(np.array(ro)), torch.from_numpy(np.array(rd)),
            torch.from_numpy(pix.astype(np.int64)), 1, SEED)
    mcfg = cfg.replace(engine="mega", compact_every=2, compact_group=8)
    launches = (cuda_mega.mega_segment.launches,
                cuda_queue.queue_launch.launches)
    rgb_m = cuda_mega.mega_trace(tt, mcfg, *args).numpy()
    rgb_q = cuda_queue.queue_trace(tt, cfg.replace(engine="queue",
                                                   queue_steps=3),
                                   *args, check_once=True).numpy()
    assert (cuda_mega.mega_segment.launches,
            cuda_queue.queue_launch.launches) == launches  # CPU: plain
    np.testing.assert_array_equal(rgb_q, rgb_m)
    ok = (np.abs(rgb_m - rgb_j) <= 1e-4).all(-1)
    assert ok.mean() >= 0.99, ok.mean()
    assert rgb_m.max() > 0


def _jax_regen(jt, cj, seg_iters, spp, depth):
    """rt_tpu's mega_regen over the frame's pixels (padded to its
    2048-lane tile with pixel 0), from an init segment."""
    cj = cj.replace(cull_chunks=False)
    (tbl, sph, rect, cyl, tri, sbnd, tbnd, sph_co, uv, atlas, counts,
     kw) = jmega._prep_scene(jt, cj)
    b = W * H
    bp = -(-b // jmega.RAY_TILE) * jmega.RAY_TILE
    pix = np.zeros(bp, np.int32)
    pix[:b] = np.arange(b)
    pix = jnp.asarray(pix)
    zeros = jnp.zeros((bp,), jnp.float32)
    zi = jnp.zeros((bp,), jnp.int32)
    st, samp, bvec = jmega.mega_regen(
        sph, rect, cyl, tri, sbnd, tbnd, sph_co, uv, atlas, counts,
        tbl.background, jmega.camera_vec(tbl.camera), (zeros,) * 13, pix,
        pix // W, zi, zi, jnp.int32(BASE), jnp.int32(SEED),
        jnp.int32(seg_iters), max_depth=depth, spp=spp, init=True,
        width=W, height=H, defocus=bool(cj.enable_defocus),
        exhaust_bg=cj.exhaust_mode == "background", **kw)
    rgb = np.stack([np.asarray(c)[:b] for c in st[9:12]], -1)
    return rgb, np.asarray(samp)[:b], np.asarray(st[12])[:b]


@pytest.mark.parametrize("name,seg_iters", [
    ("demo", 2 * 7), ("mesh", 2 * 7), ("cover_lights", 5)],
    ids=["demo_whole", "mesh_exhaust_whole", "cover_lights_capped"])
def test_plain_b7_matches_pallas_regen(name, seg_iters):
    spp, depth = 2, 6
    jt, cj, tt, cfg = _scene(name, W, H, spp, depth)
    cfg = cfg.replace(cull_chunks=False)  # _jax_regen's
    j_rgb, j_samp, j_alive = _jax_regen(jt, cj, seg_iters, spp, depth)
    b = W * H
    pix = torch.arange(b, dtype=torch.int32)
    state = torch.zeros((13, b))
    samp = torch.zeros(b, dtype=torch.int32)
    bvec = torch.zeros(b, dtype=torch.int32)
    before = cuda_mega.mega_regen.launches
    cuda_mega.mega_regen(
        tt.mega.table, tt.mega.cam, state, pix, pix // W, samp, bvec, BASE,
        SEED, seg_iters, max_depth=depth, spp=spp, init=True, width=W,
        height=H, defocus=cfg.enable_defocus,
        exhaust_bg=cfg.exhaust_mode == "background",
        **mega_plain.trace_options(tt, cfg))
    assert cuda_mega.mega_regen.launches == before
    t_rgb = state[mega_plain.C:mega_plain.C + 3].T.numpy()
    ok = ((np.abs(t_rgb - j_rgb) <= 1e-4).all(-1)
          & (samp.numpy() == j_samp)
          & (state[mega_plain.ALIVE].numpy() == j_alive))
    assert ok.mean() >= 0.99, ok.mean()
    assert t_rgb.max() > 0
    if name == "mesh":
        assert cfg.exhaust_mode == "background"


@pytest.mark.parametrize("engine,regen", [("mega", False), ("queue", False),
                                          ("mega", True)],
                         ids=["mega", "queue", "regen"])
def test_kernel_engines_match_plain_engine(demo, engine, regen,
                                           images_close):
    """render() on the megakernel engines (their plain versions here)
    against the wavefront plain engine: the same paths but for the
    megakernels' own rounding (o + t d for a cylinder's hit point,
    ROADMAP C-10; the family tie rule, C-9), by images_close."""
    _, _, tt, cfg = demo
    stats = {}
    img = trender(tt, cfg.replace(engine=engine, regen=regen),
                  device="cpu", stats=stats).numpy()
    ref = trender(tt, cfg, device="cpu").numpy()
    assert stats["launches"] > 0 and stats["ray_bounces"] > 0
    images_close(img, ref, spp=2)


@pytest.mark.parametrize("name", ["demo", "cover_lights"])
def test_regen_frame_equals_mega_frame(name):
    """B7's plain version renders the mega frame bit for bit, with the
    same ray-bounces, on a scene with rects and cylinders."""
    _, _, tt, cfg = _scene(name, 24, 16, 3, 6)
    cfg = cfg.replace(engine="mega")
    sm, sr = {}, {}
    mega = trender(tt, cfg, device="cpu", stats=sm)
    regen = trender(tt, cfg.replace(regen=True), device="cpu", stats=sr)
    assert torch.equal(regen, mega)
    assert sr["ray_bounces"] == sm["ray_bounces"] > 0


def test_closest_hit_family_tie_goes_to_the_later_family():
    """An equal t across families goes to the later family (`_merge`),
    within a family to the larger row: a rect and a triangle in one
    plane, the triangle after the rect in family order, and a duplicate
    rect row."""
    from rt_tpu_torch.scene.types import SceneDef, build_tables

    s = SceneDef(width=4, height=4)
    m = s.add_lambertian_color((0.5, 0.5, 0.5))
    s.add_rect("xy_rect", -1, 1, -1, 1, -2, m)
    s.add_rect("xy_rect", -1, 1, -1, 1, -2, m)
    s.add_triangle((-3, -3, -2), (3, -3, -2), (0, 3, -2), m)
    s.set_camera((0, 0, 1), (0, 0, -1), (0, 1, 0), 60, 0.0)
    tt = build_tables(s)
    o = torch.zeros((2, 3))
    d = torch.tensor([[0.1, 0.1, -1.0], [0.0, -0.5, -1.0]])
    t, fam, row = mega_plain.closest_hit(
        tt.mega.table, *o.T, *d.T, 1e-3, tt.mega.fam)
    assert torch.isfinite(t).all()
    assert fam.tolist() == [mega_plain.FAM_TRIANGLE] * 2
    assert row.tolist() == [0, 0]
    s.objects.pop()  # without the triangle: the larger rect row
    tt = build_tables(s)
    t, fam, row = mega_plain.closest_hit(
        tt.mega.table, *o.T, *d.T, 1e-3, tt.mega.fam)
    assert fam.tolist() == [mega_plain.FAM_RECT] * 2
    assert row.tolist() == [1, 1]


def test_sphere_scenes_keep_the_sphere_only_tables(demo):
    """A sphere-only scene has no family tables, so its launches take
    the kernels' sphere-only instantiation; a family scene has all
    three, cut to their live rows."""
    from rt_tpu_torch.scene import builders, types

    _, _, tt, cfg = demo
    assert [t.shape[0] for t in tt.mega.fam] == [1, 1, 0]
    assert mega_plain.trace_options(tt, cfg)["fam"] is \
        mega_tables.scene_for(tt, cfg).fam
    dna = _scene("dna", 8, 8, 1, 2)[2]
    assert [t.shape[0] for t in dna.mega.fam] == [0, 30, 0]
    cover = types.build_tables(builders.cover_scene(grid=1)[0])
    assert cover.mega.fam is None and not cover.has_families
    assert mega_tables.mega_supported(cover)
    assert mega_plain.trace_options(cover, cfg)["fam"] is None
