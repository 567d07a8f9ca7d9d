"""rt_tpu_torch's regeneration path (ops/cuda_mega.mega_trace_regen,
regen_schedule and mega_regen; ops/mega_plain.regen_plain, the plain
version of kernel B7; ops/camera.camera_vec; the regen branch of
render/renderer.render) against the port's per-sample megakernel render
and rt_tpu's render(regen=True).

On the CPU mega_regen runs its plain version. Every operation of it is
elementwise per lane and draws at the per-sample launches' RNG
coordinates, and a path adds at most one non-zero term to its pixel's
sum, so the regen image equals the per-sample image bit for bit
(assert_array_equal), as do the segment schedules, group sizes and
shrinking among themselves. Against rt_tpu (its Pallas regen kernel in
interpret mode, as tests/test_mega.py runs it) the images are held by
images_close: XLA-CPU's sin, cos and rsqrt round differently by ulps,
which a flipped path amplifies. The CUDA kernel is held against the
plain version on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt_tpu.ops import pallas_mega as jmega
from rt_tpu.render import renderer as jrenderer
from rt_tpu.scene import builders as jbuilders
from rt_tpu.scene import types as jtypes
from rt_tpu_torch.config import RenderConfig, check_supported
from rt_tpu_torch.ops import camera, cuda_mega, mega_plain, mega_tables
from rt_tpu_torch.render import renderer as trenderer
from rt_tpu_torch.scene import builders as tbuilders
from rt_tpu_torch.scene import types as ttypes

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's default of one thread per core in each of them
# oversubscribes the CPU many times over.
torch.set_num_threads(1)


def open_lens(sdef, aperture=0.2):
    """The Cornell scene's camera with an open lens (its own has none),
    so its regen cases draw the defocus disk."""
    p = sdef.camera_params
    sdef.set_camera(p["lookfrom"], p["lookat"], p["vup"], p["vfov"],
                    aperture, focus_dist=5.0)
    return sdef


def _scene(name, jax_too=False, **size):
    """(port tables, port cfg with engine "mega"[, rt_tpu tables, cfg])
    of cover_scene(grid=3) or the Cornell scene with an open lens."""
    fn, kw = {"cover": ("cover_scene", dict(grid=3)),
              "cornell": ("cornell_spheres_scene", {})}[name]
    st, _ = getattr(tbuilders, fn)(**kw, **size)
    sj, cj = getattr(jbuilders, fn)(**kw, **size)
    if name == "cornell":
        open_lens(st)
        open_lens(sj)
        cj = cj.replace(enable_defocus=True)
    cj = cj.replace(engine="mega")
    cfg = RenderConfig(**{**dataclasses.asdict(cj), "engine": "mega"})
    out = (ttypes.build_tables(st), cfg)
    return out + (jtypes.build_tables(sj), cj) if jax_too else out


REGEN_CASES = {
    "cover": ("cover", dict(width=48, height=27, spp=4, max_depth=8), {},
              0),
    "cornell_lens": ("cornell", dict(width=48, height=36, spp=4,
                                     max_depth=6), {}, 0),
    "cover_rr_exhaust_offset": ("cover", dict(width=48, height=27, spp=4,
                                              max_depth=8),
                                dict(p_rr=0.9, exhaust_mode="background"),
                                3),
}


@pytest.mark.parametrize("case", sorted(REGEN_CASES))
def test_regen_render_equals_mega_render(case):
    """render(engine="mega", regen=True) is the per-sample megakernel
    render bit for bit, with the same ray-bounces, in one launch."""
    name, size, extra, offset = REGEN_CASES[case]
    tt, cfg = _scene(name, **size)
    cfg = cfg.replace(**extra)
    st_m, st_r = {}, {}
    want = trenderer.render(tt, cfg, sample_offset=offset, device="cpu",
                            stats=st_m)
    before = cuda_mega.mega_regen.launches
    got = trenderer.render(tt, cfg.replace(regen=True), sample_offset=offset,
                           device="cpu", stats=st_r)
    assert cuda_mega.mega_regen.launches == before  # CPU: plain version
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert bool(torch.isfinite(got).all()) and float(got.max()) > 0.0
    assert st_r["launches"] == 1
    assert st_m["launches"] == size["spp"]
    assert st_r["ray_bounces"] == st_m["ray_bounces"] > 0
    if name == "cornell":
        assert float(got.max()) > size["spp"]  # the lights were hit


@pytest.fixture(scope="module")
def compact_scene():
    """48x32 in tiles of 512 pixels, and its one-segment regen image."""
    tt, cfg = _scene("cover", width=48, height=32, spp=3, max_depth=6)
    cfg = cfg.replace(regen=True, rays_per_batch=1 << 9)
    return tt, cfg, trenderer.render(tt, cfg, device="cpu").numpy()


@pytest.mark.parametrize("shrink", [True, False], ids=["shrink", "full"])
@pytest.mark.parametrize("group", [16, 32, 128])
@pytest.mark.parametrize("every", [-1, 5, 2])
def test_regen_compaction_is_invisible(compact_scene, every, group, shrink):
    """Segments capped by regen_compact, the partition of pending groups
    between them and the shrunken prefix leave every pixel's bits as
    they are (tests/test_mega.py:325)."""
    tt, cfg, whole = compact_scene
    stats = {}
    got = trenderer.render(tt, cfg.replace(regen_compact=every,
                                           compact_group=group,
                                           regen_shrink=shrink),
                           device="cpu", stats=stats)
    np.testing.assert_array_equal(got.numpy(), whole)
    assert stats["launches"] > 3  # three tiles, some with several segments


def test_regen_is_ignored_by_other_engines():
    """regen=True with engine "queue" is the queue render, as in the
    reference (regen applies to engine "mega" only)."""
    tt, cfg = _scene("cover", width=32, height=18, spp=2, max_depth=6)
    cfg = cfg.replace(engine="queue")
    want = trenderer.render(tt, cfg, device="cpu")
    before = cuda_mega.mega_regen.launches
    got = trenderer.render(tt, cfg.replace(regen=True), device="cpu")
    assert torch.equal(got, want)
    assert cuda_mega.mega_regen.launches == before


def test_regen_config_is_supported():
    check_supported(RenderConfig(engine="mega", regen=True, regen_compact=-1))
    check_supported(RenderConfig(engine="mega", regen=True,
                                 compact_sort="spatial"))
    # the BVH is taken, as rt_tpu takes it; B7 reads none
    # (tests/test_torch_bvh_cli.py renders it)
    check_supported(RenderConfig(engine="mega", regen=True,
                                 compact_sort="spatial", traversal="bvh"))


@pytest.mark.parametrize("name", ["cover", "cornell"])
def test_regen_render_matches_jax_regen(name, images_close):
    """The port's regen render against rt_tpu's render(regen=True)
    (tests/test_mega.py:304, 338): images_close."""
    size = (dict(width=48, height=27, spp=4, max_depth=8) if name == "cover"
            else dict(width=48, height=36, spp=4, max_depth=6))
    tt, cfg, jt, cj = _scene(name, jax_too=True, **size)
    want = np.asarray(jrenderer.render(jt, cj.replace(regen=True)))
    got = trenderer.render(tt, cfg.replace(regen=True), device="cpu").numpy()
    images_close(got, want, spp=size["spp"])


def test_camera_vec_matches_jax():
    """The 19 floats the kernel takes are rt_tpu's camera_vec, bit for
    bit, and camera_of_vec gives the camera back."""
    st, _ = tbuilders.cover_scene(width=32, height=18)
    sj, _ = jbuilders.cover_scene(width=32, height=18)
    tt = ttypes.build_tables(st)
    jt = jax.tree.map(jnp.asarray, jtypes.build_tables(sj))
    want = np.asarray(jmega.camera_vec(jt.camera))
    got = np.array(camera.camera_vec(tt.camera), np.float32)
    np.testing.assert_array_equal(got, want)
    assert tt.mega.cam == camera.camera_vec(tt.camera)
    back = camera.camera_of_vec(tt.mega.cam, "cpu")
    for f in camera.CAMERA_FIELDS:
        assert torch.equal(getattr(back, f), getattr(tt.camera, f)), f


GRID = [(spp, depth, every, growth)
        for spp in (1, 4, 8, 16) for depth in (1, 2, 8, 50)
        for every in (-1, 0, 1, 3, 7, 24, 1000) for growth in (2, 4)]


@pytest.mark.parametrize("spp,depth,every,growth", GRID[::7] + [
    (8, 50, -1, 2), (8, 50, 0, 2), (4, 50, 7, 2), (1, 2, -1, 2),
    (16, 50, -1, 4)])
def test_regen_schedule_matches_reference(spp, depth, every, growth):
    """regen_schedule is pallas_mega.regen_schedule, with the reference's
    own assertions (tests/test_mega.py:367-373) on every case."""
    got = cuda_mega.regen_schedule(spp, depth, every, growth=growth)
    assert got == jmega.regen_schedule(spp, depth, every, growth=growth)
    total = spp * (depth + 1)
    assert sum(got) == total and all(s > 0 for s in got)
    if every == 0 or every >= total:
        assert got == [total]
    elif every > 0:
        assert got[:-1] == [every] * (len(got) - 1)
    else:
        assert got[0] == min(total, (5 if growth == 4 else 3) * spp)


def test_regen_schedule_reference_cases():
    assert cuda_mega.regen_schedule(8, 50, 0) == [8 * 51]
    assert sum(cuda_mega.regen_schedule(8, 50, -1)) == 8 * 51
    assert sum(cuda_mega.regen_schedule(4, 50, 7)) == 4 * 51
    assert cuda_mega.regen_schedule(8, 50, -1)[0] == 24  # 3*spp head
    assert cuda_mega.regen_schedule(1, 2, -1) == [3]     # clamps to total


def _lanes(cfg):
    """Fresh regen operands over every pixel of cfg's frame."""
    w, h = cfg.width, cfg.height
    pix = torch.arange(w * h, dtype=torch.int32)
    b = pix.shape[0]
    return dict(state=torch.zeros((13, b)), pixel=pix, py=pix // w,
                samp=torch.zeros(b, dtype=torch.int32),
                bvec=torch.zeros(b, dtype=torch.int32))


def test_resumed_segments_equal_one_segment():
    """A segment capped at a few iterations, then resumed (init only at
    the first), ends in the state, samp and bvec of one uncapped
    segment, and its per-lane bounce counts add up to the same."""
    tt, cfg = _scene("cornell", width=24, height=18, spp=3, max_depth=6)
    kw = dict(max_depth=6, spp=3, width=24, height=18, defocus=True,
              **mega_plain.trace_options(tt, cfg))
    ms = mega_tables.scene_for(tt, cfg)
    tab, cam = ms.table, ms.cam
    one = _lanes(cfg)
    d_one = torch.zeros(24 * 18, dtype=torch.int32)
    cuda_mega.mega_regen(tab, cam, one["state"], one["pixel"], one["py"],
                         one["samp"], one["bvec"], 2, 5, 3 * 7, init=True,
                         depth=d_one, **kw)
    parts = _lanes(cfg)
    d_parts = torch.zeros(24 * 18, dtype=torch.int32)
    for i, seg in enumerate((2, 1, 4, 3 * 7)):
        cuda_mega.mega_regen(tab, cam, parts["state"], parts["pixel"],
                             parts["py"], parts["samp"], parts["bvec"], 2, 5,
                             seg, init=i == 0, depth=d_parts, **kw)
    done = one["state"][mega_plain.ALIVE] == 0.0
    assert bool(done.all()) and bool((one["samp"] == 4).all())
    assert torch.equal(parts["state"], one["state"])
    assert torch.equal(parts["samp"], one["samp"])
    assert torch.equal(parts["bvec"], one["bvec"])
    assert torch.equal(d_parts, d_one) and int(d_one.sum()) > 24 * 18 * 3


def test_init_segment_makes_generate_rays_camera_rays():
    """A zero-iteration init segment leaves each lane at sample_base's
    camera ray (ops/camera.generate_rays) with throughput 1, radiance 0,
    alive; seg_iters 0 without init changes nothing."""
    tt, cfg = _scene("cover", width=20, height=12, spp=2, max_depth=4)
    kw = dict(max_depth=4, spp=2, width=20, height=12, defocus=True,
              **mega_plain.trace_options(tt, cfg))
    ln = _lanes(cfg)
    cuda_mega.mega_regen(tt.mega.table, tt.mega.cam, ln["state"],
                         ln["pixel"], ln["py"], ln["samp"], ln["bvec"], 7, 3,
                         0, init=True, **kw)
    pix = ln["pixel"].long()
    ro, rd = camera.generate_rays(tt.camera, 20, 12, pix % 20, pix // 20, 7,
                                  3, True)
    assert torch.equal(ln["state"], mega_plain.fresh_state(ro, rd))
    assert bool((ln["samp"] == 7).all()) and bool((ln["bvec"] == 0).all())
    before = ln["state"].clone()
    cuda_mega.mega_regen(tt.mega.table, tt.mega.cam, ln["state"],
                         ln["pixel"], ln["py"], ln["samp"], ln["bvec"], 7, 3,
                         0, init=False, **kw)
    assert torch.equal(ln["state"], before)


def test_plain_regen_route_and_checks():
    """mega_trace_regen(plain=True) is the routed CPU call's result; the
    wrapper refuses another device type before it reaches a kernel."""
    tt, cfg = _scene("cover", width=16, height=9, spp=2, max_depth=4)
    pix = torch.arange(16 * 9)
    a = cuda_mega.mega_trace_regen(tt, cfg, pix, pix // 16, 0, 2)
    b = cuda_mega.mega_trace_regen(tt, cfg, pix, pix // 16, 0, 2, plain=True)
    assert torch.equal(a, b) and a.shape == (16 * 9, 3)
    ln = _lanes(cfg)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_mega.mega_regen(tt.mega.table, tt.mega.cam,
                             ln["state"].to("meta"), ln["pixel"], ln["py"],
                             ln["samp"], ln["bvec"], 0, 0, 1, max_depth=4,
                             spp=2, init=True, width=16, height=9,
                             defocus=True, bg=tt.mega.bg)
