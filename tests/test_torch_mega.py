"""rt_tpu_torch's megakernel path (ops/mega_tables, ops/mega_plain,
ops/cuda_mega: kernel B2's plain versions and the segmented trace)
against rt_tpu's engine="mega" on the same inputs.

The JAX side runs as its own tests run it on the CPU: mega_trace with the
Pallas kernel in interpret mode. Per-lane comparisons use cull_chunks=False
on the reference (its Morton-sorted table may pick another sphere on an
exact-t tie, ROADMAP C-3). The CUDA kernel itself is held against these
plain versions on the card by tests/test_torch_cuda.py."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rt_tpu.ops import camera as jcamera
from rt_tpu.ops import pallas_mega as jmega
from rt_tpu.render import integrator as jintegrator
from rt_tpu.scene import builders as jbuilders
from rt_tpu.scene import types as jtypes
from rt_tpu_torch.config import RenderConfig
from rt_tpu_torch.ops import cuda_mega, mega_plain, mega_tables
from rt_tpu_torch.ops import rng as trng
from rt_tpu_torch.render import renderer as trenderer
from rt_tpu_torch.scene import builders as tbuilders
from rt_tpu_torch.scene import types as ttypes

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's default of one thread per core in each of them
# oversubscribes the CPU many times over.
torch.set_num_threads(1)

SCENES = {"three_sphere": ("three_sphere_scene", {}),
          "cover_grid3": ("cover_scene", dict(grid=3)),
          "cornell": ("cornell_spheres_scene", {})}


def _scene(name, **size):
    fn, kw = SCENES[name]
    sj, cj = getattr(jbuilders, fn)(**kw, **size)
    st, _ = getattr(tbuilders, fn)(**kw, **size)
    return jtypes.build_tables(sj), cj, ttypes.build_tables(st)


def _port_cfg(cj, **kw):
    return RenderConfig(**{**dataclasses.asdict(cj), **kw})


@pytest.mark.parametrize("name", sorted(SCENES))
def test_sphere_table_matches_jax(name):
    """The packed table equals rt_tpu's sphere_table + _pad_chunked on
    every kept column (0..16, and the gradient slot, the reference's
    column 31), bit for bit."""
    jt, _, tt = _scene(name, width=16, height=9, spp=1, max_depth=2)
    ref = np.asarray(jmega._pad_chunked(
        jmega.sphere_table(jax.tree.map(jnp.asarray, jt)), jmega.SPH_CHUNK))
    got = mega_tables.sphere_table(tt)
    assert got.dtype == torch.float32
    assert got.shape == (ref.shape[0], mega_tables.S_COLS)
    kept = list(range(mega_tables.X_SLOT)) + [jmega._SLOT_COL]
    np.testing.assert_array_equal(got.numpy(), ref[:, kept])
    assert mega_tables.mega_supported(tt)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_mega_scene_is_the_live_prefix_built_once(name):
    """What the kernels read: the packed table's live rows (pad rows
    follow them and never hit) and the sky as host floats, built once
    per SceneTables."""
    _, _, tt = _scene(name, width=16, height=9, spp=1, max_depth=2)
    ms = tt.mega
    assert tt.mega is ms
    full = mega_tables.sphere_table(tt)
    assert ms.table.shape == (tt.n_spheres, mega_tables.S_COLS)
    assert torch.equal(ms.table, full[:tt.n_spheres])
    assert bool((ms.table[:, mega_tables.S_VALID] == 1.0).all())
    assert bool((full[tt.n_spheres:, mega_tables.S_VALID] == 0.0).all())
    assert ms.bg == tuple(float(v) for v in tt.background.tolist())
    assert all(type(v) is float for v in ms.bg)


def test_pad_chunked_pads_to_whole_chunks():
    tab = torch.ones((40, mega_tables.S_COLS))
    out = mega_tables.pad_chunked(tab)
    assert out.shape[0] == 64 and bool((out[40:] == 0).all())
    assert mega_tables.pad_chunked(tab[:20]).shape[0] == 20


def _words(n, seed):
    rs = np.random.default_rng(seed)
    edge = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint64)
    return np.concatenate([edge, rs.integers(0, 2**32, n, dtype=np.uint64)]
                          ).astype(np.uint32)


def test_rng_twins_match_jax_mega():
    """The megakernel's hash, uniform and unit ball (pallas_mega._key /
    _uniform / _unit_ball on int32 words) against the port's twins: the
    hash bits and uniforms exactly; the unit-ball coordinates within one
    ulp of 1.0 (2^-23), since the reference's exp, log, cos and sin are
    XLA's own approximations (relative ulps near 0 are larger)."""
    seed, pix, smp, bnc = (_words(20000, s) for s in range(4))

    def j(x):
        return jnp.asarray(x.view(np.int32))

    def t(x):
        return torch.from_numpy(x.astype(np.int64))

    purpose = jnp.full(pix.shape, trng.SCAT_U1, jnp.int32)
    kj = np.asarray(jmega._key(j(seed), j(pix), j(smp), j(bnc), purpose))
    kt = trng.key(t(seed), t(pix), t(smp), t(bnc), trng.SCAT_U1).numpy()
    np.testing.assert_array_equal(kt.astype(np.uint32), kj.view(np.uint32))
    for purpose in (trng.RR, trng.DIEL_REFL, trng.SCAT_U3):
        uj = np.asarray(jmega._uniform(j(seed), j(pix), j(smp), j(bnc),
                                       purpose))
        ut = trng.uniform(t(seed), t(pix), t(smp), t(bnc),
                          purpose).numpy()
        np.testing.assert_array_equal(ut, uj)
    bj = jmega._unit_ball(j(seed), j(pix), j(smp), j(bnc))
    bt = mega_plain.unit_ball(t(seed), t(pix), t(smp), t(bnc))
    for a, b in zip(bj, bt):
        assert b.dtype == torch.float32
        assert np.abs(b.numpy() - np.asarray(a)).max() <= 2.0 ** -23


# (scene, size, extra config, per-lane fraction within 1e-4). The
# fractions are measured here with margin: three_sphere and cornell
# agree bit for bit per lane; the cover scene's gradient sky (rsqrt) and
# checker (sin) round differently in XLA's CPU code by ulps, and an ulp
# that flips a checker square or a grazing hit moves a lane by more
# (0.4% of lanes beyond 1e-4).
CASES = {
    "three_sphere": ("three_sphere", dict(width=32, height=18, spp=2,
                                          max_depth=8), {}, 0.999),
    "cover_grid3": ("cover_grid3", dict(width=48, height=27, spp=2,
                                        max_depth=6), {}, 0.99),
    "cornell_rr": ("cornell", dict(width=24, height=24, spp=2,
                                   max_depth=6), {}, 0.999),
    "cover_exhaust_bg": ("cover_grid3", dict(width=48, height=27, spp=2,
                                             max_depth=6),
                         dict(exhaust_mode="background"), 0.99),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_mega_trace_matches_jax_mega(case, images_close):
    """Each sample's camera rays through rt_tpu's trace(engine="mega",
    cull_chunks=False) and the port's mega_trace (the plain segment on
    the CPU): per-lane radiance, then the summed image by images_close."""
    name, size, extra, frac = CASES[case]
    jt, cj, tt = _scene(name, **size)
    cj = cj.replace(cull_chunks=False, **extra)
    w, h, spp = size["width"], size["height"], size["spp"]
    px = np.tile(np.arange(w, dtype=np.int32), h)
    py = np.repeat(np.arange(h, dtype=np.int32), w)
    pix = (py * w + px).astype(np.uint32)
    jtd = jax.tree.map(jnp.asarray, jt)
    img_j = np.zeros((w * h, 3), np.float32)
    img_t = np.zeros((w * h, 3), np.float32)
    for s in range(spp):
        ro, rd = jcamera.generate_rays(jtd.camera, w, h, jnp.asarray(px),
                                       jnp.asarray(py), s, 0,
                                       cj.enable_defocus)
        rgb_j = np.asarray(jintegrator.trace(
            jtd, cj.replace(engine="mega"), ro, rd, jnp.asarray(pix), s, 0))
        rgb_t = cuda_mega.mega_trace(
            tt, _port_cfg(cj, engine="mega"), torch.from_numpy(np.array(ro)),
            torch.from_numpy(np.array(rd)),
            torch.from_numpy(pix.astype(np.int64)), s, 0).numpy()
        diff = np.abs(rgb_t - rgb_j).max(-1)
        assert np.mean(diff <= 1e-4) >= frac, np.mean(diff <= 1e-4)
        img_j += rgb_j
        img_t += rgb_t
    assert np.isfinite(img_t).all()
    if name == "cornell":
        assert img_t.max() > 1.0  # the lights were hit
    images_close(img_t.reshape(h, w, 3), img_j.reshape(h, w, 3), spp=spp)


@pytest.mark.parametrize("opts", [
    dict(compact_every=2, compact_group=8),
    dict(compact_every=3, compact_group=16),
    dict(compact_schedule=(2, 3, 5, 10), compact_group=16),
    dict(compact_every=-1, compact_group=4),
    dict(compact_schedule=(1, 2), compact_group=8, compact_shrink=False),
], ids=["every2_g8", "every3_g16", "schedule_g16", "auto_g4",
        "schedule12_g8"])
def test_compaction_is_bit_equal_to_one_segment(opts):
    """Segments, group partitions and the final unpermute only regroup
    per-lane work: the image is the one-segment image, bit for bit."""
    _, cj, tt = _scene("cover_grid3", width=30, height=17, spp=2,
                       max_depth=12)
    cfg = _port_cfg(cj, engine="mega")
    whole = trenderer.render(tt, cfg, device="cpu")
    split = trenderer.render(tt, cfg.replace(**opts), device="cpu")
    assert torch.equal(split, whole)


def test_schedule_matches_reference_rules():
    base = RenderConfig(max_depth=50)
    assert cuda_mega.schedule(base) == [50]
    assert cuda_mega.schedule(base.replace(compact_schedule=(2, 3, 5, 10))
                              ) == [2, 3, 5, 10, 30]
    assert cuda_mega.schedule(base.replace(max_depth=4,
                                           compact_schedule=(2, 3, 5, 10))
                              ) == [2, 2]
    assert cuda_mega.schedule(base.replace(compact_every=4)) == [4] * 12 + [2]
    assert cuda_mega.schedule(base.replace(max_depth=10, compact_every=-1)
                              ) == [1, 2, 4, 3]


def test_mega_stats_and_segment_routes_cpu_to_plain():
    """stats count the segments run and every lane's bounces; a CPU
    tensor takes the plain version, which launches no kernel."""
    _, cj, tt = _scene("cover_grid3", width=16, height=9, spp=1,
                       max_depth=8)
    cfg = _port_cfg(cj, engine="mega", compact_schedule=(2, 3),
                    compact_group=8)
    before = cuda_mega.mega_segment.launches
    stats = {}
    img = trenderer.render(tt, cfg, device="cpu", stats=stats)
    assert cuda_mega.mega_segment.launches == before
    assert 1 <= stats["launches"] <= 3
    # every path takes at least its first bounce, and at most max_depth
    assert 16 * 9 <= stats["ray_bounces"] <= 16 * 9 * 8
    assert bool(torch.isfinite(img).all())
    # rays from above the scene, straight up: one bounce, into the sky
    state = mega_plain.fresh_state(torch.tensor([[0.0, 5.0, 30.0]] * 4),
                                   torch.tensor([[0.0, 1.0, 0.0]] * 4))
    state[mega_plain.ALIVE, 2:] = 0.0  # dead lanes stay as they are
    depth = torch.zeros(4, dtype=torch.int32)
    out = cuda_mega.mega_segment(tt.mega.table, state.clone(),
                                 torch.zeros(4, dtype=torch.int32), 0, 0, 0,
                                 4, bg=tt.mega.bg, grad_bg=True,
                                 depth=depth)
    assert torch.equal(out[:, 2:], state[:, 2:])
    assert depth.tolist() == [1, 1, 0, 0]
    sky_up = torch.tensor([0.5, 0.7, 1.0])[:, None].expand(3, 2)
    assert torch.equal(out[mega_plain.C:mega_plain.C + 3, :2], sky_up)


def test_mega_stats_count_every_segment():
    """With a compaction schedule the group partition moves the bounce
    counts with their lanes: mega's ray-bounces are the queue's and the
    adjoint's on the same rays."""
    from rt_tpu_torch.ops import adjoint_plain, camera, cuda_queue

    _, cj, tt = _scene("cover_grid3", width=24, height=16, spp=1,
                       max_depth=12)
    cfg = _port_cfg(cj, engine="mega", compact_schedule=(2, 3),
                    compact_group=4)
    pix = torch.arange(24 * 16)
    ro, rd = camera.generate_rays(tt.camera, 24, 16, pix % 24, pix // 24, 0,
                                  0, cfg.enable_defocus)
    st_m, st_q, st_a = {}, {}, {}
    rgb = cuda_mega.mega_trace(tt, cfg, ro, rd, pix, 0, 0, stats=st_m)
    cuda_queue.queue_trace(tt, cfg, ro, rd, pix, 0, 0, stats=st_q)
    adjoint_plain.trace_adjoint_plain(tt, cfg, ro, rd, pix, 0, 0, rgb,
                                      torch.ones_like(rgb), 12, False,
                                      stats=st_a)
    assert st_m["launches"] == 3
    assert st_m["ray_bounces"] == st_q["ray_bounces"] == st_a["ray_bounces"]
