"""rt_tpu_torch's chunk culling (cfg.cull_chunks, the reference's default:
the Morton-sorted tables of ops/mega_tables.MegaScene.of and each lane's
chunk skip in the plain versions of the kernels B2, B3, B4 and B7) and
the spatial compaction sort (cfg.compact_sort="spatial",
ops/cuda_mega.group_order) against rt_tpu's on the same inputs.

The sort order and the chunk boxes are held bit for bit against
rt_tpu's sort_spheres_morton / sort_triangles_morton. The plain kernels
run with cull_chunks=True on both sides against rt_tpu's Pallas kernels
in interpret mode, as tests/test_mega.py:189-290 runs them on the CPU.
rt_tpu skips a chunk for a tile of 2048 lanes at once and the port for
each lane, so the two may part only on a lane whose own slab test and
its tile's disagree on a grazing hit: per lane within 1e-4 on >= 99% of
lanes, the gate of the unculled comparisons (tests/test_torch_mega.py),
and the lanes outside it are counted. The CUDA kernels are held against
these plain versions bit for bit on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt_tpu.io.image import write_png
from rt_tpu.ops import camera as jcamera
from rt_tpu.ops import pallas_mega as jmega
from rt_tpu.render import integrator as jintegrator
from rt_tpu.scene import builders as jbuilders
from rt_tpu.scene import types as jtypes
from rt_tpu_torch import cli as tcli
from rt_tpu_torch.config import RenderConfig
from rt_tpu_torch.ops import cuda_mega, cuda_queue, mega_plain, mega_tables
from rt_tpu_torch.render import renderer as trenderer
from rt_tpu_torch.scene import builders as tbuilders
from rt_tpu_torch.scene import types as ttypes
from test_mega import _grid_obj
from test_torch_nee import light_scene

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's default of one thread per core in each of them
# oversubscribes the CPU many times over.
torch.set_num_threads(1)


def _scene(name, tmp_path, w, h, spp, depth):
    """(rt_tpu's tables and config, the port's) of a scene: cover(grid=3)
    (2 sphere chunks), the 12x12 grid mesh of tests/test_mega.py (288
    triangles, 9 chunks), the same mesh textured by a seeded PNG, or
    three_sphere (4 rows in an 8-row table with pad rows)."""
    if name.startswith("grid"):
        obj = tmp_path / "grid.obj"
        tex = None
        _grid_obj(obj, n=12, textured=name == "grid_textured")
        if name == "grid_textured":
            tex = str(tmp_path / "tex.png")
            rs = np.random.RandomState(5)
            write_png(tex, (rs.rand(16, 16, 3) * 255).astype(np.uint8))
        kw = dict(width=w, height=h, spp=spp, max_depth=depth,
                  texture_path=tex)
        sj, cj = jbuilders.mesh_scene(str(obj), **kw)
        st, _ = tbuilders.mesh_scene(str(obj), **kw)
    else:
        fn, extra = {"cover": ("cover_scene", dict(grid=3)),
                     "three_sphere": ("three_sphere_scene", {})}[name]
        sj, cj = getattr(jbuilders, fn)(width=w, height=h, **extra,
                                         **({} if name == "three_sphere"
                                            else dict(spp=spp,
                                                      max_depth=depth)))
        st, _ = getattr(tbuilders, fn)(width=w, height=h, **extra,
                                        **({} if name == "three_sphere"
                                           else dict(spp=spp,
                                                     max_depth=depth)))
    cj = cj.replace(samples_per_pixel=spp, max_depth=depth, loop="while",
                    cull_chunks=True)
    cfg = RenderConfig(**{**dataclasses.asdict(cj), "engine": "mega"})
    return jtypes.build_tables(sj), cj, ttypes.build_tables(st), cfg


def _jprep(jt, cj):
    return jmega._prep_scene(jax.tree.map(jnp.asarray, jt), cj)


@pytest.mark.parametrize("name", ["cover", "grid_textured", "three_sphere"])
def test_sort_matches_jax(name, tmp_path):
    """The sorted rows (every column), their SceneTables rows, the chunk
    boxes and the reordered triangle UV rows equal rt_tpu's _prep_scene
    under cull_chunks=True, bit for bit; the chunks past the live rows
    (all pad rows) are empty on rt_tpu's side, and cut here."""
    jt, cj, tt, cfg = _scene(name, tmp_path, 16, 9, 1, 2)
    (_, sph, _, _, tri, sbnd, tbnd, _, uv, _, _, kw) = _jprep(jt, cj)
    ms = tt.mega_culled
    assert tt.mega_culled is ms and mega_tables.scene_for(tt, cfg) is ms
    assert mega_tables.scene_for(tt, cfg.replace(cull_chunks=False)) \
        is tt.mega
    ns, _, _, nt = tt.counts
    cull = ms.cull
    assert kw["cull"] == (cull.sph is not None)
    assert kw["cull_t"] == (cull.tri is not None)
    kept = list(range(mega_tables.X_SLOT)) + [jmega._SLOT_COL]
    np.testing.assert_array_equal(ms.table.numpy(),
                                  np.asarray(sph)[:ns, kept])
    k = cull.sph.shape[0]
    assert k == -(-ns // mega_tables.SPH_CHUNK)
    np.testing.assert_array_equal(cull.sph.numpy().view(np.uint32),
                                  np.asarray(sbnd)[:k].view(np.uint32))
    assert (np.asarray(sbnd)[k:, 0] > np.asarray(sbnd)[k:, 3]).all()
    order = jmega.sort_spheres_morton(
        jmega._pad_chunked(jmega.sphere_table(jax.tree.map(jnp.asarray, jt)),
                           jmega.SPH_CHUNK),
        min(sph.shape[0], jmega.SPH_CHUNK))[2]
    np.testing.assert_array_equal(cull.sph_rows.numpy(),
                                  np.asarray(order)[:ns])
    if name == "grid_textured":
        kt = cull.tri.shape[0]
        assert kt == 9 and nt == 288
        np.testing.assert_array_equal(ms.fam.tri.numpy(),
                                      np.asarray(tri)[:nt])
        np.testing.assert_array_equal(cull.tri.numpy().view(np.uint32),
                                      np.asarray(tbnd)[:kt].view(np.uint32))
        np.testing.assert_array_equal(ms.img.tri.numpy(),
                                      np.asarray(uv[3])[:nt])
        rows = cull.tri_rows.long()
        np.testing.assert_array_equal(
            ms.fam.tri.numpy(), mega_tables.triangle_table(tt)[rows].numpy())
    else:
        assert cull.tri is None and cull.tri_rows is None


def test_cull_off_and_small_meshes_keep_scene_order():
    """cull_chunks=False gives the tables of scene order, and a culled
    scene sorts only where the reference does: its spheres when it has
    one, its triangles from two chunks on (demo_scene.json's 2 triangles
    stay as they are; a scene without spheres has no sphere boxes)."""
    from rt_tpu_torch.scene.parser import parse_scene

    sdef, _ = parse_scene("scenes/demo_scene.json")
    tt = ttypes.build_tables(sdef)
    off, on = mega_tables.MegaScene.of(tt), tt.mega_culled
    assert off.cull is None
    assert torch.equal(off.table, mega_tables.sphere_table(tt)[:tt.n_spheres])
    assert on.cull.sph is not None and on.cull.tri is None
    assert torch.equal(on.fam.tri, off.fam.tri)
    assert sorted(on.cull.sph_rows.tolist()) == list(range(tt.n_spheres))
    assert torch.equal(on.table, off.table[on.cull.sph_rows.long()])
    s = ttypes.SceneDef(width=8, height=8)
    m = s.add_lambertian_color((0.5, 0.5, 0.5))
    s.add_rect("xy_rect", -1, 1, -1, 1, -2, m)
    s.set_camera((0, 0, 1), (0, 0, -1), (0, 1, 0), 45, 0.0)
    rect_only = ttypes.build_tables(s)
    assert rect_only.mega_culled.cull is None


def _rays(jt, tt, w, h, sample=0, seed=0):
    px = np.tile(np.arange(w, dtype=np.int32), h)
    py = np.repeat(np.arange(h, dtype=np.int32), w)
    pix = (py * w + px).astype(np.uint32)
    jtd = jax.tree.map(jnp.asarray, jt)
    ro, rd = jcamera.generate_rays(jtd.camera, w, h, jnp.asarray(px),
                                   jnp.asarray(py), sample, seed, False)
    return jtd, pix, ro, rd, (torch.from_numpy(np.array(ro)),
                              torch.from_numpy(np.array(rd)),
                              torch.from_numpy(pix.astype(np.int64)))


def _lanes_close(got, want, label):
    """>= 99% of lanes within 1e-4 (the unculled gate); returns the lanes
    outside it."""
    bad = ~(np.abs(got - want) <= 1e-4).all(-1)
    assert bad.mean() <= 0.01, (label, bad.mean())
    return int(bad.sum())


@pytest.mark.parametrize("name", ["cover", "grid", "grid_textured"])
def test_plain_b2_b3_culled_match_pallas_mega(name, tmp_path):
    """One sample through rt_tpu's trace(engine="mega", cull_chunks=True)
    and the port's culled mega_trace and queue_trace at 32x18, depth 3:
    queue equals mega bit for bit, both equal rt_tpu per lane within
    the outlier budget, and culling changes no lane of the port's own
    unculled trace beyond it; the lanes tested fewer rows."""
    w, h = 32, 18
    jt, cj, tt, cfg = _scene(name, tmp_path, w, h, 1, 3)
    jtd, pix, ro, rd, targs = _rays(jt, tt, w, h)
    want = np.asarray(jintegrator.trace(jtd, cj.replace(engine="mega"), ro,
                                        rd, jnp.asarray(pix), 0, 0))
    mega_plain.closest_hit.rows = [0, 0, 0, 0]
    got = cuda_mega.mega_trace(tt, cfg.replace(compact_every=2,
                                               compact_group=8),
                               *targs, 0, 0).numpy()
    culled_rows = list(mega_plain.closest_hit.rows)
    q = cuda_queue.queue_trace(tt, cfg.replace(engine="queue",
                                               queue_steps=3),
                               *targs, 0, 0, check_once=True).numpy()
    np.testing.assert_array_equal(q, got)
    _lanes_close(got, want, (name, "vs rt_tpu"))
    mega_plain.closest_hit.rows = [0, 0, 0, 0]
    off = cuda_mega.mega_trace(tt, cfg.replace(cull_chunks=False), *targs,
                               0, 0).numpy()
    _lanes_close(got, off, (name, "vs unculled"))
    assert sum(culled_rows) < sum(mega_plain.closest_hit.rows)
    assert got.max() > 0


@pytest.mark.parametrize("name", ["cover", "grid_textured"])
def test_plain_b4_culled_codes_match_pallas_capture(name, tmp_path):
    """The plain B4 with culling against rt_tpu's culled Pallas capture:
    the same codes (SceneTables rows, through the sorted rows' map) on
    >= 99.9% of live codes and the same death counts on >= 99% of lanes;
    and against the port's unculled capture on every lane whose path
    is the same."""
    w, h = 24, 16
    jt, cj, tt, cfg = _scene(name, tmp_path, w, h, 1, 3)
    jtd, pix, ro, rd, targs = _rays(jt, tt, w, h)
    jcodes, jdeath = (np.asarray(x) for x in jmega.mega_capture(
        jtd, cj, ro, rd, jnp.asarray(pix.astype(np.int32)), jnp.uint32(0),
        jnp.uint32(0)))
    codes, death = (x.numpy() for x in cuda_mega.mega_capture(
        tt, cfg, *targs, 0, 0))
    live = np.arange(cfg.max_depth)[:, None] <= death[None, :]
    assert (death == jdeath).mean() >= 0.99
    same = death == jdeath
    assert (codes == jcodes)[live & same[None, :]].mean() >= 0.999
    ocodes, odeath = (x.numpy() for x in cuda_mega.mega_capture(
        tt, cfg.replace(cull_chunks=False), *targs, 0, 0))
    assert (odeath == death).mean() >= 0.99
    agree = (ocodes == codes)[live & (odeath == death)[None, :]]
    assert agree.mean() >= 0.999, agree.mean()
    fam = np.unique(codes[codes >= 0] >> 24)
    assert (0 in fam) and (name == "cover" or 3 in fam)


def test_plain_b7_culled_matches_pallas_regen(tmp_path):
    """The plain B7 with culling against rt_tpu's culled Pallas regen
    kernel over a whole segment at 24x16, spp 2, depth 3 on cover(grid=3):
    radiance within 1e-4, sample counter and alive word on >= 99% of
    lanes (tests/test_torch_regen_pallas.py's gate)."""
    w, h, spp, depth = 24, 16, 2, 3
    jt, cj, tt, cfg = _scene("cover", tmp_path, w, h, spp, depth)
    (tbl, sph, rect, cyl, tri, sbnd, tbnd, sph_co, uv, atlas, counts,
     kw) = _jprep(jt, cj)
    assert kw["cull"]
    b = w * h
    bp = -(-b // jmega.RAY_TILE) * jmega.RAY_TILE
    jpix = np.zeros(bp, np.int32)
    jpix[:b] = np.arange(b)
    jpix = jnp.asarray(jpix)
    zi = jnp.zeros((bp,), jnp.int32)
    iters = spp * (depth + 1)
    st, jsamp, _ = jmega.mega_regen(
        sph, rect, cyl, tri, sbnd, tbnd, sph_co, uv, atlas, counts,
        tbl.background, jmega.camera_vec(tbl.camera),
        (jnp.zeros((bp,), jnp.float32),) * 13, jpix, jpix // w, zi, zi,
        jnp.int32(1), jnp.int32(3), jnp.int32(iters), max_depth=depth,
        spp=spp, init=True, width=w, height=h,
        defocus=bool(cj.enable_defocus),
        exhaust_bg=cj.exhaust_mode == "background", **kw)
    j_rgb = np.stack([np.asarray(c)[:b] for c in st[9:12]], -1)
    ms = mega_tables.scene_for(tt, cfg)
    pix = torch.arange(b, dtype=torch.int32)
    state = torch.zeros((13, b))
    samp, bvec = (torch.zeros(b, dtype=torch.int32) for _ in range(2))
    cuda_mega.mega_regen(ms.table, ms.cam, state, pix, pix // w, samp, bvec,
                         1, 3, iters, max_depth=depth, spp=spp, init=True,
                         width=w, height=h, defocus=cfg.enable_defocus,
                         exhaust_bg=cfg.exhaust_mode == "background",
                         **mega_plain.trace_options(tt, cfg))
    t_rgb = state[mega_plain.C:mega_plain.C + 3].T.numpy()
    ok = ((np.abs(t_rgb - j_rgb) <= 1e-4).all(-1)
          & (samp.numpy() == np.asarray(jsamp)[:b]))
    assert ok.mean() >= 0.99, ok.mean()
    # the frame driver culls as the segment does
    frame = cuda_mega.mega_trace_regen(tt, cfg, pix, pix // w, 3, spp, 1)
    assert torch.equal(frame, state[mega_plain.C:mega_plain.C + 3].T)


def test_wrong_table_with_culled_options_raises(tmp_path):
    """The chunk boxes go with the sorted sphere table only: the table in
    scene order beside the culled options is refused."""
    _, _, tt, cfg = _scene("cover", tmp_path, 8, 6, 1, 2)
    state = mega_plain.fresh_state(torch.zeros((4, 3)), torch.ones((4, 3)))
    pix = torch.arange(4)
    with pytest.raises(ValueError, match="sorted"):
        cuda_mega.mega_segment(tt.mega.table, state, pix, 0, 0, 0, 2,
                               **mega_plain.trace_options(tt, cfg))


@pytest.mark.parametrize("mis", [True, False], ids=["mis", "nee"])
def test_nee_under_the_sort_matches_unsorted(mis, images_close):
    """A light-sampled render of the four light families with culling
    equals the unculled one (per lane on >= 99% of lanes, and by
    images_close): the sorted sphere light keeps its SceneTables row
    for MIS's emitter match. Matching by the sorted row fails it."""
    w, h = 24, 16
    tt = light_scene(ttypes, w, h)
    cfg = RenderConfig(width=w, height=h, samples_per_pixel=2, max_depth=4,
                       engine="mega", nee=True, mis=mis)
    assert tt.mega_culled.cull.sph_rows.tolist() != list(
        range(tt.n_spheres))   # the sort moved the rows
    on = trenderer.render(tt, cfg, device="cpu").numpy()
    off = trenderer.render(tt, cfg.replace(cull_chunks=False),
                           device="cpu").numpy()
    assert (np.abs(on - off) <= 1e-5).all(-1).mean() >= 0.99
    images_close(on, off, 2)
    if mis:
        real = mega_plain.scene_rows
        try:
            mega_plain.scene_rows = lambda cull, family, row: row
            wrong = trenderer.render(tt, cfg, device="cpu").numpy()
        finally:
            mega_plain.scene_rows = real
        with pytest.raises(AssertionError):
            images_close(wrong, off, 2, outlier_frac=0.0, atol=1e-5)


def _jax_spatial_perm(state, live, group):
    g = live.shape[0] // group
    _, _, perm = jmega._compact(
        tuple(jnp.asarray(x) for x in state[:13]),
        jnp.zeros(live.shape[0], jnp.int32), jnp.arange(g), group=group,
        sort="spatial", pending=jnp.asarray(live))
    return np.asarray(perm)


@pytest.mark.parametrize("group", [8, 32])
def test_spatial_group_order_matches_jax(group):
    """group_order(sort="spatial") equals rt_tpu's _compact(sort=
    "spatial") permutation on the same seeded state and live mask (a
    third of the groups dead), and "dead" the stable live-first one."""
    rs = np.random.default_rng(group)
    b = 64 * group
    state = np.zeros((13, b), np.float32)
    state[0:3] = rs.normal(0, 4, (3, b))
    state[3:6] = rs.normal(0, 1, (3, b))
    live = rs.random(b) < 0.6
    live.reshape(-1, group)[rs.random(b // group) < 0.33] = False
    state[12] = live
    got = cuda_mega.group_order(torch.from_numpy(state),
                                torch.from_numpy(live), group, "spatial")
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_spatial_perm(state, live, group))
    dead = cuda_mega.group_order(torch.from_numpy(state),
                                 torch.from_numpy(live), group)
    alive_g = live.reshape(-1, group).any(-1)
    np.testing.assert_array_equal(dead.numpy(),
                                  np.argsort(~alive_g, kind="stable"))


def test_spatial_sort_is_bit_equal_to_dead_sort(tmp_path):
    """compact_sort="spatial" only permutes groups: the mega frame, the
    regen frame and the replay's gradients equal compact_sort="dead"'s
    bit for bit (tests/test_mega.py:201), with culling on."""
    from rt_tpu_torch.diff import replay as treplay

    _, _, tt, cfg = _scene("cover", tmp_path, 32, 18, 2, 6)
    cfg = cfg.replace(compact_every=2, compact_group=8)
    a = trenderer.render(tt, cfg, device="cpu")
    b = trenderer.render(tt, cfg.replace(compact_sort="spatial"),
                         device="cpu")
    assert torch.equal(a, b)
    rcfg = cfg.replace(regen=True, regen_compact=3)
    assert torch.equal(
        trenderer.render(tt, rcfg, device="cpu"),
        trenderer.render(tt, rcfg.replace(compact_sort="spatial"),
                         device="cpu"))
    pix = torch.arange(32 * 18)
    tgt = torch.full((pix.shape[0], 3), 0.3)
    grads = []
    for sort in ("dead", "spatial"):
        p = {"mat_albedo": tt.mat_albedo.clone().requires_grad_(True)}
        treplay.make_replay_loss_fn(tt, cfg.replace(compact_sort=sort), 1,
                                    pix % 32, pix // 32, tgt)(p).backward()
        grads.append(p["mat_albedo"].grad)
    assert torch.equal(grads[0], grads[1]) and grads[0].abs().max() > 0


@pytest.mark.parametrize("flags,want", [
    ([], dict(sampler="rng", cull_chunks=True)),
    (["--sampler", "qmc"], dict(sampler="qmc", cull_chunks=True)),
    (["--no-cull"], dict(sampler="rng", cull_chunks=False)),
], ids=["default", "qmc", "no_cull"])
def test_cli_sampler_and_cull_flags(tmp_path, monkeypatch, flags, want):
    """render --sampler qmc / --no-cull on the CPU: exit 0, the frame
    written, the flags in the configuration the renderer is given."""
    ns = {}
    real = trenderer.render

    def spy(tables, cfg, **kw):
        ns["cfg"] = cfg
        return real(tables, cfg, **kw)

    monkeypatch.setattr(trenderer, "render", spy)
    out = str(tmp_path / "c.png")
    assert tcli.main(["render", "-f", "scenes/demo_scene.json", "-w", "24",
                      "--height", "14", "-spp", "1", "-d", "3", "-o", out,
                      "--device", "cpu"] + flags) == 0
    assert {k: getattr(ns["cfg"], k) for k in want} == want
    assert (tmp_path / "c.png").stat().st_size > 0
