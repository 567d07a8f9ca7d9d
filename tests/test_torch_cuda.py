"""rt_tpu_torch's CUDA kernels against their plain PyTorch versions, on
the card. These tests need a CUDA GPU and nvcc and skip without them.
The file imports no JAX (run it without the JAX-importing conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import functools
import os

import numpy as np
import pytest
import torch

from rt_tpu_torch.ops import cuda_intersect, mega_tables
from rt_tpu_torch.scene import builders, types


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    return torch.device("cuda")


def _rays(n, seed):
    rs = np.random.default_rng(seed)
    ro = rs.normal(0, 3, (n, 3)).astype(np.float32)
    rd = rs.normal(0, 1, (n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return torch.from_numpy(ro), torch.from_numpy(rd)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1 << 17, 1000, 1])
def test_sphere_hit_kernel_matches_plain(n):
    """At the main path's table size (cover_scene, 512 rows). Tolerance as
    tests/test_pallas.py, on >= 99.9% of lanes: FMA on the card rounds
    differently from the plain float32 on ill-conditioned grazing lanes
    (ROADMAP C-5)."""
    dev = _card()
    tt = types.build_tables(builders.cover_scene()[0], device=dev)
    ro, rd = _rays(n, seed=8)
    args = (tt.sph_center, tt.sph_radius, tt.sph_obj >= 0, ro.to(dev),
            rd.to(dev))
    before = cuda_intersect.sphere_closest_hit.launches
    t_k, pid_k = cuda_intersect.sphere_closest_hit(*args)
    torch.cuda.synchronize()
    assert cuda_intersect.sphere_closest_hit.launches == before + 1
    assert t_k.dtype == torch.float32 and pid_k.dtype == torch.int32
    t_p, pid_p = cuda_intersect.sphere_closest_hit_plain(*args)
    t_k, pid_k, t_p, pid_p = (x.cpu().numpy() for x in (t_k, pid_k, t_p,
                                                        pid_p))
    hit = np.isfinite(t_p)
    assert np.mean(hit == np.isfinite(t_k)) >= 0.999
    assert np.mean(pid_k == pid_p) >= 0.999
    both = hit & np.isfinite(t_k)
    close = np.abs(t_k[both] - t_p[both]) <= 1e-4 + 2e-4 * np.abs(t_p[both])
    assert close.size == 0 or close.mean() >= 0.999
    # a ray that hits nothing reports the last row, as the TPU kernel does
    assert (pid_k[~np.isfinite(t_k)] == tt.sph_center.shape[0] - 1).all()


@pytest.mark.cuda
def test_sphere_hit_wrapper_checks_inputs():
    dev = _card()
    tt = types.build_tables(builders.three_sphere_scene()[0], device=dev)
    ro, rd = _rays(64, seed=9)
    args = [tt.sph_center, tt.sph_radius, tt.sph_obj >= 0, ro.to(dev),
            rd.to(dev)]
    with pytest.raises(TypeError):
        cuda_intersect.sphere_closest_hit(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="shape"):
        cuda_intersect.sphere_closest_hit(*args[:3], args[3][:, :2], args[4])
    with pytest.raises(ValueError, match="contiguous"):
        cuda_intersect.sphere_closest_hit(*args[:3], args[3].t().t()[::2],
                                          args[4][::2])
    with pytest.raises(ValueError, match="tensors on"):
        cuda_intersect.sphere_closest_hit(*args[:3], ro, rd)
    empty = cuda_intersect.sphere_closest_hit(*args[:3], args[3][:0],
                                              args[4][:0])
    assert empty[0].shape == (0,)


def _b1_case(case, b=3077):
    """(centers, radii, live, ro, rd, extra) of one of B1's edge cases as
    numpy arrays, b rays (3077: not a multiple of the rays a thread nor of
    a block's tile). ties: 40 spheres, each given three times; pad: 300
    spheres, a third of them pad rows (live False) placed in front of the
    live ones; miss: spheres behind every ray; t_min: a unit sphere whose
    near root lies just under or over t_min (1e-3), extra the near root;
    stages: 2,500 spheres, more than one shared-memory stage."""
    rs = np.random.default_rng(31)
    extra = None
    if case == "ties":
        c = np.repeat(rs.normal(0, 2, (40, 3)), 3, 0)
        r = np.repeat(rs.uniform(0.2, 0.8, 40), 3)
        live = np.ones(120, bool)
    elif case == "pad":
        c = rs.normal(0, 2, (300, 3))
        r = rs.uniform(0.2, 0.6, 300)
        live = rs.random(300) >= 1 / 3
        # each pad row sits nearer the camera than a live row
        c[~live] = c[rs.choice(np.flatnonzero(live), (~live).sum())] \
            + np.array([0.0, 0.0, 0.5])
    elif case == "miss":
        c = rs.normal(0, 1, (64, 3)) + np.array([0.0, 0.0, -50.0])
        r = rs.uniform(0.2, 0.6, 64)
        live = np.ones(64, bool)
    elif case == "t_min":
        c = np.concatenate([np.zeros((1, 3)), rs.normal(0, 1, (15, 3))
                            + np.array([0.0, 0.0, 40.0])])
        r = np.concatenate([[1.0], rs.uniform(0.2, 0.6, 15)])
        live = np.ones(16, bool)
    else:  # stages
        c = rs.normal(0, 6, (2500, 3))
        r = rs.uniform(0.05, 0.4, 2500)
        live = rs.random(2500) >= 0.1
    if case == "miss":
        ro = rs.normal(0, 1, (b, 3))
        rd = rs.normal(0, 0.2, (b, 3)) + np.array([0.0, 0.0, 1.0])
    elif case == "t_min":
        # origin on the -z side at distance 1 + d from the centre, so the
        # roots are d and d + 2
        extra = rs.choice(np.array([0.5, 0.9, 0.99, 1.01, 1.1, 2.0]) * 1e-3,
                          b)
        ro = np.stack([np.zeros(b), np.zeros(b), -1.0 - extra], 1)
        rd = np.tile([0.0, 0.0, 1.0], (b, 1))
    else:
        ro = rs.normal(0, 1, (b, 3)) + np.array([0.0, 0.0, 12.0])
        aim = c[rs.integers(0, c.shape[0], b)] + rs.normal(0, 0.3, (b, 3))
        rd = aim - ro
    rd = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
    f32 = np.float32
    return (c.astype(f32), r.astype(f32), live, ro.astype(f32),
            rd.astype(f32), extra)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ties", "pad", "miss", "t_min", "stages"])
def test_sphere_hit_edge_cases_match_plain(case):
    """B1 (one float4 row a sphere, c2r = +inf for a pad row, several rays
    a thread, the root only where disc >= 0, pid = N-1 on a miss) against
    its plain version on 3,077 rays: B1's gates (>= 99.9% of lanes, t
    within rtol 2e-4 / atol 1e-4) and the contract's exact rules: a miss
    reports row N-1, a pad row never wins, equal spheres go to the last
    copy, a near root under t_min gives way to the far root."""
    dev = _card()
    c, r, live, ro, rd, extra = _b1_case(case)
    args = [torch.from_numpy(x).to(dev) for x in (c, r, live, ro, rd)]
    before = cuda_intersect.sphere_closest_hit.launches
    t_k, pid_k = cuda_intersect.sphere_closest_hit(*args)
    torch.cuda.synchronize()
    assert cuda_intersect.sphere_closest_hit.launches == before + 1
    t_p, pid_p = cuda_intersect.sphere_closest_hit_plain(*args)
    t_k, pid_k, t_p, pid_p = (x.cpu().numpy() for x in (t_k, pid_k, t_p,
                                                        pid_p))
    n = c.shape[0]
    hit = np.isfinite(t_p)
    assert np.mean(hit == np.isfinite(t_k)) >= 0.999
    assert np.mean(pid_k == pid_p) >= 0.999
    both = hit & np.isfinite(t_k)
    close = np.abs(t_k[both] - t_p[both]) <= 1e-4 + 2e-4 * np.abs(t_p[both])
    assert close.size == 0 or close.mean() >= 0.999
    assert (pid_k[~np.isfinite(t_k)] == n - 1).all()
    assert live[pid_k[np.isfinite(t_k)]].all()
    if case == "miss":
        assert not np.isfinite(t_k).any()
    elif case == "ties":
        assert both.mean() > 0.5
        assert (pid_k[both] % 3 == 2).all()
    elif case == "t_min":
        want = np.where(extra >= 1e-3, extra, extra + 2.0)
        assert np.allclose(t_k, want, rtol=2e-4, atol=1e-4)
        assert (pid_k == 0).all()
    else:
        assert both.mean() > 0.2


@pytest.mark.cuda
def test_pallas_render_uses_kernel_once_per_bounce():
    dev = _card()
    from rt_tpu_torch.render.renderer import render

    sdef, cfg = builders.cover_scene(width=64, height=36, spp=2, max_depth=8)
    stats = {}
    before = cuda_intersect.sphere_closest_hit.launches
    img = render(types.build_tables(sdef, device=dev),
                 cfg.replace(engine="pallas"), device="cuda", stats=stats)
    assert img.device.type == "cuda" and bool(torch.isfinite(img).all())
    assert cuda_intersect.sphere_closest_hit.launches - before == \
        stats["bounces"] > 0


def _depth1(dev, name):
    """Camera rays of a scene at max_depth 1 on the card."""
    from rt_tpu_torch.ops import camera

    fn = {"cover": builders.cover_scene,
          "cornell": builders.cornell_spheres_scene}[name]
    sdef, cfg = fn(width=256, height=128, spp=1, max_depth=1)
    tt = types.build_tables(sdef, device=dev)
    pix = torch.arange(256 * 128, device=dev)
    ro, rd = camera.generate_rays(tt.camera, 256, 128, pix % 256,
                                  pix // 256, 0, 0, cfg.enable_defocus)
    return tt, cfg, ro, rd, pix


def _lanes_close(a, b, frac=0.999):
    """>= frac of lanes within atol 1e-4 / rtol 2e-4, the gate of B1's
    tests. The megakernels are built without FMA contraction and give
    their plain versions' bits (ops/cuda_build.LIB_FLAGS); the gate still
    holds if a build contracts, where an ulp flips a grazing hit now and then
    (ROADMAP C-4, C-5, C-6)."""
    close = ((a - b).abs() <= 1e-4 + 2e-4 * b.abs()).all(-1)
    assert close.float().mean().item() >= frac, close.float().mean().item()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cover", "cornell"])
def test_mega_and_queue_kernels_match_plain_at_depth1(name):
    from rt_tpu_torch.ops import cuda_mega, cuda_queue

    dev = _card()
    tt, cfg, ro, rd, pix = _depth1(dev, name)
    mega_before = cuda_mega.mega_segment.launches
    queue_before = cuda_queue.queue_launch.launches
    k_mega = cuda_mega.mega_trace(tt, cfg, ro, rd, pix, 0, 7)
    k_queue = cuda_queue.queue_trace(tt, cfg, ro, rd, pix, 0, 7,
                                     check_once=True)
    torch.cuda.synchronize()
    assert cuda_mega.mega_segment.launches == mega_before + 1
    assert cuda_queue.queue_launch.launches == queue_before + 1
    p_mega = cuda_mega.mega_trace(tt, cfg, ro, rd, pix, 0, 7, plain=True)
    p_queue = cuda_queue.queue_trace(tt, cfg, ro, rd, pix, 0, 7, plain=True)
    assert torch.equal(p_mega, p_queue)
    _lanes_close(k_mega, p_mega)
    _lanes_close(k_queue, p_queue)


@pytest.mark.cuda
def test_queue_kernel_bit_identical_across_budgets():
    from rt_tpu_torch.ops import cuda_mega, cuda_queue

    dev = _card()
    sdef, cfg = builders.cover_scene(width=160, height=90, spp=1,
                                     max_depth=50)
    tt = types.build_tables(sdef, device=dev)
    from rt_tpu_torch.ops import camera

    pix = torch.arange(160 * 90, device=dev)
    ro, rd = camera.generate_rays(tt.camera, 160, 90, pix % 160, pix // 160,
                                  3, 0, True)
    outs = [cuda_queue.queue_trace(tt, cfg.replace(queue_steps=k), ro, rd,
                                   pix, 3, 0, check_once=True)
            for k in (0, 64, 5)]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    mega = cuda_mega.mega_trace(tt, cfg.replace(
        compact_schedule=(2, 3, 5, 10), compact_group=16), ro, rd, pix, 3, 0)
    close = ((mega - outs[0]).abs() <= 1e-5).all(-1).float().mean().item()
    assert close >= 0.999, close


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [0, 3])
def test_queue_kernel_refill_matches_plain(steps):
    """A pool of 4 blocks (1,024 lanes) for 14,400 rays at depth 8: every
    thread claims a dozen or more rays through the warp refill (ballot,
    one atomicAdd per warp, popc ranks) and, with a budget of 3 steps, is
    saved and resumed between launches. Per lane the result is the plain
    emulation's (the depth-1 gate), and the full pool's bits."""
    from rt_tpu_torch.ops import camera, cuda_queue

    dev = _card()
    sdef, cfg = builders.cover_scene(width=160, height=90, spp=1,
                                     max_depth=8)
    cfg = cfg.replace(queue_steps=steps)
    tt = types.build_tables(sdef, device=dev)
    pix = torch.arange(160 * 90, device=dev)
    ro, rd = camera.generate_rays(tt.camera, 160, 90, pix % 160, pix // 160,
                                  1, 0, True)
    before = cuda_queue.queue_launch.launches
    stats = {}
    small = cuda_queue.queue_trace(tt, cfg, ro, rd, pix, 1, 4, stats=stats,
                                   check_once=True, pool_lanes=1024)
    torch.cuda.synchronize()
    assert cuda_queue.queue_launch.launches - before == stats["launches"]
    if steps == 0:
        assert stats["launches"] == 1
    else:
        assert stats["launches"] > 1
    full = cuda_queue.queue_trace(tt, cfg, ro, rd, pix, 1, 4,
                                  check_once=True)
    assert torch.equal(small, full)
    plain = cuda_queue.queue_trace(tt, cfg, ro, rd, pix, 1, 4, plain=True)
    _lanes_close(small, plain)


@pytest.mark.cuda
def test_mega_and_queue_wrappers_check_inputs_and_launches():
    from rt_tpu_torch.ops import cuda_mega, cuda_queue, mega_plain

    dev = _card()
    tt = types.build_tables(builders.three_sphere_scene()[0], device=dev)
    tab = tt.mega.table
    ro, rd = (x.to(dev) for x in _rays(64, seed=10))
    state = mega_plain.fresh_state(ro, rd)
    pix = torch.arange(64, device=dev, dtype=torch.int32)
    kw = dict(bg=tt.mega.bg)
    with pytest.raises(TypeError):
        cuda_mega.mega_segment(tab.double(), state, pix, 0, 0, 0, 4, **kw)
    with pytest.raises(ValueError, match="shape"):
        cuda_mega.mega_segment(tab, state[:12].contiguous(), pix, 0, 0, 0, 4,
                               **kw)
    with pytest.raises(ValueError, match="on cpu"):
        cuda_mega.mega_segment(tab, state, pix.cpu(), 0, 0, 0, 4, **kw)
    with pytest.raises(TypeError):
        cuda_mega.mega_segment(tab, state, pix.long(), 0, 0, 0, 4, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_mega.mega_segment(tab, state[:, ::2], pix, 0, 0, 0, 4, **kw)
    # an over-sized block is refused by the launch itself
    with pytest.raises(RuntimeError, match="launch failed"):
        cuda_mega.mega_segment(tab, state, pix, 0, 0, 0, 4, threads=2048,
                               **kw)
    blocks = cuda_queue.grid_blocks(tab.shape[0], dev)
    lanes = blocks * cuda_mega.THREADS
    pool_f = torch.empty((13, lanes), device=dev)
    pool_i = torch.full((4, lanes), -1, dtype=torch.int32, device=dev)
    counters = torch.zeros(2, dtype=torch.int32, device=dev)
    out = torch.empty((64, 3), device=dev)
    args = (tab, ro, rd, pix, 0, pool_f, pool_i, counters, out)
    qkw = dict(seed=0, max_depth=4, budget=0, blocks=blocks, **kw)
    with pytest.raises(ValueError, match="shape"):
        cuda_queue.queue_launch(tab, ro[:, :2].contiguous(), *args[2:], **qkw)
    with pytest.raises(TypeError):
        cuda_queue.queue_launch(*args[:3], pix.long(), *args[4:], **qkw)
    with pytest.raises(ValueError, match="on cpu"):
        cuda_queue.queue_launch(*args[:8], out.cpu(), **qkw)
    big_f = torch.empty((13, 2048), device=dev)
    big_i = torch.full((4, 2048), -1, dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="launch failed"):
        cuda_queue.queue_launch(*args[:5], big_f, big_i, *args[7:],
                                threads=2048, **{**qkw, "blocks": 1})
    cuda_queue.queue_launch(*args, **qkw)
    torch.cuda.synchronize()
    assert counters.tolist()[1] == 64


# ---- the adjoint kernels B5 (mega_adjoint.cu) and B6 (queue_adjoint.cu)

ADJ_FIELDS = ("tex_color", "tex_color2", "mat_albedo", "background")


def _adj_sample(dev, w, h, depth, scene="cover", **over):
    """Camera rays of sample 0 with their radiance (the queue kernel) and
    a seeded loss cotangent."""
    from rt_tpu_torch.ops import camera, cuda_queue

    if scene == "cover":
        sdef, cfg = builders.cover_scene(width=w, height=h, spp=1,
                                         max_depth=depth)
        # a bright constant sky (the cover scene's is black, and then
        # every path carries zero radiance): read with the constant sky
        sdef.background = (0.6, 0.7, 0.9)
    else:
        n, n_mat = scene
        sdef, cfg = builders.random_spheres_scene(n, n_mat, width=w,
                                                  height=h, max_depth=depth)
    cfg = cfg.replace(compact_schedule=(2, 3, 5, 10), compact_group=16,
                      **over)
    tt = types.build_tables(sdef, device=dev)
    pix = torch.arange(w * h, device=dev)
    ro, rd = camera.generate_rays(tt.camera, w, h, pix % w, pix // w, 0, 0,
                                  cfg.enable_defocus)
    L = cuda_queue.queue_trace(tt, cfg, ro, rd, pix, 0, 0)
    g = torch.from_numpy(np.random.default_rng(5).normal(
        0, 1e-3, (w * h, 3)).astype(np.float32)).to(dev)
    return tt, cfg, ro, rd, pix, L, g


def _grads_close(want, got):
    """Per field |a - b| <= 1e-5 + 1e-3 max|a|: float atomics sum in an
    order that changes from run to run (the reference's tolerance between
    its replay and its kernels, tests/test_diff.py:567)."""
    for k in ADJ_FIELDS:
        a, b = want[k].double(), got[k].double()
        assert a.shape == b.shape, k
        mag = max(float(a.abs().max()), 1e-12)
        err = float((a - b).abs().max())
        assert err <= 1e-5 + 1e-3 * mag, (k, err, mag)


@pytest.mark.cuda
@pytest.mark.parametrize("depth,over", [
    (1, {}), (50, {}), (50, {"background_mode": "constant"}),
    (12, {"background_mode": "constant", "exhaust_mode": "background"})],
    ids=["depth1", "depth50_sky", "depth50_constant", "exhaust"])
def test_adjoint_kernels_match_plain(depth, over):
    """B5 and B6 against the plain adjoint on the cover scene at 192x108
    (the ground's checker routes cotangents to both colours), and B6
    against B5; each kernel launched by its wrapper."""
    from rt_tpu_torch.ops import cuda_mega, cuda_queue

    dev = _card()
    tt, cfg, ro, rd, pix, L, g = _adj_sample(dev, 192, 108, depth, **over)
    exhaust = cfg.exhaust_mode == "background"
    args = (tt, cfg, ro, rd, pix, 0, 0, L, g, depth, exhaust)
    m0 = cuda_mega.mega_adjoint_segment.launches
    q0 = cuda_queue.queue_adjoint_launch.launches
    st_m, st_q = {}, {}
    k_m = cuda_mega.mega_trace_adjoint(*args, stats=st_m)
    k_q = cuda_queue.queue_trace_adjoint(*args, stats=st_q, check_once=True)
    torch.cuda.synchronize()
    assert cuda_mega.mega_adjoint_segment.launches - m0 == st_m["launches"]
    assert cuda_queue.queue_adjoint_launch.launches - q0 == st_q["launches"]
    st_p = {}
    plain = cuda_queue.queue_trace_adjoint(*args, plain=True, stats=st_p)
    assert st_m["ray_bounces"] == st_q["ray_bounces"] == st_p["ray_bounces"]
    _grads_close(plain, k_m)
    _grads_close(plain, k_q)
    _grads_close(k_m, k_q)
    # a scattering hit takes g * (L - C_after) / att: nothing at depth 1,
    # where no radiance follows it; the ground's odd checker colour later
    assert (float(plain["tex_color2"].abs().max()) > 0.0) == (depth > 1)
    sky = cfg.background_mode == "gradient"
    assert (float(plain["background"].abs().max()) == 0.0) == sky


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [0, 5])
def test_queue_adjoint_small_pool_and_budgets(steps):
    """B6 with a 2,048-lane pool (every thread refills several times) and
    with a budget of 5 steps per launch (lanes saved and resumed): the
    gradients of the full pool and of the plain version."""
    from rt_tpu_torch.ops import cuda_queue

    dev = _card()
    tt, cfg, ro, rd, pix, L, g = _adj_sample(dev, 160, 90, 16,
                                             background_mode="constant")
    cfg = cfg.replace(queue_steps=steps)
    args = (tt, cfg, ro, rd, pix, 0, 0, L, g, 16, False)
    stats = {}
    small = cuda_queue.queue_trace_adjoint(*args, pool_lanes=2048,
                                           check_once=True, stats=stats)
    assert (stats["launches"] > 1) == (steps > 0)
    full = cuda_queue.queue_trace_adjoint(*args, check_once=True)
    plain = cuda_queue.queue_trace_adjoint(*args, plain=True)
    for got in (small, full):
        _grads_close(plain, got)


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_mat", [(3000, 64), (12000, 0)])
def test_large_tables_match_plain(n, n_mat):
    """ROADMAP C-7: tables past the 2,048 rows staged in shared memory
    (the rest read from global memory) through B2, B3, B5 and B6 against
    their plain versions. 3,000 rows with 64 shared materials keep the
    adjoints' accumulators in shared memory; 12,000 rows with a material
    each (32,768 slots) take the global variant."""
    from rt_tpu_torch.ops import cuda_mega, cuda_queue

    dev = _card()
    tt, cfg, ro, rd, pix, L, g = _adj_sample(dev, 64, 48, 6,
                                             scene=(n, n_mat))
    assert tt.mega.table.shape[0] == n
    assert cuda_mega.acc_fits_smem(tt.mega.n_slots) == (n_mat > 0)
    fwd = (tt, cfg, ro, rd, pix, 0, 0)
    plain = cuda_mega.mega_trace(*fwd, plain=True)
    assert torch.equal(cuda_mega.mega_trace(*fwd), plain)
    assert torch.equal(cuda_queue.queue_trace(*fwd, check_once=True), plain)
    adj = (*fwd, L, g, 6, False)
    want = cuda_queue.queue_trace_adjoint(*adj, plain=True)
    _grads_close(want, cuda_mega.mega_trace_adjoint(*adj))
    _grads_close(want, cuda_queue.queue_trace_adjoint(*adj, check_once=True))
    # rows past the staged ones were hit: their slots took cotangents
    flat = torch.cat([want["tex_color"], want["mat_albedo"]]).abs().sum(-1)
    late = tt.mega.table[2048:, mega_tables.X_SLOT].long()
    assert bool((flat[late] > 0).any())


@pytest.mark.cuda
def test_adjoint_wrappers_check_inputs():
    from rt_tpu_torch.ops import cuda_mega, mega_plain

    dev = _card()
    tt = types.build_tables(builders.three_sphere_scene()[0], device=dev)
    tab = tt.mega.table
    ro, rd = (x.to(dev) for x in _rays(64, seed=10))
    state = torch.cat([mega_plain.fresh_state(ro, rd),
                       torch.zeros((6, 64), device=dev)])
    pix = torch.arange(64, device=dev, dtype=torch.int32)
    grad = torch.zeros((8, tt.mega.n_slots), device=dev)
    kw = dict(bg=tt.mega.bg)
    with pytest.raises(ValueError, match="shape"):
        cuda_mega.mega_adjoint_segment(tab, state[:13].contiguous(), pix, 0,
                                       0, 0, 4, grad, **kw)
    with pytest.raises(ValueError, match="shape"):
        cuda_mega.mega_adjoint_segment(tab, state, pix, 0, 0, 0, 4,
                                       grad[:6].contiguous(), **kw)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_mega.mega_adjoint_segment(tab.cpu(), state.cpu(), pix.cpu(), 0,
                                       0, 0, 4, grad.cpu(), **kw)
    with pytest.raises(RuntimeError, match="launch failed"):
        cuda_mega.mega_adjoint_segment(tab, state, pix, 0, 0, 0, 4, grad,
                                       threads=2048, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["queue", "mega"])
def test_replay_step_runs_the_adjoint_kernel(engine):
    """One value-and-grad of make_replay_loss_fn on the card: the backward
    launches the engine's adjoint kernel, and its gradients are the plain
    adjoint's (bwd_kernel=False) within the tolerance."""
    from rt_tpu_torch.diff.replay import make_replay_loss_fn
    from rt_tpu_torch.ops import cuda_mega, cuda_queue

    dev = _card()
    sdef, cfg = builders.cover_scene(width=96, height=54, spp=2,
                                     max_depth=20)
    cfg = cfg.replace(engine=engine, compact_schedule=(2, 3, 5, 10),
                      compact_group=16)
    tt = types.build_tables(sdef, device=dev)
    pix = torch.arange(96 * 54, device=dev)
    tgt = torch.rand((96 * 54, 3), generator=torch.Generator().manual_seed(0)
                     ).to(dev)
    counter = (cuda_queue.queue_adjoint_launch if engine == "queue"
               else cuda_mega.mega_adjoint_segment)
    grads = []
    for bwd_kernel in (None, False):
        params = {k: getattr(tt, k).clone().requires_grad_(True)
                  for k in ("tex_color", "mat_albedo")}
        before = counter.launches
        loss = make_replay_loss_fn(tt, cfg, 2, pix % 96, pix // 96, tgt,
                                   bwd_kernel=bwd_kernel)(params)
        loss.backward()
        torch.cuda.synchronize()
        assert (counter.launches > before) == (bwd_kernel is None)
        grads.append({k: v.grad for k, v in params.items()})
    for k in grads[0]:
        a, b = grads[1][k].double(), grads[0][k].double()
        mag = max(float(a.abs().max()), 1e-12)
        assert float((a - b).abs().max()) <= 1e-5 + 1e-3 * mag, k


@pytest.mark.cuda
@pytest.mark.parametrize("scene,p_rr", [
    ("cover", 0.0), ("cover", 0.9), ((12000, 0), 0.0)],
    ids=["cover", "cover_rr", "rows12000"])
def test_capture_kernel_matches_plain(scene, p_rr):
    """B4 against its plain version at 192x108, depth 50: codes and death
    counts equal on every lane and bounce; with roulette, and with a
    12,000-row table (rows past the staged ones, the kTail path, C-7).
    Its death counts and B2's per-lane bounce counts on the same rays:
    bounces run = death + 1 for a lane that ends early, death for one
    alive at max_depth."""
    from rt_tpu_torch.ops import cuda_mega, mega_plain

    dev = _card()
    tt, cfg, ro, rd, pix, _, _ = _adj_sample(dev, 192, 108, 50, scene=scene,
                                             p_rr=p_rr)
    before = cuda_mega.mega_capture.launches
    codes, death = cuda_mega.mega_capture(tt, cfg, ro, rd, pix, 0, 0)
    torch.cuda.synchronize()
    assert cuda_mega.mega_capture.launches == before + 1
    assert codes.dtype == death.dtype == torch.int32
    assert tuple(codes.shape) == (50, 192 * 108)
    p_codes, p_death = cuda_mega.mega_capture(tt, cfg, ro, rd, pix, 0, 0,
                                              plain=True)
    assert cuda_mega.mega_capture.launches == before + 1
    assert torch.equal(codes, p_codes) and torch.equal(death, p_death)
    if scene != "cover":
        assert int(codes.max()) >= 2048  # rows past the staged ones hit
    state = mega_plain.fresh_state(ro, rd)
    ran = torch.zeros(192 * 108, dtype=torch.int32, device=dev)
    cuda_mega.mega_segment(mega_tables.scene_for(tt, cfg).table, state,
                           pix.to(torch.int32), 0, 0, 0, 50, depth=ran,
                           **mega_plain.trace_options(tt, cfg))
    assert torch.equal(ran, torch.where(death < 50, death + 1, death))


@pytest.mark.cuda
def test_capture_wrapper_checks_inputs():
    from rt_tpu_torch.ops import cuda_mega

    dev = _card()
    tt = types.build_tables(builders.three_sphere_scene()[0], device=dev)
    sdef, cfg = builders.three_sphere_scene()
    ro, rd = (x.to(dev) for x in _rays(64, seed=11))
    pix = torch.arange(64, device=dev)
    with pytest.raises(ValueError, match="want"):
        cuda_mega.mega_capture(tt, cfg, ro, rd, pix[:8], 0, 0)
    with pytest.raises(RuntimeError, match="launch failed"):
        cuda_mega.mega_capture(tt, cfg, ro, rd, pix, 0, 0, threads=2048)


@pytest.mark.cuda
def test_tape_vg_on_card():
    """make_tape_vg on the card (capture on B4) against the full-width
    tape loss on the card, within tests/test_torch_tape.py's vg
    tolerance (loss rtol 2e-4; gradients rtol 2e-3, atol 2e-4 max|g|);
    and the tape's radiance on the card against the CPU's by
    images_close. Card and CPU round sin, exp and log otherwise, so a
    few lanes take other paths, and the gradient rows of a sphere those
    lanes reach move far beyond the vg tolerance: gradients are compared
    on one device."""
    from rt_tpu_torch.diff.tape import (make_tape_loss_fn, make_tape_render,
                                        make_tape_vg)
    from rt_tpu_torch.ops import cuda_mega

    dev = _card()
    sdef, cfg = builders.cover_scene(width=96, height=54, spp=1,
                                     max_depth=12)
    fields = ("sph_center", "sph_radius", "tex_color", "mat_albedo",
              "mat_fuzz", "mat_ior")
    tgt = torch.rand((96 * 54, 3), generator=torch.Generator().manual_seed(1))
    tt = types.build_tables(sdef, device=dev)
    pix = torch.arange(96 * 54, device=dev)
    step = make_tape_vg(tt, cfg, pix % 96, pix // 96, tgt.to(dev),
                        min_width=1024)
    before = cuda_mega.mega_capture.launches
    times = {}
    lk, gk = step({k: getattr(tt, k) for k in fields}, times=times)
    assert cuda_mega.mega_capture.launches == before + 1
    assert min(times["widths"]) < 96 * 54
    p = {k: getattr(tt, k).clone().requires_grad_(True) for k in fields}
    lf = make_tape_loss_fn(tt, cfg, 1, pix % 96, pix // 96, tgt.to(dev))(p)
    lf.backward()
    assert abs(float(lk) - float(lf)) <= 2e-4 * float(lf)
    for k in fields:
        a = p[k].grad
        assert bool(torch.isfinite(gk[k]).all()), k
        torch.testing.assert_close(gk[k], a, rtol=2e-3,
                                   atol=2e-4 * float(a.abs().max()) + 1e-12)
    imgs = []
    for d in (dev, torch.device("cpu")):
        td = types.build_tables(sdef, device=d)
        pd = torch.arange(96 * 54, device=d)
        with torch.no_grad():
            imgs.append(make_tape_render(td, cfg, 2, pd % 96, pd // 96)(
                {"tex_color": td.tex_color}).cpu().numpy())
    diff = np.abs(imgs[0] - imgs[1]).max(-1)
    assert (diff > 2e-3).mean() <= 0.01 and diff.max() <= 0.5


# ---- the regeneration kernel B7 (regen.cu)


def _regen_scene(dev, w, h, spp, depth, scene="cover", **over):
    """(tables, cfg) on the card: cover_scene, the Cornell scene with an
    open lens (defocus and lights), or a random (n, n_mat) scene."""
    if scene == "cover":
        sdef, cfg = builders.cover_scene(width=w, height=h, spp=spp,
                                         max_depth=depth)
    elif scene == "cornell":
        sdef, cfg = builders.cornell_spheres_scene(width=w, height=h,
                                                   spp=spp, max_depth=depth)
        p = sdef.camera_params
        sdef.set_camera(p["lookfrom"], p["lookat"], p["vup"], p["vfov"], 0.2,
                        focus_dist=5.0)
        cfg = cfg.replace(enable_defocus=True)
    else:
        n, n_mat = scene
        sdef, cfg = builders.random_spheres_scene(n, n_mat, width=w,
                                                  height=h, spp=spp,
                                                  max_depth=depth)
    return (types.build_tables(sdef, device=dev),
            cfg.replace(engine="mega", **over))


def _regen_segment(tt, cfg, seg_iters, plain, sample_base=0, seed=0):
    """One init segment of B7 (or its plain version) over every pixel:
    (state, samp, bvec, depth)."""
    from rt_tpu_torch.ops import cuda_mega, mega_plain

    dev = tt.sph_center.device
    w, h = cfg.width, cfg.height
    pix = torch.arange(w * h, dtype=torch.int32, device=dev)
    state = torch.zeros((13, w * h), device=dev)
    samp, bvec, depth = (torch.zeros(w * h, dtype=torch.int32, device=dev)
                         for _ in range(3))
    fn = mega_plain.regen_plain if plain else cuda_mega.mega_regen
    ms = mega_tables.scene_for(tt, cfg)
    fn(ms.table, ms.cam, state, pix, pix // w, samp, bvec,
       sample_base, seed, seg_iters, max_depth=cfg.max_depth,
       spp=cfg.samples_per_pixel, init=True, width=w, height=h,
       defocus=cfg.enable_defocus,
       exhaust_bg=cfg.exhaust_mode == "background", depth=depth,
       **mega_plain.trace_options(tt, cfg))
    return state, samp, bvec, depth


@pytest.mark.cuda
@pytest.mark.parametrize("scene,p_rr", [
    ("cover", 0.0), ("cover", 0.9), ("cornell", 0.9), ((12000, 0), 0.0)],
    ids=["cover", "cover_rr", "cornell_lens", "rows12000"])
def test_regen_kernel_matches_plain(scene, p_rr):
    """B7 against its plain version at 192x108 (the random scene at
    128x96), depth 50, spp 4, one whole segment: every lane's state,
    sample and bounce counters and bounce count bit for bit (regen.cu is
    built without FMA contraction; its camera rays are generate_rays's
    bits)."""
    from rt_tpu_torch.ops import cuda_mega

    dev = _card()
    w, h = (128, 96) if scene == (12000, 0) else (192, 108)
    tt, cfg = _regen_scene(dev, w, h, 4, 50, scene=scene, p_rr=p_rr)
    before = cuda_mega.mega_regen.launches
    got = _regen_segment(tt, cfg, 4 * 51, plain=False, sample_base=2,
                         seed=9)
    torch.cuda.synchronize()
    assert cuda_mega.mega_regen.launches == before + 1
    want = _regen_segment(tt, cfg, 4 * 51, plain=True, sample_base=2,
                          seed=9)
    assert cuda_mega.mega_regen.launches == before + 1
    for k, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), k
    assert bool((got[0][12] == 0.0).all()) and bool((got[1] == 5).all())
    assert float(got[0][9:12].max()) > 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("opts", [
    dict(regen_compact=-1, compact_group=16),
    dict(regen_compact=5, compact_group=128),
    dict(regen_compact=5, compact_group=16, regen_shrink=False),
    dict(regen_compact=-1, compact_group=128, regen_shrink=False)],
    ids=["auto_g16", "every5_g128", "every5_g16_full", "auto_g128_full"])
def test_regen_segments_equal_one_segment(opts):
    """Capped segments, the partition of pending groups and the shrunken
    prefix on the card give the one-launch radiance bit for bit, with the
    same ray-bounces."""
    from rt_tpu_torch.ops import cuda_mega

    dev = _card()
    tt, cfg = _regen_scene(dev, 192, 108, 4, 50)
    pix = torch.arange(192 * 108, device=dev)
    st_one, st_seg = {}, {}
    one = cuda_mega.mega_trace_regen(tt, cfg, pix, pix // 192, 0, 4,
                                     stats=st_one)
    seg = cuda_mega.mega_trace_regen(tt, cfg.replace(**opts), pix,
                                     pix // 192, 0, 4, stats=st_seg)
    assert st_one["launches"] == 1 and st_seg["launches"] > 1
    assert torch.equal(one, seg)
    assert st_one["ray_bounces"] == st_seg["ray_bounces"]


@pytest.mark.cuda
def test_regen_frame_equals_mega_frame():
    """render(engine="mega", regen=True) on the card is the per-sample
    megakernel frame bit for bit, in one launch of B7, with the same
    ray-bounces."""
    from rt_tpu_torch.ops import cuda_mega
    from rt_tpu_torch.render.renderer import render

    dev = _card()
    tt, cfg = _regen_scene(dev, 192, 108, 4, 50,
                           compact_schedule=(2, 3, 5, 10), compact_group=16)
    st_m, st_r = {}, {}
    want = render(tt, cfg, device="cuda", stats=st_m)
    before = cuda_mega.mega_regen.launches
    got = render(tt, cfg.replace(regen=True), device="cuda", stats=st_r)
    torch.cuda.synchronize()
    assert cuda_mega.mega_regen.launches == before + 1 == before + \
        st_r["launches"]
    assert torch.equal(got, want)
    assert st_r["ray_bounces"] == st_m["ray_bounces"] > 0


@pytest.mark.cuda
def test_regen_wrapper_checks_inputs():
    from rt_tpu_torch.ops import cuda_mega, mega_plain

    dev = _card()
    tt, cfg = _regen_scene(dev, 16, 8, 2, 4)
    b = 16 * 8
    pix = torch.arange(b, dtype=torch.int32, device=dev)
    tab = mega_tables.scene_for(tt, cfg).table
    args = [tab, tt.mega.cam, torch.zeros((13, b), device=dev),
            pix, pix // 16, torch.zeros(b, dtype=torch.int32, device=dev),
            torch.zeros(b, dtype=torch.int32, device=dev), 0, 0, 10]
    kw = dict(max_depth=4, spp=2, init=True, width=16, height=8,
              defocus=True, **mega_plain.trace_options(tt, cfg))

    def call(i, x, **over):
        a = list(args)
        a[i] = x
        return cuda_mega.mega_regen(*a, **{**kw, **over})

    with pytest.raises(TypeError):
        call(0, tab.double())
    with pytest.raises(ValueError, match="shape"):
        call(2, args[2][:12].contiguous())
    with pytest.raises(ValueError, match="on cpu"):
        call(3, pix.cpu())
    with pytest.raises(TypeError):
        call(5, args[5].long())
    with pytest.raises(ValueError, match="want 19"):
        call(1, tt.mega.cam[:18])
    with pytest.raises(RuntimeError, match="launch failed"):
        call(6, args[6], threads=2048)
    before = cuda_mega.mega_regen.launches
    call(6, args[6])
    torch.cuda.synchronize()
    assert cuda_mega.mega_regen.launches == before + 1


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _family_scene(dev, name, w, h, spp, depth):
    """A scene with rects, cylinders or triangles, on the card: the
    in-repo demo_scene.json, cover_scene(lights=True), mesh_scene on
    scenes/plane441.obj, dna_scene."""
    from rt_tpu_torch.scene import parser

    if name == "demo":
        sdef, cfg = parser.parse_scene(f"{ROOT}/scenes/demo_scene.json")
        sdef.resize(w, h)
        cfg = cfg.replace(width=w, height=h, samples_per_pixel=spp,
                          max_depth=depth)
    elif name == "mesh":
        sdef, cfg = builders.mesh_scene(f"{ROOT}/scenes/plane441.obj",
                                        width=w, height=h, spp=spp,
                                        max_depth=depth)
    else:
        fn = {"cover_lights": lambda **k: builders.cover_scene(lights=True,
                                                              **k),
              "dna": builders.dna_scene}[name]
        sdef, cfg = fn(width=w, height=h, spp=spp, max_depth=depth)
    return types.build_tables(sdef, device=dev), cfg


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["demo", "cover_lights", "mesh", "dna"])
def test_family_kernels_match_plain(name):
    """B2, B3 and B7 on a scene with rects, cylinders or triangles
    against their plain versions at 192x108: every lane's radiance bit
    for bit (B7 also its sample and bounce counters), one launch each."""
    from rt_tpu_torch.ops import cuda_mega, cuda_queue
    from rt_tpu_torch.ops.camera import generate_rays

    dev = _card()
    depth = 16 if name == "mesh" else 40
    tt, cfg = _family_scene(dev, name, 192, 108, 2, depth)
    assert tt.mega.fam is not None
    px = torch.arange(192 * 108, device=dev)
    ro, rd = generate_rays(tt.camera, 192, 108, px % 192, px // 192, 0, 0,
                           cfg.enable_defocus)
    args = (tt, cfg.replace(engine="mega"), ro, rd, px, 0, 4)
    before = (cuda_mega.mega_segment.launches,
              cuda_queue.queue_launch.launches)
    k_m = cuda_mega.mega_trace(*args)
    k_q = cuda_queue.queue_trace(*args, check_once=True)
    torch.cuda.synchronize()
    assert (cuda_mega.mega_segment.launches,
            cuda_queue.queue_launch.launches) == (before[0] + 1,
                                                  before[1] + 1)
    assert torch.equal(k_m, cuda_mega.mega_trace(*args, plain=True))
    assert torch.equal(k_q, cuda_queue.queue_trace(*args, plain=True))
    assert torch.equal(k_q, k_m) and float(k_m.max()) > 0.0
    cfg_r = cfg.replace(engine="mega")
    got = _regen_segment(tt, cfg_r, 2 * (depth + 1), plain=False)
    want = _regen_segment(tt, cfg_r, 2 * (depth + 1), plain=True)
    for k, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), k


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["demo", "cover_lights"])
def test_family_regen_frame_equals_mega_frame(name):
    """render(engine="mega", regen=True) on a family scene is the
    megakernel frame bit for bit; the queue frame agrees by images_close
    (the conftest's bound)."""
    from rt_tpu_torch.ops import cuda_mega
    from rt_tpu_torch.render.renderer import render

    dev = _card()
    tt, cfg = _family_scene(dev, name, 192, 108, 4, 40)
    cfg = cfg.replace(engine="mega", compact_schedule=(2, 3, 5, 10),
                      compact_group=16)
    st_m, st_r = {}, {}
    want = render(tt, cfg, device="cuda", stats=st_m)
    before = cuda_mega.mega_regen.launches
    got = render(tt, cfg.replace(regen=True), device="cuda", stats=st_r)
    torch.cuda.synchronize()
    assert cuda_mega.mega_regen.launches == before + 1
    assert torch.equal(got, want)
    assert st_r["ray_bounces"] == st_m["ray_bounces"] > 0
    queue = render(tt, cfg.replace(engine="queue"), device="cuda")
    am = want.cpu().double().numpy() / 4
    bm = queue.cpu().double().numpy() / 4
    diff = np.abs(am - bm).max(-1)
    assert (diff > 2e-3).mean() <= 0.01 and diff.max() <= 0.5


@pytest.mark.cuda
def test_family_tables_are_checked():
    """The launchers check the family tables as the sphere table: type,
    shape, device."""
    from rt_tpu_torch.ops import cuda_mega, mega_plain, mega_tables

    dev = _card()
    tt, cfg = _family_scene(dev, "demo", 16, 8, 1, 4)
    state = mega_plain.fresh_state(torch.zeros((8, 3), device=dev),
                                   torch.ones((8, 3), device=dev))
    pix = torch.arange(8, dtype=torch.int32, device=dev)
    kw = mega_plain.trace_options(tt, cfg)
    fam = kw.pop("fam")
    tab = mega_tables.scene_for(tt, cfg).table
    for bad in (fam._replace(rect=fam.rect.double()),
                fam._replace(cyl=fam.cyl[:, :31].contiguous()),
                fam._replace(tri=fam.tri.cpu())):
        with pytest.raises((TypeError, ValueError)):
            cuda_mega.mega_segment(tab, state.clone(), pix, 0, 0, 0, 4,
                                   fam=bad, **kw)
    before = cuda_mega.mega_segment.launches
    cuda_mega.mega_segment(tab, state, pix, 0, 0, 0, 4, fam=fam, **kw)
    assert cuda_mega.mega_segment.launches == before + 1
    assert fam.rect.shape[1] == mega_tables.F_COLS


def _family_adj(dev, name, w, h, depth, **over):
    """Sample 0's camera rays on a family scene with their radiance (the
    queue kernel) and a seeded loss cotangent; "big" is a table past the
    staged rows (3,000 random spheres, 64 materials) with an emissive
    rect, a cylinder and a triangle added (ROADMAP C-7)."""
    from rt_tpu_torch.ops import camera, cuda_queue

    if name == "big":
        sdef, cfg = builders.random_spheres_scene(3000, 64, width=w,
                                                  height=h, max_depth=depth)
        sdef.add_rect("xz_rect", -3, 3, -3, 3, 4.0,
                      sdef.add_diffuse_light_color((4.0, 4.0, 4.0)))
        sdef.add_cylinder(0.5, -0.5, 0.5, sdef.add_metal((0.8, 0.8, 0.7),
                                                         0.1),
                          translate=(0.0, 0.5, 0.0))
        sdef.add_triangle((-2, 0, -1), (2, 0, -1), (0, 2, -1),
                          sdef.add_lambertian_color((0.3, 0.6, 0.3)))
        tt = types.build_tables(sdef, device=dev)
    else:
        tt, cfg = _family_scene(dev, name, w, h, 1, depth)
    cfg = cfg.replace(compact_schedule=(2, 3, 5, 10), compact_group=16,
                      **over)
    pix = torch.arange(w * h, device=dev)
    ro, rd = camera.generate_rays(tt.camera, w, h, pix % w, pix // w, 0, 0,
                                  cfg.enable_defocus)
    L = cuda_queue.queue_trace(tt, cfg, ro, rd, pix, 0, 0)
    g = torch.from_numpy(np.random.default_rng(5).normal(
        0, 1e-3, (w * h, 3)).astype(np.float32)).to(dev)
    return tt, cfg, ro, rd, pix, L, g


@pytest.mark.cuda
@pytest.mark.parametrize("name,over", [
    ("demo", {}), ("demo", {"p_rr": 0.9, "background_mode": "gradient"}),
    ("cover_lights", {}), ("mesh", {}), ("big", {})],
    ids=["demo", "demo_rr", "cover_lights", "mesh", "big"])
def test_family_capture_and_adjoints_match_plain(name, over):
    """B4, B5 and B6 on a scene with rects, cylinders or triangles
    against their plain versions at 192x108 (96x64 for the table past the
    staged rows): B4's codes (`family << 24 | row`) and death counts bit
    for bit, one launch; B5's and B6's gradients per field within
    1e-5 + 1e-3 max|g|, exact and truncated, and B6 against B5."""
    from rt_tpu_torch.ops import cuda_mega, cuda_queue

    dev = _card()
    w, h = (96, 64) if name == "big" else (192, 108)
    depth = 16 if name == "mesh" else 12
    tt, cfg, ro, rd, pix, L, g = _family_adj(dev, name, w, h, depth, **over)
    assert tt.mega.fam is not None
    args = (tt, cfg, ro, rd, pix, 0, 0)
    before = cuda_mega.mega_capture.launches
    codes, death = cuda_mega.mega_capture(*args)
    torch.cuda.synchronize()
    assert cuda_mega.mega_capture.launches == before + 1
    p_codes, p_death = cuda_mega.mega_capture(*args, plain=True)
    assert torch.equal(codes, p_codes) and torch.equal(death, p_death)
    fams = set((codes[codes >= 0] >> 24).tolist())
    assert len(fams) >= 2 and fams <= {0, 1, 2, 3}, fams
    for depth_bwd, exhaust in ((depth, False), (3, False)):
        adj = (*args, L, g, depth_bwd, exhaust)
        want = cuda_queue.queue_trace_adjoint(*adj, plain=True)
        before = (cuda_mega.mega_adjoint_segment.launches,
                  cuda_queue.queue_adjoint_launch.launches)
        k_m = cuda_mega.mega_trace_adjoint(*adj)
        k_q = cuda_queue.queue_trace_adjoint(*adj, check_once=True)
        torch.cuda.synchronize()
        assert cuda_mega.mega_adjoint_segment.launches > before[0]
        assert cuda_queue.queue_adjoint_launch.launches > before[1]
        _grads_close(want, k_m)
        _grads_close(want, k_q)
        _grads_close(k_m, k_q)
        assert float(want["tex_color"].abs().max()) > 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("extra,kernel", [
    ([], "queue_adjoint_launch"), (["--engine", "mega"],
                                   "mega_adjoint_segment"),
    (["--method", "tape", "--fields", "rect_k,cyl_radius,tex_color"],
     "mega_capture")], ids=["replay", "mega", "tape"])
def test_fit_cli_runs_the_kernels(tmp_path, extra, kernel):
    """`python -m rt_tpu_torch fit -f scenes/demo_scene.json` on the card
    at 96x54, depth 8: exit 0 (the loss fell), both files written, and
    the method's kernel launched."""
    from rt_tpu_torch import cli
    from rt_tpu_torch.ops import cuda_mega, cuda_queue
    from rt_tpu_torch.render.renderer import render

    dev = _card()
    tt, cfg = _family_scene(dev, "demo", 96, 54, 16, 8)
    tc = tt.tex_color.clone()
    tc[3] *= 0.8
    tc[1] = torch.tensor([0.2, 0.6, 0.3], device=dev)
    import dataclasses
    img = render(dataclasses.replace(tt, tex_color=tc), cfg, device="cuda")
    np.savez(tmp_path / "t.npz", img=(img / 16).cpu().numpy())
    counts = {"queue_adjoint_launch": cuda_queue.queue_adjoint_launch,
              "mega_adjoint_segment": cuda_mega.mega_adjoint_segment,
              "mega_capture": cuda_mega.mega_capture}
    before = counts[kernel].launches
    rc = cli.main(["fit", "-f", f"{ROOT}/scenes/demo_scene.json",
                   "--target", str(tmp_path / "t.npz"), "--fields",
                   "tex_color,mat_albedo", "-spp", "4", "--steps", "3",
                   "-d", "8", "--out", str(tmp_path / "out")] + extra)
    assert rc == 0
    assert counts[kernel].launches > before
    for f in ("recovered.npz", "after.png"):
        assert (tmp_path / "out" / f).stat().st_size > 0


def _light_scene(dev, w, h, depth):
    """tests/test_torch_nee.py's scene (the four light families, a checker
    light, a fuzzy metal and a glass sphere) on the card."""
    s = types.SceneDef(width=w, height=h, samples_per_pixel=1,
                       max_depth=depth, background=(0.0, 0.0, 0.0))
    s.add_sphere((0, 0, -2), 0.5, s.add_lambertian_color((0.6, 0.4, 0.3)))
    s.add_sphere((0, -100.5, -2), 100,
                 s.add_lambertian_color((0.5, 0.5, 0.55)))
    s.add_sphere((1.6, 0.4, -1.4), 0.25, s.add_diffuse_light(
        s.add_checker((8.0, 3.0, 3.0), (3.0, 8.0, 3.0))))
    s.add_rect("xz_rect", -0.8, 0.8, -2.8, -1.2, 2.0,
               s.add_diffuse_light_color((6.0, 5.5, 5.0)))
    s.add_cylinder(0.2, -0.3, 0.3, s.add_diffuse_light_color((2.0, 4.0, 8.0)),
                   rotate=((1, 0, 0), 90.0), translate=(-1.5, 0.6, -2.0))
    s.add_triangle((-2.2, 0.1, -2.6), (-1.4, 0.1, -3.0), (-1.8, 1.0, -2.8),
                   s.add_diffuse_light_color((7.0, 2.0, 6.0)))
    s.add_sphere((-0.9, -0.2, -1.5), 0.3, s.add_metal((0.8, 0.8, 0.7), 0.3))
    s.add_sphere((0.9, -0.25, -1.4), 0.25, s.add_dielectric(1.5))
    s.set_camera((0, 0.4, 1.2), (0, 0, -2), (0, 1, 0), 55, 0.0)
    from rt_tpu_torch.config import RenderConfig

    return types.build_tables(s, device=dev), RenderConfig(
        width=w, height=h, samples_per_pixel=1, max_depth=depth)


NEE_FLAGS = {"nee": dict(nee=True), "mis": dict(nee=True, mis=True),
             "glossy": dict(nee=True, nee_glossy=True),
             "mis_glossy": dict(nee=True, mis=True, nee_glossy=True)}


def _nee_scene(dev, name, w, h, depth):
    if name == "lights":
        return _light_scene(dev, w, h, depth)
    return _family_scene(dev, name, w, h, 1, depth)


@pytest.mark.cuda
@pytest.mark.parametrize("flags", sorted(NEE_FLAGS))
@pytest.mark.parametrize("name", ["lights", "demo"])
def test_nee_kernels_match_plain(name, flags):
    """B2 and B3 with light sampling (the kNee instantiations) against
    their plain versions at 192x108, depth 8, p_rr 0 and 0.9: every
    lane's radiance bit for bit, the kernels launched."""
    from rt_tpu_torch.ops import cuda_mega, cuda_queue
    from rt_tpu_torch.ops.camera import generate_rays

    dev = _card()
    tt, cfg = _nee_scene(dev, name, 192, 108, 8)
    assert tt.n_lights > 0 and tt.mega.lights is not None
    px = torch.arange(192 * 108, device=dev)
    ro, rd = generate_rays(tt.camera, 192, 108, px % 192, px // 192, 1, 0,
                           cfg.enable_defocus)
    for p_rr in (0.0, 0.9):
        c = cfg.replace(p_rr=p_rr, max_depth=8, **NEE_FLAGS[flags])
        for fn, eng, count in (
                (cuda_mega.mega_trace, "mega", cuda_mega.mega_segment),
                (cuda_queue.queue_trace, "queue", cuda_queue.queue_launch)):
            ce = c.replace(engine=eng, compact_every=2, queue_steps=3)
            before = count.launches
            k = fn(tt, ce, ro, rd, px, 1, 0)
            torch.cuda.synchronize()
            assert count.launches > before, eng
            assert torch.equal(k, fn(tt, ce, ro, rd, px, 1, 0, plain=True)), \
                (eng, p_rr)
            assert float(k.max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["lights", "demo"])
def test_nee_adjoints_match_plain(name):
    """B5 and B6 with NEE (the kNee instantiations: the direct term's
    credits to the winner's slot and the light's) against the plain
    adjoint, within 1e-5 + 1e-3 max|g| per field, and B6 against B5."""
    from rt_tpu_torch.ops import camera, cuda_mega, cuda_queue

    dev = _card()
    tt, cfg = _nee_scene(dev, name, 192, 108, 8)
    cfg = cfg.replace(nee=True, compact_every=2)
    pix = torch.arange(192 * 108, device=dev)
    ro, rd = camera.generate_rays(tt.camera, 192, 108, pix % 192, pix // 192,
                                  0, 0, cfg.enable_defocus)
    L = cuda_queue.queue_trace(tt, cfg.replace(engine="queue"), ro, rd, pix,
                               0, 0)
    g = torch.from_numpy(np.random.default_rng(6).normal(
        0, 1e-3, (192 * 108, 3)).astype(np.float32)).to(dev)
    adj = (tt, cfg, ro, rd, pix, 0, 0, L, g, 8, False)
    want = cuda_queue.queue_trace_adjoint(*adj, plain=True)
    before = (cuda_mega.mega_adjoint_segment.launches,
              cuda_queue.queue_adjoint_launch.launches)
    k_m = cuda_mega.mega_trace_adjoint(*adj)
    k_q = cuda_queue.queue_trace_adjoint(*adj, check_once=True)
    torch.cuda.synchronize()
    assert cuda_mega.mega_adjoint_segment.launches > before[0]
    assert cuda_queue.queue_adjoint_launch.launches > before[1]
    _grads_close(want, k_m)
    _grads_close(want, k_q)
    _grads_close(k_m, k_q)
    assert float(want["tex_color"].abs().max()) > 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("extra,kernel", [
    ([], "queue_adjoint_launch"), (["--engine", "mega"],
                                   "mega_adjoint_segment"),
    (["--method", "tape"], "mega_capture")], ids=["replay", "mega", "tape"])
def test_fit_cli_nee_runs_the_kernels(tmp_path, extra, kernel):
    """`fit -f scenes/demo_scene.json --nee` on the card at 96x54, depth
    8: exit 0 (the loss fell) and the method's kernel launched."""
    from rt_tpu_torch import cli
    from rt_tpu_torch.ops import cuda_mega, cuda_queue
    from rt_tpu_torch.render.renderer import render

    dev = _card()
    tt, cfg = _family_scene(dev, "demo", 96, 54, 16, 8)
    tc = tt.tex_color.clone()
    tc[3] *= 0.8
    tc[1] = torch.tensor([0.2, 0.6, 0.3], device=dev)
    import dataclasses
    img = render(dataclasses.replace(tt, tex_color=tc),
                 cfg.replace(engine="queue", nee=True), device="cuda")
    np.savez(tmp_path / "t.npz", img=(img / 16).cpu().numpy())
    counts = {"queue_adjoint_launch": cuda_queue.queue_adjoint_launch,
              "mega_adjoint_segment": cuda_mega.mega_adjoint_segment,
              "mega_capture": cuda_mega.mega_capture}
    before = counts[kernel].launches
    rc = cli.main(["fit", "-f", f"{ROOT}/scenes/demo_scene.json",
                   "--target", str(tmp_path / "t.npz"), "--fields",
                   "tex_color,mat_albedo", "-spp", "4", "--steps", "3",
                   "-d", "8", "--nee", "--out", str(tmp_path / "out")]
                  + extra)
    assert rc == 0
    assert counts[kernel].launches > before


def _image_scene(dev, name, w, h, depth, tmp_path):
    """A scene with image textures on the card: "families", two 64x64
    seeded images on a sphere, both rect orientations, a cylinder and a
    triangle, with an image-textured sphere light and triangle light
    (tests/test_torch_images.py's scene, without JAX); "demo", a copy of
    demo_scene.json with image textures on the blue sphere and the
    xz_rect light; "mesh", mesh_scene on plane441.obj textured, with the
    Taichi UV swap."""
    import json

    from rt_tpu_torch.config import RenderConfig
    from rt_tpu_torch.io.image import write_png
    from rt_tpu_torch.scene import parser

    rs = np.random.default_rng(7)
    a, b = (rs.random((64, 64, 3)).astype(np.float32) for _ in range(2))
    if name == "families":
        s = types.SceneDef(width=w, height=h, samples_per_pixel=1,
                           max_depth=depth, background=(0.2, 0.25, 0.3))
        ta, tb = s.add_image_texture(a), s.add_image_texture(b)
        ma, mb = s.add_lambertian(ta), s.add_lambertian(tb)
        s.add_sphere((0, 0, -2), 0.5, ma)
        s.add_sphere((0, -100.5, -2), 100, s.add_lambertian(
            s.add_checker((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))))
        s.add_rect("xy_rect", -2, 2, -1, 2, -3.5, mb)
        s.add_rect("yz_rect", -1, 1, -3, -1, 1.8, ma)
        s.add_cylinder(0.25, -0.3, 0.3, mb, rotate=((1, 0, 0), 90.0),
                       translate=(0.9, -0.2, -1.6))
        s.add_triangle((0.4, -0.5, -1.2), (0.9, -0.5, -1.4),
                       (0.6, 0.2, -1.3), ma, uv1=(0, 0), uv2=(1, 0),
                       uv3=(0, 1))
        s.add_sphere((-0.9, -0.2, -1.5), 0.3,
                     s.add_metal((0.8, 0.8, 0.7), 0.3))
        s.add_sphere((-0.4, -0.3, -1.2), 0.2, s.add_dielectric(1.5))
        s.add_sphere((1.6, 0.4, -1.4), 0.25, s.add_diffuse_light(tb))
        s.add_triangle((-2.2, 0.1, -2.6), (-1.4, 0.1, -3.0),
                       (-1.8, 1.0, -2.8), s.add_diffuse_light(ta),
                       uv1=(0.1, 0.2), uv2=(0.9, 0.1), uv3=(0.5, 0.8))
        s.set_camera((0, 0.3, 1.2), (0, 0, -2), (0, 1, 0), 55, 0.0)
        return types.build_tables(s, device=dev), RenderConfig(
            width=w, height=h, samples_per_pixel=1, max_depth=depth)
    png = str(tmp_path / "a.png")
    write_png(png, (a * 255).astype(np.uint8))
    if name == "mesh":
        sdef, cfg = builders.mesh_scene(f"{ROOT}/scenes/plane441.obj",
                                        width=w, height=h, spp=1,
                                        max_depth=depth, texture_path=png)
        sdef.taichi_tri_uv = True
        return types.build_tables(sdef, device=dev), cfg
    write_png(str(tmp_path / "b.png"), (b * 255).astype(np.uint8))
    data = json.loads(open(f"{ROOT}/scenes/demo_scene.json").read())
    tex = data["texture"]["data"]
    tex += [{"type": "image", "file": "a.png"},
            {"type": "image", "file": "b.png"}]
    data["material"]["data"][1]["texture"] = len(tex) - 2
    data["material"]["data"][4]["texture"] = len(tex) - 1
    path = tmp_path / "textured.json"
    path.write_text(json.dumps(data))
    sdef, cfg = parser.parse_scene(str(path))
    sdef.resize(w, h)
    return types.build_tables(sdef, device=dev), cfg.replace(
        width=w, height=h, samples_per_pixel=1, max_depth=depth)


IMG_FLAGS = {"none": {}, "nee": dict(nee=True),
             "mis_glossy": dict(nee=True, mis=True, nee_glossy=True)}


@pytest.mark.cuda
@pytest.mark.parametrize("flags", sorted(IMG_FLAGS))
@pytest.mark.parametrize("name", ["families", "demo"])
def test_image_kernels_match_plain(tmp_path, name, flags):
    """B2 and B3 with image textures (the kImages instantiations; with
    nee, an image-textured light's texel at the light point) against their
    plain versions at 192x108, depth 8, p_rr 0 and 0.9: every lane's
    radiance bit for bit (atan2f / acosf are torch.atan2 / torch.acos's
    libdevice calls), the kernels launched."""
    from rt_tpu_torch.ops import cuda_mega, cuda_queue
    from rt_tpu_torch.ops.camera import generate_rays

    dev = _card()
    tt, cfg = _image_scene(dev, name, 192, 108, 8, tmp_path)
    assert tt.mega.img is not None and tt.nee_img
    px = torch.arange(192 * 108, device=dev)
    ro, rd = generate_rays(tt.camera, 192, 108, px % 192, px // 192, 1, 0,
                           cfg.enable_defocus)
    for p_rr in (0.0, 0.9):
        c = cfg.replace(p_rr=p_rr, max_depth=8, **IMG_FLAGS[flags])
        for fn, eng, count in (
                (cuda_mega.mega_trace, "mega", cuda_mega.mega_segment),
                (cuda_queue.queue_trace, "queue", cuda_queue.queue_launch)):
            ce = c.replace(engine=eng, compact_every=2, queue_steps=3)
            before = count.launches
            k = fn(tt, ce, ro, rd, px, 1, 0)
            torch.cuda.synchronize()
            assert count.launches > before, eng
            assert torch.equal(k, fn(tt, ce, ro, rd, px, 1, 0, plain=True)), \
                (eng, p_rr)
            assert float(k.max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["families", "mesh"])
def test_image_capture_and_regen_match_plain(tmp_path, name):
    """B4 takes textured tables and B7 samples the atlas (kImages): both
    equal their plain versions on every lane at 192x108, depth 8, p_rr
    0.9, and the regen frame equals the mega frame bit for bit."""
    from rt_tpu_torch.ops import cuda_mega
    from rt_tpu_torch.ops.camera import generate_rays
    from rt_tpu_torch.render.renderer import render

    dev = _card()
    tt, cfg = _image_scene(dev, name, 192, 108, 8, tmp_path)
    cfg = cfg.replace(p_rr=0.9, samples_per_pixel=2)
    px = torch.arange(192 * 108, device=dev)
    ro, rd = generate_rays(tt.camera, 192, 108, px % 192, px // 192, 0, 0,
                           cfg.enable_defocus)
    before = cuda_mega.mega_capture.launches
    codes, death = cuda_mega.mega_capture(tt, cfg, ro, rd, px, 0, 0)
    torch.cuda.synchronize()
    assert cuda_mega.mega_capture.launches == before + 1
    p_codes, p_death = cuda_mega.mega_capture(tt, cfg, ro, rd, px, 0, 0,
                                              plain=True)
    assert torch.equal(codes, p_codes) and torch.equal(death, p_death)
    before = cuda_mega.mega_regen.launches
    regen = render(tt, cfg.replace(engine="mega", regen=True), device="cuda")
    assert cuda_mega.mega_regen.launches > before
    mega = render(tt, cfg.replace(engine="mega"), device="cuda")
    assert torch.equal(regen, mega)
    pix = px.to(torch.int32)
    k = cuda_mega.mega_trace_regen(tt, cfg.replace(engine="mega"), pix,
                                   pix // 192, 0, 2)
    p = cuda_mega.mega_trace_regen(tt, cfg.replace(engine="mega"), pix,
                                   pix // 192, 0, 2, plain=True)
    assert torch.equal(k, p) and float(k.max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("nee", [False, True])
@pytest.mark.parametrize("name", ["families", "demo"])
def test_image_adjoints_match_plain(tmp_path, name, nee):
    """B5 and B6 with the atlas gradient (one atomicAdd per channel of a
    texel-sampled hit; with nee also the image lights' Le cotangent)
    against the plain adjoint, within 1e-5 + 1e-3 max|g| per field, the
    atlas included, and B6 against B5."""
    from rt_tpu_torch.ops import camera, cuda_mega, cuda_queue

    dev = _card()
    tt, cfg = _image_scene(dev, name, 192, 108, 8, tmp_path)
    cfg = cfg.replace(nee=nee, compact_every=2)
    pix = torch.arange(192 * 108, device=dev)
    ro, rd = camera.generate_rays(tt.camera, 192, 108, pix % 192, pix // 192,
                                  0, 0, cfg.enable_defocus)
    L = cuda_queue.queue_trace(tt, cfg.replace(engine="queue"), ro, rd, pix,
                               0, 0)
    g = torch.from_numpy(np.random.default_rng(6).normal(
        0, 1e-3, (192 * 108, 3)).astype(np.float32)).to(dev)
    adj = (tt, cfg, ro, rd, pix, 0, 0, L, g, 8, False)
    want = cuda_queue.queue_trace_adjoint(*adj, plain=True)
    before = (cuda_mega.mega_adjoint_segment.launches,
              cuda_queue.queue_adjoint_launch.launches)
    k_m = cuda_mega.mega_trace_adjoint(*adj)
    k_q = cuda_queue.queue_trace_adjoint(*adj, check_once=True)
    torch.cuda.synchronize()
    assert cuda_mega.mega_adjoint_segment.launches > before[0]
    assert cuda_queue.queue_adjoint_launch.launches > before[1]
    for a, b in ((want, k_m), (want, k_q), (k_m, k_q)):
        for key in ADJ_FIELDS + ("images",):
            x, y = a[key].double(), b[key].double()
            assert x.shape == y.shape, key
            mag = max(float(x.abs().max()), 1e-12)
            assert float((x - y).abs().max()) <= 1e-5 + 1e-3 * mag, key
    assert float(want["images"].abs().max()) > 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("extra,kernel", [
    ([], "queue_adjoint_launch"), (["--engine", "mega"],
                                   "mega_adjoint_segment"),
    (["--method", "tape"], "mega_capture")], ids=["replay", "mega", "tape"])
def test_fit_cli_images_runs_the_kernels(tmp_path, extra, kernel):
    """`fit -f <the textured demo copy> --fields images` on the card at
    96x54, depth 8: exit 0 (the loss fell) and the method's kernel
    launched."""
    from rt_tpu_torch import cli
    from rt_tpu_torch.ops import cuda_mega, cuda_queue
    from rt_tpu_torch.render.renderer import render

    dev = _card()
    tt, cfg = _image_scene(dev, "demo", 96, 54, 8, tmp_path)
    img = tt.images.clone()
    img[0] = img[0] * 0.5 + 0.25
    import dataclasses
    out = render(dataclasses.replace(tt, images=img),
                 cfg.replace(engine="queue", samples_per_pixel=16),
                 device="cuda")
    np.savez(tmp_path / "t.npz", img=(out / 16).cpu().numpy())
    counts = {"queue_adjoint_launch": cuda_queue.queue_adjoint_launch,
              "mega_adjoint_segment": cuda_mega.mega_adjoint_segment,
              "mega_capture": cuda_mega.mega_capture}
    before = counts[kernel].launches
    rc = cli.main(["fit", "-f", str(tmp_path / "textured.json"),
                   "--target", str(tmp_path / "t.npz"), "--fields",
                   "images", "-spp", "4", "--steps", "3", "-d", "8",
                   "--out", str(tmp_path / "out")] + extra)
    assert rc == 0
    assert counts[kernel].launches > before


FLAG_SETTINGS = {"qmc": dict(sampler="qmc"),
                 "qmc_no_cull_rr": dict(sampler="qmc", cull_chunks=False,
                                        p_rr=0.9),
                 "cull": dict(cull_chunks=True),
                 "cull_nee_mis": dict(cull_chunks=True, nee=True, mis=True)}


def _flag_scene(dev, name):
    if name == "cover":
        sdef, cfg = builders.cover_scene(width=192, height=108, spp=1,
                                         max_depth=12)
        return types.build_tables(sdef, device=dev), cfg
    if name == "lights":
        return _light_scene(dev, 192, 108, 8)
    return _family_scene(dev, name, 192, 108, 1, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("setting", sorted(FLAG_SETTINGS))
@pytest.mark.parametrize("name", ["cover", "mesh", "lights"])
def test_qmc_and_culled_kernels_match_plain(name, setting):
    """B2 and B3 (with the setting's light sampler), B4 and B7 under the
    sampler "qmc" and under chunk culling against their plain versions
    at 192x108: every lane bit for bit (B4's codes and deaths, B7's
    every word), the kernels launched; B5 / B6 (NEE without MIS) within
    1e-5 + 1e-3 max|g| per field."""
    from rt_tpu_torch.ops import camera, cuda_mega, cuda_queue, mega_tables

    dev = _card()
    tt, cfg = _flag_scene(dev, name)
    cfg = cfg.replace(compact_every=2, queue_steps=3,
                      **FLAG_SETTINGS[setting])
    if cfg.cull_chunks:
        assert mega_tables.scene_for(tt, cfg).cull is not None
    px = torch.arange(192 * 108, device=dev)
    ro, rd = camera.generate_rays(tt.camera, 192, 108, px % 192, px // 192,
                                  0, 0, cfg.enable_defocus, cfg.sampler)
    for fn, eng, count in (
            (cuda_mega.mega_trace, "mega", cuda_mega.mega_segment),
            (cuda_queue.queue_trace, "queue", cuda_queue.queue_launch)):
        ce = cfg.replace(engine=eng)
        before = count.launches
        k = fn(tt, ce, ro, rd, px, 0, 0)
        torch.cuda.synchronize()
        assert count.launches > before, eng
        assert torch.equal(k, fn(tt, ce, ro, rd, px, 0, 0, plain=True)), eng
    c0 = cfg.replace(nee=False, mis=False)
    codes, death = cuda_mega.mega_capture(tt, c0, ro, rd, px, 0, 0)
    p_codes, p_death = cuda_mega.mega_capture(tt, c0, ro, rd, px, 0, 0,
                                              plain=True)
    assert torch.equal(codes, p_codes) and torch.equal(death, p_death)
    assert int(codes.max()) >= 0
    for a, b in zip(_regen_segment(tt, c0, 14, False),
                    _regen_segment(tt, c0, 14, True)):
        assert torch.equal(a, b)
    ca = cfg.replace(mis=False)
    L = cuda_queue.queue_trace(tt, ca, ro, rd, px, 0, 0)
    g = torch.from_numpy(np.random.default_rng(3).normal(
        0, 1e-3, (192 * 108, 3)).astype(np.float32)).to(dev)
    adj = (tt, ca, ro, rd, px, 0, 0, L, g, 8, False)
    want = cuda_queue.queue_trace_adjoint(*adj, plain=True)
    _grads_close(want, cuda_mega.mega_trace_adjoint(*adj))
    _grads_close(want, cuda_queue.queue_trace_adjoint(*adj, check_once=True))


@pytest.mark.cuda
def test_culled_launchers_check_the_sorted_table():
    """The chunk boxes go with the sorted sphere table: a launcher given
    the table in scene order beside culled options raises before the
    kernel; the boxes are checked for type and shape."""
    from rt_tpu_torch.ops import cuda_mega, mega_plain, mega_tables

    dev = _card()
    tt = types.build_tables(builders.cover_scene()[0], device=dev)
    from rt_tpu_torch.config import RenderConfig

    cfg = RenderConfig()
    kw = mega_plain.trace_options(tt, cfg)
    state = mega_plain.fresh_state(torch.zeros((8, 3), device=dev),
                                   torch.ones((8, 3), device=dev))
    pix = torch.arange(8, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="sorted"):
        cuda_mega.mega_segment(tt.mega.table, state.clone(), pix, 0, 0, 0, 4,
                               **kw)
    tab = mega_tables.scene_for(tt, cfg).table
    bad = kw["cull"]._replace(sph=kw["cull"].sph[:, :6].contiguous())
    with pytest.raises(ValueError, match="shape"):
        cuda_mega.mega_segment(tab, state.clone(), pix, 0, 0, 0, 4,
                               **{**kw, "cull": bad})
    before = cuda_mega.mega_segment.launches
    cuda_mega.mega_segment(tab, state, pix, 0, 0, 0, 4, **kw)
    assert cuda_mega.mega_segment.launches == before + 1


def _smoke():
    """chip_smoke.py as a module (its tie scene and its scratch builds of
    B3 / B6)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
@pytest.mark.parametrize("dense_max", [None, 0, 32])
@pytest.mark.parametrize("name", ["ties", "mesh"])
def test_warp_hit_on_ties_matches_plain(name, dense_max):
    """B3 / B6's warp-cooperative closest hit (bounce.cuh warp_hit) on
    equal hits at 192x108: chip_smoke.tie_scene (spheres given twice in one
    chunk, one sphere given 40 times across two chunks, each copy its own
    colour) and the grid mesh's shared edges, in the default build (None)
    and the scratch builds with kDenseMax 0 (the per-lane loop) and 32
    (always dense): B3 bit for bit against its plain version at
    queue_steps 0 and 3, B6 within 1e-5 + 1e-3 max|g| of the plain adjoint
    and of B5 (the default build's); in the same build B5 (mega_adjoint.cu)
    within that of the plain adjoint and of B6, B7's regen render
    (regen.cu, spp 2) bit for bit against its plain version, and B4's
    codes and deaths (capture.cu) bit for bit against capture_plain with
    p_rr 0 and 0.9 (a lane the roulette stops still records its
    winner)."""
    from rt_tpu_torch.ops import camera, cuda_mega, cuda_queue

    dev = _card()
    smoke = _smoke()
    if name == "ties":
        sdef, cfg = smoke.tie_scene(192, 108, 12)
        tt = types.build_tables(sdef, device=dev)
    else:
        tt, cfg = _family_scene(dev, "mesh", 192, 108, 1, 8)
    assert mega_tables.scene_for(tt, cfg).cull is not None
    px = torch.arange(192 * 108, device=dev)
    ro, rd = camera.generate_rays(tt.camera, 192, 108, px % 192, px // 192,
                                  0, 0, cfg.enable_defocus)
    want = cuda_queue.queue_trace(tt, cfg, ro, rd, px, 0, 0, plain=True)
    g = torch.from_numpy(np.random.default_rng(4).normal(
        0, 1e-3, (192 * 108, 3)).astype(np.float32)).to(dev)
    adj = (tt, cfg, ro, rd, px, 0, 0, want, g, cfg.max_depth, False)
    g_plain = cuda_queue.queue_trace_adjoint(*adj, plain=True)
    g_b5 = cuda_mega.mega_trace_adjoint(*adj)
    regen = (tt, cfg.replace(engine="mega"), px, px // 192, 3, 2)
    want_r = cuda_mega.mega_trace_regen(*regen, plain=True)
    cap_cfgs = [cfg.replace(p_rr=p) for p in (0.0, 0.9)]
    want_c = [cuda_mega.mega_capture(tt, c, ro, rd, px, 0, 0, plain=True)
              for c in cap_cfgs]
    with smoke.dense_schedule(dense_max):
        for steps in (0, 3):
            before = cuda_queue.queue_launch.launches
            got = cuda_queue.queue_trace(tt, cfg.replace(queue_steps=steps),
                                         ro, rd, px, 0, 0, check_once=True)
            assert cuda_queue.queue_launch.launches > before
            assert torch.equal(got, want), steps
        g6 = cuda_queue.queue_trace_adjoint(*adj, check_once=True)
        before = cuda_mega.mega_adjoint_segment.launches
        g5 = cuda_mega.mega_trace_adjoint(*adj)
        assert cuda_mega.mega_adjoint_segment.launches > before
        before = cuda_mega.mega_regen.launches
        got_r = cuda_mega.mega_trace_regen(*regen)
        torch.cuda.synchronize()
        assert cuda_mega.mega_regen.launches > before
        got_c = []
        for c in cap_cfgs:
            before = cuda_mega.mega_capture.launches
            got_c.append(cuda_mega.mega_capture(tt, c, ro, rd, px, 0, 0))
            assert cuda_mega.mega_capture.launches == before + 1
    for (codes, death), (p_codes, p_death), c in zip(got_c, want_c,
                                                     cap_cfgs):
        assert torch.equal(codes, p_codes), c.p_rr
        assert torch.equal(death, p_death), c.p_rr
    # the roulette stops lanes on a hit, whose code they record
    def died_on_a_hit(codes, death):
        at = codes.gather(0, death.long().clamp(max=codes.shape[0] - 1)[None])
        return int(((death < codes.shape[0]) & (at[0] >= 0)).sum())

    assert died_on_a_hit(*want_c[1]) > died_on_a_hit(*want_c[0])
    _grads_close(g_plain, g6)
    _grads_close(g_b5, g6)
    _grads_close(g_plain, g5)
    _grads_close(g5, g6)
    assert torch.equal(got_r, want_r)


def _ragged_scene(dev, case, w, h, tmp_path, tail=(3000, 64)):
    """(tables, cfg) at depth 6 of one instantiation of the warp loops:
    "tail" (random_spheres_scene(*tail): spheres past the staged rows,
    n_materials shared materials or one a sphere), "families" (the mesh,
    culled), "nee" (every light family; cfg.nee left to the caller),
    "images" (the families textured), "qmc" (cover, culled, p_rr 0.9)."""
    if case == "tail":
        sdef, cfg = builders.random_spheres_scene(*tail, width=w, height=h,
                                                  max_depth=6)
        return types.build_tables(sdef, device=dev), cfg
    if case == "families":
        return _family_scene(dev, "mesh", w, h, 1, 6)
    if case == "nee":
        return _light_scene(dev, w, h, 6)
    if case == "images":
        return _image_scene(dev, "families", w, h, 6, tmp_path)
    sdef, cfg = builders.cover_scene(width=w, height=h, spp=1, max_depth=6)
    return (types.build_tables(sdef, device=dev),
            cfg.replace(sampler="qmc", p_rr=0.9))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["tail", "families", "nee", "images",
                                  "qmc"])
def test_mega_segment_ragged_lanes_match_plain(tmp_path, case):
    """B2's warp-cooperative loop (every thread of a warp stays in it; a
    thread past n or with a dead lane only helps with the hit) on one
    segment, in the kTail (3,000 rows), kFamilies (the mesh, culled),
    kNee (with MIS, on a scene of every family), kImages and kQmc
    (culled, p_rr 0.9) instantiations:
    n = 2,997 lanes of 3,072 (not a multiple of 32), every seventh lane
    dead on entry, a per-lane sample array, start bounce 2, 6 bounces,
    the sky credited at the end and the depth counter, against
    mega_segment_plain bit for bit; lanes past n are left as they were."""
    from rt_tpu_torch.ops import camera, cuda_mega, mega_plain

    dev = _card()
    w, h = 64, 48
    tt, cfg = _ragged_scene(dev, case, w, h, tmp_path)
    if case in ("nee", "images"):
        cfg = cfg.replace(nee=True, mis=case == "nee")
    kw = mega_plain.trace_options(tt, cfg)
    nee = mega_plain.nee_options(tt, cfg)
    tab = mega_tables.scene_for(tt, cfg).table
    assert (case == "tail") == (tab.shape[0] > 2048)
    assert (case in ("families", "nee", "images")) == (kw["fam"] is not
                                                      None)
    assert (case in ("nee", "images")) == (nee is not None)
    assert (case == "images") == (kw["img"] is not None)
    px = torch.arange(w * h, device=dev)
    ro, rd = camera.generate_rays(tt.camera, w, h, px % w, px // w, 3, 0,
                                  cfg.enable_defocus, cfg.sampler)
    state = mega_plain.fresh_state(ro, rd)
    state[mega_plain.ALIVE, ::7] = 0.0
    n = w * h - 75
    rs = np.random.default_rng(12)
    sample = torch.from_numpy(rs.integers(0, 9, w * h).astype(np.int32)).to(
        dev)
    pix = px.to(torch.int32)
    depth0 = torch.from_numpy(rs.integers(0, 3, w * h).astype(np.int32)).to(
        dev)
    got, want = state.clone(), state.clone()
    d_got, d_want = depth0.clone(), depth0.clone()
    seg = dict(n=n, exhaust_bg=True, nee=nee, **kw)
    before = cuda_mega.mega_segment.launches
    cuda_mega.mega_segment(tab, got, pix, sample, 5, 2, 6, depth=d_got,
                           **seg)
    torch.cuda.synchronize()
    assert cuda_mega.mega_segment.launches == before + 1
    cuda_mega.mega_segment_plain(tab, want, pix, sample, 5, 2, 6,
                                 depth=d_want, **seg)
    assert torch.equal(got, want)
    assert torch.equal(d_got, d_want)
    assert torch.equal(got[:, n:], state[:, n:])
    alive = state[mega_plain.ALIVE, :n] > 0.0
    assert bool(((d_got - depth0)[:n][alive] >= 1).all())
    assert bool(((d_got - depth0)[:n][~alive] == 0).all())


@pytest.mark.cuda
def test_mega_segment_refuses_threads_off_the_warp():
    """The warp-cooperative hit needs whole warps: threads=48 is refused
    before the launch; 64 launches."""
    from rt_tpu_torch.ops import cuda_mega, mega_plain

    dev = _card()
    tt = types.build_tables(builders.three_sphere_scene()[0], device=dev)
    ro, rd = (x.to(dev) for x in _rays(100, seed=11))
    pix = torch.arange(100, device=dev, dtype=torch.int32)
    before = cuda_mega.mega_segment.launches
    with pytest.raises(ValueError, match="multiple of 32"):
        cuda_mega.mega_segment(tt.mega.table, mega_plain.fresh_state(ro, rd),
                               pix, 0, 0, 0, 4, bg=tt.mega.bg, threads=48)
    assert cuda_mega.mega_segment.launches == before
    got = mega_plain.fresh_state(ro, rd)
    cuda_mega.mega_segment(tt.mega.table, got, pix, 0, 0, 0, 4,
                           bg=tt.mega.bg, threads=64)
    want = cuda_mega.mega_segment_plain(tt.mega.table,
                                        mega_plain.fresh_state(ro, rd), pix,
                                        0, 0, 0, 4, bg=tt.mega.bg)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["tail", "families", "images", "qmc"])
def test_regen_ragged_lanes_match_plain(tmp_path, case):
    """B7's warp loop (regen.cu: every thread of a warp stays in it; a
    thread past n, or whose lane is not pending on entry, only helps) on
    resumed segments (init 0) in its kTail, kFamilies, kImages and kQmc
    (culled, p_rr 0.9) instantiations: 1,000 lanes of 1,024 at 256
    threads, entered from three iterations of an init segment, every
    fifth lane then dead with no sample owed (not pending) and every
    seventh dead with samples owed; a segment of 5 iterations, then one
    to the end, each against regen_plain bit for bit (state, samp, bvec,
    the depth count); lanes past n and lanes not pending keep every
    stored value."""
    from rt_tpu_torch.ops import cuda_mega, mega_plain

    dev = _card()
    w, h, spp = 40, 25, 4
    tt, cfg = _ragged_scene(dev, case, w, h, tmp_path)
    ms = mega_tables.scene_for(tt, cfg)
    b, n = 1024, 1000
    pix = torch.arange(b, dtype=torch.int32, device=dev) % (w * h)
    py = pix // w
    state = torch.zeros((13, b), device=dev)
    samp, bvec = (torch.zeros(b, dtype=torch.int32, device=dev)
                  for _ in range(2))
    opts = dict(max_depth=cfg.max_depth, spp=spp, width=w, height=h,
                defocus=cfg.enable_defocus, exhaust_bg=True,
                **mega_plain.trace_options(tt, cfg))
    mega_plain.regen_plain(ms.table, ms.cam, state, pix, py, samp, bvec, 0,
                           5, 3, init=True, **opts)
    state[mega_plain.ALIVE, ::7] = 0.0
    idle = torch.zeros(b, dtype=torch.bool, device=dev)
    idle[:n:5] = True
    state[mega_plain.ALIVE, idle] = 0.0
    samp[idle] = spp - 1
    depth = torch.from_numpy(np.random.default_rng(3).integers(
        0, 4, b).astype(np.int32)).to(dev)
    entry = (state, samp, bvec, depth)
    got = [x.clone() for x in entry]
    want = [x.clone() for x in entry]
    for seg_iters in (5, spp * (cfg.max_depth + 1)):
        before = cuda_mega.mega_regen.launches
        cuda_mega.mega_regen(ms.table, ms.cam, *got[:1], pix, py, *got[1:3],
                             0, 5, seg_iters, init=False, n=n,
                             depth=got[3], **opts)
        torch.cuda.synchronize()
        assert cuda_mega.mega_regen.launches == before + 1
        mega_plain.regen_plain(ms.table, ms.cam, *want[:1], pix, py,
                               *want[1:3], 0, 5, seg_iters, init=False, n=n,
                               depth=want[3], **opts)
        for k, (a, c) in enumerate(zip(got, want)):
            assert torch.equal(a, c), (seg_iters, k)
    keep = idle.clone()
    keep[n:] = True
    for a, e in zip(got, entry):
        assert torch.equal(a[..., keep], e[..., keep])
    assert bool((got[0][mega_plain.ALIVE, :n] == 0.0).all())
    assert bool((got[1][:n] == spp - 1).all())
    assert bool((got[3][:n][~idle[:n]] > entry[3][:n][~idle[:n]]).any())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["tail", "families", "qmc"])
def test_capture_ragged_lanes_match_plain(tmp_path, case):
    """B4's warp loop (capture.cu: every thread of a warp stays in it; a
    thread past n only helps, a lane the roulette stops records its
    winner first) in its kTail (3,000 rows), kFamilies (the mesh,
    culled) and kQmc (cover, culled, p_rr 0.9) instantiations: 1,000
    lanes of 1,024 at 256 threads, sample 4, depth 6, codes and deaths
    bit for bit against capture_plain, and the deaths against B2's
    bounce counts on the same rays (death + 1 for a lane that ends
    early)."""
    from rt_tpu_torch.ops import camera, cuda_mega, mega_plain

    dev = _card()
    w, h = 40, 25
    tt, cfg = _ragged_scene(dev, case, w, h, tmp_path)
    px = torch.arange(w * h, device=dev)
    ro, rd = camera.generate_rays(tt.camera, w, h, px % w, px // w, 4, 0,
                                  cfg.enable_defocus, cfg.sampler)
    before = cuda_mega.mega_capture.launches
    codes, death = cuda_mega.mega_capture(tt, cfg, ro, rd, px, 4, 0,
                                          threads=256)
    torch.cuda.synchronize()
    assert cuda_mega.mega_capture.launches == before + 1
    p_codes, p_death = cuda_mega.mega_capture(tt, cfg, ro, rd, px, 4, 0,
                                              plain=True)
    assert torch.equal(codes, p_codes)
    assert torch.equal(death, p_death)
    assert bool((death < cfg.max_depth).any())
    ran = torch.zeros(w * h, dtype=torch.int32, device=dev)
    cuda_mega.mega_segment(mega_tables.scene_for(tt, cfg).table,
                           mega_plain.fresh_state(ro, rd),
                           px.to(torch.int32), 4, 0, 0, cfg.max_depth,
                           depth=ran, **mega_plain.trace_options(tt, cfg))
    assert torch.equal(ran, torch.where(death < cfg.max_depth, death + 1,
                                        death))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["tail", "families", "nee", "images",
                                  "qmc"])
def test_mega_adjoint_ragged_lanes_match_plain(tmp_path, case):
    """B5's warp loop (mega_adjoint.cu: every thread of a warp runs it,
    every thread of a block reaches the flush; a thread past n or with a
    dead lane only helps and credits nothing) on one segment in its kTail
    (5,000 rows of their own material: the accumulators past the shared
    memory, shared_acc off), kFamilies, kNee, kImages (with the atlas
    gradient) and kQmc (p_rr 0.9) instantiations: 1,000 lanes of 1,024
    at 256 threads, every seventh dead on entry, per-lane samples, the
    sky credited at the end. The gradients are within 1e-5 + 1e-3 max|g| of the plain
    adjoint over the live lanes; each lane's path and depth count are
    the plain forward segment's bits; lanes past n, dead lanes and the
    L, g rows are left as they were."""
    from rt_tpu_torch.ops import adjoint_plain, camera, cuda_mega, mega_plain

    dev = _card()
    w, h = 40, 25
    tt, cfg = _ragged_scene(dev, case, w, h, tmp_path, tail=(5000, 0))
    if case in ("nee", "images"):
        cfg = cfg.replace(nee=True)
    ms = mega_tables.scene_for(tt, cfg)
    kw = mega_plain.trace_options(tt, cfg)
    nee = mega_plain.nee_options(tt, cfg, adjoint=True)
    assert (case in ("nee", "images")) == (nee is not None)
    assert cuda_mega.acc_fits_smem(ms.n_slots) == (case != "tail")
    b, n = 1024, 1000
    px = torch.arange(b, device=dev) % (w * h)
    ro, rd = camera.generate_rays(tt.camera, w, h, px % w, px // w, 3, 0,
                                  cfg.enable_defocus, cfg.sampler)
    rs = np.random.default_rng(21)
    L, g = (torch.from_numpy(rs.normal(0, s_, (b, 3)).astype(np.float32))
            .to(dev) for s_ in (1.0, 1e-3))
    sample = torch.from_numpy(rs.integers(0, 9, b).astype(np.int32)).to(dev)
    state = torch.cat([mega_plain.fresh_state(ro, rd), L.T, g.T])
    live = torch.ones(b, dtype=torch.bool, device=dev)
    live[::7] = False
    live[n:] = False
    state[mega_plain.ALIVE, ::7] = 0.0
    entry = state.clone()
    depth = torch.zeros(b, dtype=torch.int32, device=dev)
    grad = torch.zeros((adjoint_plain.ACC_ROWS, ms.n_slots), device=dev)
    gimg = adjoint_plain.atlas_grad(ms, dev)
    pix = px.to(torch.int32)
    before = cuda_mega.mega_adjoint_segment.launches
    cuda_mega.mega_adjoint_segment(ms.table, state, pix, sample, 5, 0,
                                   cfg.max_depth, grad, n=n,
                                   exhaust_bg=True, depth=depth, nee=nee,
                                   gimg=gimg, **kw)
    torch.cuda.synchronize()
    assert cuda_mega.mega_adjoint_segment.launches == before + 1
    got = adjoint_plain.split_grads(grad, ms, kw["grad_bg"], gimg)
    want = adjoint_plain.trace_adjoint_plain(
        tt, cfg, ro[live], rd[live], px[live], sample[live], 5, L[live],
        g[live], cfg.max_depth, True)
    _grads_close(want, got)
    assert any(float(v.abs().max()) > 0.0 for v in want.values()
               if v is not None)
    fwd = entry[:13].clone()
    d_want = torch.zeros_like(depth)
    cuda_mega.mega_segment_plain(ms.table, fwd, pix, sample, 5, 0,
                                 cfg.max_depth, n=n, exhaust_bg=True,
                                 depth=d_want, nee=nee, **kw)
    assert torch.equal(state[:13], fwd)
    assert torch.equal(depth, d_want)
    assert torch.equal(state[13:], entry[13:])
    assert torch.equal(state[:, ~live], entry[:, ~live])


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["regen", "adjoint", "capture"])
def test_regen_and_adjoint_refuse_threads_off_the_warp(kernel):
    """B7, B5 and B4 run the warp-cooperative hit too: mega_regen,
    mega_adjoint_segment and mega_capture refuse threads=48 before the
    launch; 64 launches and matches the plain version (B7 and B4 bit for
    bit, B5 within 1e-5 + 1e-3 max|g|)."""
    from rt_tpu_torch.ops import adjoint_plain, cuda_mega, mega_plain

    dev = _card()
    if kernel == "regen":
        tt, cfg = _regen_scene(dev, 16, 8, 2, 4)
        ms = mega_tables.scene_for(tt, cfg)
        b = 16 * 8
        pix = torch.arange(b, dtype=torch.int32, device=dev)

        def run(fn, **kw):
            out = [torch.zeros((13, b), device=dev)] + [
                torch.zeros(b, dtype=torch.int32, device=dev)
                for _ in range(2)]
            fn(ms.table, ms.cam, out[0], pix, pix // 16, out[1], out[2], 0,
               0, 10, max_depth=4, spp=2, init=True, width=16, height=8,
               defocus=True, **mega_plain.trace_options(tt, cfg), **kw)
            return out

        fn, plain = cuda_mega.mega_regen, mega_plain.regen_plain
    elif kernel == "adjoint":
        tt, cfg, ro, rd, pix, L, g = _adj_sample(dev, 16, 8, 4)
        ms = mega_tables.scene_for(tt, cfg)
        kw0 = mega_plain.trace_options(tt, cfg)
        lanes = torch.cat([mega_plain.fresh_state(ro, rd), L.T, g.T])

        def run(fn, **kw):
            grad = torch.zeros((adjoint_plain.ACC_ROWS, ms.n_slots),
                               device=dev)
            fn(ms.table, lanes.clone(), pix.to(torch.int32), 0, 0, 0, 4,
               grad, **kw0, **kw)
            return adjoint_plain.split_grads(grad, ms, kw0["grad_bg"], None)

        fn, plain = cuda_mega.mega_adjoint_segment, None
    else:
        tt, cfg = _regen_scene(dev, 16, 8, 1, 4, p_rr=0.9)
        ro, rd = (x.to(dev) for x in _rays(100, seed=11))
        pix = torch.arange(100, device=dev)

        def run(fn, **kw):
            return fn(tt, cfg, ro, rd, pix, 0, 0, **kw)

        fn = cuda_mega.mega_capture
        plain = functools.partial(fn, plain=True)
    before = fn.launches
    with pytest.raises(ValueError, match="multiple of 32"):
        run(fn, threads=48)
    assert fn.launches == before
    got = run(fn, threads=64)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    if plain is not None:
        for a, c in zip(got, run(plain)):
            assert torch.equal(a, c)
    else:
        _grads_close(adjoint_plain.trace_adjoint_plain(
            tt, cfg, ro, rd, pix, 0, 0, L, g, 4, False), got)


def _sparse_lanes(dev, w, h, n, seed):
    """n pixels of a w x h frame, unsorted, each with its own sample start
    in [0, 8): adaptive sampling's round lanes."""
    rs = np.random.default_rng(seed)
    sel = torch.from_numpy(rs.choice(w * h, n, replace=False)).to(dev)
    starts = torch.from_numpy(rs.integers(0, 8, n)).to(dev)
    return sel % w, sel // w, starts


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["queue", "mega"])
def test_per_lane_starts_on_sparse_lanes_match_plain(engine):
    """B3 and B2 with a per-lane sample vector on 2,001 unsorted pixels of
    a 192x108 cover frame (not a multiple of the block), depth 50, through
    render_pixels' trace: bit for bit their plain versions on the same
    lanes, and each launch counted."""
    from rt_tpu_torch.ops import camera, cuda_mega, cuda_queue

    dev = _card()
    sdef, cfg = builders.cover_scene(width=192, height=108, spp=1,
                                     max_depth=50)
    cfg = cfg.replace(engine=engine, compact_schedule=(2, 3, 5, 10),
                      compact_group=16)
    tt = types.build_tables(sdef, device=dev)
    px, py, starts = _sparse_lanes(dev, 192, 108, 2001, 5)
    pix = py.long() * 192 + px.long()
    fn = cuda_queue.queue_trace if engine == "queue" else cuda_mega.mega_trace
    counter = (cuda_queue.queue_launch if engine == "queue"
               else cuda_mega.mega_segment)
    for i in range(3):
        s = starts + i
        ro, rd = camera.generate_rays(tt.camera, 192, 108, px, py, s, 9,
                                      cfg.enable_defocus)
        before = counter.launches
        k = fn(tt, cfg, ro, rd, pix, s, 9)
        torch.cuda.synchronize()
        assert counter.launches > before
        p = fn(tt, cfg, ro, rd, pix, s, 9, plain=True)
        assert torch.equal(k, p), (engine, i)


@pytest.mark.cuda
def test_progressive_resume_on_queue_is_bit_equal(tmp_path):
    """render_progressive on the card (queue, B3) stopped at 4 samples and
    resumed to 8 with one-sample passes: the one-shot render's sum bit for
    bit."""
    from rt_tpu_torch.render.progressive import render_progressive
    from rt_tpu_torch.render.renderer import render

    dev = _card()
    sdef, cfg = builders.cover_scene(width=192, height=108, spp=8,
                                     max_depth=50)
    cfg = cfg.replace(engine="queue")
    tt = types.build_tables(sdef, device=dev)
    ref = render(tt, cfg, device=dev)
    ck = str(tmp_path / "ck.npz")
    render_progressive(tt, cfg.replace(samples_per_pixel=4),
                       checkpoint_path=ck, checkpoint_every=2,
                       samples_per_pass=1, device=dev)
    acc, done = render_progressive(tt, cfg, checkpoint_path=ck,
                                   samples_per_pass=1, device=dev)
    assert done == 8 and acc.device.type == "cuda"
    assert torch.equal(acc, ref)


@pytest.mark.cuda
def test_frame_pipeline_on_the_card_matches_sync(tmp_path):
    """FramePipeline on the card (pinned download behind the next frame's
    launches) writes the synchronous path's PNGs byte for byte."""
    from rt_tpu_torch.drivers.animate import FramePipeline
    from rt_tpu_torch.io.image import write_png
    from rt_tpu_torch.render import film
    from rt_tpu_torch.render.renderer import render

    dev = _card()
    pipe = FramePipeline("cuda")
    for i in range(3):
        sdef, cfg = builders.dna_scene(angle_deg=10 * i, width=320,
                                       height=180, spp=4, max_depth=16)
        cfg = cfg.replace(engine="queue")
        tt = types.build_tables(sdef)
        pipe.submit(tt, cfg, str(tmp_path / f"pipe_{i}.png"))
        write_png(str(tmp_path / f"sync_{i}.png"), film.finalize(
            render(tt, cfg, device=dev), 4, gamma=True))
    assert pipe.flush()[0].endswith("pipe_2.png")
    for i in range(3):
        assert (tmp_path / f"pipe_{i}.png").read_bytes() == \
            (tmp_path / f"sync_{i}.png").read_bytes()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cover", "demo"])
def test_bvh_walk_on_the_card_matches_cpu(name):
    """The BVH walk (accel/bvh.py, plain PyTorch) on CUDA tensors against
    the same walk on the CPU: the native builder loaded, and the hits,
    families and rows equal on >= 99.9% of lanes, t within rtol 2e-4 /
    atol 1e-4 (tests/test_pallas.py) on >= 99.9% of the lanes where both
    hit: the card sums the leaf tests' dot products in another order,
    which moves an ill-conditioned lane (a ray grazing the radius-1000
    ground sphere, ROADMAP C-5) by more."""
    from rt_tpu_torch.io import native
    from rt_tpu_torch.ops.intersect import intersect
    from rt_tpu_torch.scene.parser import parse_scene

    dev = _card()
    assert native.available()
    sdef = (builders.cover_scene(grid=5)[0] if name == "cover" else
            parse_scene(os.path.join(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))), "scenes",
                "demo_scene.json"))[0])
    fams = ("sphere", "rect", "cylinder", "triangle")
    cpu = types.build_tables(sdef, bvh_types=fams)
    card = types.build_tables(sdef, device=dev, bvh_types=fams)
    ro, rd = _rays(1 << 15, seed=9)
    hc = intersect(cpu, ro, rd, traversal="bvh")
    hk = intersect(card, ro.to(dev), rd.to(dev), traversal="bvh")
    hk = type(hk)(*(x.cpu() for x in hk))
    assert hc.hit.float().mean() > 0.05
    same = ((hc.hit == hk.hit) & (hc.ptype == hk.ptype)
            & (hc.pid == hk.pid))
    assert same.float().mean() >= 0.999
    both = same & hc.hit
    close = (hk.t[both] - hc.t[both]).abs() <= 1e-4 + 2e-4 * hc.t[both].abs()
    assert close.float().mean() >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["queue", "mega"])
def test_world_of_one_nccl_render_sharded_matches_render(engine, tmp_path):
    """A NCCL process group of one rank (init_distributed with explicit
    arguments): render_sharded_ex over its (1, 1) mesh, through the
    collective, gives render's frame bit for bit on B3 / B2."""
    import torch.distributed as dist

    from rt_tpu_torch.parallel import distributed
    from rt_tpu_torch.parallel.mesh import make_mesh
    from rt_tpu_torch.parallel.sharded import render_sharded_ex
    from rt_tpu_torch.render.renderer import render

    _card()
    sdef, cfg = builders.cover_scene(width=320, height=180, spp=4,
                                     max_depth=8)
    cfg = cfg.replace(engine=engine)
    tables = types.build_tables(sdef)
    dev = distributed.init_distributed(
        device="cuda", rank=0, world_size=1,
        init_method=f"file://{tmp_path / 'store'}", timeout_s=100.0)
    try:
        assert dist.get_backend() == "nccl" and dev.type == "cuda"
        mesh = make_mesh()
        assert mesh.group is not None and mesh.device == dev
        img, spp = render_sharded_ex(tables, cfg, mesh)
    finally:
        distributed.shutdown_distributed()
    assert spp == 4 and img.max() > 0
    np.testing.assert_array_equal(
        img, render(tables, cfg, device=dev).cpu().numpy())
