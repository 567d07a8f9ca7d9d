"""rt_tpu_torch's CUDA kernels against their plain PyTorch versions, on
the card. These tests need a CUDA GPU and nvcc and skip without them.
The file imports no JAX (run it without the JAX-importing conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

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
