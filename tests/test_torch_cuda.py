"""rt_tpu_torch's CUDA kernels against their plain PyTorch versions, on
the card. These tests need a CUDA GPU and nvcc and skip without them.
The file imports no JAX (run it without the JAX-importing conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from rt_tpu_torch.ops import cuda_intersect
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
