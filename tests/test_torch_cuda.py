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
