"""The last names rt_tpu has beside its engines, in rt_tpu_torch, on the
CPU: materials.scatter and texture_value, geometry.scale and apply_ray,
utils/debug.checked_intersect(traversal=) against rt_tpu's on the same
inputs (tolerances of tests/test_torch_intersect.py), and
cuda_mega.mega_trace_regen(width=, height=), whose frame size defaults
to cfg's, against the call at cfg's size bit for bit (its plain version
here; B7 itself runs in chip_smoke.py phase 61)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rt_tpu.ops import geometry as jgeom
from rt_tpu.ops import materials as jmaterials
from rt_tpu.scene import builders as jbuilders
from rt_tpu.scene import types as jtypes
from rt_tpu.utils import debug as jdebug
from rt_tpu_torch.ops import cuda_mega
from rt_tpu_torch.ops import geometry as tgeom
from rt_tpu_torch.ops import materials as tmaterials
from rt_tpu_torch.scene import builders as tbuilders
from rt_tpu_torch.scene import types as ttypes
from rt_tpu_torch.utils import debug as tdebug
from test_torch_intersect import _assert_hits_close, _rays, _t, _tables

# One intra-op thread: the suite runs in several worker processes at
# once (as the other port test files).
torch.set_num_threads(1)


def _shade_args(n_mat, n=512):
    """Random lanes: material ids, unit directions and normals, faces,
    UVs, points, and the ball and reflect draws."""
    rs = np.random.default_rng(7)
    ro, rd = _rays(n, seed=6)
    normal = rs.normal(size=(n, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    ball = rs.normal(size=(n, 3)).astype(np.float32)
    ball *= (rs.random((n, 1)) ** (1 / 3) / np.linalg.norm(
        ball, axis=-1, keepdims=True)).astype(np.float32)
    return [rs.integers(0, n_mat, n).astype(np.int32), rd, normal,
            rs.random(n) < 0.5, rs.random(n).astype(np.float32),
            rs.random(n).astype(np.float32), ro, ball,
            rs.random(n).astype(np.float32)]


def test_scatter_and_texture_value_match_rt_tpu():
    jt, tt = _tables("cover_grid4")
    args = _shade_args(tt.mat_type.shape[0])
    # jitted: one compile, where the eager call dispatches op by op
    sj = jax.jit(lambda *a: jmaterials.scatter(jt, *a))(
        *map(jnp.asarray, args))
    st = tmaterials.scatter(tt, *map(_t, args))
    shaded, _ = tmaterials.shade(tt, *map(_t, args))
    for f in st._fields:
        assert torch.equal(getattr(st, f), getattr(shaded, f)), f
    np.testing.assert_array_equal(st.ok.numpy(), np.asarray(sj.ok))
    for f in ("direction", "attenuation"):
        np.testing.assert_allclose(getattr(st, f).numpy(),
                                   np.asarray(getattr(sj, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    n_tex = tt.tex_type.shape[0]
    tex = np.random.default_rng(3).integers(-1, n_tex, 512).astype(np.int32)
    u, v, p = args[4], args[5], args[6]
    np.testing.assert_allclose(
        tmaterials.texture_value(tt, _t(tex), _t(u), _t(v), _t(p)).numpy(),
        np.asarray(jmaterials.texture_value(jt, *map(jnp.asarray, (
            tex, u, v, p)))), atol=1e-6)


def test_scale_and_apply_ray_match_rt_tpu():
    m, minv = tgeom.scale(2.0, 0.5, 4.0)
    jm, jminv = jgeom.scale(2.0, 0.5, 4.0)
    np.testing.assert_array_equal(m, jm)
    np.testing.assert_array_equal(minv, jminv)
    np.testing.assert_allclose(m @ minv, np.eye(4), atol=1e-7)
    xf = tgeom.compose(tgeom.rotate((1, 2, 3), 0.7), (m, minv))[0]
    ro, rd = _rays(64, seed=2)
    got = tgeom.apply_ray(_t(xf), _t(ro), _t(rd))
    want = jgeom.apply_ray(jnp, jnp.asarray(xf), jnp.asarray(ro),
                           jnp.asarray(rd))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_checked_intersect_takes_traversal():
    """checked_intersect(traversal="bvh") walks the tables' BVH, as
    rt_tpu's does."""
    sj, _ = jbuilders.three_sphere_scene()
    st, _ = tbuilders.three_sphere_scene()
    jt = jtypes.build_tables(sj, bvh_types=("sphere",))
    tt = ttypes.build_tables(st, bvh_types=("sphere",))
    ro, rd = _rays(256, seed=4)
    # jitted: one compile of the checkified walk, where the eager call
    # dispatches op by op
    err, hj = jax.jit(lambda o, d: jdebug.checked_intersect(
        jt, o, d, traversal="bvh"))(jnp.asarray(ro), jnp.asarray(rd))
    err.throw()
    ht = tdebug.checked_intersect(tt, _t(ro), _t(rd), traversal="bvh")
    # the walk, not the scan: its t differs from the linear pass's in
    # the last bit on some lanes
    assert not torch.equal(ht.t, tdebug.checked_intersect(tt, _t(ro),
                                                          _t(rd)).t)
    hit = np.asarray(hj.hit)
    assert hit.any()
    np.testing.assert_array_equal(ht.hit.numpy(), hit)
    _assert_hits_close(np.asarray(hj.t), np.asarray(hj.pid), ht.t.numpy(),
                       ht.pid.numpy())


def test_regen_frame_size_defaults_to_cfg():
    sdef, cfg = tbuilders.cover_scene(width=20, height=12, spp=2,
                                      max_depth=4)
    tt = ttypes.build_tables(sdef)
    cfg = cfg.replace(engine="mega")
    pix = torch.arange(20 * 12)
    want = cuda_mega.mega_trace_regen(tt, cfg, pix, pix // 20, 3, 2)
    got = cuda_mega.mega_trace_regen(tt, cfg, pix, pix // 20, 3, 2, 0,
                                     20, 12)
    assert torch.equal(got, want)
    # another size than cfg's: the camera rays of a 20x12 frame
    other = cfg.replace(width=64, height=36)
    assert torch.equal(cuda_mega.mega_trace_regen(
        tt, other, pix, pix // 20, 3, 2, width=20, height=12), want)
    assert not torch.equal(cuda_mega.mega_trace_regen(
        tt, other, pix, pix // 20, 3, 2), want)
