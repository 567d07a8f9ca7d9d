"""rt_tpu_torch's camera, intersect, sphere closest-hit (kernel B1's plain
version and wrapper) and materials against rt_tpu's on the same inputs.

The JAX side runs as its own tests run it on the CPU: intersect with
engine="xla", and the Pallas kernel in interpret mode
(tests/test_pallas.py). Tolerances are those of tests/test_pallas.py:
hit masks equal, t within rtol 2e-4 / atol 1e-4, pids agree on > 99.9%.
The CUDA kernel itself is held against its plain version on the card by
tests/test_torch_cuda.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rt_tpu.ops import camera as jcamera
from rt_tpu.ops import intersect as jintersect
from rt_tpu.ops import materials as jmaterials
from rt_tpu.ops.pallas_intersect import sphere_closest_hit as jsphere_hit
from rt_tpu.scene import builders as jbuilders
from rt_tpu.scene import types as jtypes
from rt_tpu_torch.ops import camera as tcamera
from rt_tpu_torch.ops import cuda_build, cuda_intersect
from rt_tpu_torch.ops import intersect as tintersect
from rt_tpu_torch.ops import materials as tmaterials
from rt_tpu_torch.scene import builders as tbuilders
from rt_tpu_torch.scene import types as ttypes

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's default of one thread per core in each of them
# oversubscribes the CPU many times over.
torch.set_num_threads(1)

SCENES = {"cover_grid4": ("cover_scene", dict(grid=4)),
          "three_sphere": ("three_sphere_scene", {})}


def _tables(name):
    fn, kw = SCENES[name]
    return (jtypes.build_tables(getattr(jbuilders, fn)(**kw)[0]),
            ttypes.build_tables(getattr(tbuilders, fn)(**kw)[0]))


def _rays(n, seed=0):
    rs = np.random.default_rng(seed)
    ro = rs.normal(0, 3, (n, 3)).astype(np.float32)
    rd = rs.normal(0, 1, (n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return ro, rd


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_hits_close(t_ref, pid_ref, t_got, pid_got):
    hit = np.isfinite(t_ref)
    np.testing.assert_array_equal(hit, np.isfinite(t_got))
    np.testing.assert_allclose(np.where(hit, t_got, 0.0),
                               np.where(hit, t_ref, 0.0),
                               rtol=2e-4, atol=1e-4)
    assert np.mean(pid_ref == pid_got) > 0.999


@pytest.mark.parametrize("name", sorted(SCENES))
@pytest.mark.parametrize("n", [1024, 300])
def test_sphere_hit_plain_matches_pallas_interpret(name, n):
    jt, tt = _tables(name)
    ro, rd = _rays(n)
    # the Pallas kernel wants whole 2048-ray tiles; pad as intersect does
    pad = (-n) % 2048
    ro_p = np.concatenate([ro, np.zeros((pad, 3), np.float32)])
    rd_p = np.concatenate([rd, np.tile([[0, 0, 1]], (pad, 1)).astype(np.float32)])
    t_j, pid_j = jsphere_hit(jt.sph_center, jt.sph_radius, jt.sph_obj >= 0,
                             jnp.asarray(ro_p), jnp.asarray(rd_p),
                             interpret=True)
    t_p, pid_p = cuda_intersect.sphere_closest_hit_plain(
        tt.sph_center, tt.sph_radius, tt.sph_obj >= 0, _t(ro), _t(rd))
    assert t_p.dtype == torch.float32 and pid_p.dtype == torch.int32
    _assert_hits_close(np.asarray(t_j)[:n], np.asarray(pid_j)[:n],
                       t_p.numpy(), pid_p.numpy())


def test_sphere_hit_wrapper_uses_plain_on_cpu():
    _, tt = _tables("cover_grid4")
    ro, rd = _rays(512, seed=1)
    args = (tt.sph_center, tt.sph_radius, tt.sph_obj >= 0, _t(ro), _t(rd))
    before = cuda_intersect.sphere_closest_hit.launches
    t_w, pid_w = cuda_intersect.sphere_closest_hit(*args)
    t_p, pid_p = cuda_intersect.sphere_closest_hit_plain(*args)
    assert torch.equal(t_w, t_p) and torch.equal(pid_w, pid_p)
    # the count is of kernel launches only
    assert cuda_intersect.sphere_closest_hit.launches == before


def test_sphere_hit_plain_chunks_like_one_block(monkeypatch):
    _, tt = _tables("cover_grid4")
    ro, rd = _rays(1000, seed=2)
    args = (tt.sph_center, tt.sph_radius, tt.sph_obj >= 0, _t(ro), _t(rd))
    whole = cuda_intersect.sphere_closest_hit_plain(*args)
    monkeypatch.setattr(cuda_intersect, "PLAIN_RAY_CHUNK", 128)
    chunked = cuda_intersect.sphere_closest_hit_plain(*args)
    assert torch.equal(whole[0], chunked[0])
    assert torch.equal(whole[1], chunked[1])
    empty = cuda_intersect.sphere_closest_hit_plain(
        *args[:3], _t(ro[:0]), _t(rd[:0]))
    assert empty[0].shape == (0,) and empty[1].dtype == torch.int32


def test_sphere_hit_rejects_unsupported_device():
    _, tt = _tables("three_sphere")
    meta = [x.to("meta") for x in (tt.sph_center, tt.sph_radius)]
    live = (tt.sph_obj >= 0).to("meta")
    ro = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="device"):
        cuda_intersect.sphere_closest_hit(*meta, live, ro, ro)
    with pytest.raises(ValueError, match="tensors on"):
        cuda_intersect.sphere_closest_hit(tt.sph_center, *meta[1:], live,
                                          ro, ro)


def test_nvcc_missing_raises(monkeypatch):
    monkeypatch.setattr(cuda_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(cuda_build.os.path, "isfile", lambda _: False)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.find_nvcc()


def test_library_path_keyed_by_sources_and_flags(monkeypatch):
    p = cuda_build.library_path("sphere_hit")
    assert p.parent == cuda_build.BUILD_DIR and p.name.startswith(
        "libsphere_hit-")
    assert (cuda_build.CSRC_DIR / "sphere_hit.cu").is_file()
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS",
                        cuda_build.NVCC_FLAGS + ("-lineinfo",))
    assert cuda_build.library_path("sphere_hit") != p


def test_last_argmin_ties_to_largest_index():
    rs = np.random.default_rng(3)
    t = rs.integers(0, 4, (200, 16)).astype(np.float32)
    t[5] = np.inf  # all-miss row -> last index
    want = np.asarray(jintersect._last_argmin(jnp.asarray(t)))
    got = tintersect._last_argmin(_t(t)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[5] == 15


@pytest.mark.parametrize("name", sorted(SCENES))
def test_sphere_candidates_match_jax(name):
    jt, tt = _tables(name)
    ro, rd = _rays(256, seed=4)
    want = np.asarray(jintersect._sphere_t(jt, jnp.asarray(ro),
                                           jnp.asarray(rd), 1e-3))
    got = tintersect._sphere_t(tt.sph_center, tt.sph_radius,
                               tt.sph_obj >= 0, _t(ro), _t(rd), 1e-3).numpy()
    fin = np.isfinite(want)
    np.testing.assert_array_equal(fin, np.isfinite(got))
    np.testing.assert_allclose(got[fin], want[fin], rtol=2e-4, atol=1e-4)


@pytest.mark.parametrize("name", sorted(SCENES))
@pytest.mark.parametrize("engine", ["plain", "pallas"])
def test_intersect_matches_jax_xla(name, engine):
    jt, tt = _tables(name)
    ro, rd = _rays(1024)
    hj = jintersect.intersect(jt, jnp.asarray(ro), jnp.asarray(rd),
                              engine="xla")
    ht = tintersect.intersect(tt, _t(ro), _t(rd), engine=engine)
    hit = np.asarray(hj.hit)
    np.testing.assert_array_equal(ht.hit.numpy(), hit)
    _assert_hits_close(np.asarray(hj.t), np.asarray(hj.pid), ht.t.numpy(),
                       ht.pid.numpy())
    same = hit & (np.asarray(hj.pid) == ht.pid.numpy())
    for f in ("ptype", "obj", "mat", "front_face"):
        np.testing.assert_array_equal(getattr(ht, f).numpy()[same],
                                      np.asarray(getattr(hj, f))[same], f)
    for f in ("p", "normal", "u", "v"):
        np.testing.assert_allclose(getattr(ht, f).numpy()[same],
                                   np.asarray(getattr(hj, f))[same],
                                   rtol=1e-3, atol=1e-3, err_msg=f)
    # misses: the reference's pid / obj / mat bookkeeping, exactly
    for f in ("pid", "obj", "mat", "ptype"):
        np.testing.assert_array_equal(getattr(ht, f).numpy()[~hit],
                                      np.asarray(getattr(hj, f))[~hit], f)


def test_intersect_empty_scene_misses():
    st, _ = tbuilders.three_sphere_scene()
    st.objects.clear()
    tt = ttypes.build_tables(st)
    ro, rd = _rays(8)
    h = tintersect.intersect(tt, _t(ro), _t(rd))
    assert not h.hit.any() and torch.isinf(h.t).all()


@pytest.mark.parametrize("defocus", [False, True])
def test_generate_rays_match_jax(defocus):
    jt, tt = _tables("cover_grid4")
    w, h = 64, 36
    rs = np.random.default_rng(5)
    px = rs.integers(0, w, 500).astype(np.int32)
    py = rs.integers(0, h, 500).astype(np.int32)
    ro_j, rd_j = jcamera.generate_rays(jt.camera, w, h, jnp.asarray(px),
                                       jnp.asarray(py), 3, 11, defocus)
    ro_t, rd_t = tcamera.generate_rays(tt.camera, w, h, _t(px), _t(py), 3,
                                       11, defocus)
    np.testing.assert_allclose(ro_t.numpy(), np.asarray(ro_j), atol=1e-5)
    np.testing.assert_allclose(rd_t.numpy(), np.asarray(rd_j), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_shade_matches_jax(name):
    """materials.shade per lane on the hits of random rays, with the same
    ball and reflect draws."""
    jt, tt = _tables(name)
    ro, rd = _rays(2048, seed=6)
    h = jintersect.intersect(jt, jnp.asarray(ro), jnp.asarray(rd))
    keep = np.asarray(h.hit)
    rs = np.random.default_rng(7)
    ball = rs.normal(size=(2048, 3)).astype(np.float32)
    ball *= (rs.random((2048, 1)) ** (1 / 3) / np.linalg.norm(
        ball, axis=-1, keepdims=True)).astype(np.float32)
    refl_u = rs.random(2048).astype(np.float32)
    args = [np.asarray(x) for x in (h.mat, rd, h.normal, h.front_face, h.u,
                                    h.v, h.p)] + [ball, refl_u]
    sj, em_j = jmaterials.shade(jt, *map(jnp.asarray, args))
    st, em_t = tmaterials.shade(tt, *map(_t, args))
    np.testing.assert_array_equal(st.ok.numpy()[keep], np.asarray(sj.ok)[keep])
    for got, want in ((st.direction, sj.direction),
                      (st.attenuation, sj.attenuation), (em_t, em_j)):
        np.testing.assert_allclose(got.numpy()[keep], np.asarray(want)[keep],
                                   rtol=1e-5, atol=1e-5)
    mat = _t(args[0])
    np.testing.assert_allclose(
        tmaterials.material_albedo(tt, mat, _t(args[4]), _t(args[5]),
                                   _t(args[6])).numpy(),
        np.asarray(jmaterials.material_albedo(jt, *map(jnp.asarray, (
            args[0], args[4], args[5], args[6])))), atol=1e-6)
    np.testing.assert_allclose(
        tmaterials.schlick(_t(refl_u), _t(1.0 + refl_u)).numpy(),
        np.asarray(jmaterials.schlick(jnp.asarray(refl_u),
                                      jnp.asarray(1.0 + refl_u))),
        rtol=1e-6, atol=1e-7)
