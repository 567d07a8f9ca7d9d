"""The plain versions of the kernels B2, B3, B4 and B7 with image
textures (ops/mega_plain's winner UV and texel fetch and NEE's `nee_img`,
reached through cuda_mega.mega_trace, cuda_queue.queue_trace,
cuda_mega.mega_capture and cuda_mega.mega_regen on CPU tensors) against
rt_tpu's Pallas kernels with has_img and nee_img in interpret mode, as
tests/test_mega.py runs them on the CPU (cull_chunks=False on rt_tpu's
side, ROADMAP C-3); the packed tables' image columns and UV tables
against rt_tpu's.

The port computes a curved primitive's (u, v) with atan2 / acos (on the
card libdevice's atan2f / acosf, which the CUDA kernels call), rt_tpu's
TPU kernel with polynomials accurate to about 1e-5 rad (`_atan2` :709,
`_acos` :723). The UVs agree within 1e-5; a lane whose UV sits that
close to a texel boundary picks the neighbouring texel (ROADMAP C-13),
so per lane rtol 1e-4 / atol 1e-4 holds on >= 99% of lanes, as the
families' tests hold them. Scene: tests/test_torch_images.py's (two
16x16 images on all four families, image-textured sphere and triangle
lights), 16x12, depth 4, spp 1. The CUDA kernels are held against these
plain versions bit for bit on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt_tpu.config import RenderConfig as JConfig
from rt_tpu.ops import camera as jcamera
from rt_tpu.ops import pallas_mega as jmega
from rt_tpu.render import integrator as jintegrator
from rt_tpu_torch.config import RenderConfig
from rt_tpu_torch.ops import cuda_mega, cuda_queue, mega_plain, mega_tables
from test_torch_images import both_tables

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's default of one thread per core in each of them
# oversubscribes the CPU many times over.
torch.set_num_threads(1)

W, H = 16, 12
SEED = 3

CASES = {
    "mega": ("mega", {}),
    "mega-nee_rr": ("mega", dict(nee=True, p_rr=0.9)),
    "queue-nee": ("queue", dict(nee=True)),
    "queue-mis_rr": ("queue", dict(nee=True, mis=True, p_rr=0.9)),
}


@pytest.fixture(scope="module")
def scenes():
    return both_tables(w=W, h=H)


def _rays(jt):
    px = np.tile(np.arange(W, dtype=np.int32), H)
    py = np.repeat(np.arange(H, dtype=np.int32), W)
    pix = (py * W + px).astype(np.uint32)
    ro, rd = jcamera.generate_rays(jt.camera, W, H, jnp.asarray(px),
                                   jnp.asarray(py), 1, SEED, False)
    return pix, ro, rd


def test_uv_matches_the_reference_polynomials():
    """The sphere's and the cylinder's (u, v) of ops/mega_plain (atan2,
    acos) against the reference kernel's expressions with its
    polynomials, on random unit offsets and the poles and seams: within
    1e-5, u compared around the circle (u = 0 and 1 are one seam)."""
    rs = np.random.default_rng(3)
    d = rs.normal(size=(20000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = np.concatenate([d, np.array(
        [[0, 1, 0], [0, -1, 0], [1, 0, 0], [-1, 0, -0.0], [-1, 0, 1e-9],
         [0, 0, 1], [0, 0, -1]], np.float32)])
    ux, uy, uz = (torch.from_numpy(d[:, k].copy()) for k in range(3))
    u, v = mega_plain.sphere_uv(ux, uy, uz)
    jx, jy, jz = (jnp.asarray(d[:, k]) for k in range(3))
    az = (jz == 0.0) & (jx == 0.0)
    ju = (jmega._atan2(-jz, jnp.where(az, 1.0, jx)) + np.float32(np.pi)) \
        * np.float32(1.0 / (2.0 * np.pi))
    jv = jmega._acos(-jy) * np.float32(1.0 / np.pi)
    du = np.abs(u.numpy() - np.asarray(ju))
    assert np.minimum(du, 1.0 - du).max() <= 1e-5
    assert np.abs(v.numpy() - np.asarray(jv)).max() <= 1e-5
    # at a 512-texel axis the lanes that close to a texel boundary, whose
    # texel differs (ROADMAP C-13), are under 1%
    for a, b in ((u.numpy(), np.asarray(ju)), (v.numpy(), np.asarray(jv))):
        ta, tb = (np.clip(((x - np.floor(x)) * 512).astype(np.int64), 0, 511)
                  for x in (a, b))
        assert (ta != tb).mean() <= 0.01
    # the cylinder's azimuth, as the light sampler and the hit take it
    phi = torch.from_numpy(rs.uniform(0, 2 * np.pi, 20000).astype(
        np.float32))
    cu = (torch.atan2(torch.sin(phi), torch.cos(phi)) + 2.0 * np.pi) \
        * mega_plain.INV_4PI
    jphi = jnp.asarray(phi.numpy())
    jcu = (jmega._atan2(jnp.sin(jphi), jnp.cos(jphi))
           + np.float32(2.0 * np.pi)) * np.float32(1.0 / (4.0 * np.pi))
    dc = np.abs(cu.numpy() - np.asarray(jcu))
    assert np.minimum(dc, 0.5 - dc).max() <= 1e-5


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_b2_b3_images_match_pallas_per_lane(scenes, case):
    """B2 / B3 with has_img (and nee_img under nee) against rt_tpu's
    `_mega_kernel` / `_queue_kernel`; the queue's lanes equal the
    megakernel's bit for bit."""
    engine, flags = CASES[case]
    jt, tt = scenes
    jcfg = JConfig(width=W, height=H, samples_per_pixel=1, max_depth=4,
                   engine=engine, loop="while", cull_chunks=False, **flags)
    cfg = RenderConfig(**dataclasses.asdict(jcfg))
    pix, ro, rd = _rays(jt)
    want = np.asarray(jintegrator.trace(jt, jcfg, ro, rd, jnp.asarray(pix),
                                        1, SEED))
    args = (torch.from_numpy(np.array(ro)), torch.from_numpy(np.array(rd)),
            torch.from_numpy(pix.astype(np.int64)), 1, SEED)
    launches = (cuda_mega.mega_segment.launches,
                cuda_queue.queue_launch.launches)
    rgb_m = cuda_mega.mega_trace(
        tt, cfg.replace(engine="mega", compact_every=2, compact_group=8),
        *args).numpy()
    rgb_q = cuda_queue.queue_trace(
        tt, cfg.replace(engine="queue", queue_steps=3), *args,
        check_once=True).numpy()
    assert (cuda_mega.mega_segment.launches,
            cuda_queue.queue_launch.launches) == launches  # CPU: plain
    np.testing.assert_array_equal(rgb_q, rgb_m)
    ok = (np.abs(rgb_m - want) <= 1e-4 + 1e-4 * np.abs(want)).all(-1)
    assert ok.mean() >= 0.99, ok.mean()
    assert want.max() > 0


def test_plain_capture_with_images_matches_pallas(scenes):
    """B4 takes textured tables: its codes and deaths equal rt_tpu's
    `_capture_kernel` with has_img on every live lane (no code depends
    on a texel)."""
    jt, tt = scenes
    jcfg = JConfig(width=W, height=H, samples_per_pixel=1, max_depth=4,
                   engine="mega", loop="while", cull_chunks=False, p_rr=0.9)
    cfg = RenderConfig(**dataclasses.asdict(jcfg))
    pix, ro, rd = _rays(jt)
    jcodes, jdeath = jmega.mega_capture(jt, jcfg, ro, rd,
                                        jnp.asarray(pix.astype(np.int32)),
                                        jnp.uint32(1), jnp.uint32(SEED))
    jcodes, jdeath = np.asarray(jcodes), np.asarray(jdeath)
    codes, death = cuda_mega.mega_capture(
        tt, cfg, torch.from_numpy(np.array(ro)),
        torch.from_numpy(np.array(rd)), torch.from_numpy(pix.astype(
            np.int64)), 1, SEED)
    codes, death = codes.numpy(), death.numpy()
    live = np.arange(cfg.max_depth)[:, None] <= death[None, :]
    np.testing.assert_array_equal(death, jdeath)
    assert (codes[live] == jcodes[live]).all()
    assert (codes[live] >> 24 == 3).any() and (codes[live] >> 24 == 2).any()


def test_plain_regen_with_images_matches_pallas(scenes):
    """B7 with has_img: one init segment of the whole spp loop (spp 2)
    against rt_tpu's `_regen_kernel`, per lane."""
    jt, tt = scenes
    jcfg = JConfig(width=W, height=H, samples_per_pixel=2, max_depth=4,
                   engine="mega", loop="while", cull_chunks=False)
    cfg = RenderConfig(**dataclasses.asdict(jcfg))
    (tbl, sph, rect, cyl, tri, sbnd, tbnd, sph_co, uv, atlas, counts,
     kw) = jmega._prep_scene(jt, jcfg)
    assert kw["has_img"]
    b = W * H
    bp = -(-b // jmega.RAY_TILE) * jmega.RAY_TILE
    jpix = np.zeros(bp, np.int32)
    jpix[:b] = np.arange(b)
    jpix = jnp.asarray(jpix)
    zeros = jnp.zeros((bp,), jnp.float32)
    zi = jnp.zeros((bp,), jnp.int32)
    seg = 2 * (4 + 1)
    st, jsamp, _ = jmega.mega_regen(
        sph, rect, cyl, tri, sbnd, tbnd, sph_co, uv, atlas, counts,
        tbl.background, jmega.camera_vec(tbl.camera), (zeros,) * 13, jpix,
        jpix // W, zi, zi, jnp.int32(0), jnp.int32(SEED), jnp.int32(seg),
        max_depth=4, spp=2, init=True, width=W, height=H, defocus=False,
        exhaust_bg=False, **kw)
    want = np.stack([np.asarray(c)[:b] for c in st[9:12]], -1)
    pix = torch.arange(b, dtype=torch.int32)
    state = torch.zeros((13, b))
    samp = torch.zeros(b, dtype=torch.int32)
    bvec = torch.zeros(b, dtype=torch.int32)
    cuda_mega.mega_regen(tt.mega.table, tt.mega.cam, state, pix, pix // W,
                         samp, bvec, 0, SEED, seg, max_depth=4, spp=2,
                         init=True, width=W, height=H, defocus=False,
                         **mega_plain.trace_options(tt, cfg))
    got = state[mega_plain.C:mega_plain.C + 3].T.numpy()
    ok = (np.abs(got - want) <= 1e-4 + 1e-4 * np.abs(want)).all(-1)
    assert ok.mean() >= 0.99, ok.mean()
    np.testing.assert_array_equal(samp.numpy(), np.asarray(jsamp)[:b])


def test_image_columns_and_uv_tables_match_rt_tpu(scenes):
    """Column 14 (the image id) of the sphere and family tables, the UV
    tables and the light table against rt_tpu's: the light table's
    columns 0-24 bit for bit, and the port's image id and triangle UVs
    (26-32) against the reference's 25-31."""
    jt, tt = scenes
    ms = tt.mega
    n_s = tt.n_spheres
    np.testing.assert_array_equal(
        ms.table[:, mega_tables.X_IMG].numpy(),
        np.asarray(jmega.sphere_table(jt))[:n_s, jmega._X_IMG])
    for name, fam_t, uv_t, n in (
            ("rect", ms.fam.rect, ms.img.rect, tt.counts[1]),
            ("cylinder", ms.fam.cyl, ms.img.cyl, tt.counts[2]),
            ("triangle", ms.fam.tri, ms.img.tri, tt.counts[3])):
        jtab = np.asarray(getattr(jmega, f"{name}_table")(jt))
        np.testing.assert_array_equal(fam_t[:, mega_tables.X_IMG].numpy(),
                                      jtab[:n, jmega._X_IMG])
        juv = np.asarray(getattr(jmega, f"{name}_uv_table")(jt))[:n]
        np.testing.assert_array_equal(uv_t.numpy(), juv)
    want = np.asarray(jmega.nee_light_table(jt))[:tt.n_lights]
    got = ms.lights.numpy()
    np.testing.assert_array_equal(got[:, :25], want[:, :25])
    np.testing.assert_array_equal(got[:, mega_tables.L_IMG:], want[:, 25:32])
    assert (got[:, mega_tables.L_IMG] >= 0).all() and tt.nee_img
