"""The plain versions of the kernels B2 and B3 with next-event estimation
(ops/mega_plain's NEE block and shadow any-hit, reached through
cuda_mega.mega_trace and cuda_queue.queue_trace on CPU tensors) against
rt_tpu's Pallas kernels `_mega_kernel` and `_queue_kernel` with nee, mis
and nee_glossy, in interpret mode as tests/test_mega.py runs them on the
CPU, with cull_chunks=False on rt_tpu's side (ROADMAP C-3).

Scene: tests/test_torch_nee.py's (four light families, a checker light,
a fuzzy metal and a glass sphere), 16x12, depth 4, spp 1; the queue
resumes its lanes across launches (queue_steps 3), the megakernel
groups them (compact_every 2). Per lane: rtol 1e-4 / atol 1e-4 on >= 99%
of lanes, as tests/test_torch_families_pallas.py holds the families;
the queue's lanes equal the megakernel's bit for bit. The CUDA kernels
are held against these plain versions bit for bit on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt_tpu.config import RenderConfig as JConfig
from rt_tpu.ops import camera as jcamera
from rt_tpu.render import integrator as jintegrator
from rt_tpu.scene import types as jtypes
from rt_tpu_torch.config import RenderConfig
from rt_tpu_torch.ops import cuda_mega, cuda_queue
from rt_tpu_torch.scene import types as ttypes
from test_torch_nee import light_scene

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's default of one thread per core in each of them
# oversubscribes the CPU many times over.
torch.set_num_threads(1)

W, H = 16, 12
SEED = 3

# each weight branch of the NEE block (single-technique, glossy alone,
# MIS) on each engine, roulette on one case of each
CASES = {
    "mega-mis_glossy": ("mega", dict(nee=True, mis=True, nee_glossy=True)),
    "mega-glossy_rr": ("mega", dict(nee=True, nee_glossy=True, p_rr=0.9)),
    "queue-nee_rr": ("queue", dict(nee=True, p_rr=0.9)),
    "queue-mis_glossy": ("queue", dict(nee=True, mis=True,
                                       nee_glossy=True)),
}


@pytest.fixture(scope="module")
def scenes():
    jt = jax.tree_util.tree_map(jnp.asarray, light_scene(jtypes, W, H))
    return jt, light_scene(ttypes, W, H)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_b2_b3_nee_match_pallas_per_lane(scenes, case):
    engine, flags = CASES[case]
    jt, tt = scenes
    jcfg = JConfig(width=W, height=H, samples_per_pixel=1, max_depth=4,
                   engine=engine, loop="while", cull_chunks=False, **flags)
    cfg = RenderConfig(**dataclasses.asdict(jcfg))
    px = np.tile(np.arange(W, dtype=np.int32), H)
    py = np.repeat(np.arange(H, dtype=np.int32), W)
    pix = (py * W + px).astype(np.uint32)
    ro, rd = jcamera.generate_rays(jt.camera, W, H, jnp.asarray(px),
                                   jnp.asarray(py), 1, SEED, False)
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
