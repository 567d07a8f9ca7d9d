"""rt_tpu_torch's path-replay backward on the CPU (the plain version of the
adjoint kernels B5 and B6, through diff/replay.make_replay_loss_fn with
engine "queue" and "mega") against rt_tpu's Pallas adjoint kernels B6
(`_queue_adjoint_kernel`, engine "queue") and B5 (`_adjoint_kernel`,
engine "mega"), with bwd_kernel=True in interpret mode, as
tests/test_diff.py:523, 839 run them, at 16x12, depth 6, spp 2, with
cull_chunks=False on rt_tpu's side (ROADMAP C-3). The forward runs the
same engine on both sides. Scene, tolerance and helpers:
tests/test_torch_adjoint.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rt_tpu.diff.replay import make_replay_loss_fn as jreplay_loss
from rt_tpu_torch.scene.convert import params_from_numpy
from test_torch_adjoint import (VARIANTS, assert_grads_close, jparams,
                                make_scene, pixels, port_grads)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("engine", ["queue", "mega"])
def test_plain_adjoint_matches_pallas_adjoint(engine, variant):
    """Against rt_tpu's adjoint kernels (B6 for queue, B5 for mega) in
    interpret mode, forward on the same engine, at 16x12."""
    jt, jcfg, tt, cfg = make_scene(16, 12, 6, seed=11)
    over, kw = VARIANTS[variant]
    jcfg = jcfg.replace(engine=engine, **over)
    cfg = cfg.replace(engine=engine, **over)
    px, py = pixels(16, 12)
    tgt = np.random.RandomState(2).rand(px.shape[0], 3).astype(np.float32)
    jp = jparams(jt)
    lj, gj = jax.value_and_grad(jreplay_loss(
        jt, jcfg, 2, jnp.asarray(px), jnp.asarray(py), jnp.asarray(tgt),
        bwd_kernel=True, **kw))(jp)
    lt, gt = port_grads(tt, cfg, px, py, tgt, params_from_numpy(jp), **kw)
    np.testing.assert_allclose(lt, float(lj), rtol=1e-5)
    assert_grads_close(gj, gt, (engine, variant))
