"""The plain version of the adjoint kernels B5 and B6 on a scene with a
rect light, a cylinder and a triangle (ops/adjoint_plain, through
diff/replay.make_replay_loss_fn with engine "mega" and "queue" on the
CPU) against rt_tpu's Pallas adjoint kernels B5 (`_adjoint_kernel`,
engine "mega") and B6 (`_queue_adjoint_kernel`, engine "queue") with
bwd_kernel=True in interpret mode, as tests/test_diff.py:523, 839 run
them, forward on the same engine on both sides, at 16x12, depth 6, spp 1
(each case compiles rt_tpu's interpret-mode kernels anew, which is most
of its time), cull_chunks=False on rt_tpu's side (ROADMAP C-3). Scene,
variants and tolerance: tests/test_torch_families_adjoint.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rt_tpu.diff.replay import make_replay_loss_fn as jreplay_loss
from rt_tpu_torch.scene.convert import params_from_numpy
from test_torch_adjoint import assert_grads_close, jparams, pixels, \
    port_grads
from test_torch_families_adjoint import VARIANTS, _target, rect_lit


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("engine", ["queue", "mega"])
def test_plain_adjoint_matches_pallas_adjoint_on_families(engine, variant):
    over, kw = VARIANTS[variant]
    jt, jcfg, tt, cfg = rect_lit(16, 12, engine=engine, **over)
    assert tt.counts[1:] == (1, 1, 1)
    px, py = pixels(16, 12)
    tgt = _target(px.shape[0], 2)
    jp = jparams(jt)
    lj, gj = jax.value_and_grad(jreplay_loss(
        jt, jcfg, 1, jnp.asarray(px), jnp.asarray(py), jnp.asarray(tgt),
        bwd_kernel=True, **kw))(jp)
    lt, gt = port_grads(tt, cfg.replace(engine=engine), px, py, tgt,
                        params_from_numpy(jp), spp=1, **kw)
    np.testing.assert_allclose(lt, float(lj), rtol=1e-5)
    assert_grads_close(gj, gt, (engine, variant))
