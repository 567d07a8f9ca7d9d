"""The path-replay backward with next-event estimation: the plain version
of the adjoint kernels B5 and B6 (ops/adjoint_plain with the NEE block's
two credits, reached through diff/replay.make_replay_loss_fn with engine
"mega" and "queue" on the CPU) against rt_tpu's Pallas adjoint kernels
with bwd_kernel=True in interpret mode (`_adjoint_kernel`,
`_queue_adjoint_kernel`, as tests/test_diff.py::
test_adjoint_megakernel_nee_matches_xla_replay runs them), against
rt_tpu's XLA replay and against the port's own method "ad"; the
tangent replay (geom_spec) with NEE against "ad"; and the ValueError
for mis / nee_glossy (tests/test_mis.py::test_mis_replay_refuses,
tests/test_glossy_nee.py::test_glossy_replay_refuses).

Scene: the rect-lit scene of tests/test_torch_families_adjoint.py (a rect
light over lambertian, metal, glass and checker spheres, a cylinder and
a triangle), 16x12, depth 6, spp 1, cull_chunks=False on rt_tpu's side
(ROADMAP C-3). Tolerance per field |a - b| <= 1e-5 + 1e-3 max|a| (the
reference's between its replay and its kernels); against "ad" the same.
The CUDA kernels are held against adjoint_plain on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt_tpu.diff.replay import make_replay_loss_fn as jreplay_loss
from rt_tpu_torch.diff import inverse as tinverse
from rt_tpu_torch.diff import replay as treplay
from rt_tpu_torch.scene.convert import params_from_numpy
from test_torch_adjoint import FIELDS, assert_grads_close, jparams, \
    pixels, port_grads
from test_torch_families_adjoint import _target, rect_lit

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's default of one thread per core in each of them
# oversubscribes the CPU many times over.
torch.set_num_threads(1)

W, H = 16, 12


def _ad_grads(tt, cfg, px, py, tgt, params, spp=1):
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss = tinverse.make_loss_fn(tt, cfg, spp)(
        p, torch.from_numpy(px).long(), torch.from_numpy(py).long(),
        torch.from_numpy(tgt))
    loss.backward()
    return float(loss.detach()), {k: v.grad for k, v in p.items()}


@pytest.mark.parametrize("engine", ["queue", "mega"])
def test_plain_adjoint_nee_matches_pallas_adjoint(engine):
    jt, jcfg, tt, cfg = rect_lit(W, H, engine=engine, nee=True)
    assert tt.n_lights == 1
    px, py = pixels(W, H)
    tgt = _target(px.shape[0], 2)
    jp = jparams(jt)
    lj, gj = jax.value_and_grad(jreplay_loss(
        jt, jcfg, 1, jnp.asarray(px), jnp.asarray(py), jnp.asarray(tgt),
        bwd_kernel=True))(jp)
    lt, gt = port_grads(tt, cfg.replace(engine=engine), px, py, tgt,
                        params_from_numpy(jp), spp=1)
    np.testing.assert_allclose(lt, float(lj), rtol=1e-5)
    assert_grads_close(gj, gt, engine)


def test_replay_nee_matches_ad():
    """The exact replay against the port's autograd through its plain
    engine, which runs the wavefront's `_nee_direct`: the suffix identity
    reproduces the direct term, so the two agree."""
    _, _, tt, cfg = rect_lit(W, H, nee=True)
    px, py = pixels(W, H)
    tgt = _target(px.shape[0], 3)
    p0 = {k: getattr(tt, k) for k in FIELDS}
    lt, gt = port_grads(tt, cfg.replace(engine="queue"), px, py, tgt, p0,
                        spp=1)
    la, ga = _ad_grads(tt, cfg, px, py, tgt, p0)
    np.testing.assert_allclose(lt, la, rtol=1e-5)
    assert_grads_close({k: v.numpy() for k, v in ga.items()}, gt, "ad")


def test_truncated_replay_nee_matches_xla_replay():
    """bwd_depth 3 with roulette (p_rr 0.9) against rt_tpu's XLA
    per-bounce replay (its forward on "xla"), truncated alike."""
    jt, jcfg, tt, cfg = rect_lit(W, H, nee=True, p_rr=0.9)
    px, py = pixels(W, H)
    tgt = _target(px.shape[0], 3)
    jp = jparams(jt)
    lj, gj = jax.value_and_grad(jreplay_loss(
        jt, jcfg.replace(engine="xla"), 1, jnp.asarray(px), jnp.asarray(py),
        jnp.asarray(tgt), bwd_kernel=False, bwd_depth=3))(jp)
    lt, gt = port_grads(tt, cfg.replace(engine="queue"), px, py, tgt,
                        params_from_numpy(jp), spp=1, bwd_depth=3)
    np.testing.assert_allclose(lt, float(lj), rtol=1e-4)
    assert_grads_close(gj, gt, "trunc3_rr")


def test_nee_gradient_reaches_the_light():
    """The direct term's emission credit lands in the light's slot (its
    texture row): the light's gradient with NEE is not the one without,
    and the plain B5 and B6 (one plain adjoint) agree."""
    _, _, tt, cfg = rect_lit(W, H)
    px, py = pixels(W, H)
    tgt = _target(px.shape[0], 4)
    p0 = {k: getattr(tt, k) for k in FIELDS}
    light = int(tt.mat_tex[tt.rect_mat[0]])
    _, g0 = port_grads(tt, cfg.replace(engine="queue"), px, py, tgt, p0,
                       spp=1)
    _, gq = port_grads(tt, cfg.replace(engine="queue", nee=True), px, py,
                       tgt, p0, spp=1)
    _, gm = port_grads(tt, cfg.replace(engine="mega", nee=True,
                                       compact_every=2), px, py, tgt, p0,
                       spp=1)
    assert float(gq["tex_color"][light].abs().max()) > 0
    assert not torch.equal(gq["tex_color"][light], g0["tex_color"][light])
    for k in FIELDS:
        torch.testing.assert_close(gm[k], gq[k], rtol=1e-5, atol=1e-7)


def test_tangent_replay_nee_matches_ad():
    """The tangent replay (geom_spec: the light's and a sphere's
    geometry) with the NEE direct term's geometry attached, against
    autograd through the plain engine."""
    _, _, tt, cfg = rect_lit(W, H, depth=4, nee=True)
    px, py = pixels(W, H)
    tgt = _target(px.shape[0], 5)
    spec = {"sph_center": [(0, 0), (0, 1)], "sph_radius": [(0,)]}
    fields = ("sph_center", "sph_radius", "tex_color")
    p = {k: getattr(tt, k).clone().requires_grad_(True) for k in fields}
    loss = treplay.make_replay_loss_fn(
        tt, cfg.replace(engine="queue"), 1, torch.from_numpy(px),
        torch.from_numpy(py), torch.from_numpy(tgt), geom_spec=spec,
        geom_tape=False)(p)
    loss.backward()
    _, ga = _ad_grads(tt, cfg, px, py, tgt,
                      {k: getattr(tt, k) for k in fields})
    for f, idxs in spec.items():
        for idx in idxs:
            a, b = float(ga[f][idx]), float(p[f].grad[idx])
            assert abs(a - b) <= 1e-5 + 2e-3 * abs(a), (f, idx, a, b)
    assert float(p["sph_center"].grad[0].abs().max()) > 0
    torch.testing.assert_close(p["tex_color"].grad, ga["tex_color"],
                               rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("flags,match", [
    (dict(mis=True), "mis"), (dict(nee_glossy=True), "glossy")],
    ids=["mis", "glossy"])
def test_replay_refuses_mis_and_glossy(flags, match):
    _, _, tt, cfg = rect_lit(W, H)
    px, py = pixels(W, H)
    with pytest.raises(ValueError, match=match):
        treplay.make_replay_render(tt, cfg.replace(nee=True, **flags), 1,
                                   px, py)
