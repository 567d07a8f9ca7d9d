"""rt_tpu_torch's training over a mesh (diff/inverse.fit and fit_hybrid
with mesh=, the losses' row offsets) on the CPU, against the port's
single-process gradients: tests/test_shard_bwd.py's matrix for the port.

One gloo group of 2 spawned ranks (tests/torch_dist_worker.py, once for
the module) runs every case on grad_scene() at 24x14 (336 pixels; the
padded list holds 512, so rank 1's slab ends in 176 pad rows: the
non-dividing case of tests/test_diff.py::
test_fit_replay_mesh_pads_nondivisible_pixels). Each rank masks its
rows by their global index and divides by the whole frame's count, and
the ranks' sums are held to one process's gradients within rtol 1e-5 /
atol 1e-7 (tests/test_shard_bwd.py:79-82); the fits' parameters must be
equal bit for bit on the two ranks.
"""

import numpy as np
import pytest
import torch

import torch_dist_worker as worker
from rt_tpu_torch.diff import inverse
from rt_tpu_torch.diff.replay import make_replay_loss_fn
from rt_tpu_torch.diff.tape import make_tape_vg

# One intra-op thread: the suite runs in several worker processes at
# once (as the other port test files).
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-7)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return worker.spawn("grad", 2, str(tmp_path_factory.mktemp("grad")))


@pytest.fixture(scope="module")
def single():
    """The scene, its config, the target and the whole frame's rows."""
    tables, cfg = worker.grad_scene()
    target = worker.grad_target(cfg)
    px, py, tgt = inverse._frame(cfg, target, "cpu")
    return tables, cfg, target, px, py, tgt


def test_slabs_cover_the_padded_frame(ranks):
    assert [int(r["row0"]) for r in ranks] == [0, 256]
    assert [int(r["rows"]) for r in ranks] == [256, 256]


def _held(ranks, name, want):
    for k, v in want.items():
        got = ranks[0][f"{name}_{k}"]
        np.testing.assert_array_equal(got, ranks[1][f"{name}_{k}"])
        np.testing.assert_allclose(got, np.asarray(v), **TOL, err_msg=k)


@pytest.mark.parametrize("name,engine,bwd_kernel", [
    ("replay_plain", "mega", False), ("replay_mega", "mega", None),
    ("replay_queue", "queue", None)])
def test_sharded_replay_grads_match_single(ranks, single, name, engine,
                                           bwd_kernel):
    """The path replay on the plain adjoint, on B5's and on B6's plain
    versions (bwd_kernel None on "mega" / "queue")."""
    tables, cfg, _, px, py, tgt = single
    params = worker.grad_params(tables)
    loss = make_replay_loss_fn(tables, cfg.replace(engine=engine), 2, px, py,
                               tgt, bwd_kernel=bwd_kernel)(params)
    loss.backward()
    assert float(params["tex_color"].grad.abs().max()) > 0
    _held(ranks, name, {"loss": loss.detach(),
                        **{k: v.grad for k, v in params.items()}})


def test_sharded_tape_vg_matches_single(ranks, single):
    """make_tape_vg's loss and the gradients of the sphere geometry and
    the albedo, each rank's lanes sorted by death within its slab."""
    tables, cfg, _, px, py, tgt = single
    loss, grads = make_tape_vg(tables, cfg, px, py, tgt, spp=2,
                               min_width=64)(
        worker.grad_params(tables, ("sph_center", "sph_radius",
                                    "mat_albedo")))
    assert float(grads["sph_center"].abs().max()) > 0
    _held(ranks, "tape_vg", {"loss": loss, **grads})


def test_sharded_fd_probe_losses_match_single(ranks, single):
    """fit_hybrid's probe losses, summed over the ranks before they are
    differenced (inverse.fd_losses on each slab, masked)."""
    tables, cfg, _, px, py, tgt = single
    want = inverse.fd_losses(
        lambda pp: inverse._render_loss(inverse.apply_params(tables, pp),
                                        cfg, px, py, tgt, 2),
        {"sph_center": tables.sph_center}, worker.FD_COMPONENTS, 2e-2)
    np.testing.assert_array_equal(ranks[0]["fd_probes"],
                                  ranks[1]["fd_probes"])
    np.testing.assert_allclose(ranks[0]["fd_probes"], want.numpy(), **TOL)


@pytest.mark.parametrize("method,fields", [
    ("ad", worker.GRAD_FIELDS), ("replay", worker.GRAD_FIELDS),
    ("tape", ("sph_center", "mat_albedo"))], ids=["ad", "replay", "tape"])
def test_sharded_fit_matches_single(ranks, single, method, fields):
    """fit(mesh=) for 2 steps: the loss history and the parameters."""
    tables, cfg, target, *_ = single
    rec, hist = inverse.fit(tables, cfg, target, fields=fields, spp=2,
                            steps=2, method=method, device="cpu")
    assert hist[1] != hist[0]
    _held(ranks, f"fit_{method}", {"history": hist, **rec})


def test_sharded_fit_hybrid_matches_single(ranks, single):
    """fit_hybrid(mesh=) for 2 steps with two sph_center FD components.
    The history and the replay's field within rtol 1e-5 / atol 1e-7;
    the FD components within rtol 1e-4: a central difference divides
    the gap of two losses (each within an ulp of the single-process one,
    test_sharded_fd_probe_losses_match_single) by 2 eps = 0.04, which
    leaves the difference ~1e-5 relative, and Adam's second step
    carries that into the parameter (tests/test_diff.py holds rt_tpu's
    sharded fit_hybrid to atol 1e-4)."""
    tables, cfg, target, *_ = single
    rec, hist = inverse.fit_hybrid(
        tables, cfg, target, replay_fields=("tex_color",),
        fd_params={"sph_center": [c for _, c in worker.FD_COMPONENTS]},
        spp=2, steps=2, device="cpu")
    _held(ranks, "fit_hybrid", {"history": hist,
                                "tex_color": rec["tex_color"]})
    got = ranks[0]["fit_hybrid_sph_center"]
    np.testing.assert_array_equal(got, ranks[1]["fit_hybrid_sph_center"])
    np.testing.assert_allclose(got, rec["sph_center"], rtol=1e-4)
    assert not np.array_equal(rec["sph_center"],
                              tables.sph_center.numpy())
