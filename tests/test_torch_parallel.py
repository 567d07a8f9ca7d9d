"""rt_tpu_torch's multi-process rendering (parallel/: init_distributed,
the (tile, sample) mesh, render_sharded_ex) on the CPU, against the
port's single-process render and rt_tpu's sharded render.

One gloo group of 4 spawned ranks (tests/torch_dist_worker.py, once for
the module) renders three_sphere_scene at 64x36, spp 4, depth 4 on the
meshes (4,1), (2,2), (1,4) x the engines plain, mega and queue (the
plain versions of B2 and B3 on the CPU), with compaction, with spp 3
over a sample axis of 2, and in one-sample launches. A mesh with one
sample a pixel gives render's frame bit for bit (the counter RNG keys on
the absolute pixel and sample); a sample axis above 1 sums in another
order (rtol / atol 1e-5, as tests/test_parallel.py). In the same group
the CLI's render --sharded --checkpoint runs in-process on every rank:
rank 0 alone writes the checkpoint, the other ranks waiting with no
collective timeout. The CLI's render --sharded, fit
--sharded and animate run under torchrun with 2 ranks.
"""

import json
import os
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import torch_dist_worker as worker
from rt_tpu.config import RenderConfig as JConfig
from rt_tpu.parallel.mesh import make_mesh as jmake_mesh
from rt_tpu.parallel.sharded import _padded_pixel_list as jpadded
from rt_tpu.parallel.sharded import render_sharded_ex as jrender_sharded_ex
from rt_tpu.scene import builders as jbuilders
from rt_tpu.scene import types as jtypes
from rt_tpu_torch import cli as tcli
from rt_tpu_torch.io.image import read_png
from rt_tpu_torch.parallel import distributed, make_mesh
from rt_tpu_torch.parallel.mesh import SAMPLE_AXIS, TILE_AXIS
from rt_tpu_torch.parallel.sharded import _padded_pixel_list
from rt_tpu_torch.render.progressive import Checkpoint
from rt_tpu_torch.render.renderer import render

# One intra-op thread: the suite runs in several worker processes at
# once (as the other port test files).
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(ROOT, "scenes", "demo_scene.json")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's arrays of the render job (4 ranks, one group)."""
    return worker.spawn("render", 4, str(tmp_path_factory.mktemp("render")))


@pytest.fixture(scope="module")
def frames():
    """The port's single-process frames, by engine."""
    tables, cfg = worker.render_scene()
    return {e: render(tables, cfg.replace(engine=e), device="cpu").numpy()
            for e in worker.ENGINES}


def _same_on_every_rank(ranks, key):
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[key], ranks[0][key])
    return ranks[0][key]


@pytest.mark.parametrize("shape", worker.RENDER_MESHES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("engine", worker.ENGINES)
def test_render_sharded_matches_render(ranks, frames, shape, engine):
    key = f"{shape[0]}x{shape[1]}_{engine}"
    img = _same_on_every_rank(ranks, key)
    assert int(ranks[0][key + "_spp"]) == 4
    if shape[1] == 1:
        np.testing.assert_array_equal(img, frames[engine])
    else:
        np.testing.assert_allclose(img, frames[engine], rtol=1e-5,
                                   atol=1e-5)
    assert img.max() > 0


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_mega_with_compaction(ranks, frames, shape):
    """tests/test_parallel.py::test_sharded_mega_with_compaction: the
    segmented megakernel with live-lane compaction on each rank's slab,
    against the frame without compaction."""
    img = _same_on_every_rank(ranks, f"{shape[0]}x{shape[1]}_compact")
    if shape[1] == 1:
        np.testing.assert_array_equal(img, frames["mega"])
    else:
        np.testing.assert_allclose(img, frames["mega"], rtol=1e-5,
                                   atol=1e-5)


def test_sample_axis_rounds_up(ranks, frames):
    """spp 3 over a sample axis of 2 renders 4 samples a pixel."""
    assert int(ranks[0]["spp3_spp"]) == 4
    img = _same_on_every_rank(ranks, "spp3")
    np.testing.assert_allclose(img, frames["plain"], rtol=1e-5, atol=1e-5)


def test_samples_per_launch_keeps_the_bits(ranks, frames):
    """One-sample launches add to the running sum in sample order."""
    np.testing.assert_array_equal(
        _same_on_every_rank(ranks, "per_launch"), frames["queue"])


def test_cli_render_sharded_checkpoint_has_one_writer(ranks, tmp_path,
                                                     capsys):
    """render --sharded --checkpoint over the 4 ranks of the group (the
    CLI's main in-process): rank 0 alone saves, a checkpoint a sample,
    and the other ranks none; the second run resumes rank 0's file from
    sample 2 to 4. Its sums and PNG equal the one-process checkpointed
    render's bit for bit."""
    for r, out in enumerate(ranks):
        assert int(out["ckpt2_rc"]) == 0 and int(out["ckpt4_rc"]) == 0
        want = ([1, 2], [3, 4]) if r == 0 else ([], [])
        assert out["ckpt2_saves"].tolist() == want[0], r
        assert out["ckpt4_saves"].tolist() == want[1], r
    args = [a for a in worker.CKPT_ARGS if a != "--sharded"]
    ck = str(tmp_path / "ck.npz")
    assert tcli.main(args + ["-spp", "4", "--checkpoint", ck, "-o",
                             str(tmp_path / "u.png"), "--log",
                             str(tmp_path / "u.log")]) == 0
    capsys.readouterr()
    np.testing.assert_array_equal(ranks[0]["ckpt_sum"],
                                  Checkpoint.load(ck).pixel_sum)
    np.testing.assert_array_equal(ranks[0]["ckpt_png"],
                                  read_png(str(tmp_path / "u.png")))


def test_run_on_root_outlives_the_group_timeout(ranks):
    """Mesh.run_on_root (render --sharded --checkpoint's wait) on a
    group whose collectives time out after 2 s: rank 0 works 5 s, every
    rank gets its code 7, and the group still sums afterwards; when
    rank 0 raises, every rank raises."""
    assert worker.ROOT_WORK_S > 2 * worker.ROOT_GROUP_TIMEOUT_S
    for r, out in enumerate(ranks):
        assert int(out["root_code"]) == 7, r
        assert out["root_sum"].tolist() == [7.0 * len(ranks)], r
        assert int(out["root_raised"]) == 1, r


def test_sharded_matches_rt_tpu_sharded(ranks, images_close):
    """The port's (2, 2) gloo mesh on the plain engine against rt_tpu's
    render_sharded_ex on its (2, 2) CPU mesh with engine "xla", by the
    images_close of the plain-vs-xla frame tests."""
    sdef, cfg = jbuilders.three_sphere_scene(width=64, height=36, spp=4,
                                             max_depth=4)
    want, spp = jrender_sharded_ex(
        jtypes.build_tables(sdef), cfg.replace(engine="xla"),
        jmake_mesh((2, 2), jax.devices()[:4]))
    assert spp == 4 and isinstance(cfg, JConfig)
    images_close(ranks[0]["2x2_plain"], np.asarray(want), 4)


@pytest.mark.parametrize("w,h,n", [(64, 36, 4), (25, 15, 8), (7, 3, 3),
                                   (1920, 1080, 2)])
def test_padded_pixel_list_matches_rt_tpu(w, h, n):
    got, want = _padded_pixel_list(w, h, n), jpadded(w, h, n)
    assert got[2] == want[2] == w * h
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def test_make_mesh_world_of_one_and_bad_shapes():
    """Without a process group the mesh is (1, 1) on its device and the
    collective returns its input; a shape that does not fit the world
    raises ValueError, as rt_tpu's make_mesh does."""
    assert distributed.init_distributed(device="cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized()
    assert distributed.world() == (0, 1)
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {TILE_AXIS: 1, SAMPLE_AXIS: 1}
    assert mesh.coords == (0, 0) and mesh.group is None
    x = torch.arange(3.0)
    assert mesh.all_reduce_sum([x])[0] is x
    for shape in ((2, 1), (1, 2), (0, 1)):
        with pytest.raises(ValueError, match="!= 1 ranks"):
            make_mesh(shape, device="cpu")
    with pytest.raises(ValueError, match="gloo"):
        distributed.init_distributed(device="cpu", backend="nccl", rank=0,
                                     world_size=1)
    distributed.shutdown_distributed()


def _torchrun(args, cwd, timeout=110):
    """`python -m torch.distributed.run --standalone --nproc-per-node 2
    -m rt_tpu_torch ...` on the CPU in the directory cwd; returns rank
    0's standard output. Past timeout seconds the launcher and its ranks
    are killed. No --log: torchrun's own parser (Python 3.12.3) reads it
    as an ambiguous prefix of its --log-dir."""
    env = {**os.environ, "PYTHONPATH": ROOT, "CUDA_VISIBLE_DEVICES": "",
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "rt_tpu_torch"] + args,
        cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    assert proc.returncode == 0, out[-2000:] + err[-4000:]
    return out


def test_cli_render_and_fit_sharded_under_torchrun(tmp_path, capsys):
    """render --sharded and fit --sharded over 2 torchrun ranks (gloo on
    the CPU): rank 0 writes the same PNG as the unsharded render (queue)
    and a recovered.npz within rtol 1e-5 / atol 1e-7 of the unsharded
    fit's; rank 1 writes nothing and prints nothing."""
    small = ["-w", "40", "--height", "24", "-spp", "2", "-d", "4",
             "--coded", "cover", "--device", "cpu"]
    out = _torchrun(["render", "--sharded", "-o", str(tmp_path / "s.png")]
                    + small, tmp_path)
    assert out.count("wrote ") == 1 and "sharded over 2 rank(s)" in out
    assert tcli.main(["render", "-o", str(tmp_path / "u.png"), "--log",
                      str(tmp_path / "u.log")] + small) == 0
    np.testing.assert_array_equal(read_png(str(tmp_path / "s.png")),
                                  read_png(str(tmp_path / "u.png")))
    assert "devices 2" in (tmp_path / "rt_tpu_torch-time.log").read_text()

    with open(DEMO) as f:
        scene = json.load(f)
    scene["samples_per_pixel"] = 2  # the spp of fit's after.png
    with open(tmp_path / "demo.json", "w") as f:
        json.dump(scene, f)
    target = np.full((14, 24, 3), 0.3, np.float32)
    np.savez(str(tmp_path / "t.npz"), img=target)
    fit = ["fit", "-f", str(tmp_path / "demo.json"), "--target",
           str(tmp_path / "t.npz"), "--fields", "tex_color", "-spp", "2", "--steps", "2", "-d", "3",
           "--device", "cpu"]
    out = _torchrun(fit + ["--sharded", "--out", str(tmp_path / "fs")],
                    tmp_path)
    assert out.count("loss: ") == 1
    assert tcli.main(fit + ["--out", str(tmp_path / "fu")]) == 0
    capsys.readouterr()
    got = np.load(str(tmp_path / "fs" / "recovered.npz"))
    want = np.load(str(tmp_path / "fu" / "recovered.npz"))
    assert got.files == want.files
    for k in want.files:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7)
    assert os.path.getsize(tmp_path / "fs" / "after.png") > 0


def test_cli_animate_under_torchrun(tmp_path, capsys):
    """animate over 2 torchrun ranks: each frame renders over the mesh
    and rank 0 writes it, byte-equal to the one-process frames."""
    small = ["animate", "--kind", "dna", "--frames", "2", "--deg-per-frame",
             "10", "-w", "32", "--height", "18", "-spp", "2", "-d", "4",
             "--device", "cpu"]
    out = _torchrun(small + ["--outdir", str(tmp_path / "s")], tmp_path)
    assert out.count("over 2 ranks") == 2
    assert tcli.main(small + ["--outdir", str(tmp_path / "u")]) == 0
    capsys.readouterr()
    names = sorted(os.listdir(tmp_path / "u"))
    assert names == sorted(os.listdir(tmp_path / "s")) and len(names) == 2
    for n in names:
        assert (tmp_path / "s" / n).read_bytes() == \
            (tmp_path / "u" / n).read_bytes()
