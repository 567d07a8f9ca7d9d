"""One rank of the port's multi-process tests on the CPU.

    python tests/torch_dist_worker.py JOB RANK WORLD STORE OUT

joins a gloo group of WORLD ranks through the file STORE
(parallel/distributed.init_distributed with explicit arguments), runs
JOB's cases and writes its arrays to OUT/rank{RANK}.npz. Jobs:

  render  render_sharded_ex of three_sphere_scene at 64x36, spp 4,
          depth 4 on meshes (4,1), (2,2), (1,4) x engines plain, mega
          and queue; mega with compaction; spp 3 over a sample axis of
          2; samples_per_launch 1; then the CLI's render --sharded
          --checkpoint in-process, spp 2 and resumed to spp 4 on one
          checkpoint file, counting each rank's checkpoint saves;
          then Mesh.run_on_root on a group with a short timeout
  grad    gradients summed over the ranks (replay on the plain adjoint
          and on mega and queue, the tape's vg, finite-difference probe
          losses) and 2-step fits (ad, replay, tape, fit_hybrid with FD
          components) of grad_scene() at 24x14, each rank on its slab

tests/test_torch_parallel.py and tests/test_torch_shard_grad.py spawn
the ranks and hold the arrays to the single-process results. Imports
neither JAX nor rt_tpu.
"""

import os
import signal
import subprocess
import sys

import numpy as np
import torch

torch.set_num_threads(1)

RENDER_MESHES = ((4, 1), (2, 2), (1, 4))
ENGINES = ("plain", "mega", "queue")
GRAD_FIELDS = ("tex_color", "mat_albedo")
FD_COMPONENTS = [("sph_center", (0, 0)), ("sph_center", (1, 1))]


def render_scene():
    from rt_tpu_torch.scene.builders import three_sphere_scene
    from rt_tpu_torch.scene.types import build_tables

    sdef, cfg = three_sphere_scene(width=64, height=36, spp=4, max_depth=4)
    return build_tables(sdef), cfg


def grad_scene():
    """tests/test_shard_bwd.py's scene at 24x14: a metal sphere under a
    gradient sky (geometry reaches the radiance), a lambertian sphere
    and an emissive rect (the radiometric fields)."""
    from rt_tpu_torch.config import RenderConfig
    from rt_tpu_torch.scene.types import SceneDef, build_tables

    s = SceneDef(width=24, height=14, samples_per_pixel=2, max_depth=4,
                 background=(0.7, 0.8, 1.0))
    s.add_sphere((0, 0, -1.5), 0.5, s.add_metal((0.8, 0.7, 0.6), 0.0))
    s.add_sphere((-1.0, 0, -1.5), 0.5,
                 s.add_lambertian_color((0.7, 0.2, 0.2)))
    s.add_sphere((0, -100.5, -1.5), 100,
                 s.add_lambertian_color((0.5, 0.5, 0.5)))
    s.add_rect("xy_rect", -0.5, 0.5, 0.8, 1.4, -2.5,
               s.add_diffuse_light_color((4.0, 3.5, 3.0)))
    s.set_camera((0, 0.3, 1.2), (0, 0, -1.5), (0, 1, 0), 55, 0.0)
    cfg = RenderConfig(width=24, height=14, samples_per_pixel=2,
                       max_depth=4, engine="mega",
                       background_mode="gradient")
    return build_tables(s), cfg


def grad_target(cfg):
    return np.full((cfg.height, cfg.width, 3), 0.2, np.float32)


def grad_params(tables, names=GRAD_FIELDS):
    return {k: getattr(tables, k).clone().requires_grad_(True)
            for k in names}


def render_job(mesh_of):
    from rt_tpu_torch.parallel.sharded import render_sharded_ex

    tables, cfg = render_scene()
    out = {}
    for shape in RENDER_MESHES:
        mesh = mesh_of(shape)
        for engine in ENGINES:
            img, spp = render_sharded_ex(tables, cfg.replace(engine=engine),
                                         mesh)
            out[f"{shape[0]}x{shape[1]}_{engine}"] = img
            out[f"{shape[0]}x{shape[1]}_{engine}_spp"] = spp
    compact = cfg.replace(engine="mega", compact_schedule=(2,),
                          compact_group=16)
    for shape in ((4, 1), (2, 2)):
        out[f"{shape[0]}x{shape[1]}_compact"], _ = render_sharded_ex(
            tables, compact, mesh_of(shape))
    out["spp3"], out["spp3_spp"] = render_sharded_ex(
        tables, cfg.replace(samples_per_pixel=3, engine="plain"),
        mesh_of((2, 2)))
    out["per_launch"], _ = render_sharded_ex(
        tables, cfg.replace(engine="queue"), mesh_of((4, 1)),
        samples_per_launch=1)
    return out


# render --sharded --checkpoint: three_sphere at 32x18, depth 4, on the
# plain engine, a checkpoint every sample; -spp, --checkpoint, -o and
# --log come with the call
CKPT_ARGS = ["render", "--sharded", "--coded", "three_sphere", "-w", "32",
             "--height", "18", "-d", "4", "--engine", "plain", "--device",
             "cpu", "--checkpoint-every", "1"]


def checkpoint_job(outdir):
    """The CLI's render --sharded --checkpoint run twice through main on
    this rank, spp 2 and then spp 4 on the same checkpoint (the second
    resumes from the first's file). Returns each run's exit code and the
    samples_done of every checkpoint this rank saved, and on rank 0 the
    final checkpoint's sums and the PNG."""
    from rt_tpu_torch import cli
    from rt_tpu_torch.io.image import read_png
    from rt_tpu_torch.parallel.distributed import world
    from rt_tpu_torch.render import progressive

    saves = []
    save = progressive.Checkpoint.save

    def counted(ck, path):
        saves.append(ck.samples_done)
        save(ck, path)

    ck = os.path.join(outdir, "ck.npz")
    png = os.path.join(outdir, "ck.png")
    out = {}
    progressive.Checkpoint.save = counted
    try:
        for spp in (2, 4):
            n = len(saves)
            out[f"ckpt{spp}_rc"] = cli.main(CKPT_ARGS + [
                "-spp", str(spp), "--checkpoint", ck, "-o", png, "--log",
                os.path.join(outdir, "ck.log")])
            out[f"ckpt{spp}_saves"] = np.asarray(saves[n:], np.int64)
    finally:
        progressive.Checkpoint.save = save
    if world()[0] == 0:
        out["ckpt_sum"] = progressive.Checkpoint.load(ck).pixel_sum
        out["ckpt_png"] = read_png(png)
    return out


# run_on_root's wait: rank 0 works ROOT_WORK_S seconds, past the
# ROOT_GROUP_TIMEOUT_S of the group its mesh holds
ROOT_GROUP_TIMEOUT_S, ROOT_WORK_S = 2.0, 5.0


def root_wait_job():
    """Mesh.run_on_root over a gloo group whose collectives time out
    after ROOT_GROUP_TIMEOUT_S: rank 0 works ROOT_WORK_S seconds and
    returns 7, then the group sums each rank's code (it must still
    work); then rank 0 raises. Returns each rank's code, the sum, and
    whether this rank raised in the second call."""
    import dataclasses
    import datetime
    import time

    import torch.distributed as dist

    from rt_tpu_torch.parallel.mesh import make_mesh

    dist.barrier()  # the ranks make the short group together
    short = dist.new_group(backend="gloo", timeout=datetime.timedelta(
        seconds=ROOT_GROUP_TIMEOUT_S))
    mesh = dataclasses.replace(make_mesh(), group=short)

    def work():
        time.sleep(ROOT_WORK_S)
        return 7

    def fail():
        raise ValueError("rank 0 fails")

    code = mesh.run_on_root(work)
    total = mesh.all_reduce_sum([torch.tensor([float(code)])])[0]
    try:
        mesh.run_on_root(fail)
        raised = 0
    except (ValueError, RuntimeError):
        raised = 1
    return {"root_code": code, "root_sum": total.numpy(),
            "root_raised": raised}


def grad_job(mesh_of):
    from rt_tpu_torch.diff import inverse
    from rt_tpu_torch.diff.replay import make_replay_loss_fn
    from rt_tpu_torch.diff.tape import make_tape_vg

    tables, cfg = grad_scene()
    mesh = mesh_of(None)
    target = grad_target(cfg)
    px, py, tgt, row0, n_valid = inverse._pixel_rows(cfg, target, "cpu",
                                                     mesh)
    out = {"row0": row0, "rows": px.shape[0]}

    def save(name, loss, grads):
        summed = mesh.all_reduce_sum([loss.detach()] + [
            grads[k] for k in sorted(grads)])
        out[f"{name}_loss"] = summed[0].numpy()
        for k, g in zip(sorted(grads), summed[1:]):
            out[f"{name}_{k}"] = g.numpy()

    for name, engine, bwd_kernel in (("replay_plain", "mega", False),
                                     ("replay_mega", "mega", None),
                                     ("replay_queue", "queue", None)):
        params = grad_params(tables)
        loss = make_replay_loss_fn(
            tables, cfg.replace(engine=engine), 2, px, py, tgt,
            n_valid=n_valid, row_offset=row0, bwd_kernel=bwd_kernel)(params)
        loss.backward()
        save(name, loss, {k: v.grad for k, v in params.items()})

    probes = inverse.fd_losses(
        lambda pp: inverse._render_loss(inverse.apply_params(tables, pp),
                                        cfg, px, py, tgt, 2, 0, n_valid,
                                        row0),
        {"sph_center": tables.sph_center}, FD_COMPONENTS, 2e-2)
    out["fd_probes"] = mesh.all_reduce_sum([probes])[0].numpy()

    vg = make_tape_vg(tables, cfg, px, py, tgt, spp=2, min_width=64,
                      n_valid=n_valid, row_offset=row0)
    loss, grads = vg(grad_params(tables, ("sph_center", "sph_radius",
                                          "mat_albedo")))
    save("tape_vg", loss, grads)

    fits = {
        "fit_ad": lambda: inverse.fit(
            tables, cfg, target, fields=GRAD_FIELDS, spp=2, steps=2,
            method="ad", mesh=mesh),
        "fit_replay": lambda: inverse.fit(
            tables, cfg, target, fields=GRAD_FIELDS, spp=2, steps=2,
            method="replay", mesh=mesh),
        "fit_tape": lambda: inverse.fit(
            tables, cfg, target, fields=("sph_center", "mat_albedo"),
            spp=2, steps=2, method="tape", mesh=mesh),
        "fit_hybrid": lambda: inverse.fit_hybrid(
            tables, cfg, target, replay_fields=("tex_color",),
            fd_params={"sph_center": [c for _, c in FD_COMPONENTS]},
            spp=2, steps=2, mesh=mesh),
    }
    for name, run in fits.items():
        rec, hist = run()
        out[f"{name}_history"] = np.asarray(hist)
        for k, v in rec.items():
            out[f"{name}_{k}"] = v
    return out


def spawn(job: str, world: int, tmpdir: str, timeout: float = 110.0):
    """Run JOB on WORLD ranks, one process each, and return each rank's
    arrays. Every rank must exit 0 within timeout seconds, or the ranks
    are killed and this raises."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": root, "CUDA_VISIBLE_DEVICES": "",
           "OMP_NUM_THREADS": "1"}
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
              "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    store = os.path.join(tmpdir, "store")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), job, str(r), str(world),
         store, tmpdir], env=env, cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    bad = [(r, p.returncode, log[-3000:])
           for r, (p, log) in enumerate(zip(procs, logs))
           if p.returncode != 0]
    if bad or len(logs) != world:
        raise AssertionError(f"ranks failed: {bad}")
    return [dict(np.load(os.path.join(tmpdir, f"rank{r}.npz")))
            for r in range(world)]


def main(argv):
    job, rank, world, store, outdir = argv
    from rt_tpu_torch.parallel.distributed import (init_distributed,
                                                   shutdown_distributed)
    from rt_tpu_torch.parallel.mesh import make_mesh

    init_distributed(device="cpu", backend="gloo", rank=int(rank),
                     world_size=int(world), init_method=f"file://{store}",
                     timeout_s=100.0)
    try:
        out = {"render": render_job, "grad": grad_job}[job](
            lambda shape: make_mesh(shape))
        if job == "render":
            out.update(checkpoint_job(outdir))
            out.update(root_wait_job())
    finally:
        shutdown_distributed()
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
