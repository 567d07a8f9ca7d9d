"""Animation / video-synthesis drivers (rt_tpu/drivers/animate.py).

Reference equivalents:
  - "blue": mutate a base scene JSON, advancing every cylinder's rotation
    angle by N degrees per frame (gpu-version/blue.py:14-22 does +1°/frame
    for 360 frames, blue2.py +2° for 180).
  - "dna": regenerate the procedural rotating-ring scene per frame
    (gpu-version/dna.py:16-102).
  - "points": per-frame point-cloud mesh animation
    (taichi-version/main.py:152-216: reload asset/points/{i+1}.txt,
    rebuild the world, render).
  - "dolly": the naive tracer's camera moving along a parabola
    (朴素光线追踪/4_0_path_tracing.py:135-150).

Frames render one after another on one device; FramePipeline writes
frame i while frame i+1 renders. Under torchrun (a process group of
more than one rank) each frame renders over all ranks instead
(parallel/sharded.py) and rank 0 writes it. The reference farms frames over
independent processes (blue.py:24-32); `--farm N` does the same with N
worker processes, each taking a contiguous slice of the frame range
(parallel/distributed.frame_range). Per-frame outputs are idempotent,
so a crashed batch resumes at the last written frame (blue and points
skip frames already on disk). Each blue frame's scene JSON is written
next to its image before it renders, like blue.py:20-22: the on-disk
scene is the checkpoint.
"""

from __future__ import annotations

import copy
import json
import os
import time


def _frame_cfg(args, cfg):
    cfg = cfg.replace(width=args.width, height=args.height,
                      samples_per_pixel=args.spp, max_depth=args.max_depth,
                      engine=args.engine,
                      # one launch of up to 1<<25 rays: the config default
                      # 1<<17 would split a 1080p frame into a launch per
                      # sample and a tile of pixels
                      rays_per_batch=max(cfg.rays_per_batch, 1 << 25))
    if cfg.max_depth >= 16:
        # deep traces: the tapered compaction schedule (read by "mega")
        cfg = cfg.replace(compact_schedule=(2, 3, 5, 10), compact_group=16)
    return cfg


def _host_slice(args):
    """This host's contiguous frame slice of the farm
    (parallel/distributed.frame_range)."""
    from rt_tpu_torch.parallel.distributed import frame_range

    return frame_range(args.frames, args.num_hosts, args.host_index,
                       start=args.start)


def _with_retries(args, fn, frame_idx):
    """Per-frame retry: frames are idempotent (scene JSON and image
    outputs), so a failed frame is rendered again."""
    for attempt in range(args.retries + 1):
        try:
            return fn()
        except Exception:
            if attempt >= args.retries:
                raise
            print(f"frame {frame_idx}: retry {attempt + 1}", flush=True)


def _download(img, spp):
    """Start the download of a frame's 8-bit image; returns a function
    that waits for it and gives the [H,W,3] u8 array. On the card the
    u8 image is made on the device and copied into pinned host memory
    without waiting, an event marking the copy's end; the copy runs on
    the stream after the frame's launches and before the next frame's."""
    import torch

    from rt_tpu_torch.render import film

    u8 = film.finalize_u8(img, spp, gamma=True)
    if u8.device.type != "cuda":
        host = u8.numpy()
        return lambda: host
    host = torch.empty(u8.shape, dtype=torch.uint8, pin_memory=True)
    host.copy_(u8, non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def fetch(keep=u8):  # keep the device image alive until the copy ends
        done.synchronize()
        return host.numpy()

    return fetch


class FramePipeline:
    """Write frame i while frame i+1 renders (one device).

    `submit` dispatches the next frame's render and the download of its
    8-bit image, and only then waits for and writes the previous frame,
    so the previous frame's wait and image encode follow the new frame's
    launches. A frame whose download fails is rendered again
    synchronously once by `flush` (frames are idempotent); if that fails
    too, the frame stays pending and the error propagates, so the next
    submit / flush retries it: a frame is never dropped silently.

    flush reports (path, seconds from submit to the written image);
    drivers print that, not the time of submit, which is the previous
    frame's wait and encode."""

    def __init__(self, device="cuda"):
        self.device = device
        self._pending = None

    def submit(self, tables, cfg, path):
        from rt_tpu_torch.render import renderer

        img = renderer.render(tables, cfg, device=self.device)
        fetch = _download(img, cfg.samples_per_pixel)
        # flush after the dispatch. If flush raises, the old frame stays
        # pending (retried by the next flush) and this frame is dropped:
        # frames are idempotent and _with_retries submits it again
        prev = self.flush()
        self._pending = (fetch, tables, cfg, path, time.time())
        return prev

    def flush(self):
        """Wait for and write the in-flight frame, if any. Returns
        (path, in_flight_seconds) or None. On failure the frame stays
        pending (a later flush retries it) and the error propagates."""
        if self._pending is None:
            return None
        from rt_tpu_torch.io.image import write_image
        from rt_tpu_torch.render import film, renderer

        fetch, tables, cfg, path, t0 = self._pending
        try:
            u8 = fetch()
        except Exception:
            u8 = film.finalize(renderer.render(tables, cfg,
                                               device=self.device),
                               cfg.samples_per_pixel, gamma=True)
        write_image(path, u8)
        self._pending = None
        return path, time.time() - t0


def _log_done(done):
    """Print a completed pipelined frame's wall-clock (submit -> image)."""
    if done is not None:
        print(f"wrote {os.path.basename(done[0])}: {done[1]:.2f}s "
              "in flight", flush=True)


def _render_frame(pipeline, tables, cfg, path):
    """Render a frame and write it. In a process group of more than one
    rank (torchrun), the frame renders over the mesh of all ranks
    (parallel/sharded.render_sharded_ex, normalised by the spp it
    rendered) and rank 0 writes it, as the reference's branch for more
    than one local device (rt_tpu/drivers/animate.py:149-155). In a
    world of one the frame goes to the pipeline: the line printed is
    the PREVIOUS frame completing."""
    from rt_tpu_torch.parallel.distributed import world

    rank, n_ranks = world()
    if n_ranks == 1:
        _log_done(pipeline.submit(tables, cfg, path))
        return
    from rt_tpu_torch.io.image import write_image
    from rt_tpu_torch.parallel.mesh import make_mesh
    from rt_tpu_torch.parallel.sharded import render_sharded_ex
    from rt_tpu_torch.render import film

    t0 = time.time()
    img, spp = render_sharded_ex(tables, cfg, make_mesh())
    if rank == 0:
        write_image(path, film.finalize(img, spp, gamma=True))
        print(f"wrote {os.path.basename(path)}: {time.time() - t0:.2f}s "
              f"over {n_ranks} ranks", flush=True)


def run_blue(args) -> int:
    """Per-frame JSON mutation: cylinders' rotate.angle += deg_per_frame
    (gpu-version/blue.py:17-19)."""
    from rt_tpu_torch.scene.parser import parse_scene_dict
    from rt_tpu_torch.scene.types import build_tables

    if args.scene is None:
        raise SystemExit("--scene required for blue mode")
    with open(args.scene) as f:
        base = json.load(f)
    os.makedirs(args.outdir, exist_ok=True)

    lo, hi = _host_slice(args)
    pipe = FramePipeline(args.device)
    for i in range(lo, hi):
        data = copy.deepcopy(base)
        objs = data.get("object", {})
        rows = objs.get("data", objs if isinstance(objs, list) else [])
        for obj in rows:
            if obj.get("type") == "cylinder" and "rotate" in obj:
                obj["rotate"]["angle"] = (
                    obj["rotate"].get("angle", 0.0)
                    + args.deg_per_frame * i)
        out_path = os.path.join(args.outdir,
                                f"frame_{i:04d}.{args.format}")
        if os.path.exists(out_path):
            continue  # idempotent resume: finished frames are skipped
        scene_path = os.path.join(args.outdir, f"scene_{i:04d}.json")
        with open(scene_path, "w") as f:
            json.dump(data, f)
        sdef, cfg = parse_scene_dict(
            data, base_dir=os.path.dirname(args.scene) or ".")
        cfg = _frame_cfg(args, cfg)
        # the frame config overrides the parsed scene's dimensions:
        # re-derive the camera for the new aspect (SceneDef.resize)
        sdef.resize(args.width, args.height)
        _with_retries(args, lambda: _render_frame(
            pipe, build_tables(sdef), cfg, out_path), i)
    _log_done(pipe.flush())
    return 0


def run_dna(args) -> int:
    """Procedural ring scene, one render per frame angle
    (gpu-version/dna.py:103-113 renders frames serially and times them)."""
    from rt_tpu_torch.scene.builders import dna_scene
    from rt_tpu_torch.scene.types import build_tables

    os.makedirs(args.outdir, exist_ok=True)
    t_all = time.time()
    lo, hi = _host_slice(args)
    pipe = FramePipeline(args.device)
    for i in range(lo, hi):
        sdef, cfg = dna_scene(angle_deg=args.deg_per_frame * i,
                              width=args.width, height=args.height,
                              spp=args.spp, max_depth=args.max_depth)
        cfg = _frame_cfg(args, cfg)
        _with_retries(args, lambda: _render_frame(
            pipe, build_tables(sdef), cfg,
            os.path.join(args.outdir, f"frame_{i:04d}.{args.format}")), i)
    _log_done(pipe.flush())
    print(f"total: {time.time() - t_all:.2f}s")
    return 0


def run_points(args) -> int:
    """Taichi dynamic-mesh animation: frame i loads {points_dir}/{i+1}.txt
    as the mesh vertex positions (taichi-version/main.py:205-216)."""
    from rt_tpu_torch.scene.assets import readdynamic
    from rt_tpu_torch.scene.builders import mesh_scene
    from rt_tpu_torch.scene.types import build_tables

    if args.obj is None or args.points_dir is None:
        raise SystemExit("--obj and --points-dir required for points mode")
    os.makedirs(args.outdir, exist_ok=True)
    lo, hi = _host_slice(args)
    pipe = FramePipeline(args.device)
    for i in range(lo, hi):
        out_path = os.path.join(args.outdir, f"out{i}.{args.format}")
        if os.path.exists(out_path):
            continue  # idempotent resume
        pts = readdynamic(os.path.join(args.points_dir, f"{i + 1}.txt"))
        sdef, cfg = mesh_scene(args.obj, width=args.width,
                               height=args.height, spp=args.spp,
                               max_depth=args.max_depth, points=pts,
                               texture_path=args.texture)
        if args.taichi_uv:
            sdef.taichi_tri_uv = True  # pixel-comparable vs taichi output/
        cfg = _frame_cfg(args, cfg)
        _render_frame(pipe, build_tables(sdef), cfg, out_path)
    _log_done(pipe.flush())
    return 0


def run_dolly(args) -> int:
    """Camera-dolly animation: the naive tracer moves its camera along a
    parabola z -> (x, -0.2 + 0.0375*(z-4)^2, z) between progressive
    renders (朴素光线追踪/4_0_path_tracing.py:135-150). Per frame the
    camera is rebuilt and the cornell-spheres scene re-rendered."""
    from rt_tpu_torch.scene.builders import cornell_spheres_scene
    from rt_tpu_torch.scene.types import build_tables

    os.makedirs(args.outdir, exist_ok=True)
    lo, hi = _host_slice(args)
    pipe = FramePipeline(args.device)
    for i in range(lo, hi):
        z = -5.0 + 0.5 * i * args.deg_per_frame
        y = -0.2 + 0.0375 * (z - 4.0) ** 2
        sdef, cfg = cornell_spheres_scene(width=args.width,
                                          height=args.height,
                                          spp=args.spp,
                                          max_depth=args.max_depth)
        sdef.set_camera(lookfrom=(0, y, z), lookat=(0, 0.6, 0),
                        vup=(0, 1, 0), vfov_deg=60.0, aperture=0.0)
        cfg = _frame_cfg(args, cfg)
        _with_retries(args, lambda: _render_frame(
            pipe, build_tables(sdef), cfg,
            os.path.join(args.outdir, f"dolly_{i:04d}.{args.format}")), i)
    _log_done(pipe.flush())
    return 0


_FRAME_GLOBS = {"blue": "frame_*.{ext}", "dna": "frame_*.{ext}",
                "points": "out*.{ext}", "dolly": "dolly_*.{ext}"}


def _farm(args) -> int:
    """One-command local process farm: spawn N worker processes, each
    rendering a contiguous slice of the frame range, and wait for all of
    them, as the blue.py pipeline does (gpu-version/blue.py:24-35: 8
    concurrent renderer processes, a shell `wait`, abort on a nonzero
    exit). --farm-platform inherit (the default) gives the workers this
    process's --device, so they run on the card; cpu runs them with
    --device cpu."""
    import subprocess
    import sys

    n = args.farm
    device = "cpu" if args.farm_platform == "cpu" else args.device
    cmd_base = [sys.executable, "-m", "rt_tpu_torch", "animate",
                "--kind", args.kind, "--frames", str(args.frames),
                "--start", str(args.start),
                "--deg-per-frame", str(args.deg_per_frame),
                "--outdir", args.outdir, "-w", str(args.width),
                "--height", str(args.height), "-spp", str(args.spp),
                "-d", str(args.max_depth), "--engine", args.engine,
                "--retries", str(args.retries), "--num-hosts", str(n),
                "--format", args.format, "--device", device]
    for opt in ("scene", "points_dir", "obj", "texture"):
        v = getattr(args, opt)
        if v:
            cmd_base += [f"--{opt.replace('_', '-')}", v]
    if args.taichi_uv:
        cmd_base.append("--taichi-uv")
    # the workers import this package from where this process did
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    procs = [subprocess.Popen(cmd_base + ["--host-index", str(i)], env=env)
             for i in range(n)]
    rc = 0
    for i, p in enumerate(procs):
        code = p.wait()
        if code != 0:  # blue.py:33-35 aborts the batch on nonzero exit
            print(f"worker {i} failed with exit code {code}", flush=True)
            rc = code
    return rc


def run_animation(args) -> int:
    if args.farm and args.host_index == 0 and args.num_hosts == 1:
        rc = _farm(args)
    else:
        rc = {"blue": run_blue, "dna": run_dna, "points": run_points,
              "dolly": run_dolly}[args.kind](args)
    if rc == 0 and args.video:
        # assemble the frame sequence into a playable video
        import glob

        from rt_tpu_torch.io.video import assemble_video

        frames = glob.glob(os.path.join(
            args.outdir, _FRAME_GLOBS[args.kind].format(ext=args.format)))
        written = assemble_video(frames, args.video, fps=args.fps)
        print(f"wrote {written} ({len(frames)} frames)", flush=True)
    return rc
