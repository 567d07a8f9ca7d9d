"""Command-line interface (the port of rt_tpu/cli.py):

  python -m rt_tpu_torch render   one frame (rt_tpu/cli.py:27-254) of a
      JSON scene of the reference's schema (`-f scene.json`, as
      gpu-version/main.cu:454-460) or a coded scene (`--coded`), with
      the -w / --height / -spp / -d overrides (image textures load
      relative to the scene's directory; --taichi-uv swaps the triangle
      UV weights as the Taichi reference does). Output is chosen by
      extension: PNG or JPEG (no gamma, as the reference's write_image;
      --view-gamma applies sqrt) or PPM (sqrt gamma, as write_color);
      --both-formats writes the .ppm and the .png of one render, as
      jsonmain does; without -o, the scene's output_file (main.png for a
      coded scene). --checkpoint renders in passes and resumes exactly
      (render/progressive.py), --adaptive spends the spp budget on the
      noisiest pixels (render/adaptive.py), --progress prints the tiles
      or passes; each render appends its RenderStats line to --log
      (rt_tpu_torch-time.log). --bvh builds the four families' BVHs and
      walks them where an engine intersects ("plain", "pallas"; the
      kernels of "queue" and "mega" read none, as the reference's do).
      --sharded renders over the ranks of the process group that
      torchrun's environment describes (parallel/: one rank per card,
      NCCL), each its slab of pixels; rank 0 writes the image and the
      log line. With --checkpoint rank 0 alone renders and writes, as
      the reference renders it in one process. Without torchrun it is a
      world of one.
  python -m rt_tpu_torch parse    parse a scene JSON and print its
      summary (rt_tpu/cli.py `cmd_parse` :413-426).
  python -m rt_tpu_torch fit      inverse rendering (rt_tpu/cli.py
      `cmd_fit` :265-410): recover scene parameters so the render of the
      JSON scene (the initial guess) matches a target image; writes
      recovered.npz and after.png to --out and exits 0 when the loss
      fell.
  python -m rt_tpu_torch animate  a frame sequence (drivers/animate.py:
      blue, dna, points, dolly), optionally farmed over --farm worker
      processes and assembled into a --video.

render, fit and animate run on CUDA unless --device cpu is given. Under
torchrun (`torchrun --nproc-per-node N -m rt_tpu_torch render --sharded
...`) render --sharded and fit --sharded join the process group
(parallel/distributed.init_distributed: NCCL on cards, gloo with
--device cpu), and animate renders each frame over it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


CODED = ("three_sphere", "cover", "cover_lights", "cornell", "dna")


def _load(args):
    """(SceneDef, RenderConfig, output path) of the command line."""
    from rt_tpu_torch.scene import builders
    from rt_tpu_torch.scene.parser import parse_scene

    if args.scene:
        sdef, cfg = parse_scene(args.scene)
        out = sdef.output_file
    else:
        mk = {"three_sphere": builders.three_sphere_scene,
              "cover": builders.cover_scene,
              "cover_lights": lambda: builders.cover_scene(lights=True),
              "cornell": builders.cornell_spheres_scene,
              "dna": builders.dna_scene}[args.coded or "three_sphere"]
        sdef, cfg = mk()
        out = "main.png"
    if getattr(args, "taichi_uv", False):
        sdef.taichi_tri_uv = True
    updates = {}
    if args.width:
        updates["width"] = args.width
    if args.height:
        updates["height"] = args.height
    if args.spp:
        updates["samples_per_pixel"] = args.spp
    if args.max_depth:
        updates["max_depth"] = args.max_depth
    if args.seed:
        updates["seed"] = args.seed
    if updates:
        cfg = cfg.replace(**updates)
        for k, v in updates.items():
            if hasattr(sdef, k):
                setattr(sdef, k, v)
        if "width" in updates or "height" in updates:
            # re-derive the camera frame for the new aspect ratio
            sdef.resize()
    return sdef, cfg, args.output or out


def _write_outputs(img, spp, out_path, both=False, view_gamma=False):
    """Write the image by extension (PPM with sqrt gamma; PNG or JPEG
    without, unless view_gamma); with both=True write the .ppm and the
    .png of one render, as jsonmain does (gpu-version/main.cu:510-517).
    Returns the paths written."""
    from rt_tpu_torch.io.image import write_image
    from rt_tpu_torch.render import film

    base = (out_path[:-4] if out_path.endswith((".png", ".ppm", ".jpg"))
            else out_path)
    paths = [base + ".ppm", base + ".png"] if both else [out_path]
    for p in paths:
        if p.endswith(".ppm"):
            with open(p, "w") as f:
                f.write(film.to_ppm(img, spp))
        else:
            write_image(p, film.finalize(img, spp, gamma=view_gamma))
    return paths


def cmd_render(args) -> int:
    import torch.distributed as dist

    from rt_tpu_torch.config import resolve_device
    from rt_tpu_torch.parallel.distributed import shutdown_distributed

    joined = dist.is_initialized()  # a caller's group outlives this call
    mesh = _mesh(args) if args.sharded else None
    try:
        if mesh is not None and args.checkpoint:
            # --checkpoint renders in one process, as the reference's
            # (rt_tpu/cli.py:211-216): rank 0 alone renders and writes
            # the checkpoint and the image, the other ranks wait for it
            # with no collective timeout (a checkpointed render may
            # outlast the group's)
            return mesh.run_on_root(lambda: _render(args, mesh.device,
                                                    None))
        return _render(args, mesh.device if mesh is not None
                       else resolve_device(args.device), mesh)
    finally:
        if mesh is not None and not joined:
            shutdown_distributed()


def _mesh(args):
    """The (tile, sample) mesh of --sharded: the process group of
    torchrun's environment (a world of one without it) on --device."""
    from rt_tpu_torch.parallel.distributed import init_distributed
    from rt_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(device=init_distributed(device=args.device))


def _render(args, dev, mesh) -> int:
    from rt_tpu_torch.render import film
    from rt_tpu_torch.render.renderer import render
    from rt_tpu_torch.scene.types import build_tables
    from rt_tpu_torch.utils.metrics import RenderStats

    sdef, cfg, out = _load(args)
    cfg = cfg.replace(engine=args.engine)
    ce = args.compact_every
    if ce is None and cfg.max_depth >= 16:
        # deep traces: the reference's tapered compaction schedule
        # (rt_tpu/cli.py:184-195)
        cfg = cfg.replace(compact_schedule=(2, 3, 5, 10), compact_group=16)
    elif ce is not None:
        cfg = cfg.replace(compact_every=ce)
    cfg = cfg.replace(cull_chunks=args.cull, sampler=args.sampler)
    if args.nee:
        cfg = cfg.replace(nee=True)
    if args.mis:
        cfg = cfg.replace(nee=True, mis=True)
    if args.nee_glossy:
        cfg = cfg.replace(nee=True, nee_glossy=True)
    # every family's BVH, as rt_tpu/cli.py:204-208 builds them
    tables = build_tables(sdef, device=dev, bvh_types=(
        "sphere", "rect", "cylinder", "triangle") if args.bvh else ())
    if args.bvh:
        cfg = cfg.replace(traversal="bvh")

    stats = {}
    t0 = time.time()
    if args.checkpoint:
        from rt_tpu_torch.render.progressive import render_progressive

        img, _ = render_progressive(
            tables, cfg, checkpoint_path=args.checkpoint,
            checkpoint_every=args.checkpoint_every, progress=args.progress,
            device=dev)
    elif mesh is not None:
        from rt_tpu_torch.parallel.sharded import render_sharded_ex

        # the sharded renderer rounds spp up to the sample axis: the
        # writers normalise by the spp actually rendered
        img, spp_done = render_sharded_ex(tables, cfg, mesh,
                                          progress=args.progress,
                                          stats=stats)
        cfg = cfg.replace(samples_per_pixel=spp_done)
    elif args.adaptive:
        from rt_tpu_torch.render.adaptive import adaptive_mean, \
            render_adaptive

        acc, n = render_adaptive(tables, cfg, progress=args.progress,
                                 device=dev)
        # per-pixel counts: a mean scaled back to a uniform-spp sum, so
        # the writers' 1/spp scaling stays
        img = adaptive_mean(acc, n) * cfg.samples_per_pixel
    else:
        img = render(tables, cfg, device=dev, stats=stats,
                     progress=args.progress)
    neg = film.negative_pixels(img)  # waits for the device
    dt = time.time() - t0
    if mesh is not None and mesh.rank != 0:
        return 0  # rank 0 writes the image and the log line
    if neg:
        print(f"warning: {neg} pixels with negative radiance",
              file=sys.stderr)

    spp = cfg.samples_per_pixel
    paths = _write_outputs(img, spp, out, both=args.both_formats,
                           view_gamma=args.view_gamma)
    # the append-only timing log (the reference's *.log regression
    # surface, gpu-version/main.cu:338-345)
    RenderStats(width=cfg.width, height=cfg.height, spp=spp,
                max_depth=cfg.max_depth, seconds=dt, engine=cfg.engine,
                n_devices=mesh.size if mesh is not None else 1
                ).append_to(args.log)
    counts = ", ".join(f"{k} {v}" for k, v in sorted(stats.items()))
    sampling = "".join(f", {k}" for k in ("nee", "mis", "nee_glossy")
                       if getattr(cfg, k))
    mode = (", checkpointed" if args.checkpoint else
            f", sharded over {mesh.size} rank(s)" if mesh is not None else
            ", adaptive" if args.adaptive else "")
    print(f"wrote {' and '.join(paths)} ({cfg.width}x{cfg.height} @ "
          f"{spp}spp, depth {cfg.max_depth}{sampling}{mode}, engine "
          f"{cfg.engine} on {args.device}, {dt:.2f}s, paths/s "
          f"{cfg.width * cfg.height * spp / dt:.0f}; {counts})")
    return 0


def cmd_parse(args) -> int:
    """Parser smoke test: the reference's second CMake target, a binary
    that only runs parse_scene (gpu-version/parser.cu:1-4)."""
    from rt_tpu_torch.scene.parser import parse_scene

    sdef, _ = parse_scene(args.scene)
    print(json.dumps({
        "width": sdef.width, "height": sdef.height,
        "samples_per_pixel": sdef.samples_per_pixel,
        "max_depth": sdef.max_depth,
        "objects": len(sdef.objects), "materials": len(sdef.materials),
        "textures": len(sdef.textures), "output_file": sdef.output_file,
    }, indent=2))
    return 0


def cmd_animate(args) -> int:
    from rt_tpu_torch.config import resolve_device
    from rt_tpu_torch.drivers.animate import run_animation
    from rt_tpu_torch.parallel.distributed import (init_distributed,
                                                   shutdown_distributed)

    if args.farm:
        if args.farm_platform != "cpu":
            resolve_device(args.device)  # no CUDA raises here, not per frame
        return run_animation(args)
    # under torchrun every frame renders over the process group's ranks
    init_distributed(device=args.device)
    try:
        return run_animation(args)
    finally:
        shutdown_distributed()


def _parse_component(spec: str):
    """'sph_center:0,1' -> ('sph_center', (0, 1))."""
    field, _, idx = spec.partition(":")
    if not idx:
        raise SystemExit(f"--fd/--geom needs field:i[,j]; got {spec!r}")
    return field, tuple(int(i) for i in idx.split(","))


def _components(specs) -> dict:
    out: dict = {}
    for spec in specs:
        f, idx = _parse_component(spec)
        out.setdefault(f, []).append(idx)
    return out


def _load_target(args):
    """The target's mean radiance [H,W,3], row 0 the bottom scanline: an
    .npz's 'img', or a PNG (top-down, sqrt view gamma unless
    --target-linear)."""
    import numpy as np

    from rt_tpu_torch.io.image import read_png

    if args.target.endswith(".npz"):
        return np.load(args.target)["img"].astype(np.float32)
    u8 = read_png(args.target).astype(np.float32) / 255.0
    target = u8[::-1]  # PNG is top-down; render rows start at the bottom
    if not args.target_linear:
        target = target * target  # invert the sqrt view gamma
    return np.ascontiguousarray(target)


def cmd_fit(args) -> int:
    from rt_tpu_torch.config import resolve_device
    from rt_tpu_torch.parallel.distributed import shutdown_distributed

    mesh = _mesh(args) if args.sharded else None
    try:
        return _fit(args, mesh.device if mesh is not None
                    else resolve_device(args.device), mesh)
    finally:
        if mesh is not None:
            shutdown_distributed()


def _fit(args, dev, mesh) -> int:
    """fit on dev; with a mesh (--sharded) fit and fit_hybrid train over
    its ranks (fit_camera takes no mesh, as the reference's), and rank 0
    writes the outputs."""
    import os

    import numpy as np
    import torch

    from rt_tpu_torch.config import check_supported
    from rt_tpu_torch.diff import inverse
    from rt_tpu_torch.io.image import write_image
    from rt_tpu_torch.render import film
    from rt_tpu_torch.render.renderer import render
    from rt_tpu_torch.scene.parser import parse_scene
    from rt_tpu_torch.scene.types import build_tables

    target = _load_target(args)
    h, w = target.shape[:2]

    sdef, cfg = parse_scene(args.scene)
    sdef.width, sdef.height = w, h
    sdef.resize()  # re-derive the camera for the target's aspect
    cfg = cfg.replace(width=w, height=h, loop="while",
                      engine=args.engine or ("plain" if dev.type == "cpu"
                                             else "queue"))
    if args.nee:
        cfg = cfg.replace(nee=True)
    if args.gradient_sky:
        cfg = cfg.replace(background_mode="gradient")
    if args.max_depth:
        cfg = cfg.replace(max_depth=args.max_depth)
    check_supported(cfg)

    tables = build_tables(sdef)
    replay_fields = tuple(f for f in args.fields.split(",") if f)
    fd_params = _components(args.fd)
    geom_spec = _components(args.geom)
    if fd_params and geom_spec:
        raise SystemExit("--fd and --geom are mutually exclusive "
                         "(CRN-FD vs tangent-replay geometry)")
    npz = os.path.join(args.out, "recovered.npz")
    after_png = os.path.join(args.out, "after.png")
    spp_after = cfg.samples_per_pixel

    t0 = time.time()
    if args.camera:
        # camera-pose recovery: the scene's camera is the initial guess
        if fd_params or geom_spec:
            raise SystemExit("--camera is exclusive with --fd/--geom")
        p = sdef.camera_params
        init = {"lookfrom": p["lookfrom"], "lookat": p["lookat"],
                "vup": p["vup"], "vfov_deg": p["vfov"],
                "aperture": p["aperture"]}
        if "focus_dist" in p:
            init["focus_dist"] = p["focus_dist"]
        names = tuple(dict.fromkeys(args.camera))
        rec, hist = inverse.fit_camera(
            tables, cfg, target, init, recover=names, spp=args.spp,
            steps=args.steps, learning_rate=args.lr, device=dev)
        dt = time.time() - t0
        saved = {k: np.asarray(v) for k, v in rec.items()}
        sdef.set_camera(rec["lookfrom"], rec["lookat"], rec["vup"],
                        rec["vfov_deg"], rec["aperture"],
                        rec.get("focus_dist"))
        fitted = build_tables(sdef)
        shown = [(n, np.round(np.asarray(rec[n]), 5).tolist())
                 for n in names]
    else:
        if fd_params:
            rec, hist = inverse.fit_hybrid(
                tables, cfg, target, replay_fields=replay_fields,
                fd_params=fd_params, spp=args.spp, steps=args.steps,
                learning_rate=args.lr, eps=args.eps,
                bwd_depth=args.bwd_depth, device=dev, mesh=mesh)
        else:
            if args.method == "tape" and geom_spec:
                raise SystemExit(
                    "--geom is a replay-method option; with --method tape "
                    "list geometry tables directly in --fields (e.g. "
                    "--fields sph_center,mat_albedo)")
            rec, hist = inverse.fit(
                tables, cfg, target, fields=replay_fields, spp=args.spp,
                steps=args.steps, learning_rate=args.lr, method=args.method,
                geom_spec=geom_spec or None, bwd_depth=args.bwd_depth,
                device=dev, mesh=mesh)
        dt = time.time() - t0
        saved = rec
        fitted = inverse.apply_params(
            tables, {k: torch.from_numpy(np.asarray(v, np.float32))
                     for k, v in rec.items()})
        shown = []
        for f in sorted(rec):
            v = np.asarray(rec[f])
            shown.append((f, f"shape {v.shape}, first values "
                             f"{np.round(v.reshape(-1)[:6], 4).tolist()}"))
    if mesh is not None and mesh.rank != 0:
        return 0  # rank 0 writes recovered.npz, after.png and the log
    os.makedirs(args.out, exist_ok=True)
    np.savez_compressed(npz, **saved)
    after = render(fitted, cfg, device=dev) / spp_after
    write_image(after_png, film.finalize(after, 1, gamma=True))

    print(f"loss: {hist[0]:.6f} -> {hist[-1]:.7f} "
          f"({args.steps} steps, {dt:.1f}s, {dt / args.steps:.2f}s/step)")
    for name, val in shown:
        print(f"  {name}: {val}")
    print(f"wrote {npz} and {after_png}")
    return 0 if hist[-1] < hist[0] else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="rt_tpu_torch", description="PyTorch/CUDA port of rt_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    rp = sub.add_parser("render", help="render one frame")
    rp.add_argument("-f", "--scene", default=None,
                    help="scene JSON (the reference's schema); default: "
                         "the coded scene")
    rp.add_argument("--coded", default=None, choices=CODED,
                    help="built-in coded scene (default three_sphere)")
    rp.add_argument("-w", "--width", type=int, default=None)
    rp.add_argument("--height", type=int, default=None)
    rp.add_argument("-spp", "--spp", type=int, default=None)
    rp.add_argument("-d", "--max-depth", type=int, default=None)
    rp.add_argument("-o", "--output", default=None,
                    help="output path (.png or .ppm); default: the scene's "
                         "output_file, or main.png")
    rp.add_argument("--seed", type=int, default=0)
    rp.add_argument("--engine", default="queue",
                    choices=["queue", "mega", "pallas", "plain", "xla"],
                    help="queue (default): persistent ray-queue CUDA "
                         "kernel; mega: segmented CUDA megakernel; "
                         "pallas: hybrid wavefront with the CUDA sphere "
                         "closest-hit kernel; plain (xla, rt_tpu's name): "
                         "pure PyTorch")
    rp.add_argument("--compact-every", type=int, default=None,
                    help="mega: live-lane grouping every N bounces (-1 "
                         "auto, 0 off; default: the schedule 2,3,5,10 in "
                         "groups of 16 for depth >= 16, else off)")
    rp.add_argument("--cull", action="store_true", default=True,
                    help="chunk culling in the kernels: Morton-sorted "
                         "sphere and triangle chunks, each lane skipping "
                         "the chunks its ray misses (default on)")
    rp.add_argument("--no-cull", dest="cull", action="store_false")
    rp.add_argument("--sampler", default="rng", choices=("rng", "qmc"),
                    help="sample sequence: counter-based pseudo-random "
                         "(rng, the default) or Owen-scrambled Sobol' "
                         "(qmc: lower error at equal spp; on every engine)")
    rp.add_argument("--nee", action="store_true",
                    help="next-event estimation: area-sample one light per "
                         "lambertian bounce with a shadow ray (the "
                         "reference's opt-in extension; in the kernels "
                         "of queue and mega, for every light family)")
    rp.add_argument("--mis", action="store_true",
                    help="balance-heuristic multiple importance sampling "
                         "of NEE and the BSDF draw (implies --nee)")
    rp.add_argument("--nee-glossy", action="store_true",
                    help="extend NEE / MIS to fuzzy-metal bounces with "
                         "their fuzz-ball density (implies --nee)")
    rp.add_argument("--taichi-uv", action="store_true",
                    help="replicate the Taichi reference's swapped "
                         "triangle-UV barycentrics (hittable.py:57-60,233) "
                         "for pixel-comparable textured-mesh renders")
    rp.add_argument("--view-gamma", action="store_true",
                    help="apply sqrt gamma to PNG / JPEG output (the "
                         "reference's PNG writer does not; PPM always does)")
    rp.add_argument("--both-formats", action="store_true",
                    help="write both the .ppm and the .png of one render, "
                         "as the reference's jsonmain "
                         "(gpu-version/main.cu:510-517)")
    rp.add_argument("--progress", action="store_true",
                    help="print the tiles (or passes, rounds) done")
    rp.add_argument("--log", default="rt_tpu_torch-time.log",
                    help="append the render's RenderStats line here")
    rp.add_argument("--adaptive", action="store_true",
                    help="adaptive sampling: spend the spp budget on the "
                         "noisiest pixels (two-stage variance-driven "
                         "allocation, render/adaptive.py)")
    rp.add_argument("--checkpoint", default=None,
                    help="progressive checkpoint file (.npz); resumes "
                         "exactly if it exists")
    rp.add_argument("--checkpoint-every", type=int, default=32,
                    help="samples between checkpoint writes")
    rp.add_argument("--bvh", action="store_true",
                    help="build each family's BVH and walk it where the "
                         "engine intersects (plain, pallas)")
    rp.add_argument("--sharded", action="store_true",
                    help="render over the ranks of the process group "
                         "(torchrun's environment; a world of one "
                         "without it), each its slab of pixels")
    rp.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    rp.set_defaults(fn=cmd_render)

    pp = sub.add_parser("parse", help="parse a scene JSON and summarize")
    pp.add_argument("scene")
    pp.set_defaults(fn=cmd_parse)

    fp = sub.add_parser(
        "fit", help="inverse rendering: recover scene parameters from a "
                    "target image (the scene JSON is the initial guess)")
    fp.add_argument("-f", "--scene", required=True)
    fp.add_argument("--target", required=True,
                    help="target image: .png (sqrt view gamma unless "
                         "--target-linear) or .npz with 'img' = mean "
                         "radiance [H,W,3], row 0 = bottom; it sets the "
                         "resolution")
    fp.add_argument("--target-linear", action="store_true")
    fp.add_argument("--fields", default="tex_color",
                    help="comma-separated fields: radiometric ones "
                         "(tex_color, mat_albedo, tex_color2, background, "
                         "images: the image atlas) for the path replay; "
                         "with --method tape any "
                         "continuous table (sph_center, rect_k, cyl_radius, "
                         "tri_v1, ...)")
    fp.add_argument("--fd", action="append", default=[],
                    help="geometry component for CRN finite differences "
                         "(sees silhouettes), field:i[,j]; repeatable, "
                         "e.g. --fd sph_center:0,0 --fd sph_center:0,2")
    fp.add_argument("--camera", action="append", default=[],
                    choices=sorted(("lookfrom", "lookat", "vfov_deg",
                                    "aperture")),
                    help="recover this camera pose parameter by CRN finite "
                         "differences (repeatable; the scene's camera is "
                         "the initial guess); exclusive with --fd/--geom")
    fp.add_argument("--geom", action="append", default=[],
                    help="geometry component for the forward-mode tangent "
                         "replay, same syntax (e.g. --geom mat_ior:1)")
    fp.add_argument("--method", default="replay",
                    choices=["replay", "tape", "ad"],
                    help="gradient estimator: replay (path-replay "
                         "backward on the engine's adjoint kernel), tape "
                         "(winner tape: every continuous field in one "
                         "backward), ad (autograd through the plain "
                         "engine)")
    fp.add_argument("-spp", "--spp", type=int, default=4)
    fp.add_argument("--steps", type=int, default=60)
    fp.add_argument("--lr", type=float, default=3e-2)
    fp.add_argument("--eps", type=float, default=2e-2,
                    help="CRN finite-difference probe half-step")
    fp.add_argument("--bwd-depth", type=int, default=None,
                    help="truncate the replay backward at this bounce")
    fp.add_argument("-d", "--max-depth", type=int, default=None)
    fp.add_argument("--nee", action="store_true",
                    help="fit with next-event estimation on, in the "
                         "forward render and in the gradient (the adjoint "
                         "kernels and the winner tape replay the direct "
                         "term exactly)")
    fp.add_argument("--gradient-sky", action="store_true",
                    help="render with the gradient-sky background")
    fp.add_argument("--engine", default=None,
                    choices=["queue", "mega", "pallas", "plain", "xla"],
                    help="forward engine of the loss render; the replay's "
                         "backward runs on its adjoint kernel (queue: B6, "
                         "mega: B5). Default: queue on the card, whose "
                         "replay step is the faster one on the H100 "
                         "(0.0322 s against mega's 0.0422 s on the cover "
                         "scene at 1080p; the reference picks mega on the "
                         "TPU); plain with --device cpu")
    fp.add_argument("--sharded", action="store_true",
                    help="shard the pixel batch over the ranks of the "
                         "process group (torchrun's environment; a world of "
                         "one without it); gradients summed over ranks")
    fp.add_argument("--out", default="fit_out",
                    help="output directory (recovered.npz, after.png)")
    fp.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    fp.set_defaults(fn=cmd_fit)

    anp = sub.add_parser("animate", help="render a frame sequence "
                         "(blue.py / dna.py-style video synthesis)")
    anp.add_argument("--kind", choices=["blue", "dna", "points", "dolly"],
                     default="dna")
    anp.add_argument("--frames", type=int, default=3)
    anp.add_argument("--start", type=int, default=0)
    anp.add_argument("--num-hosts", type=int, default=1,
                     help="frame-farm size: partition the frame range "
                          "across hosts (blue.py's per-GPU split)")
    anp.add_argument("--host-index", type=int, default=0)
    anp.add_argument("--retries", type=int, default=1,
                     help="per-frame retry count (frames are idempotent)")
    anp.add_argument("--engine", default="queue",
                     choices=["queue", "mega", "pallas", "plain", "xla"])
    anp.add_argument("--deg-per-frame", type=float, default=1.0)
    anp.add_argument("--outdir", default="frames")
    anp.add_argument("-w", "--width", type=int, default=400)
    anp.add_argument("--height", type=int, default=225)
    anp.add_argument("-spp", "--spp", type=int, default=16)
    anp.add_argument("-d", "--max-depth", type=int, default=16)
    anp.add_argument("--scene", default=None,
                     help="base scene JSON to mutate per frame (blue mode)")
    anp.add_argument("--points-dir", default=None,
                     help="per-frame point cloud dir (points mode: frame i "
                          "reads {i+1}.txt)")
    anp.add_argument("--obj", default=None, help="OBJ mesh (points mode)")
    anp.add_argument("--texture", default=None,
                     help="PNG image texture for the mesh (points mode)")
    anp.add_argument("--taichi-uv", action="store_true",
                     help="swapped-weight triangle UVs "
                          "(taichi-version/hittable.py:57-60,233)")
    anp.add_argument("--farm", type=int, default=0,
                     help="one-command local process farm: spawn N "
                          "workers over the frame range and wait "
                          "(gpu-version/blue.py:24-35)")
    anp.add_argument("--farm-platform", default="inherit",
                     choices=["inherit", "cpu"],
                     help="device of the farmed workers: inherit (the "
                          "default) gives them --device, cpu runs them "
                          "with --device cpu")
    anp.add_argument("--format", default="png", choices=["png", "jpg"],
                     help="frame file format (jpg: the Taichi reference's "
                          "ti.imwrite frames, main.py:216)")
    anp.add_argument("--video", default=None,
                     help="assemble the frames into a video after "
                          "rendering (.mp4 through ffmpeg when it is on "
                          "PATH, else an MJPEG .avi; .gif)")
    anp.add_argument("--fps", type=int, default=30)
    anp.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    anp.set_defaults(fn=cmd_animate)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
