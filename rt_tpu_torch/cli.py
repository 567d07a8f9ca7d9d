"""Command-line interface (the port of rt_tpu/cli.py):

  python -m rt_tpu_torch render   one frame (rt_tpu/cli.py:27-235) of a
      JSON scene of the reference's schema (`-f scene.json`, as
      gpu-version/main.cu:454-460) or a coded scene (`--coded`), with
      the -w / --height / -spp / -d overrides (image textures load
      relative to the scene's directory; --taichi-uv swaps the triangle
      UV weights as the Taichi reference does). Output is chosen by
      extension: PNG (no gamma, as the reference's write_image) or PPM
      (sqrt gamma, as write_color); without -o, the scene's output_file
      (main.png for a coded scene).
  python -m rt_tpu_torch fit      inverse rendering (rt_tpu/cli.py
      `cmd_fit` :265-410): recover scene parameters so the render of the
      JSON scene (the initial guess) matches a target image; writes
      recovered.npz and after.png to --out and exits 0 when the loss
      fell.

Both run on CUDA unless --device cpu is given.
"""

from __future__ import annotations

import argparse
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


def cmd_render(args) -> int:
    from rt_tpu_torch.config import resolve_device
    from rt_tpu_torch.io.image import write_image
    from rt_tpu_torch.render import film
    from rt_tpu_torch.render.renderer import render
    from rt_tpu_torch.scene.types import build_tables

    dev = resolve_device(args.device)
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
    tables = build_tables(sdef, device=dev)

    stats = {}
    t0 = time.time()
    img = render(tables, cfg, device=dev, stats=stats)
    neg = film.negative_pixels(img)  # waits for the device
    dt = time.time() - t0
    if neg:
        print(f"warning: {neg} pixels with negative radiance",
              file=sys.stderr)

    spp = cfg.samples_per_pixel
    if out.endswith(".ppm"):
        with open(out, "w") as f:
            f.write(film.to_ppm(img, spp))
    else:
        write_image(out, film.finalize(img, spp, gamma=False))
    counts = ", ".join(f"{k} {v}" for k, v in sorted(stats.items()))
    sampling = "".join(f", {k}" for k in ("nee", "mis", "nee_glossy")
                       if getattr(cfg, k))
    print(f"wrote {out} ({cfg.width}x{cfg.height} @ {spp}spp, depth "
          f"{cfg.max_depth}{sampling}, engine {cfg.engine} on {args.device}, "
          f"{dt:.2f}s, paths/s {cfg.width * cfg.height * spp / dt:.0f}; "
          f"{counts})")
    return 0


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
    import os

    import numpy as np
    import torch

    from rt_tpu_torch.config import check_supported, resolve_device
    from rt_tpu_torch.diff import inverse
    from rt_tpu_torch.io.image import write_image
    from rt_tpu_torch.render import film
    from rt_tpu_torch.render.renderer import render
    from rt_tpu_torch.scene.parser import parse_scene
    from rt_tpu_torch.scene.types import build_tables

    if args.sharded:
        raise NotImplementedError("fit --sharded: multi-device training is "
                                  "not ported yet (ROADMAP Queue A-9)")
    dev = resolve_device(args.device)
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
    os.makedirs(args.out, exist_ok=True)
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
        np.savez_compressed(npz, **{k: np.asarray(v) for k, v in rec.items()})
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
                bwd_depth=args.bwd_depth, device=dev)
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
                device=dev)
        dt = time.time() - t0
        np.savez_compressed(npz, **rec)
        fitted = inverse.apply_params(
            tables, {k: torch.from_numpy(np.asarray(v, np.float32))
                     for k, v in rec.items()})
        shown = []
        for f in sorted(rec):
            v = np.asarray(rec[f])
            shown.append((f, f"shape {v.shape}, first values "
                             f"{np.round(v.reshape(-1)[:6], 4).tolist()}"))
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
                    choices=["queue", "mega", "pallas", "plain"],
                    help="queue (default): persistent ray-queue CUDA "
                         "kernel; mega: segmented CUDA megakernel; "
                         "pallas: hybrid wavefront with the CUDA sphere "
                         "closest-hit kernel; plain: pure PyTorch")
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
    rp.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    rp.set_defaults(fn=cmd_render)

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
                    choices=["queue", "mega", "pallas", "plain"],
                    help="forward engine of the loss render; the replay's "
                         "backward runs on its adjoint kernel (queue: B6, "
                         "mega: B5). Default: queue on the card, whose "
                         "replay step is the faster one on the H100 "
                         "(0.0322 s against mega's 0.0422 s on the cover "
                         "scene at 1080p; the reference picks mega on the "
                         "TPU); plain with --device cpu")
    fp.add_argument("--sharded", action="store_true",
                    help="shard the pixel batch over devices (not ported "
                         "yet, ROADMAP Queue A-9: raises)")
    fp.add_argument("--out", default="fit_out",
                    help="output directory (recovered.npz, after.png)")
    fp.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    fp.set_defaults(fn=cmd_fit)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
