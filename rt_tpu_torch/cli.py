"""Command-line interface: `python -m rt_tpu_torch render`
(the port of rt_tpu/cli.py's render path, :27-235): a JSON scene of the
reference's schema (`-f scene.json`, as gpu-version/main.cu:454-460) or
a coded scene (`--coded`), with the -w / --height / -spp / -d overrides.

Output is chosen by extension: PNG (no gamma, as the reference's
write_image) or PPM (sqrt gamma, as write_color); without -o, the
scene's output_file (main.png for a coded scene). Runs on CUDA unless
--device cpu is given.
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
    print(f"wrote {out} ({cfg.width}x{cfg.height} @ {spp}spp, depth "
          f"{cfg.max_depth}, engine {cfg.engine} on {args.device}, "
          f"{dt:.2f}s, paths/s {cfg.width * cfg.height * spp / dt:.0f}; "
          f"{counts})")
    return 0


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
    rp.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    rp.set_defaults(fn=cmd_render)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
