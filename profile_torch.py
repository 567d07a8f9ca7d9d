#!/usr/bin/env python3
"""Where one frame of the port's render spends its device time.

    python3 profile_torch.py [--width 1920] [--height 1080] [--spp 1]
                             [--depth 50] [--engine queue] [--top 25]

Renders cover_scene once untimed (build, warm-up), then once under
torch.profiler on one CUDA GPU, and prints: wall seconds, the summed
device time of all kernels and its share of the wall time (the rest is
the device waiting on the host), the ops and kernels by device time,
and one JSON line with the totals. Engines "queue" and "mega" render at
the bench.py shape's settings (one launch of up to 1<<25 rays, the
compaction schedule 2,3,5,10 in groups of 16). Needs a CUDA GPU;
imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--spp", type=int, default=1)
    ap.add_argument("--depth", type=int, default=50)
    ap.add_argument("--engine", default="queue",
                    choices=["queue", "mega", "pallas", "plain"])
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch: needs a CUDA GPU")

    from rt_tpu_torch.render.renderer import render
    from rt_tpu_torch.scene.builders import cover_scene
    from rt_tpu_torch.scene.types import build_tables

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip() or \
        torch.cuda.get_device_name(0)
    sdef, cfg = cover_scene(width=args.width, height=args.height,
                            spp=args.spp, max_depth=args.depth)
    if args.engine in ("queue", "mega"):
        cfg = cfg.replace(engine=args.engine, rays_per_batch=1 << 25,
                          compact_schedule=(2, 3, 5, 10), compact_group=16)
    else:
        cfg = cfg.replace(engine=args.engine, rays_per_batch=1 << 21)
    tables = build_tables(sdef, device="cuda")
    render(tables, cfg, device="cuda")  # build + warm-up
    torch.cuda.synchronize()

    stats = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        render(tables, cfg, device="cuda", stats=stats)
        torch.cuda.synchronize()
        wall = time.time() - t0
    rows = sorted(prof.key_averages(), key=_device_us, reverse=True)
    # kernels (device events) give the busy time; host ops (aten::*) get
    # the device time of the kernels they launched, for the table
    cuda = torch.autograd.DeviceType.CUDA
    device_us = sum(_device_us(e) for e in rows if e.device_type == cuda)
    ops = [e for e in rows if e.device_type != cuda and _device_us(e) > 0]
    kernels = [e for e in rows if e.device_type == cuda]
    print(f"{card}; cover_scene {args.width}x{args.height} spp {args.spp} "
          f"depth {args.depth} engine {args.engine}: wall {wall:.4f} s "
          f"under the profiler, counts {stats}, device busy "
          f"{device_us / 1e6:.4f} s = {device_us / 1e6 / wall:.1%} of wall")
    for title, table in (("op", ops), ("kernel", kernels)):
        print(f"{title:<48} {'device ms':>10} {'share':>7} {'calls':>7}")
        for e in table[:args.top]:
            us = _device_us(e)
            print(f"{e.key[:48]:<48} {us / 1e3:>10.3f} "
                  f"{us / device_us:>7.1%} {e.count:>7}")
    print(json.dumps({"card": card, "engine": args.engine, "wall_s": wall,
                      "device_busy_s": device_us / 1e6, **stats}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
