#!/usr/bin/env python3
"""Smoke run of the rt_tpu_torch port on one CUDA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ with nvcc (all at once), holds
each against its plain PyTorch version on the card, and drives each path
of the port at the bench shape, cover_scene at 1920x1080, depth 50:
the hybrid wavefront (engine "pallas", kernel B1, spp 2), the persistent
ray queue (engine "queue", kernel B3, spp 16, the main path) and the
megakernel (engine "mega", kernel B2, spp 16, the control row). It also
compares engines and kernels with their plain versions, at small sizes
and at the main path's shape of one trace call (2,073,600 lanes, depth
50, where B3's pool refills), and drives the CLI, whose default engine
is the queue. The training path follows: the adjoint kernels B5 (mega)
and B6 (queue) against their plain version at 192x108 and at the main
shape, the reference's training step (one loss.backward() of the
path-replay loss on cover_scene at 1920x1080, depth 50, spp 1, params
tex_color and mat_albedo) on both engines, three fit steps whose loss
must fall, and tables past the rows the kernels stage in shared memory
(ROADMAP C-7). The winner tape follows: the capture kernel B4 against
its plain version and the wavefront capture at 192x108 and at the main
shape (2,073,600 lanes, depth 50), the reference's all-fields tape step
at 1920x1080 (scripts/bench_tape_r3.py), the tape's radiometric
gradients against the path replay's, three fit(method="tape") steps,
and the geom_spec tangent replay on B4's tape. The regeneration path
closes it: the kernel B7 against its plain version at 192x108 (cover;
Cornell with an open lens at p_rr 0.9) and across segment schedules,
the frame of render(engine="mega", regen=True) at 1920x1080, spp 16,
depth 50 against the megakernel's frame of phase 10, and B7 against its
plain version on all 2,073,600 lanes. The primitive families follow:
B2, B3 and B7 against their plain versions bit for bit at 192x108 on a
scene of all four families and on scenes/demo_scene.json; the JSON
scene's main path, `python -m rt_tpu_torch render -f scenes/demo_scene.json` at
the scene's 960x540, spp 128, depth 40 (engine queue, kernel B3), with
its queue, mega and regen frames; and cover_scene(lights=True) at
1920x1080, depth 50, spp 16 and mesh_scene(scenes/plane441.obj) at
1920x1080, depth 16, spp 4 on the three engines, each with one B2 and
B3 trace call and one B7 call against the plain versions on every lane
and against their bounds. The training kernels on the families close it:
B4 (bit for bit), B5 and B6 against their plain versions at 192x108 on
the all-families scene and demo_scene.json; one B4, B5 and B6 call at
1920x1080 on cover_scene(lights=True) and mesh_scene against the plain
versions and their bounds; the training step on cover_scene(lights=True)
at the bench shape on both engines; the tape step with the rect and
cylinder fields there and with the triangle vertices on mesh_scene; and
this slice's main path, `python -m rt_tpu_torch fit -f
scenes/demo_scene.json` at its 960x540, depth 40, spp 4, for the replay
(B3 + B6), mega (B2 + B5), tape (B4), --fd and --camera estimators, each
of which must exit 0. Next-event estimation closes it (the kernels'
kNee instantiations): B2 and B3 with nee, nee + mis, nee + glossy and
all three, at p_rr 0 and 0.9, against their plain versions bit for bit
at 192x108 on a scene of all four light families and on
demo_scene.json, and B5 / B6 with nee against the plain adjoint (37);
cover_scene(lights=True) at the bench shape with nee and with mis on
queue and mega, each frame's mean against the frame without NEE, one
B2 / B3 trace call and one exact B5 / B6 call against their plain
versions and their bounds (38); this slice's main path, `render -f
scenes/demo_scene.json --nee` (and --mis, --mis --nee-glossy) at the
scene's 960x540, spp 128, depth 40 (39), and `fit ... --nee` with the
replay, mega and tape estimators, whose loss must fall (40). Image
textures close it (the kernels' kImages instantiations): B2 and B3 with
nee off, nee and mis at p_rr 0 and 0.9 against their plain versions bit
for bit at 192x108 on a scene whose four families and two lights sample
two images and on a copy of demo_scene.json with image textures on a
sphere and its light, B4 and B7 there, and B5 / B6 with the atlas
gradient against the plain adjoint (41); the reference's textured Taichi
scene, mesh_scene(plane441.obj) with a seeded 512x512 PNG and the Taichi
UV swap, at 1920x1080, depth 16, spp 4 on queue, mega and regen, one B2,
B3, B7, B4, B5 and B6 call against the plain versions and their bounds,
the training step with the atlas on both engines and the tape step with
it (42); cover_scene at the bench shape with its ground and its diffuse
hero sphere textured by two 1024x1024 images, on queue, mega and regen,
beside phase 10's frames, with one B2 / B3 call against the plain
versions (43); and `render -f` of the textured demo copy (with and
without --nee) and `fit ... --fields images` with the replay and the
tape, whose loss must fall (44). QMC and chunk culling follow (45-49:
the kernels against their plain versions under each, frames in four
settings, the runtime flags' A/B, with --parent also B1 on phase 3's
rays, B2 / B3 / B5 / B6 / B4 on four culled workloads, B7 on cover and
the mesh, the queue, mega, regen and hybrid frames, the mega replay step,
the tape step and `render -f` against another checkout in turns), and
the warp-cooperative hit of B2-B7 closes it (50): ties at 192x108 (B4
with p_rr 0 and 0.9) and one call on cover, cover_lights with nee, the
mesh and the textured mesh in the default build and scratch builds of
other kDenseMax values (phase 2 builds them; --dense-grid adds two),
against the plain versions, timed in turns, with the cover frame in each
build and the issued instructions per row from cuobjdump. Phase 2 also
holds the registers of B1-B7 to the parent's (and prints those of a
kernel a change redesigns, with its spills, beside the parent's); phase
3 holds B1 (one float4 row a
sphere, several rays a thread, the root only where disc >= 0) to the
parent's B1 lane for lane with --parent and counts its issued
instructions per pair. The render drivers close the run, each through
the CLI's entry point (rt_tpu_torch.cli.main, what `python -m
rt_tpu_torch` calls) with the launches counted: `animate --kind dna
--frames 4` at 1920x1080, spp 16, depth 50 with --video (queue, B3),
its frame 2 byte-equal to the synchronous render's PNG, one frame on
mega (B2), blue on scenes/demo_scene.json at 960x540, and --farm 2 at
192x108 byte-equal to a serial run (51); render_progressive on
demo_scene.json at 960x540, spp 128, depth 40, stopped at spp 64 and
resumed in one-sample passes, bit-equal to the one-shot render on queue
(B3) and held to it on mega regen (B7), `render --checkpoint` and the
regen passes of 8 then 16 within the rounding bound, and one B3 call at
sample base 64 bit-equal to its plain version (52); render_adaptive on
cover at 1920x1080, spp 16 (queue), its spend against the rule, its
frame mean against phase 10's, and its last round's lanes with their
per-lane starts on B3 and B2 bit-equal to their plain versions, then
`render -f demo_scene.json --adaptive` (53); `parse`, `render
--both-formats --view-gamma --log`, `animate --format jpg` and `render
--bvh` rendering (54). The BVH follows (55): on cover, plane441, dna and a seeded
131,072-triangle height field, the native and NumPy builds (their
seconds; equal arrays, or where centroids tie a valid NumPy tree that
walks to the same t), intersect(traversal="bvh") against the linear
scan on the 1920x1080 primary rays (the height field on 16,384 of them;
every lane whose hit or t differs grazes an edge in float64), frames at
1920x1080, spp 1, depth 8 on the plain engine (and the hybrid on cover)
with and without the BVH with the walks' host reads, and `render
--bvh` on scenes/demo_scene.json bit-equal to `render` on queue (B3),
the regen render of tables with BVHs bit-equal too (B7), the plain
engine within images_close. The example follows (56): every demo of
`python -m rt_tpu_torch.examples.inverse_render` at its own size (3
steps where it takes --steps; the albedo demo at its default 80, exit
0; position at 20 of its 60 steps), each one's loss falling, with its seconds per step and each
kernel's launches. Multi-process rendering and training
(rt_tpu_torch/parallel/) follow: a NCCL process group of one rank at
the bench shape, render_sharded_ex on queue (B3) and mega (B2)
bit-equal to render with their seconds and launches, and `torchrun
--nproc-per-node 1 -m rt_tpu_torch render --sharded` PNG-equal to
`render` (57); two ranks on the one card in a gloo group (`chip_smoke.py
--parallel-rank`), cover at 320x180, spp 4, depth 8: meshes (2, 1)
bit-equal and (1, 2) within 1e-5 of render on queue and mega, fit with
the replay on queue (B3 + B6) and on mega (B2 + B5) and the tape (B4)
for 3 steps over the mesh, held to the same fits in one process within
rtol 1e-5 / atol 1e-7 and equal bit for bit on the two ranks, and the
example's joint demo with --sharded at 320x180, exit 0 on both ranks,
and each rank's `render --sharded --checkpoint --checkpoint-every 1`
through the CLI's main, whose checkpoint rank 0 alone saves and whose
PNG equals the one-process checkpointed render's (58). The port's NumPy
oracle (rt_tpu_torch/render/oracle.py) follows (59): against the queue
(B3) and regen (B7) frames at 24x14, spp 4, depth 6 on three_sphere,
cover with the gradient sky and cover_lights with NEE (queue), by
images_close. What rt_tpu offers beside its engines closes the run
(61): on cover at 320x180, spp 2, depth 8 and (roulette 0.5) depth
16, where every lane dies before the last bounce, loop "scan" against
"while" on the hybrid (B1 once a bounce) and plain engines, bit for
bit, the scan running more bounces in the second; engine "xla"
(rt_tpu's default config carried over) against "plain", bit for bit;
the replay's loss at 96x54, roulette depth 16, with bwd_engine None /
plain / mega (B5) / queue (B6) and bwd_early_exit off and on, within
the adjoint tolerance of bwd_engine None's; B7 given the frame size against cfg's, bit for
bit. Each phase prints its
seconds; any failure raises and the script exits non-zero without its
result line. The last line of standard output is the JSON result
{"ok": true, "device": {...}}; the line before it lists each kernel with
its launches on its path, its error against the plain version, its time,
the plain version's time and its bound on this card (B2-B7 also on the
two family workloads).

Needs one CUDA GPU and nvcc; imports neither JAX nor the JAX package.
Writes only to rt_tpu_torch/_build/ (ignored by git) and temporary
directories that it removes.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import glob
import importlib.util
import io
import itertools
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
# another checkout of the port (--parent) whose B1-B3 and B5-B7 phase 48
# times beside this one's, in turns, and whose registers it compares
PARENT = None
DENSE_GRID_ON = False

# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_FP32_OPS = 67e12      # FP32 outside the tensor cores, op/s
PEAK_HBM_BYTES = 3.35e12   # HBM3, byte/s
# FP32 operations per (ray, sphere) pair in csrc/sphere_hit.cu's inner
# loop and bounce.cuh's hit loop, FMA counted as two and the sqrt as one
# (see the notes there)
SPHERE_OPS_PER_PAIR = 23
# of which the discriminant's (hb, c_term, disc), all B1 does for a pair
# whose disc < 0 (ops/intersect._sphere_t up to `disc`)
SPHERE_DISC_OPS = 17
# FP32 operations every ray-bounce of bounce.cuh does besides its hit
# loop: the ray's a, d.o, |o|^2 and 1/a. The shading after the hit loop
# depends on the material hit and is not counted, so the bound stays a
# lower bound of what this run's rays need.
SETUP_OPS = 16
# FP32 operations the adjoint adds to a ray-bounce that takes a
# cotangent, at the least: g * P per channel (a light, a miss); a
# scattering bounce does 9 (g * (L - C) / att) and a dielectric none, so
# the adjoints' bound counts none (a lower bound, and 0.1% of the hit
# loop at 488 rows)
ADJOINT_OPS = 0
# FP32 operations of one defocused camera ray (csrc/camera.cuh): s and t
# (2 adds, 2 divisions), the 4 draws' scalings, the lens disk (sqrt,
# 2pi * u2, cos, sin, 4 products: a transcendental or a sqrt counted as
# one), the offset (9), the origin (3) and the direction (18). The
# hash's integer operations are not counted, so this stays a lower bound.
CAMERA_OPS = 45

# FP32 operations per (lane, row) of each family's hit function in
# csrc/bounce.cuh (sphere, rect, cylinder, triangle), counted there
FAMILY_OPS = (SPHERE_OPS_PER_PAIR, 36, 62, 71)
# FP32 operations of a NEE shadow ray besides its rows (bounce.cuh
# shadow_any_hit: a, w.s, |s|^2, the max and 1/a); per row its any-hit
# test costs FAMILY_OPS
SHADOW_SETUP_OPS = 17
# FP32 operations of a texel-sampled hit's (u, v) per winner family
# (bounce.cuh winner_uv, atan2f / acosf counted as one each) and of its
# texel index (texel_of); its texel is one 32-byte sector of the atlas,
# and in the adjoints one atomic more
UV_OPS = (11, 14, 23, 53)
TEXEL_OPS = 10
TEXEL_BYTES = 32
# FP32 operations of one lane's test of one chunk box under culling
# (bounce.cuh box_visible); a shadow ray's box tests are left out of the
# bound, which stays a lower bound
BOX_OPS = 26

W, H, SPP, DEPTH = 1920, 1080, 2, 50     # rt_tpu bench.py:67-71 shape
MAIN_SPP = 16                            # bench.py's one-launch spp
SMALL_W, SMALL_H = 192, 108              # engine compare
CLI_W, CLI_H = 320, 180
LANES_1 = 65536                          # per-lane kernel compares
SMALL_POOL = 2048                        # B3 pool lanes of the refill check
TRAIN_BWD_DEPTH = 8      # the reference's production truncation
GRAD_FIELDS = ("tex_color", "tex_color2", "mat_albedo", "background",
               "images")
DEMO = os.path.join(ROOT, "scenes", "demo_scene.json")
MESH = os.path.join(ROOT, "scenes", "plane441.obj")


@contextlib.contextmanager
def phase(name: str):
    t0 = time.time()
    print(f"[{name}] ...", flush=True)
    yield
    print(f"[{name}] done in {time.time() - t0:.2f} s", flush=True)


def cuda_ms(fn, reps: int):
    """Mean device time of fn() over reps calls, after one warm-up, and
    the last call's result."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def images_close(a, b, spp, outlier_frac=0.01, atol=2e-3, outlier_atol=0.5):
    """The outlier-tolerant image compare of the reference's tests: paths
    agree except where an ulp flips a discrete decision, so a small
    fraction of pixels may differ; all else is bounded tightly."""
    am = np.asarray(a, np.float64) / spp
    bm = np.asarray(b, np.float64) / spp
    diff = np.abs(am - bm).max(axis=-1)
    frac_bad = float((diff > atol).mean())
    if frac_bad > outlier_frac or diff.max() > outlier_atol:
        raise AssertionError(
            f"images differ: {frac_bad:.2%} pixels beyond {atol} "
            f"(allowed {outlier_frac:.0%}), max {diff.max():.4g} "
            f"(allowed {outlier_atol})")
    return frac_bad, float(diff.max())


def compare_hits(t_k, pid_k, t_p, pid_p, t_64, label):
    """Kernel vs plain version on the same rays. Tolerance: hit masks and
    pids agree on >= 99.9% of rays, and t agrees within rtol 2e-4 /
    atol 1e-4 (tests/test_pallas.py) on >= 99.9% of the lanes where both
    hit. The outliers are lanes where float32 is ill-conditioned (grazing
    the radius-1000 ground sphere, origins near a surface): FMA on the
    card and unfused float32 on the host round differently there, as the
    reference's own Pallas/XLA pair does (ROADMAP C-5). t_64 is the plain
    version in float64: each float32 answer's distance from it is shown."""
    hk, hp = torch.isfinite(t_k), torch.isfinite(t_p)
    mask_agree = (hk == hp).float().mean().item()
    pid_agree = (pid_k == pid_p).float().mean().item()
    both = hk & hp
    err = (t_k - t_p).abs()
    out = both & (err > 1e-4 + 2e-4 * t_p.abs())
    t_agree = 1.0 - out.sum().item() / max(int(both.sum()), 1)
    max_err = float(err[both].max()) if bool(both.any()) else 0.0

    def off64(t):
        h = torch.isfinite(t) & torch.isfinite(t_64)
        d = (t.double() - t_64).abs()
        return int((h & (d > 1e-4 + 2e-4 * t_64.abs())).sum())

    print(f"  {label}: {t_k.numel()} rays, hit-mask agree {mask_agree:.6f}, "
          f"pid agree {pid_agree:.6f}, t agree {t_agree:.6f} "
          f"({int(out.sum())} lanes outside tolerance, max abs err "
          f"{max_err:.4g}); outside tolerance of float64: kernel "
          f"{off64(t_k)}, plain {off64(t_p)}", flush=True)
    for i in torch.nonzero(out | (pid_k != pid_p))[:8, 0].tolist():
        print(f"    lane {i}: t kernel {t_k[i].item():.7g} plain "
              f"{t_p[i].item():.7g} f64 {t_64[i].item():.7g}; pid "
              f"{pid_k[i].item()} {pid_p[i].item()}", flush=True)
    if mask_agree < 0.999 or pid_agree < 0.999 or t_agree < 0.999:
        raise AssertionError(f"{label}: kernel disagrees with plain version")
    return max_err


def lanes_close(k, p, label, frac=0.999):
    """Kernel vs plain version per lane: >= 99.9% of lanes within atol
    1e-4 / rtol 2e-4 on every channel. The outliers are lanes where an
    ulp of FMA contraction on the card flips a discrete decision (a
    grazing hit, ROADMAP C-4 / C-5). Returns the max abs difference."""
    err = (k - p).abs()
    ok = (err <= 1e-4 + 2e-4 * p.abs()).all(-1)
    share = ok.float().mean().item()
    same = (k == p).all(-1).float().mean().item()
    mx = err.max().item()
    print(f"  {label}: {k.shape[0]} lanes, {share:.6f} within tolerance, "
          f"{same:.6f} bit-equal, max abs err {mx:.4g}", flush=True)
    if share < frac:
        raise AssertionError(f"{label}: kernel disagrees with plain version")
    return mx


def frame(tables, cfg, w, h, trace_fn, generate_rays):
    """The radiance sum [h, w, 3] of cfg.samples_per_pixel samples, every
    sample's camera rays traced by trace_fn (scanline order)."""
    dev = tables.sph_center.device
    px = torch.arange(w * h, device=dev)
    acc = torch.zeros((w * h, 3), dtype=torch.float32, device=dev)
    for s in range(cfg.samples_per_pixel):
        ro, rd = generate_rays(tables.camera, w, h, px % w, px // w, s,
                               cfg.seed, cfg.enable_defocus)
        acc += trace_fn(tables, cfg, ro, rd, px, s, cfg.seed)
    return acc.reshape(h, w, 3).cpu().numpy()


def grads_close(want, got, label):
    """An adjoint kernel's gradients against the plain version's, per
    field: |a - b| <= 1e-5 + 1e-3 max|a| (the reference's tolerance
    between its replay and its kernels, tests/test_diff.py:567, 886).
    Every lane's cotangent is the plain version's bits, but float
    atomics sum in an order that changes from run to run. Returns the
    max abs difference over the fields."""
    worst, ratio = 0.0, 0.0
    for k in GRAD_FIELDS:
        a, b = want[k].double(), got[k].double()
        if a.shape != b.shape:
            raise AssertionError(f"{label} {k}: shape {tuple(b.shape)}, "
                                 f"want {tuple(a.shape)}")
        mag = max(float(a.abs().max()), 1e-12)
        err = float((a - b).abs().max())
        worst = max(worst, err)
        ratio = max(ratio, err / (1e-5 + 1e-3 * mag))
        if not err <= 1e-5 + 1e-3 * mag:
            raise AssertionError(f"{label} {k}: max abs err {err:.4g} "
                                 f"against max |g| {mag:.4g}")
    print(f"  {label}: max abs err {worst:.4g}, {ratio:.4f} of the "
          "tolerance", flush=True)
    return worst


def capture_mismatch(kernel, plain, label):
    """B4 against its plain version, each a (codes, death) pair: equal on
    every lane and bounce, or raise. Returns the count of codes that
    differ on lanes alive entering their bounce."""
    (kc, kd), (pc, pd) = kernel, plain
    live = torch.arange(pc.shape[0], device=pc.device)[:, None] \
        <= pd[None, :]
    bad_live = int(((kc != pc) & live).sum())
    bad_all = int((kc != pc).sum())
    bad_death = int((kd != pd).sum())
    print(f"  {label}: {pc.shape[1]} lanes x {pc.shape[0]} bounces, "
          f"{int(live.sum())} live codes; codes differing {bad_all} "
          f"({bad_live} live), death counts differing {bad_death}",
          flush=True)
    if bad_all or bad_death:
        raise AssertionError(f"{label}: B4 disagrees with its plain version")
    return bad_live


def open_lens(sdef, aperture=0.2):
    """The Cornell scene's camera with an open lens (its own has none),
    so the regeneration kernel draws the defocus disk there too."""
    p = sdef.camera_params
    sdef.set_camera(p["lookfrom"], p["lookat"], p["vup"], p["vfov"],
                    aperture, focus_dist=5.0)
    return sdef


def regen_segment(tb, cb, pixel, spp, seg_iters, plain, sample_base=0,
                  seed=0):
    """One init segment of B7 (or, with plain, of its plain version) over
    the pixel ids `pixel` of cb's frame: (state, samp, bvec, depth)."""
    from rt_tpu_torch.ops import cuda_mega, mega_plain, mega_tables

    dev = pixel.device
    b = pixel.shape[0]
    pix = pixel.to(torch.int32)
    state = torch.zeros((13, b), device=dev)
    samp, bvec, depth = (torch.zeros(b, dtype=torch.int32, device=dev)
                         for _ in range(3))
    fn = mega_plain.regen_plain if plain else cuda_mega.mega_regen
    ms = mega_tables.scene_for(tb, cb)
    fn(ms.table, ms.cam, state, pix, pix // cb.width, samp, bvec,
       sample_base, seed, seg_iters, max_depth=cb.max_depth, spp=spp,
       init=True, width=cb.width, height=cb.height,
       defocus=cb.enable_defocus,
       exhaust_bg=cb.exhaust_mode == "background", depth=depth,
       **mega_plain.trace_options(tb, cb))
    return state, samp, bvec, depth


def regen_mismatch(kernel, plain, label):
    """B7 against its plain version, each regen_segment's (state, samp,
    bvec, depth): equal on every lane, or raise. Returns the max abs
    radiance difference (0)."""
    names = ("state", "samp", "bvec", "bounces")
    bad = {n: int((a != b).reshape(-1, a.shape[-1]).any(0).sum())
           for n, a, b in zip(names, kernel, plain)}
    err = float((kernel[0][9:12] - plain[0][9:12]).abs().max())
    done = float((kernel[0][12] == 0.0).float().mean())
    print(f"  {label}: {kernel[1].shape[0]} lanes, {int(kernel[3].sum())} "
          f"ray-bounces, {done:.6f} of lanes finished; lanes differing "
          f"{bad}, max abs radiance err {err:.4g}", flush=True)
    if any(bad.values()):
        raise AssertionError(f"{label}: B7 disagrees with its plain version")
    return err


def lane_occupancy(*launches, warp=32):
    """The share of the warps' lane-iterations that trace a bounce, from
    each launch's per-lane bounce counts [B] in launch order: the sum of
    the lanes' bounces over 32 x the slowest lane's, summed over the
    warps of all launches (a warp runs until its slowest lane is done;
    iterations that only retire or restart a lane are not counted)."""
    num = den = 0.0
    for bounces in launches:
        b = bounces.shape[0] // warp * warp
        w = bounces[:b].view(-1, warp).double()
        num += float(w.sum())
        den += float((warp * w.max(-1).values).sum())
    return num / den


def disc_pairs(centers, radii, live, ro, rd, chunk=1 << 15):
    """The (ray, live sphere) pairs whose discriminant is >= 0: those for
    which B1 computes the roots (the plain version's expressions up to
    disc, ops/intersect._sphere_t)."""
    cx, cy, cz = (centers[None, :, k] for k in range(3))
    c2r = ((centers * centers).sum(-1) - radii * radii)[None, :]
    n = 0
    for s in range(0, ro.shape[0], chunk):
        o, d = ro[s:s + chunk], rd[s:s + chunk]
        a = (d * d).sum(-1)[:, None]
        hb = (d * o).sum(-1)[:, None] - (d[:, 0:1] * cx + d[:, 1:2] * cy
                                         + d[:, 2:3] * cz)
        c_term = ((o * o).sum(-1)[:, None]
                  - 2.0 * (o[:, 0:1] * cx + o[:, 1:2] * cy + o[:, 2:3] * cz)
                  + c2r)
        n += int(((hb * hb - a * c_term >= 0.0) & live[None, :]).sum())
    return n


def b1_hits(root, path):
    """B1 of the package imported from root (another checkout) on the
    sphere table and rays that phase 3 saved to `path`; writes its t and
    pid to path + ".out"."""
    sys.path.insert(0, root)
    from rt_tpu_torch.ops import cuda_intersect

    dev = torch.device("cuda")
    d = torch.load(path)
    t, pid = cuda_intersect.sphere_closest_hit(
        *(d[k].to(dev) for k in ("centers", "radii", "live", "ro", "rd")))
    torch.save({"t": t.cpu(), "pid": pid.cpu()}, path + ".out")
    return 0


def hit_ops(tables):
    """FP32 operations of one ray-bounce's hit loop over the scene's live
    rows of every family, plus the ray setup (the shading is left out,
    so the bound stays a lower bound)."""
    return sum(o * n for o, n in zip(FAMILY_OPS, tables.counts)) + SETUP_OPS


def table_bytes(tables):
    """Bytes of the packed tables the kernels read (each read once)."""
    ms = tables.mega
    tabs = [ms.table] + (list(ms.fam) if ms.fam is not None else [])
    return sum(t.numel() * 4 for t in tabs)


def bound_of(ops, nbytes):
    """(ms, "operations" or "bytes"): the least time for ops FP32
    operations and nbytes bytes on this card."""
    o, b = ops / PEAK_FP32_OPS, nbytes / PEAK_HBM_BYTES
    return max(o, b) * 1e3, ("operations" if o >= b else "bytes")


def all_families_scene(w, h, spp, depth):
    """Every primitive family with solid and checker textures, an
    emissive rect and all three rect orientations (the scene of
    tests/test_torch_families.py): (SceneDef, RenderConfig)."""
    from rt_tpu_torch.config import RenderConfig
    from rt_tpu_torch.scene.types import SceneDef

    s = SceneDef(width=w, height=h, samples_per_pixel=spp, max_depth=depth,
                 background=(0.2, 0.25, 0.3))
    s.add_sphere((0, 0, -2), 0.5, s.add_lambertian_color((0.5, 0.4, 0.3)))
    s.add_sphere((0, -100.5, -2), 100,
                 s.add_lambertian(
                     s.add_checker((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))))
    s.add_sphere((-1.1, 0, -2), 0.5, s.add_dielectric(1.5))
    s.add_rect("xz_rect", -1, 1, -3, -1, 2.0,
               s.add_diffuse_light_color((3.0, 2.8, 2.5)))
    s.add_rect("xy_rect", -2, 2, -1, 2, -3.5,
               s.add_lambertian(s.add_checker((0.8, 0.1, 0.1),
                                              (0.1, 0.1, 0.8))))
    s.add_rect("yz_rect", -1, 1, -3, -1, 1.8,
               s.add_metal((0.8, 0.8, 0.9), 0.2))
    s.add_cylinder(0.25, -0.3, 0.3, s.add_metal((0.9, 0.7, 0.4), 0.1))
    s.add_cylinder(0.2, -0.5, 0.5, s.add_dielectric(1.4),
                   rotate=((1, 0, 0), 90.0), translate=(0.9, -0.2, -1.6))
    tri_mat = s.add_lambertian_color((0.8, 0.2, 0.2))
    s.add_triangle((0.4, -0.5, -1.2), (0.9, -0.5, -1.4), (0.6, 0.2, -1.3),
                   tri_mat, uv1=(0, 0), uv2=(1, 0), uv3=(0, 1))
    s.add_triangle((-0.9, -0.4, -1.0), (-0.3, -0.45, -1.1),
                   (-0.6, 0.3, -0.9), tri_mat)
    s.set_camera((0, 0.3, 1.2), (0, 0, -2), (0, 1, 0), 55, 0.0)
    return s, RenderConfig(width=w, height=h, samples_per_pixel=spp,
                           max_depth=depth)


def light_scene(w, h, spp, depth):
    """The four light families of tests/test_nee.py's `_light_scene` (a
    sphere, an xz_rect, a cylinder and a triangle light over a lambertian
    sphere on a lambertian ground), the sphere light checker-textured,
    plus a fuzzy metal sphere for the glossy light sampler and a glass
    sphere (tests/test_torch_nee.py's scene): (SceneDef, RenderConfig)."""
    from rt_tpu_torch.config import RenderConfig
    from rt_tpu_torch.scene.types import SceneDef

    s = SceneDef(width=w, height=h, samples_per_pixel=spp, max_depth=depth,
                 background=(0.0, 0.0, 0.0))
    s.add_sphere((0, 0, -2), 0.5, s.add_lambertian_color((0.6, 0.4, 0.3)))
    s.add_sphere((0, -100.5, -2), 100,
                 s.add_lambertian_color((0.5, 0.5, 0.55)))
    s.add_sphere((1.6, 0.4, -1.4), 0.25, s.add_diffuse_light(
        s.add_checker((8.0, 3.0, 3.0), (3.0, 8.0, 3.0))))
    s.add_rect("xz_rect", -0.8, 0.8, -2.8, -1.2, 2.0,
               s.add_diffuse_light_color((6.0, 5.5, 5.0)))
    s.add_cylinder(0.2, -0.3, 0.3, s.add_diffuse_light_color((2.0, 4.0, 8.0)),
                   rotate=((1, 0, 0), 90.0), translate=(-1.5, 0.6, -2.0))
    s.add_triangle((-2.2, 0.1, -2.6), (-1.4, 0.1, -3.0), (-1.8, 1.0, -2.8),
                   s.add_diffuse_light_color((7.0, 2.0, 6.0)))
    s.add_sphere((-0.9, -0.2, -1.5), 0.3, s.add_metal((0.8, 0.8, 0.7), 0.3))
    s.add_sphere((0.9, -0.25, -1.4), 0.25, s.add_dielectric(1.5))
    s.set_camera((0, 0.4, 1.2), (0, 0, -2), (0, 1, 0), 55, 0.0)
    return s, RenderConfig(width=w, height=h, samples_per_pixel=spp,
                           max_depth=depth)


NEE_FLAGS = {"nee": dict(nee=True), "nee+mis": dict(nee=True, mis=True),
             "nee+glossy": dict(nee=True, nee_glossy=True),
             "nee+mis+glossy": dict(nee=True, mis=True, nee_glossy=True)}


def demo_scene(w=None, h=None, spp=None):
    """scenes/demo_scene.json at its own settings, or resized."""
    from rt_tpu_torch.scene.parser import parse_scene

    sdef, cfg = parse_scene(DEMO)
    if w:
        sdef.resize(w, h)
        cfg = cfg.replace(width=w, height=h)
    if spp:
        cfg = cfg.replace(samples_per_pixel=spp)
    return sdef, cfg


def seeded_png(path, size, seed):
    """A size x size RGB PNG of seeded noise over a smooth gradient,
    written by the port's writer: the image of a texture."""
    from rt_tpu_torch.io.image import write_png

    rs = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    base = np.stack([xx, yy, 1.0 - 0.5 * (xx + yy)], -1)
    img = 0.7 * base + 0.3 * rs.random((size, size, 3))
    write_png(path, (img * 255).astype(np.uint8))
    return path


def image_families_scene(w, h, spp, depth, a, b):
    """The four families and two lights sampling the images a and b
    ([H,W,3] float arrays): a sphere, both rect orientations, a cylinder
    and a triangle, an image-textured sphere light and triangle light,
    beside a checker ground, a fuzzy metal and a glass sphere (the scene
    of tests/test_torch_images.py): (SceneDef, RenderConfig)."""
    from rt_tpu_torch.config import RenderConfig
    from rt_tpu_torch.scene.types import SceneDef

    s = SceneDef(width=w, height=h, samples_per_pixel=spp, max_depth=depth,
                 background=(0.2, 0.25, 0.3))
    ta, tb = s.add_image_texture(a), s.add_image_texture(b)
    ma, mb = s.add_lambertian(ta), s.add_lambertian(tb)
    s.add_sphere((0, 0, -2), 0.5, ma)
    s.add_sphere((0, -100.5, -2), 100, s.add_lambertian(
        s.add_checker((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))))
    s.add_rect("xy_rect", -2, 2, -1, 2, -3.5, mb)
    s.add_rect("yz_rect", -1, 1, -3, -1, 1.8, ma)
    s.add_cylinder(0.25, -0.3, 0.3, mb, rotate=((1, 0, 0), 90.0),
                   translate=(0.9, -0.2, -1.6))
    s.add_triangle((0.4, -0.5, -1.2), (0.9, -0.5, -1.4), (0.6, 0.2, -1.3),
                   ma, uv1=(0, 0), uv2=(1, 0), uv3=(0, 1))
    s.add_sphere((-0.9, -0.2, -1.5), 0.3, s.add_metal((0.8, 0.8, 0.7), 0.3))
    s.add_sphere((-0.4, -0.3, -1.2), 0.2, s.add_dielectric(1.5))
    s.add_sphere((1.6, 0.4, -1.4), 0.25, s.add_diffuse_light(tb))
    s.add_triangle((-2.2, 0.1, -2.6), (-1.4, 0.1, -3.0), (-1.8, 1.0, -2.8),
                   s.add_diffuse_light(ta), uv1=(0.1, 0.2), uv2=(0.9, 0.1),
                   uv3=(0.5, 0.8))
    s.set_camera((0, 0.3, 1.2), (0, 0, -2), (0, 1, 0), 55, 0.0)
    return s, RenderConfig(width=w, height=h, samples_per_pixel=spp,
                           max_depth=depth)


def textured_demo_json(dirname, sphere_png, light_png):
    """A copy of scenes/demo_scene.json in dirname whose blue lambertian
    sphere and xz_rect light sample the images sphere_png and light_png
    (file names in dirname): its path."""
    data = json.loads(open(DEMO).read())
    tex = data["texture"]["data"]
    tex += [{"type": "image", "file": sphere_png},
            {"type": "image", "file": light_png}]
    data["material"]["data"][1]["texture"] = len(tex) - 2
    data["material"]["data"][4]["texture"] = len(tex) - 1
    path = os.path.join(dirname, "textured_demo.json")
    with open(path, "w") as f:
        json.dump(data, f)
    return path


def texel_terms(calls=1):
    """(FP32 operations, bytes, hits) of one call's texel-sampled hits,
    from what the plain version counted over `calls` equal calls since its
    counter was reset (mega_plain.winner_uv.texels): each hit's (u, v)
    and texel index, and its 32-byte sector of the atlas."""
    from rt_tpu_torch.ops import mega_plain

    hits = [n // calls for n in mega_plain.winner_uv.texels]
    ops = sum(n * (o + TEXEL_OPS) for n, o in zip(hits, UV_OPS))
    return ops, sum(hits) * TEXEL_BYTES, sum(hits)


def reset_plain_counts():
    """Zero what the plain versions count for a bound: texel-sampled
    hits, the closest-hit rows and chunk boxes the lanes tested, the
    shadow rays and their rows."""
    from rt_tpu_torch.ops import mega_plain

    mega_plain.winner_uv.texels = [0, 0, 0, 0]
    mega_plain.closest_hit.rows = [0, 0, 0, 0]
    mega_plain.closest_hit.boxes = 0
    mega_plain.closest_hit.need = [[0] * (mega_plain.WARP + 1)
                                   for _ in range(4)]
    mega_plain.shadow_occluded.rays = 0
    mega_plain.shadow_occluded.rows = [0, 0, 0, 0]


def hit_terms(bounces, calls=1):
    """FP32 operations of `bounces` ray-bounces' hit loops over the rows
    the lanes tested, from what the plain version counted over `calls`
    equal calls since reset_plain_counts (mega_plain.closest_hit: the
    kernels take the same per-lane chunk decisions): each (lane, row)
    pair at its family's FAMILY_OPS, each chunk box at BOX_OPS, and the
    ray setup. Without culling it is bounces x hit_ops(tables)."""
    from rt_tpu_torch.ops import mega_plain

    rows = [n // calls for n in mega_plain.closest_hit.rows]
    return (sum(o * n for o, n in zip(FAMILY_OPS, rows))
            + BOX_OPS * (mega_plain.closest_hit.boxes // calls)
            + SETUP_OPS * bounces)


def rows_tested(calls=1):
    """The (lane, row) pairs of one call's hit loops, per family."""
    from rt_tpu_torch.ops import mega_plain

    return [n // calls for n in mega_plain.closest_hit.rows]


def counters():
    from rt_tpu_torch.ops import cuda_intersect, cuda_mega, cuda_queue

    return {"sphere_closest_hit": cuda_intersect.sphere_closest_hit,
            "mega_segment": cuda_mega.mega_segment,
            "queue_launch": cuda_queue.queue_launch,
            "mega_adjoint_segment": cuda_mega.mega_adjoint_segment,
            "queue_adjoint_launch": cuda_queue.queue_adjoint_launch,
            "mega_capture": cuda_mega.mega_capture,
            "mega_regen": cuda_mega.mega_regen}


KERNELS = ["sphere_hit", "mega", "queue", "mega_adjoint", "queue_adjoint",
           "capture", "regen"]
# kDenseMax of the scratch builds (bounce.cuh warp_hit; phase 50):
# the per-lane schedule and always dense; --dense-grid adds the grid's
# other values. The default build's value is bounce.cuh's RTT_DENSE_MAX.
DENSE_BUILDS = [0, 32]
DENSE_GRID = (8, 24)
# the libraries built again in each scratch build of kDenseMax: the
# kernels of the warp-cooperative hit, B2-B7
DENSE_LIBS = ("mega", "queue", "queue_adjoint", "mega_adjoint", "regen",
              "capture")
# phase 2 holds the ptxas registers of HELD_LIBS (B1-B7), per
# instantiation, to the parent's build (--parent) or to PARENT_REGS, and
# prints those of MOVED_LIBS (a kernel a change redesigns; none now)
# beside the parent's.
# PARENT_REGS: the parent's registers on the card's toolkit (CUDA 12.8,
# from a --parent run's printout), per library its kernel and "bool
# template arguments:registers" of each instantiation
HELD_LIBS = ("queue", "queue_adjoint", "mega", "sphere_hit", "mega_adjoint",
             "regen", "capture")
MOVED_LIBS = ()
PARENT_REGS = {
    "capture": ("capture_kernel", """
        000:48 001:48 010:63 011:61 100:40 101:40 110:63 111:61
        """),
    "mega": ("mega_kernel", """
        00000:48 00001:48 00010:48 00011:48 00100:64 00101:64 00110:64
        00111:64 01000:64 01001:64 01010:64 01011:64 01100:64 01101:75
        01110:64 01111:64 10000:48 10001:48 10010:48 10011:48 10100:64
        10101:64 10110:64 10111:64 11000:64 11001:64 11010:64 11011:64
        11100:64 11101:64 11110:64 11111:64
        """),
    "mega_adjoint": ("mega_adjoint_kernel", """
        00000:62 00001:48 00010:64 00011:60 00100:80 00101:80 00110:80
        00111:80 01000:64 01001:64 01010:64 01011:64 01100:80 01101:80
        01110:80 01111:80 10000:62 10001:64 10010:64 10011:60 10100:64
        10101:80 10110:80 10111:80 11000:64 11001:64 11010:64 11011:64
        11100:80 11101:80 11110:80 11111:80
        """),
    "queue": ("queue_kernel", """
        00000:56 00001:57 00010:60 00011:60 00100:64 00101:64 00110:75
        00111:74 01000:64 01001:64 01010:64 01011:64 01100:77 01101:77
        01110:77 01111:77 10000:56 10001:59 10010:60 10011:60 10100:64
        10101:64 10110:64 10111:64 11000:64 11001:64 11010:64 11011:64
        11100:77 11101:79 11110:77 11111:77
        """),
    "queue_adjoint": ("queue_adjoint_kernel", """
        00000:64 00001:64 00010:64 00011:64 00100:80 00101:78 00110:80
        00111:80 01000:79 01001:78 01010:76 01011:76 01100:89 01101:89
        01110:95 01111:94 10000:64 10001:64 10010:64 10011:64 10100:78
        10101:78 10110:80 10111:80 11000:78 11001:77 11010:77 11011:77
        11100:89 11101:93 11110:95 11111:94
        """),
    "regen": ("regen_kernel", """
        0000:53 0001:59 0010:58 0011:62 0100:64 0101:64 0110:64 0111:64
        1000:56 1001:62 1010:48 1011:62 1100:64 1101:64 1110:64 1111:64
        """),
    "sphere_hit": ("sphere_hit_kernel", """
        :64
        """),
}


def parent_regs():
    """PARENT_REGS as {"library:kernel<bits>": registers}."""
    out = {}
    for lib, (kernel, table) in PARENT_REGS.items():
        for item in table.split():
            bits, regs = item.split(":")
            out[f"{lib}:{kernel}<{bits}>"] = int(regs)
    return out


def dense_defines(dense_max):
    """The nvcc defines of a scratch build with kDenseMax."""
    return (f"RTT_DENSE_MAX={dense_max}",)


def default_dense_max():
    """kDenseMax of the default build, from csrc/bounce.cuh."""
    with open(os.path.join(ROOT, "rt_tpu_torch", "csrc", "bounce.cuh")) as f:
        return int(re.search(r"#define RTT_DENSE_MAX (\d+)", f.read())
                   .group(1))


def build_all(extra=()):
    """Build every kernel library of the tree that rt_tpu_torch is imported
    from, and the scratch builds `extra` ((name, defines) pairs), one nvcc
    per library, all started together: the library paths, KERNELS' then
    extra's."""
    from rt_tpu_torch.ops import cuda_build

    jobs = [(k, ()) for k in KERNELS] + list(extra)
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
        return list(ex.map(
            lambda j: cuda_build.build(j[0], *([j[1]] if j[1] else [])),
            jobs))


@contextlib.contextmanager
def dense_schedule(dense_max):
    """Inside, B2-B7 run from the scratch libraries built with
    -DRTT_DENSE_MAX=dense_max (None: the default build): the
    wrappers' library loaders and the grids they cached are swapped, so
    no option reaches the port's entry points."""
    from rt_tpu_torch.ops import cuda_mega, cuda_queue

    loaders = ((cuda_queue, "_library"), (cuda_queue, "_adjoint_library"),
               (cuda_mega, "_library"), (cuda_mega, "_adjoint_library"),
               (cuda_mega, "_regen_library"),
               (cuda_mega, "_capture_library"))
    saved = [getattr(mod, name) for mod, name in loaders]

    def clear():
        cuda_queue._grid_blocks.cache_clear()
        cuda_queue._adjoint_grid_blocks.cache_clear()

    if dense_max is not None:
        for (mod, name), load in zip(loaders, saved):
            lib = load(dense_defines(dense_max))
            setattr(mod, name, lambda lib=lib: lib)
        clear()
    try:
        yield
    finally:
        for (mod, name), load in zip(loaders, saved):
            setattr(mod, name, load)
        clear()


def kernel_key(fn):
    """"kernel<bits>" of a mangled kernel name: its name without the
    anonymous namespace (whose hash follows the source's path) and its
    bool template arguments, 0 / 1 in order."""
    m = re.search(r"([a-z_]+_kernel)(?:I((?:Lb[01]E)+)E)?", fn)
    return f"{m.group(1)}<{''.join(re.findall('[01]', m.group(2) or ''))}>"


def registers_of(lib):
    """{"kernel<bits>": registers} from the ptxas report that
    ops/cuda_build.py keeps beside the library `lib` (<lib>.log)."""
    out, fn = {}, None
    for line in open(f"{lib}.log"):
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif fn and " registers" in line and "Used " in line:
            out[kernel_key(fn)] = int(
                line.split("Used ")[1].split(" register")[0])
            fn = None
    return out


def spills_of(lib):
    """{"kernel<bits>": (spill store bytes, spill load bytes)} of each
    kernel in the ptxas report beside the library `lib` (<lib>.log)."""
    out, fn = {}, None
    for line in open(f"{lib}.log"):
        if "Function properties for " in line:
            fn = line.split("Function properties for ")[1].strip()
        elif fn and "spill stores" in line:
            if "_kernel" in fn:
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              "loads", line)
                out[kernel_key(fn)] = (int(m.group(1)), int(m.group(2)))
            fn = None
    return out


def ptxas_registers(root):
    """{"library:kernel<bits>": registers} of the libraries built under
    root (one build of each: a fresh checkout's)."""
    out = {}
    pattern = os.path.join(root, "rt_tpu_torch", "_build", "lib*.so")
    for lib in sorted(glob.glob(pattern)):
        name = os.path.basename(lib)[3:].split("-")[0]
        out.update({f"{name}:{k}": v for k, v in registers_of(lib).items()})
    return out


def sass_listing(lib, kernel):
    """[(address, instruction)] of `kernel` ("kernel<bits>") in the SASS
    of the library lib (cuobjdump -sass, beside nvcc), or None without
    cuobjdump."""
    from rt_tpu_torch.ops import cuda_build

    cuobj = os.path.join(os.path.dirname(cuda_build.find_nvcc()),
                         "cuobjdump")
    if not os.path.exists(cuobj):
        return None
    sass = subprocess.run([cuobj, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    body = [f for f in re.split(r"\n\s*Function : ", sass)[1:]
            if kernel_key(f.split("\n", 1)[0]) == kernel][0]
    return [(int(a, 16), t.strip()) for a, t in
            re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]


def opcode(txt):
    """An instruction's opcode without its predicate."""
    return re.sub(r"^@!?U?P\w+\s+", "", txt).split()[0]


def sass_loops(lib, kernel):
    """The loops of `kernel` in the SASS of the library lib:
    [(instructions, opcode counts)], one per backward branch, or None
    without cuobjdump."""
    ins = sass_listing(lib, kernel)
    if ins is None:
        return None
    loops = []
    for addr, txt in ins:
        m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", txt)
        if m and int(m.group(1), 16) < addr:
            lo = int(m.group(1), 16)
            ops = [opcode(t) for a, t in ins if lo <= a <= addr]
            counts = {}
            for op in ops:
                for key in {op.split(".")[0], op}:
                    counts[key] = counts.get(key, 0) + 1
            loops.append((len(ops), counts))
    return loops


def b1_instructions(lib):
    """Issued instructions per (ray, sphere) pair in B1's row loop, from
    the SASS of sphere_hit_kernel: the loop that reads rows (LDS.128) and
    takes roots (one MUFU.RSQ a pair of its unrolled body). Instructions
    that a forward branch of the loop skips, to a target inside it, are
    the root path (disc >= 0); the rest every pair runs. {"loop",
    "pairs", "rows", "miss_pair", "root_pair"}, or None."""
    ins = sass_listing(lib, "sphere_hit_kernel<>")
    if ins is None:
        return None
    out = None
    for addr, txt in ins:
        m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", txt)
        if not (m and int(m.group(1), 16) < addr):
            continue
        body = [(a, t) for a, t in ins if int(m.group(1), 16) <= a <= addr]
        ops = [opcode(t) for _, t in body]
        pairs, rows = ops.count("MUFU.RSQ"), ops.count("LDS.128")
        if not (pairs and rows) or (out and out["loop"] <= len(body)):
            continue  # the innermost such loop
        skipped = set()
        for a, t in body:
            f = re.search(r"^@!?U?P\w+\s+BRA\b.*?(0x[0-9a-f]+)", t)
            if f and a < int(f.group(1), 16) <= addr:
                skipped |= {b for b, _ in body
                            if a < b < int(f.group(1), 16)}
        out = dict(loop=len(body), pairs=pairs, rows=rows,
                   miss_pair=(len(body) - len(skipped)) / pairs,
                   root_pair=len(skipped) / pairs)
    return out


def row_instructions(lib, kernel="queue_kernel<01000>"):
    """Issued instructions per (lane, row) in the hit loops of B3 (or of
    `kernel`, B2's mega_kernel<01000>), from the SASS of its
    instantiation with families (kTail, kNee, kImages, kQmc off): the
    per-lane sphere loop (unrolled: its length over its
    LDS.128 rows), the per-lane triangle loop (one row an iteration, 17+
    LDG), and the dense path's loop per (ray, chunk) for spheres (10
    shuffled ray words and the winner's t) and triangles (6 and the t),
    where every thread tests one row; None where not found."""
    loops = sass_loops(lib, kernel)
    if loops is None:
        return None
    out = {"sphere_row": None, "triangle_row": None,
           "dense_sphere_ray_chunk": None, "dense_triangle_ray_chunk": None}
    for n, c in loops:
        shfl, redux = c.get("SHFL", 0), c.get("REDUX", 0)
        if redux == 1 and shfl >= 11 and c.get("LDS", 0) == 0:
            out["dense_sphere_ray_chunk"] = n
        elif redux == 1 and 7 <= shfl < 11 and c.get("LDG", 0) == 0:
            out["dense_triangle_ray_chunk"] = n
        elif not shfl and not redux and c.get("LDS.128", 0) >= 1 \
                and c.get("MUFU", 0) == c["LDS.128"]:
            out["sphere_row"] = n / c["LDS.128"]
        elif not shfl and not redux and c.get("LDG", 0) >= 17 \
                and c.get("MUFU", 0) == 1 and n < 200:
            out["triangle_row"] = n
    return out


def ab_times(root):
    """Times of the package imported from root (this tree or another
    checkout of it), one JSON line: B2 / B3 / B5 / B6 / B4 at phases 11 /
    13 / 19's shape (cover_scene 1920x1080, depth 50, one trace call of
    sample 0, its exact adjoint call, one capture) under rng without
    culling; B2 / B3 / B5 / B6 / B4 with culling (the default) on cover,
    cover_lights with nee (B4: its capture, which has no NEE; depth 50),
    the mesh and the textured mesh (depth 16), as phase 50; B7's
    culled regen call (phase 27's) on cover at spp 16 and on the mesh at
    spp 4; B1 on phase 3's 1080p primary rays; mean ms over 5 calls (B1
    20, B7 3) after a warm-up. Then the bench-shape queue, mega and regen
    frames (spp 16, mean s of 3 after one), phase 4's hybrid frame (spp
    2, mean s of 2 after one), phase 14's mega replay step (bwd_depth 8,
    mean s of 3 after one), phase 20's tape step (make_tape_vg on the
    all-fields workload, mean s of 3 after one, and its capture's ms) and
    `render -f scenes/demo_scene.json` (s, the second of two runs)."""
    sys.path.insert(0, root)
    from profile_torch import tape_workload
    from rt_tpu_torch import cli
    from rt_tpu_torch.diff.replay import make_replay_loss_fn
    from rt_tpu_torch.diff.tape import make_tape_vg
    from rt_tpu_torch.ops import cuda_intersect, cuda_mega, cuda_queue
    from rt_tpu_torch.ops.camera import generate_rays
    from rt_tpu_torch.render.renderer import _block_order, render
    from rt_tpu_torch.scene.builders import cover_scene
    from rt_tpu_torch.scene.types import build_tables

    build_all()
    dev = torch.device("cuda")
    sdef, cfg = cover_scene(width=W, height=H, spp=MAIN_SPP, max_depth=DEPTH)
    cfg = cfg.replace(rays_per_batch=1 << 25, compact_schedule=(2, 3, 5, 10),
                      compact_group=16, cull_chunks=False)
    tables = build_tables(sdef, device=dev)
    px = torch.arange(W * H, device=dev)
    ro, rd = generate_rays(tables.camera, W, H, px % W, px // W, 0, 0,
                           cfg.enable_defocus)
    args = (tables, cfg, ro, rd, px, 0, 0)
    L = cuda_queue.queue_trace(*args)
    g = torch.from_numpy(np.random.default_rng(0).normal(
        0, 1.0 / (W * H), (W * H, 3)).astype(np.float32)).to(dev)
    adj = args + (L, g, DEPTH, False)
    out = {}
    for name, fn, a in (
            ("mega_segment", cuda_mega.mega_trace, args),
            ("queue_launch", cuda_queue.queue_trace, args),
            ("mega_adjoint_segment", cuda_mega.mega_trace_adjoint, adj),
            ("queue_adjoint_launch", cuda_queue.queue_trace_adjoint, adj)):
        out[name] = cuda_ms(lambda: fn(*a), 5)[0]
    out["mega_capture"] = cuda_ms(lambda: cuda_mega.mega_capture(*args),
                                  5)[0]
    b1_args = (tables.sph_center, tables.sph_radius, tables.sph_obj >= 0,
               ro, rd)
    out["sphere_closest_hit"] = cuda_ms(
        lambda: cuda_intersect.sphere_closest_hit(*b1_args), 20)[0]
    with tempfile.TemporaryDirectory() as tmp:
        for label, tb, cb in warp_scenes(tmp, dev):
            rays = generate_rays(tb.camera, W, H, px % W, px // W, 0, 0,
                                 cb.enable_defocus, cb.sampler)
            a = (tb, cb, *rays, px, 0, 0)
            am = (tb, cb.replace(compact_schedule=cfg.compact_schedule,
                                 compact_group=cfg.compact_group), *a[2:])
            L = cuda_queue.queue_trace(*a)
            ad = a + (L, g, cb.max_depth, False)
            out[f"mega_segment {label}"] = cuda_ms(
                lambda: cuda_mega.mega_trace(*am), 5)[0]
            out[f"queue_launch {label}"] = cuda_ms(
                lambda: cuda_queue.queue_trace(*a), 5)[0]
            out[f"queue_adjoint_launch {label}"] = cuda_ms(
                lambda: cuda_queue.queue_trace_adjoint(*ad), 5)[0]
            adm = am + (L, g, cb.max_depth, False)
            out[f"mega_adjoint_segment {label}"] = cuda_ms(
                lambda: cuda_mega.mega_trace_adjoint(*adm), 5)[0]
            out[f"mega_capture {label}"] = cuda_ms(
                lambda: cuda_mega.mega_capture(*a), 5)[0]
            if label in ("cover", "mesh"):  # phases 27 and 31's B7 call
                spp = MAIN_SPP if label == "cover" else 4
                pix_b = torch.from_numpy(_block_order(W, H)[2]).to(dev)
                seg = (tb, am[1].replace(engine="mega"), pix_b, spp,
                       spp * (cb.max_depth + 1))
                out[f"mega_regen {label}"] = cuda_ms(
                    lambda: regen_segment(*seg, plain=False), 3)[0]
        frames = (("queue frame s", cfg.replace(cull_chunks=True,
                                                engine="queue"), 4),
                  ("mega frame s", cfg.replace(cull_chunks=True,
                                               engine="mega"), 4),
                  ("regen frame s", cfg.replace(cull_chunks=True,
                                                engine="mega", regen=True,
                                                regen_compact=0), 4),
                  ("hybrid frame s", cfg.replace(
                      cull_chunks=True, engine="pallas",
                      samples_per_pixel=SPP, rays_per_batch=1 << 21), 3))
        for key, frame_cfg, reps in frames:
            secs = []
            for rep in range(reps):
                torch.cuda.synchronize()
                t0 = time.time()
                render(tables, frame_cfg, device="cuda")
                torch.cuda.synchronize()
                secs.append(time.time() - t0)
            out[key] = float(np.mean(secs[1:]))
        # phase 14's mega replay step: cover at spp 1, bwd_depth 8
        s1, c1 = cover_scene(width=W, height=H, spp=1, max_depth=DEPTH)
        c1 = c1.replace(compact_schedule=(2, 3, 5, 10), compact_group=16,
                        engine="mega")
        t1 = build_tables(s1, device=dev)
        tgt = torch.rand((W * H, 3), generator=torch.Generator()
                         .manual_seed(0)).to(dev)
        loss_fn = make_replay_loss_fn(t1, c1, 1, px % W, px // W, tgt,
                                      bwd_depth=TRAIN_BWD_DEPTH)
        secs = []
        for rep in range(4):
            params = {k: getattr(t1, k).clone().requires_grad_(True)
                      for k in ("tex_color", "mat_albedo")}
            torch.cuda.synchronize()
            t0 = time.time()
            loss_fn(params).backward()
            torch.cuda.synchronize()
            secs.append(time.time() - t0)
        out["mega replay step s"] = float(np.mean(secs[1:]))
        # phase 20's tape step: the capture (B4), then the replay
        t_tp, c_tp, p_tp, tgt_tp = tape_workload(W, H, DEPTH, dev)
        vg = make_tape_vg(t_tp, c_tp, px % W, px // W, tgt_tp)
        secs, caps = [], []
        for rep in range(4):
            times = {}
            torch.cuda.synchronize()
            t0 = time.time()
            vg(p_tp, times=times)
            torch.cuda.synchronize()
            secs.append(time.time() - t0)
            caps.append(times["capture_s"])
        out["tape step s"] = float(np.mean(secs[1:]))
        out["tape capture ms"] = 1e3 * float(np.mean(caps[1:]))
        with contextlib.chdir(tmp), \
                contextlib.redirect_stdout(io.StringIO()):
            for rep in range(2):
                torch.cuda.synchronize()
                t0 = time.time()
                if cli.main(["render", "-f", DEMO, "-o", "d.ppm"]) != 0:
                    raise AssertionError("render -f demo failed")
                torch.cuda.synchronize()
                out["render -f demo s"] = time.time() - t0
    print(json.dumps(out))
    return 0


# phase 50's timed calls, by wrapper, in the order of its times
WARP_KERNELS = {"queue_launch": "B3", "queue_adjoint_launch": "B6",
                "mega_segment": "B2", "mega_adjoint_segment": "B5",
                "mega_regen": "B7 (spp 2)", "mega_capture": "B4"}


def warp_scenes(tmpd, dev):
    """The bench-shape workloads of B3 / B6's warp-cooperative hit
    (phases 48 and 50), with culling: (label, tables, cfg) of cover and
    cover_lights with nee at depth 50, the mesh and the mesh textured by a
    seeded 512x512 PNG (Taichi's UV swap) at depth 16."""
    from rt_tpu_torch.scene.builders import cover_scene, mesh_scene
    from rt_tpu_torch.scene.types import build_tables

    sd, cb = cover_scene(width=W, height=H, spp=1, max_depth=DEPTH)
    yield "cover", build_tables(sd, device=dev), cb
    sd, cb = cover_scene(width=W, height=H, spp=1, max_depth=DEPTH,
                         lights=True)
    yield "cover_lights, nee", build_tables(sd, device=dev), cb.replace(
        nee=True)
    sd, cb = mesh_scene(MESH, width=W, height=H, spp=1, max_depth=16)
    yield "mesh", build_tables(sd, device=dev), cb
    png = seeded_png(os.path.join(tmpd, "warp_mesh.png"), 512, 23)
    sd, cb = mesh_scene(MESH, width=W, height=H, spp=1, max_depth=16,
                        texture_path=png)
    sd.taichi_tri_uv = True
    yield "textured mesh", build_tables(sd, device=dev), cb


def tie_scene(w, h, depth):
    """Equal hits: a ground sphere, 25 spheres each given twice (same
    centre and radius, different albedo: adjacent rows of one chunk once
    Morton-sorted) and one sphere given 40 times (lambertian and metal
    copies, across two chunks), so that the rule "an equal t goes to the
    later row" picks the colour: (SceneDef, RenderConfig)."""
    from rt_tpu_torch.config import RenderConfig
    from rt_tpu_torch.scene.types import SceneDef

    s = SceneDef(width=w, height=h, samples_per_pixel=1, max_depth=depth,
                 background=(0.3, 0.4, 0.5))
    s.add_sphere((0, -100.5, -2), 100, s.add_lambertian_color((0.5, 0.5,
                                                               0.5)))
    k = 0
    for i in range(5):
        for j in range(5):
            for _ in range(2):
                k += 1
                s.add_sphere((-1.2 + 0.6 * i, -0.3, -3.0 + 0.6 * j), 0.2,
                             s.add_lambertian_color(
                                 ((k * 0.37) % 1, (k * 0.61) % 1,
                                  (k * 0.13) % 1)))
    for m in range(40):
        mat = (s.add_metal((0.9, 0.8 * (m % 2), 0.3), 0.1 * (m % 3))
               if m % 3 == 0 else
               s.add_lambertian_color(((m * 0.29) % 1, (m * 0.47) % 1, 0.5)))
        s.add_sphere((0.0, 0.3, -1.6), 0.35, mat)
    s.set_camera((0, 0.5, 1.0), (0, 0, -2), (0, 1, 0), 60, 0.0)
    return s, RenderConfig(width=w, height=h, samples_per_pixel=1,
                           max_depth=depth)


def sums_within(a, b, passes, spp, label):
    """Two sums of the same spp per-sample radiances that add them in
    other orders (passes partial sums against one sequence). Each addition
    rounds by at most 2^-24 of the running sum and radiance is
    non-negative, so |a - b| <= (2 spp + passes) 2^-24 |b|, + 1e-6 for sums
    near 0: the tolerance of progressive passes longer than one sample.
    Prints the largest relative difference and the share of values within
    the reference's rtol 1e-6 / atol 1e-6 (tests/test_progressive.py:25).
    Returns the largest absolute difference."""
    a = torch.as_tensor(a, dtype=torch.float64).cpu()
    b = torch.as_tensor(b, dtype=torch.float64).cpu()
    err = (a - b).abs()
    bound = (2 * spp + passes) * 2.0 ** -24 * b.abs() + 1e-6
    ref_ok = (err <= 1e-6 + 1e-6 * b.abs()).double().mean().item()
    rel = (err / b.abs().clamp(min=1e-6)).max().item()
    print(f"  {label}: max abs diff {err.max().item():.4g}, max relative "
          f"{rel:.4g}; {ref_ok:.6f} of values within rtol 1e-6 / atol "
          f"1e-6; bound ({2 * spp} + {passes}) x 2^-24 of the sum: "
          f"{int((err > bound).sum())} values beyond", flush=True)
    if bool((err > bound).any()):
        raise AssertionError(f"{label}: beyond the rounding bound")
    return err.max().item()


def adaptive_spend(spp, n_pix, rounds=16, sel_frac=0.125):
    """The total paths render_adaptive spends at its defaults, restated
    from its rule (rt_tpu/render/adaptive.py:99-146): the base pass
    2 * (spp_base // 2) samples a pixel, spp_base = max(4, spp // 2) made
    even; each round k samples on b_sel pixels, b_sel the top 1/8 of the
    frame padded to 128 lanes (narrowed to the round's share where that is
    smaller), k the round's share over b_sel; a round runs while the spend
    stays within the budget plus b_sel - 1. Returns (spend, b_sel, k)."""
    base = max(4, spp // 2)
    base = min(spp, base + base % 2)
    n_base = 2 * (base // 2) or 1
    budget = (spp - n_base) * n_pix
    if budget <= 0:
        return n_base * n_pix, 0, 0
    per_round = budget // rounds
    pad = lambda x: -(-max(x, 1) // 128) * 128  # noqa: E731
    b_sel = min(pad(int(n_pix * sel_frac)), n_pix)
    if per_round < b_sel:
        b_sel = min(pad(per_round), n_pix)
    k = max(1, per_round // b_sel)
    if b_sel >= n_pix:
        b_sel, k = n_pix, max(1, per_round // n_pix)
    runs = 0
    while runs < rounds and (runs + 1) * k * b_sel <= budget + b_sel - 1:
        runs += 1
    return n_base * n_pix + runs * k * b_sel, b_sel, k


def driver_phases(dev, smi, c16, t16, uniform, cli):
    """Phases 51-54: the render drivers and the CLI's render surface on
    the card. uniform: phase 10's queue frame (radiance sum, spp
    MAIN_SPP). Returns their numbers for the kernels line."""
    import argparse

    from rt_tpu_torch.drivers import animate
    from rt_tpu_torch.io.image import read_png, write_png
    from rt_tpu_torch.ops import cuda_mega, cuda_queue
    from rt_tpu_torch.ops.camera import generate_rays
    from rt_tpu_torch.render import adaptive, film
    from rt_tpu_torch.render.adaptive import adaptive_mean, render_adaptive
    from rt_tpu_torch.render.progressive import Checkpoint, \
        render_progressive
    from rt_tpu_torch.render.renderer import render
    from rt_tpu_torch.scene.builders import dna_scene
    from rt_tpu_torch.scene.parser import parse_scene
    from rt_tpu_torch.scene.types import build_tables

    drv = {"animate": {}, "progressive": {}, "adaptive": {}, "cli": {}}
    tmp_dir = tempfile.TemporaryDirectory()
    tmpd = tmp_dir.name
    log = os.path.join(tmpd, "time.log")

    def counted(fn):
        """fn() between reset_counts and read_counts, timed."""
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        res = fn()
        torch.cuda.synchronize()
        return res, time.time() - t0, read_counts()

    def only(counts, *names):
        """The launches of `names`, failing if one is 0 or another kernel
        launched."""
        if any(counts[n] <= 0 for n in names) or any(
                v for k, v in counts.items() if k not in names):
            raise AssertionError(f"launches {counts}, want only {names}")
        return {n: counts[n] for n in names}

    with phase(f"51 animate: python -m rt_tpu_torch animate --kind dna "
               f"--frames 4 at {W}x{H} spp {MAIN_SPP} depth {DEPTH} "
               "--video (queue, B3); one mega frame (B2); blue on "
               "scenes/demo_scene.json at 960x540; --farm 2 at "
               f"{SMALL_W}x{SMALL_H} against a serial run"):
        d = os.path.join(tmpd, "dna")
        avi = os.path.join(d, "dna.avi")
        size = ["-w", str(W), "--height", str(H), "-spp", str(MAIN_SPP),
                "-d", str(DEPTH)]
        rc, sec, counts = counted(lambda: cli.main(
            ["animate", "--kind", "dna", "--frames", "4", "--outdir", d,
             "--video", avi] + size))
        frames = sorted(glob.glob(os.path.join(d, "frame_*.png")))
        head = open(avi, "rb").read(12) if os.path.exists(avi) else b""
        if rc != 0 or len(frames) != 4 or head[:4] != b"RIFF" or \
                head[8:12] != b"AVI ":
            raise AssertionError(f"animate exited {rc}, wrote {frames}, "
                                 f"video header {head!r}")
        q = only(counts, "queue_launch")
        # frame 2 against a direct render of the same frame, written by
        # the synchronous path (render, finalize with gamma, write_png)
        sdef, cfg = dna_scene(angle_deg=2.0, width=W, height=H,
                              spp=MAIN_SPP, max_depth=DEPTH)
        cfg = animate._frame_cfg(argparse.Namespace(
            width=W, height=H, spp=MAIN_SPP, max_depth=DEPTH,
            engine="queue"), cfg)
        tb = build_tables(sdef, device=dev)
        render(tb, cfg, device="cuda")  # warm
        img, render_s, _ = counted(lambda: render(tb, cfg, device="cuda"))
        t0 = time.time()
        u8 = film.finalize(img, MAIN_SPP, gamma=True)
        finalize_s = time.time() - t0
        direct = os.path.join(tmpd, "direct.png")
        t0 = time.time()
        write_png(direct, u8)
        png_s = time.time() - t0
        same = open(direct, "rb").read() == open(frames[2], "rb").read()
        print(f"  animate dna: exit {rc}, {sec:.4f} s for 4 frames = "
              f"{sec / 4:.4f} s per frame (the video included), launches "
              f"{q}; one frame alone: render {render_s:.4f} s, finalize "
              f"(download) {finalize_s:.4f} s, PNG encode {png_s:.4f} s "
              f"({png_s / (sec / 4):.1%} of a frame); frame 2 == the "
              f"synchronous render's PNG: {same}; {smi}", flush=True)
        if not same:
            raise AssertionError("the pipelined frame 2 differs from the "
                                 "synchronous path's")
        drv["animate"]["dna"] = dict(
            s=sec, s_per_frame=sec / 4, launches=q["queue_launch"],
            render_s=render_s, finalize_s=finalize_s, png_s=png_s)

        dm = os.path.join(tmpd, "dna_mega")
        rc, sec, counts = counted(lambda: cli.main(
            ["animate", "--kind", "dna", "--frames", "1", "--engine",
             "mega", "--outdir", dm] + size))
        m = only(counts, "mega_segment")
        png = read_png(os.path.join(dm, "frame_0000.png"))
        print(f"  animate dna --engine mega, 1 frame: exit {rc}, "
              f"{sec:.4f} s, launches {m}", flush=True)
        if rc != 0 or png.shape != (H, W, 3) or png.max() == 0:
            raise AssertionError(f"mega animate exited {rc}")
        drv["animate"]["dna_mega"] = dict(s=sec,
                                          launches=m["mega_segment"])

        db = os.path.join(tmpd, "blue")
        rc, sec, counts = counted(lambda: cli.main(
            ["animate", "--kind", "blue", "--scene", DEMO, "--frames", "2",
             "--deg-per-frame", "10", "-w", "960", "--height", "540",
             "-spp", str(MAIN_SPP), "-d", "40", "--outdir", db]))
        b = only(counts, "queue_launch")
        written = sorted(os.listdir(db))
        print(f"  animate blue (demo_scene.json, 960x540, spp {MAIN_SPP}, "
              f"depth 40), 2 frames: exit {rc}, {sec:.4f} s, launches {b}, "
              f"wrote {written}", flush=True)
        if rc != 0 or written != ["frame_0000.png", "frame_0001.png",
                                  "scene_0000.json", "scene_0001.json"]:
            raise AssertionError(f"blue animate exited {rc}")
        drv["animate"]["blue"] = dict(s=sec, launches=b["queue_launch"])

        small = ["--frames", "4", "-w", str(SMALL_W), "--height",
                 str(SMALL_H), "-spp", str(MAIN_SPP), "-d", str(DEPTH)]
        ds, df = os.path.join(tmpd, "serial"), os.path.join(tmpd, "farm")
        rc_s, sec_s, _ = counted(lambda: cli.main(
            ["animate", "--kind", "dna", "--outdir", ds] + small))
        t0 = time.time()
        rc_f = cli.main(["animate", "--kind", "dna", "--outdir", df,
                         "--farm", "2"] + small)
        sec_f = time.time() - t0
        names = sorted(os.listdir(ds))
        equal = names == sorted(os.listdir(df)) and all(
            open(os.path.join(ds, n), "rb").read()
            == open(os.path.join(df, n), "rb").read() for n in names)
        print(f"  --farm 2 (two worker processes on this card) at "
              f"{SMALL_W}x{SMALL_H}, 4 frames: exit {rc_f}, {sec_f:.4f} s "
              f"(serial {sec_s:.4f} s); frames byte-equal to the serial "
              f"run's: {equal} ({names})", flush=True)
        if rc_s != 0 or rc_f != 0 or len(names) != 4 or not equal:
            raise AssertionError("the farm's frames differ from the serial "
                                 "run's")
        drv["animate"]["farm"] = dict(s=sec_f, serial_s=sec_s)

    with phase("52 progressive: render_progressive on "
               "scenes/demo_scene.json (960x540, spp 128, depth 40) "
               "stopped at spp 64 and resumed, queue (B3) and mega regen "
               "(B7); render --checkpoint; B3 at sample base 64"):
        sd, cd = demo_scene()
        dw, dh, dspp = cd.width, cd.height, cd.samples_per_pixel
        # the CLI's configuration: the compaction schedule at depth >= 16
        cd = cd.replace(compact_schedule=(2, 3, 5, 10), compact_group=16)
        td = build_tables(sd, device=dev)
        for name, ce, kern in (
                ("queue", cd.replace(engine="queue"), "queue_launch"),
                ("regen", cd.replace(engine="mega", regen=True),
                 "mega_regen")):
            render(td, ce.replace(samples_per_pixel=2), device="cuda")
            one, one_s, c1 = counted(lambda: render(td, ce, device="cuda"))
            ck = os.path.join(tmpd, f"{name}.npz")

            def resume(ck=ck, ce=ce, per=1):
                render_progressive(td, ce.replace(samples_per_pixel=64),
                                   checkpoint_path=ck, checkpoint_every=32,
                                   samples_per_pass=per, device="cuda")
                if Checkpoint.load(ck).samples_done != 64:
                    raise AssertionError("the stop at spp 64 was not saved")
                return render_progressive(td, ce, checkpoint_path=ck,
                                          checkpoint_every=32,
                                          samples_per_pass=per,
                                          device="cuda")

            (acc, done), prog_s, c2 = counted(resume)
            bit = bool(torch.equal(acc, one))
            print(f"  {name}: one-shot spp {dspp} {one_s:.4f} s (launches "
                  f"{only(c1, kern)}); stopped at 64 and resumed to {done} "
                  f"in one-sample passes {prog_s:.4f} s (launches "
                  f"{only(c2, kern)}, {prog_s / one_s:.3f}x the one-shot, "
                  f"two checkpoint writes included); bit-equal to the "
                  f"one-shot: {bit}", flush=True)
            rec = drv["progressive"][name] = dict(
                oneshot_s=one_s, progressive_s=prog_s,
                oneshot_launches=c1[kern], progressive_launches=c2[kern],
                one_sample_passes_bit_equal=bit)
            if not bit:
                if name == "queue":
                    raise AssertionError("queue: the resumed render is not "
                                         "the one-shot render bit for bit")
                rec["one_sample_passes_max_abs_err"] = sums_within(
                    acc, one, dspp, dspp, f"{name} one-sample passes")
            # the CLI's pass schedule: --checkpoint-every 32 gives passes
            # of 8 samples to spp 64, then of 16 (min(32, spp // 8))
            ck2 = os.path.join(tmpd, f"{name}_cli.npz")
            out = os.path.join(tmpd, f"{name}_cli.png")
            if name == "queue":
                runs = [cli.main(["render", "-f", DEMO, "--checkpoint", ck2,
                                  "--checkpoint-every", "32", "-spp", str(s),
                                  "-o", out, "--log", log])
                        for s in (64, dspp)]
                if runs != [0, 0]:
                    raise AssertionError(f"render --checkpoint exited {runs}")
                label = "render --checkpoint (CLI) to 64, then 128"
            else:  # the CLI has no regen flag: the same calls directly
                for s in (64, dspp):
                    render_progressive(td, ce.replace(samples_per_pixel=s),
                                       checkpoint_path=ck2,
                                       checkpoint_every=32, device="cuda")
                label = "regen passes of 8, then 16"
            saved = Checkpoint.load(ck2)
            if saved.samples_done != dspp:
                raise AssertionError(f"{label}: {saved.samples_done} done")
            rec["cli_schedule_max_abs_err"] = sums_within(
                saved.pixel_sum, one, 64 // 8 + 64 // 16, dspp, label)
            if name == "queue":
                png = read_png(out)
                if png.shape != (dh, dw, 3) or png.max() == 0:
                    raise AssertionError("render --checkpoint wrote a bad "
                                         "PNG")

        # one B3 call at sample base 64 on every pixel, against the plain
        # version bit for bit
        cq = cd.replace(engine="queue")
        px = torch.arange(dw * dh, device=dev)
        ro, rd = generate_rays(td.camera, dw, dh, px % dw, px // dw, 64,
                               cq.seed, cq.enable_defocus, cq.sampler)
        args = (td, cq, ro, rd, px, 64, cq.seed)
        ms, k_q = cuda_ms(lambda: cuda_queue.queue_trace(*args), 3)
        p_q = cuda_queue.queue_trace(*args, plain=True)
        same = bool(torch.equal(k_q, p_q))
        print(f"  B3 at sample base 64 on {dw * dh} lanes: {ms:.4f} ms, "
              f"bit-equal to the plain version: {same}; {smi}", flush=True)
        if not same:
            raise AssertionError("B3 at sample base 64 differs from plain")
        drv["progressive"]["b3_base64_ms"] = ms

    with phase(f"53 adaptive: render_adaptive on cover_scene {W}x{H} spp "
               f"{MAIN_SPP} depth {DEPTH} (queue, B3); one round's lanes "
               "on B3 and B2 against their plain versions; render -f "
               "scenes/demo_scene.json --adaptive"):
        ca = c16.replace(engine="queue")
        rounds, round_s = [], []
        real = adaptive.render_pixels

        def spy(*a, **k):
            """render_pixels, its arguments kept and its device work
            timed (synchronised at both ends)."""
            rounds.append(a)
            torch.cuda.synchronize()
            t0 = time.time()
            out = real(*a, **k)
            torch.cuda.synchronize()
            round_s.append(time.time() - t0)
            return out

        adaptive.render_pixels = spy
        try:
            (acc, n), sec, counts = counted(
                lambda: render_adaptive(t16, ca, device="cuda"))
        finally:
            adaptive.render_pixels = real
        q = only(counts, "queue_launch")
        want, b_sel, k = adaptive_spend(MAIN_SPP, W * H)
        total = int(n.sum())
        mean_a = float(adaptive_mean(acc, n).mean())
        mean_u = float(np.mean(uniform)) / MAIN_SPP
        print(f"  {sec:.4f} s ({len(rounds)} rounds of {k} samples on "
              f"{b_sel} pixels, their render_pixels calls {sum(round_s):.4f}"
              f" s, the rest the base pass and the host's bookkeeping), "
              f"launches {q}; n.sum() {total}, the rule's "
              f"{want}, uniform {MAIN_SPP * W * H}; n from {int(n.min())} "
              f"to {int(n.max())}; frame mean {mean_a:.5f} against phase "
              f"10's uniform {mean_u:.5f} ({mean_a / mean_u - 1:+.3%}); "
              f"{smi}", flush=True)
        if total != want or abs(total - MAIN_SPP * W * H) > \
                len(rounds) * 128 * k:
            raise AssertionError("adaptive spent other than its rule")
        if not np.isfinite(acc).all() or abs(mean_a / mean_u - 1) > 0.02:
            raise AssertionError("the adaptive frame's mean is off")
        # the last round's lanes, each from its own start (the first
        # round's all start at the base count), on B3 and B2
        _, _, xs, ys, starts, k0, seed = rounds[-1][:7]
        lx = torch.from_numpy(np.asarray(xs)).to(dev)
        ly = torch.from_numpy(np.asarray(ys)).to(dev)
        ls = torch.from_numpy(np.asarray(starts)).to(dev)
        pix = ly.long() * W + lx.long()
        ro, rd = generate_rays(t16.camera, W, H, lx, ly, ls, seed,
                               ca.enable_defocus, ca.sampler)
        errs = {}
        for name, fn, ce in (
                ("B3", cuda_queue.queue_trace, ca),
                ("B2", cuda_mega.mega_trace, c16.replace(engine="mega"))):
            got = fn(t16, ce, ro, rd, pix, ls, seed)
            ref = fn(t16, ce, ro, rd, pix, ls, seed, plain=True)
            errs[name] = (got - ref).abs().max().item()
            print(f"  round {len(rounds)}, {name}: {lx.numel()} lanes (starts "
                  f"{int(ls.min())}-{int(ls.max())}), bit-equal to the "
                  f"plain version: {torch.equal(got, ref)}", flush=True)
            if not torch.equal(got, ref):
                raise AssertionError(f"{name} with per-lane starts differs "
                                     "from its plain version")
        if int(ls.min()) == int(ls.max()):
            raise AssertionError("the last round's lanes share one start")
        drv["adaptive"] = dict(s=sec, launches=q["queue_launch"],
                               render_pixels_s=sum(round_s),
                               spend=total, rounds=len(rounds), k=k,
                               b_sel=b_sel, mean=mean_a, uniform_mean=mean_u,
                               round_lanes=int(lx.numel()))
        out = os.path.join(tmpd, "adaptive.png")
        rc, sec, counts = counted(lambda: cli.main(
            ["render", "-f", DEMO, "--adaptive", "-o", out, "--log", log]))
        q = only(counts, "queue_launch")
        print(f"  render -f demo_scene.json --adaptive: exit {rc}, "
              f"{sec:.4f} s, launches {q}", flush=True)
        if rc != 0 or read_png(out).max() == 0:
            raise AssertionError(f"render --adaptive exited {rc}")
        drv["adaptive"]["cli"] = dict(s=sec, launches=q["queue_launch"])

    with phase("54 CLI breadth: parse, render --both-formats --view-gamma "
               "--log, animate --format jpg, render --bvh renders"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["parse", DEMO])
        got = json.loads(buf.getvalue())
        sd, _ = parse_scene(DEMO)
        want = {"width": sd.width, "height": sd.height,
                "samples_per_pixel": sd.samples_per_pixel,
                "max_depth": sd.max_depth, "objects": len(sd.objects),
                "materials": len(sd.materials),
                "textures": len(sd.textures), "output_file": sd.output_file}
        print(f"  parse: exit {rc}, {got}", flush=True)
        if rc != 0 or got != want:
            raise AssertionError(f"parse printed {got}, want {want}")

        base = os.path.join(tmpd, "both.png")
        log2 = os.path.join(tmpd, "both.log")
        rc, sec, counts = counted(lambda: cli.main(
            ["render", "--coded", "cover", "-w", str(CLI_W), "--height",
             str(CLI_H), "-spp", "2", "-d", "50", "-o", base,
             "--both-formats", "--view-gamma", "--log", log2]))
        lines = open(log2).read().splitlines()
        ppm = os.path.join(tmpd, "both.ppm")
        print(f"  render --both-formats --view-gamma --log: exit {rc}, "
              f"launches {only(counts, 'queue_launch')}, wrote "
              f"{sorted(f for f in os.listdir(tmpd) if f.startswith('both'))}"
              f", log {lines}", flush=True)
        if rc != 0 or not os.path.exists(ppm) or read_png(base).max() == 0 \
                or len(lines) != 1 or not lines[0].startswith(
                    f"rt_tpu_torch, width {CLI_W} height {CLI_H} spp 2"):
            raise AssertionError("render --both-formats / --log failed")

        dj = os.path.join(tmpd, "jpg")
        rc = cli.main(["animate", "--kind", "dna", "--frames", "2", "-w",
                       str(CLI_W), "--height", str(CLI_H), "-spp", "4",
                       "-d", "16", "--format", "jpg", "--outdir", dj])
        jpgs = sorted(os.listdir(dj))
        heads = [open(os.path.join(dj, f), "rb").read(2) for f in jpgs]
        print(f"  animate --format jpg: exit {rc}, {jpgs}", flush=True)
        if rc != 0 or jpgs != ["frame_0000.jpg", "frame_0001.jpg"] or \
                any(h != b"\xff\xd8" for h in heads):
            raise AssertionError("animate --format jpg failed")

        bvh_png = os.path.join(tmpd, "bvh.png")
        proc = subprocess.run(
            [sys.executable, "-m", "rt_tpu_torch", "render", "--bvh", "--log",
             log, "-w", str(CLI_W), "--height", str(CLI_H), "-spp", "2", "-d",
             "8", "-o", bvh_png], cwd=ROOT, capture_output=True, text=True,
            timeout=300)
        last = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() \
            else proc.stderr
        print(f"  render --bvh: exit {proc.returncode}, {last}", flush=True)
        if proc.returncode != 0 or read_png(bvh_png).max() == 0:
            raise AssertionError("render --bvh did not render")
        drv["cli"] = dict(both_formats_launches=counts["queue_launch"])
    tmp_dir.cleanup()
    return drv


# the BVH (phase 55)
BVH_ALL = ("sphere", "rect", "cylinder", "triangle")
BVH_DEPTH = 8                 # the frames of phase 55(c), spp 1
BIG_CELLS = 256               # the height field: 2 x 256 x 256 triangles
BIG_RAYS = 16384              # its rays held against the linear scan
LINEAR_CHUNK = 1 << 17        # rays a linear intersect takes at once


def height_field_obj(path, cells=BIG_CELLS, seed=19):
    """A seeded height field of cells x cells quads, two triangles each,
    as an OBJ: vertices on [-1.2, 1.2]^2, z a sum of six seeded waves
    plus jitter (plane441.obj's square, finer and not flat)."""
    rng = np.random.default_rng(seed)
    n = cells + 1
    u = np.linspace(-1.2, 1.2, n)
    x, y = np.meshgrid(u, u, indexing="xy")
    z = rng.normal(0.0, 0.003, x.shape)
    for _ in range(6):
        kx, ky = rng.uniform(1.0, 6.0, 2)
        px, py = rng.uniform(0.0, 2.0 * np.pi, 2)
        z += rng.uniform(0.02, 0.06) * np.sin(kx * x + px) * np.cos(ky * y
                                                                     + py)
    idx = np.arange(1, n * n + 1).reshape(n, n)
    a, b, c, d = idx[:-1, :-1], idx[:-1, 1:], idx[1:, :-1], idx[1:, 1:]
    faces = np.concatenate([np.stack([a, b, d], -1).reshape(-1, 3),
                            np.stack([a, d, c], -1).reshape(-1, 3)])
    verts = np.stack([x, y, z], -1).reshape(-1, 3)
    with open(path, "w") as f:
        f.write("".join(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n"
                        for p in verts))
        f.write("".join(f"f {i} {j} {k}\n" for i, j, k in faces))
    return len(faces)


def linear_hits(intersect, tables, ro, rd):
    """intersect(traversal="linear") in chunks of rays (its [rays, rows]
    candidates at 1080p would not fit): at most LINEAR_CHUNK rays and
    2^27 (ray, row) pairs of the largest family a chunk; fields joined."""
    rows = max(tables.sph_center.shape[0], tables.rect_k.shape[0],
               tables.cyl_radius.shape[0], tables.tri_v1.shape[0])
    chunk = max(64, min(LINEAR_CHUNK, (1 << 27) // rows))
    parts = [intersect(tables, ro[s:s + chunk], rd[s:s + chunk])
             for s in range(0, ro.shape[0], chunk)]
    return type(parts[0])(*(torch.cat(f) for f in zip(*parts)))


def graze_margin(tables, ptype, pid, ro, rd):
    """Per lane, how near in float64 the ray passes to an edge or a
    silhouette of the primitive of family ptype, row pid, in units of the
    magnitudes that float32 rounds when it decides the hit (so a float32
    disagreement on a graze reads as a few times 2^-23): 0 at the edge,
    inf where ptype is no family of the tables. Sphere: |disc| / (hb^2 +
    a |c|) of the half-b quadratic. Rect: the plane point's distance to
    the rect's outline over |o| + |t d|, or |d_k| / |d| for a ray along
    its plane. Cylinder (in object space): the radial quadratic's |delta|
    / (b^2 + 4 a |c|), each root's distance to the ends of the z window
    over |o| + |t d|, or a / |d|^2 for a ray along its axis. Triangle: the
    plane point's distance to the nearest edge over |o| + |t d|, or the
    cosine between the ray and its plane."""
    o, d = ro.double(), rd.double()
    m = torch.full(ptype.shape, float("inf"), dtype=torch.float64,
                   device=ro.device)

    def rows(fam, n):
        return torch.where(ptype == fam, pid.long(), 0) if n else None

    def dot(x, y):
        return (x * y).sum(-1)

    n_sph, n_rect, n_cyl, n_tri = tables.counts
    row = rows(0, n_sph)
    if row is not None:
        oc = o - tables.sph_center[row].double()
        r = tables.sph_radius[row].double()
        a, hb = dot(d, d), dot(oc, d)
        cc = dot(oc, oc) - r * r
        g = (hb * hb - a * cc).abs() / (hb * hb + a * cc.abs())
        m = torch.where(ptype == 0, g, m)
    row = rows(1, n_rect)
    if row is not None:
        ax = tables.rect_axis[row].long()[:, None]
        k = tables.rect_k[row].double()
        lo, hi = tables.rect_lo[row].double(), tables.rect_hi[row].double()
        free = torch.cat([torch.where(ax == 0, 1, 0),
                          torch.where(ax == 2, 1, 2)], dim=1)
        dk = torch.gather(d, 1, ax)[:, 0]
        t = (k - torch.gather(o, 1, ax)[:, 0]) / torch.where(dk == 0, 1.0,
                                                              dk)
        q = torch.gather(o, 1, free) + t[:, None] * torch.gather(d, 1, free)
        out = torch.maximum(lo - q, q - hi)          # > 0 outside an edge
        sdf = torch.where(out.amax(-1) > 0, out.clamp(min=0).norm(dim=-1),
                          -out.amax(-1))
        scale = o.norm(dim=-1) + (t[:, None] * d).norm(dim=-1)
        g = torch.minimum(sdf / scale, dk.abs() / d.norm(dim=-1))
        m = torch.where(ptype == 1, g, m)
    row = rows(2, n_cyl)
    if row is not None:
        w2o = tables.cyl_w2o[row].double()
        oo = (w2o[:, :3, :3] @ o[:, :, None])[:, :, 0] + w2o[:, :3, 3]
        od = (w2o[:, :3, :3] @ d[:, :, None])[:, :, 0]
        r = tables.cyl_radius[row].double()
        zmin, zmax = tables.cyl_zmin[row].double(), tables.cyl_zmax[row].double()
        a = od[:, 0] ** 2 + od[:, 1] ** 2
        b = 2.0 * (od[:, 0] * oo[:, 0] + od[:, 1] * oo[:, 1])
        c = oo[:, 0] ** 2 + oo[:, 1] ** 2 - r * r
        delta = b * b - 4.0 * a * c
        g = torch.minimum(delta.abs() / (b * b + 4.0 * a * c.abs()),
                          a / dot(od, od))
        sq = delta.clamp(min=0).sqrt()
        for root in ((-b - sq) / (2 * a), (-b + sq) / (2 * a)):
            pz = oo[:, 2] + root * od[:, 2]
            scale = oo.norm(dim=-1) + (root[:, None] * od).norm(dim=-1)
            g = torch.minimum(g, torch.minimum((pz - zmin).abs(),
                                               (pz - zmax).abs()) / scale)
        m = torch.where(ptype == 2, g, m)
    row = rows(3, n_tri)
    if row is not None:
        v = [getattr(tables, f"tri_v{i}")[row].double() for i in (1, 2, 3)]
        n0 = torch.cross(v[1] - v[0], v[2] - v[0], dim=-1)
        dn = dot(d, n0)
        t = dot(v[0] - o, n0) / torch.where(dn == 0, 1.0, dn)
        q = o + t[:, None] * d
        dist = []
        for va, vb in ((v[0], v[1]), (v[1], v[2]), (v[2], v[0])):
            e = vb - va
            s = (dot(q - va, e) / dot(e, e)).clamp(0.0, 1.0)
            dist.append((q - va - s[:, None] * e).norm(dim=-1))
        scale = o.norm(dim=-1) + (t[:, None] * d).norm(dim=-1)
        g = torch.minimum(torch.stack(dist).amin(0) / scale,
                          dn.abs() / (d.norm(dim=-1) * n0.norm(dim=-1)))
        m = torch.where(ptype == 3, g, m)
    return m


# the graze_margin that explains a differing lane: 84 float32 ulps of
# the magnitudes rounded (the lanes that differ read 1-2)
GRAZE = 1e-5


def bvh_vs_linear(hb, hl, label, tables, ro, rd):
    """The walk against the scan on the same rays, with
    tests/test_bvh.py:65-73's tolerances per lane: hit masks equal, t
    within rtol 1e-3 / atol 5e-3 where a lane hits, the same (family,
    row) on more than 99.5% of the lanes that hit. The walk's leaf tests
    are the reference's oc-form quadratics and the scan's the expanded
    ones, which round otherwise, so a ray that grazes a silhouette or an
    edge can hit in one and miss in the other (ROADMAP C-5's class). So
    at most 0.1% of lanes may differ, and every lane whose hit or t
    differs, of any family, must graze the nearer of the two answers'
    primitives (the one that one side found and the other did not):
    within GRAZE of its edge in float64 (graze_margin)."""
    tb = torch.where(hb.hit, hb.t, 0.0)
    tl = torch.where(hl.hit, hl.t, 0.0)
    hit_off = hb.hit != hl.hit
    t_off = (tb - tl).abs() > 5e-3 + 1e-3 * tl.abs()
    row_off = hl.hit & ((hb.pid != hl.pid) | (hb.ptype != hl.ptype))
    off = hit_off | t_off | row_off
    n_off = int(off.sum())
    agree = 1.0 - float(row_off.sum()) / max(int(hl.hit.sum()), 1)
    lanes = torch.nonzero(hit_off | t_off)[:, 0]
    # the nearer answer of each lane: the walk's where it hits nearer
    walk = hb.hit[lanes] & (~hl.hit[lanes] | (hb.t[lanes] <= hl.t[lanes]))
    ptype = torch.where(walk, hb.ptype[lanes], hl.ptype[lanes])
    pid = torch.where(walk, hb.pid[lanes], hl.pid[lanes])
    m = graze_margin(tables, ptype, pid, ro[lanes], rd[lanes])
    # the check's power: the share of the lanes that agree whose hit is
    # as near an edge as GRAZE (a wrong lane passes by chance as often)
    same = hb.hit & hl.hit & ~off
    m_same = graze_margin(tables, hb.ptype[same], hb.pid[same], ro[same],
                          rd[same])
    by_family = {}
    for fam, fname in enumerate(("sphere", "rect", "cylinder", "triangle")):
        sel, sel_same = ptype == fam, hb.ptype[same] == fam
        if bool(sel.any()) or bool(sel_same.any()):
            by_family[fname] = dict(
                lanes=int(sel.sum()), max_margin=float(
                    m[sel].max()) if bool(sel.any()) else None,
                agreeing_hits=int(sel_same.sum()), agreeing_within=float(
                    (m_same[sel_same] <= GRAZE).double().mean()))
    unexplained = int((m > GRAZE).sum())
    worst = float(m.max()) if lanes.numel() else 0.0
    print(f"  {label}: {hb.hit.numel()} rays, {float(hl.hit.float().mean()):.4f}"
          f" hit; lanes that differ {n_off} ({n_off / hb.hit.numel():.4%}):"
          f" hit masks {int(hit_off.sum())}, t outside tolerance "
          f"{int(t_off.sum())}, (family, row) {int(row_off.sum())} (agree "
          f"{agree:.6f}); the {lanes.numel()} hit or t lanes by the nearer "
          f"answer's family, their largest float64 graze margin, and the "
          f"share of agreeing hits within {GRAZE:g}: {by_family}; "
          f"{unexplained} beyond {GRAZE:g}", flush=True)
    for j, i in enumerate(lanes[:6].tolist()):
        print(f"    lane {i}: walk hit {bool(hb.hit[i])} t "
              f"{float(hb.t[i]):.7g} ({int(hb.ptype[i])}, {int(hb.pid[i])});"
              f" scan hit {bool(hl.hit[i])} t {float(hl.t[i]):.7g} "
              f"({int(hl.ptype[i])}, {int(hl.pid[i])}); margin "
              f"{float(m[j]):.3g}", flush=True)
    if n_off > 1e-3 * hb.hit.numel() or unexplained or agree <= 0.995:
        raise AssertionError(f"{label}: the BVH walk disagrees with the "
                             "linear scan")
    return dict(rays=int(hb.hit.numel()), hit_share=float(
        hl.hit.float().mean()), lanes_differ=n_off,
        hit_masks_differ=int(hit_off.sum()), t_off=int(t_off.sum()),
        row_agree=agree, graze_by_family=by_family, max_graze_margin=worst)


def bvh_phase(dev, smi, cli):
    """Phase 55: the BVH at full width (see the module doc). Returns its
    numbers for the kernels line."""
    from rt_tpu_torch.accel import bvh
    from rt_tpu_torch.io import native
    from rt_tpu_torch.io.image import read_png
    from rt_tpu_torch.ops.camera import generate_rays
    from rt_tpu_torch.ops.intersect import intersect
    from rt_tpu_torch.render.renderer import render
    from rt_tpu_torch.scene.builders import cover_scene, dna_scene, \
        mesh_scene
    from rt_tpu_torch.scene.parser import parse_scene
    from rt_tpu_torch.scene.types import BVH_FAMILIES, BVH_KEYS, \
        build_tables

    out = {"builds": {}, "intersect": {}, "frames": {}, "cli": {}}
    tmp_dir = tempfile.TemporaryDirectory()
    tmpd = tmp_dir.name
    big = os.path.join(tmpd, "height256.obj")

    def timed(fn):
        torch.cuda.synchronize()
        for k in bvh.COUNTS:
            bvh.COUNTS[k] = 0
        reset_counts()
        t0 = time.time()
        res = fn()
        torch.cuda.synchronize()
        return res, time.time() - t0, dict(bvh.COUNTS), read_counts()

    with phase(f"55 the BVH at full width: native vs NumPy builds, "
               f"intersect(traversal='bvh') vs 'linear' on {W}x{H} primary "
               f"rays, frames at {W}x{H} spp 1 depth {BVH_DEPTH}, render "
               "--bvh on scenes/demo_scene.json"):
        if not native.available():
            raise AssertionError("the native BVH library did not build or "
                                 "load")
        print(f"  native library "
              f"{os.path.relpath(native.library_path(), ROOT)} (g++ "
              f"{' '.join(native.CXX_FLAGS)})", flush=True)
        n_big = height_field_obj(big, BIG_CELLS)
        scenes = {
            "cover": cover_scene(width=W, height=H, spp=1,
                                 max_depth=BVH_DEPTH),
            "plane441": mesh_scene(MESH, width=W, height=H, spp=1,
                                   max_depth=BVH_DEPTH),
            "dna": dna_scene(width=W, height=H, spp=1, max_depth=BVH_DEPTH),
            "height256": mesh_scene(big, width=W, height=H, spp=1,
                                    max_depth=BVH_DEPTH),
        }
        tables = {}
        for name, (sdef, cfg) in scenes.items():
            t0 = time.time()
            tables[name] = build_tables(sdef, device=dev, bvh_types=BVH_ALL)
            print(f"  {name}: tables with every family's BVH "
                  f"{tables[name].bvh_for} in {time.time() - t0:.3f} s "
                  f"(counts {tables[name].counts})", flush=True)
        if n_big != 2 * BIG_CELLS * BIG_CELLS or \
                tables["height256"].counts[3] != n_big:
            raise AssertionError("the height field has the wrong size")

        for name, tb in tables.items():
            cfg = scenes[name][1]
            px = torch.arange(W * H, device=dev)
            ro, rd = generate_rays(tb.camera, W, H, px % W, px // W, 0,
                                   cfg.seed, cfg.enable_defocus)
            sub = (torch.linspace(0, W * H - 1, BIG_RAYS, device=dev).long()
                   if name == "height256" else px)
            # (b) primary rays: the walk against the scan
            hb, s_b, reads, _ = timed(lambda: intersect(
                tb, ro, rd, traversal="bvh"))
            rec = dict(bvh_s=s_b, **reads)
            if name == "height256":
                hs, s_s, reads_s, _ = timed(lambda: intersect(
                    tb, ro[sub], rd[sub], traversal="bvh"))
                hl, s_l, _, _ = timed(lambda: linear_hits(
                    intersect, tb, ro[sub], rd[sub]))
                rec.update(bvh_subset_s=s_s, linear_subset_s=s_l,
                           **bvh_vs_linear(hs, hl, f"{name}, {BIG_RAYS} of "
                                           "the primary rays", tb, ro[sub],
                                           rd[sub]))
                print(f"  {name}: walk on all {W * H} rays {s_b:.4f} s "
                      f"({reads}); on {BIG_RAYS} rays {s_s:.4f} s against "
                      f"the scan's {s_l:.4f} s", flush=True)
            else:
                hs = hb
                hl, s_l, _, _ = timed(lambda: linear_hits(intersect, tb, ro,
                                                          rd))
                rec.update(linear_s=s_l, **bvh_vs_linear(hb, hl, name, tb,
                                                         ro, rd))
                print(f"  {name}: walk {s_b:.4f} s ({reads}), scan "
                      f"{s_l:.4f} s", flush=True)
            out["intersect"][name] = rec

            # (a) the native build against the NumPy one: equal arrays, or
            # where centroids tie (the two order tied primitives
            # otherwise, as rt_tpu's two builders do) a valid tree whose
            # walk finds the same hits
            rows = {}
            for fam in tb.bvh_for:
                lo, hi = tb.family_boxes(fam)
                t0 = time.time()
                nat = native.native_build_bvh(lo, hi)
                t_nat = time.time() - t0
                t0 = time.time()
                py = bvh._python_build(lo, hi)
                t_py = time.time() - t0
                prefix = dict(BVH_FAMILIES)[fam]
                keys = tuple(zip(BVH_KEYS, ("obj_id", "left_id", "next_id",
                                            "bmin", "bmax")))
                if not all(np.array_equal(
                        getattr(tb, f"{prefix}_bvh_{k}").cpu().numpy(),
                        nat[v]) for k, v in keys):
                    raise AssertionError(f"{name} {fam}: the tables' BVH "
                                         "is not the native build")
                differ = int(sum((nat[v] != py[v]).reshape(len(py[v]), -1)
                                 .any(-1).sum() for _, v in keys[:1]))
                rec_f = dict(primitives=len(lo), nodes=len(nat["obj_id"]),
                             bytes=sum(int(nat[v].nbytes) for _, v in keys),
                             native_s=t_nat, numpy_s=t_py,
                             leaves_ordered_otherwise=differ)
                if differ or not all(np.array_equal(nat[v], py[v])
                                     for _, v in keys):
                    leaves = np.sort(py["obj_id"][py["obj_id"] >= 0])
                    inner = np.nonzero(py["obj_id"] < 0)[0]
                    kids = np.concatenate([py["left_id"][inner],
                                           py["right_id"][inner]])
                    par = np.concatenate([inner, inner])
                    valid = (np.array_equal(leaves, np.arange(len(lo)))
                             and (py["bmin"][par] <= py["bmin"][kids]).all()
                             and (py["bmax"][par] >= py["bmax"][kids]).all())
                    alt = dataclasses.replace(tb, **{
                        f"{prefix}_bvh_{k}": torch.from_numpy(py[v]).to(dev)
                        for k, v in keys})
                    ha = intersect(alt, ro[sub], rd[sub], traversal="bvh")
                    same_t = torch.equal(torch.where(ha.hit, ha.t, 0.0),
                                         torch.where(hs.hit, hs.t, 0.0))
                    pid_eq = float(((ha.pid == hs.pid) & (
                        ha.ptype == hs.ptype))[hs.hit].float().mean())
                    rec_f.update(numpy_tree_valid=valid, walk_t_equal=same_t,
                                 walk_rows_agree=pid_eq)
                    if not (valid and same_t and pid_eq > 0.999):
                        raise AssertionError(f"{name} {fam}: the NumPy tree "
                                             "is invalid or walks otherwise")
                    verdict = (f"arrays differ on {differ} of "
                               f"{len(nat['obj_id'])} leaf slots (tied "
                               f"centroids), the NumPy tree valid, its walk's "
                               f"t bit-equal and rows agree {pid_eq:.6f} on "
                               f"{sub.numel()} rays")
                else:
                    verdict = "arrays equal"
                print(f"  {name} {fam}: {len(lo)} primitives, "
                      f"{rec_f['nodes']} nodes ({rec_f['bytes'] / 1e6:.2f} "
                      f"MB), native build {t_nat:.4f} s, NumPy build "
                      f"{t_py:.4f} s ({t_py / max(t_nat, 1e-9):.1f}x); "
                      f"{verdict}", flush=True)
                rows[fam] = rec_f
            out["builds"][name] = rows

        # (c) frames: the plain and hybrid engines walk the BVH
        imgs = {}
        for name, engine, trav in (("cover", "plain", "linear"),
                                   ("cover", "plain", "bvh"),
                                   ("cover", "pallas", "bvh"),
                                   ("plane441", "plain", "linear"),
                                   ("plane441", "plain", "bvh"),
                                   ("height256", "plain", "bvh")):
            cfg = scenes[name][1].replace(engine=engine, traversal=trav)
            if trav == "bvh":
                # the whole frame in one trace call: the walk's steps are
                # launch-bound, so tiles would multiply them (the linear
                # frames keep the default tile for their [rays, rows]
                # candidates)
                cfg = cfg.replace(rays_per_batch=W * H)
            img, sec, reads, launches = timed(lambda: render(
                tables[name], cfg, device=dev))
            img = img.cpu().numpy()
            imgs[(name, engine, trav)] = img
            if not np.isfinite(img).all() or img.min() < 0 or img.mean() <= 0:
                raise AssertionError(f"{name} {engine} {trav}: bad frame")
            launched = {k: v for k, v in launches.items() if v}
            print(f"  {name} {engine} {trav} frame {W}x{H} spp 1 depth "
                  f"{BVH_DEPTH}: {sec:.4f} s, mean {img.mean():.5f}, walks "
                  f"{reads}, kernel launches {launched}; {smi}", flush=True)
            out["frames"][f"{name} {engine} {trav}"] = dict(
                s=sec, mean=float(img.mean()), launches=launched, **reads)
            if engine == "pallas" and launched:
                raise AssertionError("the hybrid frame with the BVH launched "
                                     "B1 on a sphere-only scene")
        for name, engine in (("cover", "plain"), ("cover", "pallas"),
                             ("plane441", "plain")):
            # at spp 1 an outlier pixel is one path whose hit flipped, and
            # a path carries at most the gradient sky's brightest value,
            # 1.0 (no emitter, every attenuation <= 1)
            frac, mx = images_close(imgs[(name, engine, "bvh")],
                                    imgs[(name, "plain", "linear")], 1,
                                    outlier_atol=1.0)
            print(f"  {name} {engine} bvh against plain linear: "
                  f"images_close ({frac:.4%} pixels beyond 2e-3, max "
                  f"{mx:.4g})", flush=True)

        # (d) the CLI and the library on demo_scene.json: the kernels read
        # no BVH; the plain engine walks it
        log = os.path.join(tmpd, "t.log")
        pngs = {}
        for label, extra in (("queue --bvh", ["--bvh"]), ("queue", []),
                             ("plain --bvh", ["--engine", "plain", "--bvh",
                                              "-spp", "2", "-d", "8"]),
                             ("plain", ["--engine", "plain", "-spp", "2",
                                        "-d", "8"])):
            p = os.path.join(tmpd, label.replace(" ", "_") + ".png")
            rc, sec, reads, launches = timed(lambda: cli.main(
                ["render", "-f", DEMO, "-o", p, "--log", log] + extra))
            launched = {k: v for k, v in launches.items() if v}
            print(f"  render -f demo_scene.json {' '.join(extra)}: exit {rc},"
                  f" {sec:.4f} s, walks {reads}, launches {launched}",
                  flush=True)
            if rc != 0:
                raise AssertionError(f"render {label} exited {rc}")
            pngs[label] = read_png(p)
            out["cli"][label] = dict(s=sec, launches=launched, **reads)
        if not np.array_equal(pngs["queue --bvh"], pngs["queue"]):
            raise AssertionError("render --bvh on queue differs from render")
        sd, dcfg = parse_scene(DEMO)
        with_bvh = build_tables(sd, device=dev, bvh_types=BVH_ALL)
        plain_t = build_tables(sd, device=dev)
        for engine, extra in (("queue", {}), ("mega", {"regen": True})):
            c = dcfg.replace(engine=engine, **extra)
            a = render(with_bvh, c.replace(traversal="bvh"), device=dev)
            b = render(plain_t, c, device=dev)
            if not torch.equal(a, b):
                raise AssertionError(f"{engine} {extra}: the frame with BVHs "
                                     "differs")
            print(f"  library {engine} {extra} 960x540 spp "
                  f"{dcfg.samples_per_pixel} depth {dcfg.max_depth}: tables "
                  f"with BVHs under traversal 'bvh' bit-equal to without",
                  flush=True)
        c = dcfg.replace(engine="plain", samples_per_pixel=2, max_depth=8)
        frac, mx = images_close(
            render(with_bvh, c.replace(traversal="bvh"), device=dev).cpu(),
            render(plain_t, c, device=dev).cpu(), 2)
        print(f"  plain --bvh against plain on demo_scene.json (spp 2, depth "
              f"8): images_close ({frac:.4%} beyond 2e-3, max {mx:.4g})",
              flush=True)
        out["cli"]["bit_equal"] = ["queue --bvh", "library queue",
                                   "library regen"]
    tmp_dir.cleanup()
    return out


def example_phase(dev, smi):
    """Phase 56: every demo of rt_tpu_torch/examples/inverse_render.py at
    its own size on the card (--steps 3 where a demo takes it; the albedo
    demo at its default 80 steps, which must exit 0; position at 20 of
    its 60), each one's loss falling, its seconds per step and each
    kernel's launches (its --sharded runs in phase 58). Returns the
    numbers for the kernels line."""
    from rt_tpu_torch.examples import inverse_render as ex

    out = {}
    tmp_dir = tempfile.TemporaryDirectory()
    tmpd = tmp_dir.name

    def args(*extra):
        return ex.make_parser().parse_args(["--outdir", tmpd, *extra])

    texture = np.random.default_rng(23).random((100, 100, 3)).astype(
        np.float32)
    three = args("--steps", "3")
    demos = (
        ("albedo (autograd, 80 steps)", lambda: ex.albedo_demo(args()), 80,
         True),
        ("albedo --replay", lambda: ex.albedo_demo(
            args("--steps", "3", "--replay")), 3, False),
        # 20 of the demo's 60 fit_fd steps: its plain-engine steps are
        # host-bound (1.2-1.5 s each), and the run's time limit is shared
        ("position (fit_fd, 20 steps)", lambda: ex.position_demo(steps=20),
         20, False),
        ("grad-1080p", lambda: ex.grad_1080p_demo(three), 1, True),
        ("material-geom", lambda: ex.material_geom_demo(three), 3, False),
        ("joint-1080p", lambda: ex.joint_1080p_demo(three), 3, False),
        ("cover-albedo", lambda: ex.cover_albedo_demo(three), 3, False),
        ("camera", lambda: ex.camera_demo(three), 3, False),
        ("tape-1080p", lambda: ex.tape_1080p_demo(three), 1, True),
        ("texture (a seeded 100x100 image)", lambda: ex.texture_demo(
            three, image=texture), 3, False),
    )
    with phase("56 the example: python -m rt_tpu_torch.examples."
               "inverse_render, every demo at its own size"):
        for label, fn, steps, must_pass in demos:
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.time()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                code, hist = fn()
            torch.cuda.synchronize()
            sec = time.time() - t0
            launched = {k: v for k, v in read_counts().items() if v}
            for line in buf.getvalue().splitlines():
                print(f"    {line}")
            print(f"  {label}: exit {code}, loss {hist[0]:.6g} -> "
                  f"{hist[-1]:.6g}, {sec:.3f} s ({sec / steps:.4f} s a step "
                  f"over {steps}), launches {launched}; {smi}", flush=True)
            if not hist[-1] < hist[0] or (must_pass and code != 0):
                raise AssertionError(f"{label}: exit {code}, loss {hist}")
            out[label] = dict(exit=code, loss=[hist[0], hist[-1]], s=sec,
                              s_per_step=sec / steps, launches=launched)
    tmp_dir.cleanup()
    return out


# phases 57-58: multi-process rendering and training (rt_tpu_torch/
# parallel/). Phase 58's size: cover_scene at PAR_W x PAR_H, spp PAR_SPP,
# depth PAR_DEPTH; its fits take PAR_STEPS steps; the example's joint
# demo runs at PAR_W x PAR_H for its default 80 steps.
PAR_W, PAR_H, PAR_SPP, PAR_DEPTH, PAR_STEPS = 320, 180, 4, 8, 3
PAR_MESHES = ((2, 1), (1, 2))
PAR_FITS = (("replay_queue", "replay", "queue", ("tex_color", "mat_albedo")),
            ("replay_mega", "replay", "mega", ("tex_color", "mat_albedo")),
            ("tape", "tape", "mega", ("tex_color", "mat_albedo")))
# the fields of phase 58's tape gradient (make_tape_vg, one call): the
# geometry is held by its gradient, not by fits: Adam divides a
# gradient by its own magnitude (plus eps 1e-8), so a component whose
# gradient nearly cancels (a sphere's x seen head-on) moves by up to lr
# times the relative rounding of its sum, which the ranks' order of
# summation changes (my CPU check on cover 32x18: 31 of 1,464 sph_center
# gradients below 1e-8, the fit's parameters 3e-6 apart after 3 steps
# while every gradient agreed within 2.4e-10)
PAR_TAPE_VG = ("sph_center", "sph_radius", "mat_albedo")


def par_scene():
    """Phase 58's tables (on the CPU), config and fit target."""
    from rt_tpu_torch.scene.builders import cover_scene
    from rt_tpu_torch.scene.types import build_tables

    sdef, cfg = cover_scene(width=PAR_W, height=PAR_H, spp=PAR_SPP,
                            max_depth=PAR_DEPTH)
    return build_tables(sdef), cfg, np.full((PAR_H, PAR_W, 3), 0.3,
                                            np.float32)


def par_checkpoint_args(outdir: str, sharded: bool):
    """The CLI's checkpointed render of phase 58: cover at PAR_W x PAR_H,
    spp PAR_SPP, depth PAR_DEPTH on queue, a checkpoint every sample,
    with --sharded into outdir/sharded.*, else into outdir/single.*."""
    name = os.path.join(outdir, "sharded" if sharded else "single")
    return (["render", "--coded", "cover", "-w", str(PAR_W), "--height",
             str(PAR_H), "-spp", str(PAR_SPP), "-d", str(PAR_DEPTH),
             "--checkpoint-every", "1", "--checkpoint", name + ".npz", "-o",
             name + ".png", "--log", name + ".log"]
            + (["--sharded"] if sharded else []))


def parallel_rank(rank: int, outdir: str) -> int:
    """Phase 58's rank `rank` of two, both on cuda:0 in one gloo group
    (init_distributed with explicit arguments, a file store in outdir):
    render_sharded_ex on meshes (2, 1) and (1, 2) on queue and mega, the
    PAR_FITS fits over the (2, 1) mesh, the example's joint demo with
    --sharded, and `render --sharded --checkpoint` through the CLI's
    main. Writes outdir/rank{rank}.npz (images, histories, parameters,
    the tape's gradients summed over the ranks) and .json (seconds,
    launches, the demo's exit code and printout, the checkpointed
    render's exit code and the samples_done of each checkpoint this rank
    saved)."""
    from rt_tpu_torch import cli
    from rt_tpu_torch.diff import inverse
    from rt_tpu_torch.diff.tape import make_tape_vg
    from rt_tpu_torch.examples import inverse_render as ex
    from rt_tpu_torch.parallel import distributed
    from rt_tpu_torch.parallel.mesh import make_mesh
    from rt_tpu_torch.parallel.sharded import render_sharded_ex
    from rt_tpu_torch.render import progressive

    dev = distributed.init_distributed(
        device="cuda", backend="gloo", rank=rank, world_size=2,
        init_method=f"file://{os.path.join(outdir, 'store')}",
        timeout_s=600.0)
    arrays, info = {}, {"device": str(dev)}

    def timed(fn):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        res = fn()
        torch.cuda.synchronize()
        return res, dict(s=time.time() - t0, launches={
            k: v for k, v in read_counts().items() if v})

    try:
        tables, cfg, target = par_scene()
        for shape in PAR_MESHES:
            mesh = make_mesh(shape)
            for engine in ("queue", "mega"):
                key = f"{shape[0]}x{shape[1]}_{engine}"
                (img, spp), info[key] = timed(lambda: render_sharded_ex(
                    tables, cfg.replace(engine=engine), mesh))
                arrays[key] = img
                info[key]["spp"] = spp
        mesh = make_mesh()
        tdev = tables.to(dev)
        rows = inverse._pixel_rows(cfg, target, dev, mesh)
        vg = make_tape_vg(tdev, cfg.replace(engine="mega"), *rows[:3],
                          spp=PAR_SPP, n_valid=rows[4], row_offset=rows[3])
        (loss, grads), info["tape_vg"] = timed(lambda: vg(
            {k: getattr(tdev, k).clone() for k in PAR_TAPE_VG}))
        summed = mesh.all_reduce_sum([loss] + [grads[k]
                                               for k in PAR_TAPE_VG])
        for k, v in zip(("loss",) + PAR_TAPE_VG, summed):
            arrays[f"tape_vg_{k}"] = v.cpu().numpy()
        for name, method, engine, fields in PAR_FITS:
            (rec, hist), info[name] = timed(lambda: inverse.fit(
                tables, cfg.replace(engine=engine), target, fields=fields,
                spp=PAR_SPP, steps=PAR_STEPS, method=method, mesh=mesh))
            arrays[f"{name}_history"] = np.asarray(hist)
            for k, v in rec.items():
                arrays[f"{name}_{k}"] = v
        buf = io.StringIO()
        args = ex.make_parser().parse_args(
            ["--sharded", "--outdir", os.path.join(outdir, f"ex{rank}")])
        with contextlib.redirect_stdout(buf):
            (code, hist), info["example"] = timed(
                lambda: ex.joint_1080p_demo(args, PAR_W, PAR_H))
        info["example"].update(code=code, printout=buf.getvalue())
        arrays["example_history"] = np.asarray(hist)
        # render --sharded --checkpoint through the CLI in this group,
        # each rank's checkpoint saves counted
        saves, save = [], progressive.Checkpoint.save

        def counted(ck, path):
            saves.append(ck.samples_done)
            save(ck, path)

        progressive.Checkpoint.save = counted
        try:
            rc, info["checkpoint"] = timed(lambda: cli.main(
                par_checkpoint_args(outdir, sharded=True)))
        finally:
            progressive.Checkpoint.save = save
        info["checkpoint"].update(code=rc, saves=saves)
    finally:
        distributed.shutdown_distributed()
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(info, f)
    return 0


def parallel_phases(dev, smi, c16, t16):
    """Phases 57-58: a NCCL world of one at the bench shape
    (render_sharded_ex on queue and mega bit-equal to render, `render
    --sharded` under torchrun PNG-equal to `render`), then two ranks on
    the one card over gloo (renders on meshes (2, 1) and (1, 2), three
    fits over the (2, 1) mesh held to the same fits in one process, the
    example's joint demo with --sharded). Returns their numbers for the
    kernels line."""
    import torch.distributed as dist

    from rt_tpu_torch import cli
    from rt_tpu_torch.diff import inverse
    from rt_tpu_torch.diff.tape import make_tape_vg
    from rt_tpu_torch.io.image import read_png
    from rt_tpu_torch.parallel import distributed
    from rt_tpu_torch.parallel.mesh import make_mesh
    from rt_tpu_torch.parallel.sharded import render_sharded_ex
    from rt_tpu_torch.render.renderer import render

    out = {"p57": {}, "p58": {}}
    tmp_dir = tempfile.TemporaryDirectory()
    tmpd = tmp_dir.name
    with phase(f"57 a NCCL world of one at {W}x{H} spp {MAIN_SPP} depth "
               f"{DEPTH}: render_sharded_ex on queue and mega against "
               "render, render --sharded under torchrun"):
        dev1 = distributed.init_distributed(
            device="cuda", rank=0, world_size=1,
            init_method=f"file://{os.path.join(tmpd, 'store57')}",
            timeout_s=600.0)
        try:
            mesh = make_mesh()
            print(f"  backend {dist.get_backend()}, {mesh}", flush=True)
            if dist.get_backend() != "nccl" or mesh.group is None or \
                    mesh.device != dev1:
                raise AssertionError("phase 57 is not a NCCL group of one")
            for engine in ("queue", "mega"):
                cfg_e = c16.replace(engine=engine)
                own = "queue_launch" if engine == "queue" else "mega_segment"
                render(t16, cfg_e, device="cuda")  # warm-up
                torch.cuda.synchronize()
                t0 = time.time()
                want = render(t16, cfg_e, device="cuda")
                torch.cuda.synchronize()
                sec_r = time.time() - t0
                want = want.cpu().numpy()
                render_sharded_ex(t16, cfg_e, mesh)  # warm-up (NCCL's setup)
                reset_counts()
                t0 = time.time()
                img, spp = render_sharded_ex(t16, cfg_e, mesh)
                sec_s = time.time() - t0
                counts = {k: v for k, v in read_counts().items() if v}
                equal = bool(np.array_equal(img, want))
                print(f"  {engine}: render {sec_r:.4f} s, render_sharded_ex "
                      f"{sec_s:.4f} s (spp {spp}, launches {counts}), "
                      f"bit-equal {equal}; {smi}", flush=True)
                if not equal or spp != MAIN_SPP or counts.get(own, 0) <= 0:
                    raise AssertionError(f"57 {engine}: the sharded frame "
                                         "differs or launched no kernel")
                out["p57"][engine] = dict(render_s=sec_r, sharded_s=sec_s,
                                          launches=counts)
        finally:
            distributed.shutdown_distributed()

        size = ["--coded", "cover", "-w", str(W), "--height", str(H),
                "-spp", str(MAIN_SPP), "-d", str(DEPTH)]
        png_s = os.path.join(tmpd, "sharded.png")
        png_u = os.path.join(tmpd, "render.png")
        log = os.path.join(tmpd, "t.log")
        t0 = time.time()
        # no --log: torchrun's own parser (Python 3.12.3) reads it as an
        # ambiguous prefix of --log-dir; the log goes to the default
        # rt_tpu_torch-time.log in the working directory, tmpd
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "1", "-m", "rt_tpu_torch", "render",
             "--sharded", "-o", png_s] + size, cwd=tmpd,
            env={**os.environ, "PYTHONPATH": ROOT}, capture_output=True,
            text=True, timeout=600)
        sec_cli = time.time() - t0
        last = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() \
            else proc.stderr[-2000:]
        print(f"  torchrun --nproc-per-node 1 render --sharded: exit "
              f"{proc.returncode} in {sec_cli:.2f} s: {last}", flush=True)
        if proc.returncode != 0 or "sharded over 1 rank(s)" not in last:
            raise AssertionError("render --sharded under torchrun failed")
        reset_counts()
        rc = cli.main(["render", "-o", png_u, "--log", log] + size)
        same = bool(np.array_equal(read_png(png_s), read_png(png_u)))
        print(f"  render (no --sharded): exit {rc}, PNG equal {same}",
              flush=True)
        if rc != 0 or not same:
            raise AssertionError("render --sharded's PNG != render's")
        out["p57"]["cli"] = dict(torchrun_s=sec_cli, png_equal=same)

    with phase(f"58 two ranks on one card over gloo: meshes {PAR_MESHES} "
               f"at {PAR_W}x{PAR_H} spp {PAR_SPP} depth {PAR_DEPTH}, "
               f"{PAR_STEPS}-step fits, the example's --sharded, render "
               "--sharded --checkpoint"):
        d58 = os.path.join(tmpd, "p58")
        os.makedirs(d58)
        t0 = time.time()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--parallel-rank",
             str(r), d58], cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, start_new_session=True)
            for r in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=900)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    os.killpg(p.pid, 9)
                    p.wait()
        sec_ranks = time.time() - t0
        for r, (p, text) in enumerate(zip(procs, logs)):
            print(f"  rank {r}: exit {p.returncode} ({sec_ranks:.2f} s for "
                  f"both)", flush=True)
            if p.returncode != 0:
                print(text[-6000:], flush=True)
                raise AssertionError(f"58: rank {r} failed")
        arrs = [dict(np.load(os.path.join(d58, f"rank{r}.npz")))
                for r in range(2)]
        infos = [json.load(open(os.path.join(d58, f"rank{r}.json")))
                 for r in range(2)]
        for k in arrs[0]:
            if not np.array_equal(arrs[0][k], arrs[1][k]):
                raise AssertionError(f"58: {k} differs between the ranks")
        print(f"  devices {[i['device'] for i in infos]}; every array of "
              f"the two ranks equal bit for bit ({len(arrs[0])} arrays)",
              flush=True)
        tables, cfg, target = par_scene()
        for engine in ("queue", "mega"):
            want = render(tables, cfg.replace(engine=engine),
                          device="cuda").cpu().numpy()
            for shape in PAR_MESHES:
                key = f"{shape[0]}x{shape[1]}_{engine}"
                got = arrs[0][key]
                diff = float(np.abs(got - want).max())
                exact = bool(np.array_equal(got, want))
                print(f"  {key}: {infos[0][key]['s']:.4f} / "
                      f"{infos[1][key]['s']:.4f} s, launches "
                      f"{infos[0][key]['launches']} / "
                      f"{infos[1][key]['launches']}, bit-equal {exact}, "
                      f"max abs diff {diff:.4g}; {smi}", flush=True)
                ok = exact if shape[1] == 1 else np.allclose(
                    got, want, rtol=1e-5, atol=1e-5)
                if not ok or infos[0][key]["spp"] != PAR_SPP:
                    raise AssertionError(f"58 {key}: frame != render")
                out["p58"][key] = dict(
                    s=[i[key]["s"] for i in infos], bit_equal=exact,
                    max_abs_diff=diff,
                    launches=[i[key]["launches"] for i in infos])
        tdev = tables.to("cuda")
        px, py, tgt = inverse._frame(cfg, target, tdev.sph_center.device)
        loss, grads = make_tape_vg(tdev, cfg.replace(engine="mega"), px, py,
                                   tgt, spp=PAR_SPP)(
            {k: getattr(tdev, k).clone() for k in PAR_TAPE_VG})
        errs = {}
        for k, v in [("loss", loss)] + [(k, grads[k]) for k in PAR_TAPE_VG]:
            v = v.cpu().numpy()
            got = arrs[0][f"tape_vg_{k}"]
            errs[k] = float(np.abs(got - v).max())
            if not np.allclose(got, v, rtol=1e-5, atol=1e-7):
                raise AssertionError(f"58 tape_vg: {k} differs from one "
                                     f"process's by {errs[k]}")
        print(f"  the tape's gradient (make_tape_vg, {PAR_TAPE_VG}) summed "
              f"over the ranks: {infos[0]['tape_vg']['s']:.4f} s, launches "
              f"{infos[0]['tape_vg']['launches']} / "
              f"{infos[1]['tape_vg']['launches']}; max abs diff to one "
              f"process {errs} (largest gradient "
              f"{float(grads['sph_center'].abs().max()):.4g}); {smi}",
              flush=True)
        out["p58"]["tape_vg"] = dict(
            s=[i["tape_vg"]["s"] for i in infos], max_abs_diff=errs,
            launches=[i["tape_vg"]["launches"] for i in infos])
        for name, method, engine, fields in PAR_FITS:
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.time()
            rec, hist = inverse.fit(
                tables, cfg.replace(engine=engine), target, fields=fields,
                spp=PAR_SPP, steps=PAR_STEPS, method=method, device="cuda")
            torch.cuda.synchronize()
            sec = time.time() - t0
            errs = {}
            for k, v in [("history", np.asarray(hist))] + sorted(
                    rec.items()):
                got = arrs[0][f"{name}_{k}"]
                errs[k] = float(np.abs(got - v).max())
                if not np.allclose(got, v, rtol=1e-5, atol=1e-7):
                    raise AssertionError(
                        f"58 {name}: {k} differs from one process's fit "
                        f"by {errs[k]}")
            print(f"  fit {name}: 2 ranks {infos[0][name]['s']:.4f} s "
                  f"(launches {infos[0][name]['launches']} / "
                  f"{infos[1][name]['launches']}), one process {sec:.4f} s "
                  f"(launches {dict((k, v) for k, v in read_counts().items() if v)}); loss {hist[0]:.6g} -> "
                  f"{hist[-1]:.6g}, max abs diff to one process {errs}; "
                  f"{smi}", flush=True)
            if not hist[-1] < hist[0]:
                raise AssertionError(f"58 {name}: the loss did not fall")
            out["p58"][name] = dict(
                s=[i[name]["s"] for i in infos], single_s=sec,
                max_abs_diff=errs,
                launches=[i[name]["launches"] for i in infos])
        exs = [i["example"] for i in infos]
        for r, e in enumerate(exs):
            for line in e["printout"].splitlines():
                print(f"    rank {r}: {line}")
        hist = arrs[0]["example_history"]
        print(f"  the example's --sharded joint demo at {PAR_W}x{PAR_H}: "
              f"exit {[e['code'] for e in exs]}, {exs[0]['s']:.2f} s, loss "
              f"{hist[0]:.6g} -> {hist[-1]:.6g}, launches "
              f"{exs[0]['launches']}; {smi}", flush=True)
        if any(e["code"] != 0 for e in exs) or any(
                "sharded fit over 2 device(s)" not in e["printout"]
                for e in exs):
            raise AssertionError("58: the example's --sharded failed")
        out["p58"]["example"] = dict(s=exs[0]["s"], code=exs[0]["code"],
                                     launches=[e["launches"] for e in exs])
        cks = [i["checkpoint"] for i in infos]
        reset_counts()
        rc = cli.main(par_checkpoint_args(d58, sharded=False))
        single = {k: v for k, v in read_counts().items() if v}
        same = bool(np.array_equal(
            read_png(os.path.join(d58, "sharded.png")),
            read_png(os.path.join(d58, "single.png"))))
        print(f"  render --sharded --checkpoint --checkpoint-every 1 at "
              f"{PAR_W}x{PAR_H} spp {PAR_SPP}: exit "
              f"{[c['code'] for c in cks]}, {cks[0]['s']:.2f} s, "
              f"checkpoints saved per rank {[c['saves'] for c in cks]}, "
              f"launches {[c['launches'] for c in cks]}; one process: exit "
              f"{rc}, launches {single}; PNG equal {same}; {smi}",
              flush=True)
        if [c["code"] for c in cks] != [0, 0] or rc != 0 or not same or [
                c["saves"] for c in cks] != [list(range(1, PAR_SPP + 1)),
                                             []]:
            raise AssertionError("58: render --sharded --checkpoint had "
                                 "another writer than rank 0, or its PNG "
                                 "differs from one process's")
        out["p58"]["checkpoint"] = dict(
            s=cks[0]["s"], saves=[c["saves"] for c in cks], png_equal=same,
            launches=[c["launches"] for c in cks])
    tmp_dir.cleanup()
    return out


def oracle_phase(smi):
    """Phase 59: the port's NumPy oracle (rt_tpu_torch.render.oracle)
    against the queue (B3) and regen (B7) frames at the reference's
    oracle size, 24x14, spp 4, depth 6: three_sphere, cover with the
    gradient sky, and cover_scene(lights=True) with NEE on queue (regen
    renders no NEE). Returns the launches and outlier shares."""
    from rt_tpu_torch.render.oracle import render_oracle
    from rt_tpu_torch.render.renderer import render
    from rt_tpu_torch.scene.builders import cover_scene, three_sphere_scene
    from rt_tpu_torch.scene.types import build_tables

    size = dict(width=24, height=14, spp=4, max_depth=6)
    scenes = (("three_sphere", three_sphere_scene(**size), {}),
              ("cover_gradient_sky", cover_scene(grid=2, **size), {}),
              ("cover_lights_nee", cover_scene(grid=2, lights=True, **size),
               {"nee": True}))
    out = {}
    with phase("59 the NumPy oracle against B3 and B7 frames at 24x14 spp "
               "4 depth 6"):
        for name, (sdef, cfg), extra in scenes:
            cfg = cfg.replace(**extra)
            t0 = time.time()
            want = render_oracle(sdef, cfg)
            sec = time.time() - t0
            tables = build_tables(sdef)
            engines = {"queue": cfg.replace(engine="queue")}
            if not cfg.nee:
                engines["regen"] = cfg.replace(engine="mega", regen=True)
            for label, c in engines.items():
                reset_counts()
                img = render(tables, c, device="cuda").cpu().numpy()
                counts = {k: v for k, v in read_counts().items() if v}
                own = "queue_launch" if label == "queue" else "mega_regen"
                frac, mx = images_close(img, want, cfg.samples_per_pixel)
                print(f"  {name} {label}: oracle {sec:.2f} s, launches "
                      f"{counts}, {frac:.4%} pixels beyond 2e-3, max diff "
                      f"{mx:.4g}; {smi}", flush=True)
                if counts.get(own, 0) <= 0:
                    raise AssertionError(f"59 {name} {label}: no {own}")
                out[f"{name} {label}"] = dict(launches=counts,
                                              outlier_frac=frac, max_diff=mx)
    return out


# phase 61: cover at 320x180, spp 2, depth 8 (the replay at 96x54)
SCAN_W, SCAN_H, SCAN_SPP, SCAN_DEPTH = 320, 180, 2, 8
# roulette at which every lane of cover dies before the last bounce
SCAN_RR, SCAN_RR_DEPTH = 0.5, 16
REPLAY_W, REPLAY_H = 96, 54
# rt_tpu.config.RenderConfig's defaults (rt_tpu/config.py), field by
# field: a configuration a user of the reference carries over
RT_TPU_DEFAULTS = {
    "width": 400, "height": 225, "samples_per_pixel": 16, "max_depth": 8,
    "background_mode": "constant", "exhaust_mode": "black",
    "enable_defocus": False, "p_rr": 0.0, "seed": 0, "sampler": "rng",
    "nee": False, "mis": False, "nee_glossy": False, "engine": "xla",
    "loop": "while", "traversal": "linear", "rays_per_batch": 131072,
    "compact_every": 0, "compact_group": 128, "compact_schedule": (),
    "cull_chunks": True, "mxu_intersect": False, "compact_shrink": True,
    "compact_sort": "dead", "regen": False, "regen_compact": 0,
    "regen_shrink": True, "queue_steps": 0}


def interface_phase(dev, smi):
    """Phase 61, what rt_tpu offers beside its engines: loop "scan"
    against "while" on the hybrid (B1 once a bounce) and plain engines,
    bit for bit, at depth 8 and under roulette at depth 16, where the
    "while" loop ends first and the fixed trip runs on; the engine name
    "xla" (rt_tpu's default configuration carried over) against
    "plain", bit for bit; the path replay's loss on queue (B3), roulette
    depth 16, with bwd_engine None / "plain" / "mega" (B5) / "queue"
    (B6) and bwd_early_exit off and on, each gradient within 1e-5 +
    1e-3 max|g| of bwd_engine=None's; and B7 with the frame size given
    (mega_trace_regen(width=, height=), under a config of another size)
    against the default, bit for bit. Returns the numbers for the
    kernels line."""
    from rt_tpu_torch.config import RenderConfig
    from rt_tpu_torch.diff.replay import make_replay_loss_fn
    from rt_tpu_torch.ops import cuda_mega
    from rt_tpu_torch.render.renderer import render
    from rt_tpu_torch.scene.builders import cover_scene
    from rt_tpu_torch.scene.types import build_tables

    out = {"loops": {}, "replay": {}}
    t_phase = time.time()
    with phase(f"61 loop scan, engine xla, the replay's bwd_engine and "
               f"bwd_early_exit, B7's frame size: cover {SCAN_W}x{SCAN_H} "
               f"spp {SCAN_SPP} depth {SCAN_DEPTH}"):
        sdef, cfg = cover_scene(width=SCAN_W, height=SCAN_H, spp=SCAN_SPP,
                                max_depth=SCAN_DEPTH)
        tables = build_tables(sdef, device=dev)

        def run(fn):
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.time()
            res = fn()
            torch.cuda.synchronize()
            return res, time.time() - t0, {k: v for k, v in
                                           read_counts().items() if v}

        # depth 8: some lane lives to the last bounce; roulette at depth
        # 16: every lane dies before it, and only "scan" runs the
        # bounces after
        cases = {"": cfg, " roulette": cfg.replace(
            p_rr=SCAN_RR, max_depth=SCAN_RR_DEPTH)}
        for (label, c_loop), engine in itertools.product(
                cases.items(), ("pallas", "plain")):
            render(tables, c_loop.replace(engine=engine),
                   device="cuda")  # warm
            imgs = {}
            for loop in ("while", "scan"):
                stats = {}
                imgs[loop], sec, counts = run(lambda: render(
                    tables, c_loop.replace(engine=engine, loop=loop),
                    device="cuda", stats=stats))
                out["loops"][f"{engine}{label} {loop}"] = dict(
                    s=sec, bounces=stats["bounces"], launches=counts)
            equal = bool(torch.equal(imgs["while"], imgs["scan"]))
            rec = {k: out["loops"][f"{engine}{label} {k}"] for k in imgs}
            b1 = {k: v["launches"].get("sphere_closest_hit", 0)
                  for k, v in rec.items()}
            print(f"  {engine}{label} depth {c_loop.max_depth} p_rr "
                  f"{c_loop.p_rr}: loop while {rec['while']['s']:.4f} s "
                  f"({rec['while']['bounces']} bounces, B1 launches "
                  f"{b1['while']}), scan {rec['scan']['s']:.4f} s "
                  f"({rec['scan']['bounces']} bounces, B1 launches "
                  f"{b1['scan']}), bit-equal {equal}; {smi}", flush=True)
            trip = SCAN_SPP * c_loop.max_depth
            want_b1 = trip if engine == "pallas" else 0
            if not equal or b1["scan"] != want_b1 or (
                    engine == "pallas") != (b1["while"] > 0):
                raise AssertionError(f"61 {engine}{label}: scan != while, "
                                     "or B1 launched otherwise than once a "
                                     "bounce")
            fewer = rec["while"]["bounces"] < trip and (
                engine == "plain" or b1["while"] < b1["scan"])
            if rec["scan"]["bounces"] != trip or (label and not fewer):
                raise AssertionError(f"61 {engine}{label}: the fixed trip "
                                     "ran no bounce after the while loop's "
                                     "end")

        carried = RenderConfig(**RT_TPU_DEFAULTS).replace(
            width=SCAN_W, height=SCAN_H, samples_per_pixel=SCAN_SPP,
            max_depth=SCAN_DEPTH)
        xla, sec_x, _ = run(lambda: render(tables, carried, device="cuda"))
        plain, sec_p, _ = run(lambda: render(
            tables, carried.replace(engine="plain"), device="cuda"))
        equal = bool(torch.equal(xla, plain))
        print(f"  rt_tpu's default config carried over (engine "
              f"{carried.engine!r}): {sec_x:.4f} s, engine 'plain' "
              f"{sec_p:.4f} s, bit-equal {equal}", flush=True)
        if not equal:
            raise AssertionError("61: engine xla != plain")
        out["xla"] = dict(s=sec_x, plain_s=sec_p, bit_equal=equal)

        sdef_r, cfg_r = cover_scene(width=REPLAY_W, height=REPLAY_H, spp=1,
                                    max_depth=SCAN_DEPTH)
        t_r = build_tables(sdef_r, device=dev)
        # roulette at depth 16: the early exit skips the bounces after
        # the last lane's death
        cfg_r = cfg_r.replace(engine="queue", p_rr=SCAN_RR,
                              max_depth=SCAN_RR_DEPTH)
        pix = torch.arange(REPLAY_W * REPLAY_H, device=dev)
        tgt = torch.full((pix.shape[0], 3), 0.3, device=dev)
        grads, own = {}, {None: "queue_adjoint_launch", "plain": None,
                          "mega": "mega_adjoint_segment",
                          "queue": "queue_adjoint_launch"}

        def step(bwd_engine, early):
            p = {k: getattr(t_r, k).clone().requires_grad_(True)
                 for k in GRAD_FIELDS}
            make_replay_loss_fn(t_r, cfg_r, 1, pix % REPLAY_W,
                                pix // REPLAY_W, tgt, bwd_engine,
                                bwd_early_exit=early)(p).backward()
            return p

        for bwd_engine in own:
            step(bwd_engine, False)  # warm-up
            for early in (False, True):
                p, sec, counts = run(lambda: step(bwd_engine, early))
                key = f"{bwd_engine} early_exit {early}"
                grads[key] = {k: v.grad for k, v in p.items()}
                adj = {k: counts.get(k, 0) for k in (
                    "queue_adjoint_launch", "mega_adjoint_segment")}
                print(f"  replay bwd_engine {bwd_engine!r}, bwd_early_exit "
                      f"{early}: {sec:.4f} s, launches {counts}", flush=True)
                if (own[bwd_engine] is None and any(adj.values())) or (
                        own[bwd_engine] is not None and (
                            adj[own[bwd_engine]] <= 0 or sum(
                                adj.values()) != adj[own[bwd_engine]])):
                    raise AssertionError(f"61 replay {key}: adjoint "
                                         f"launches {adj}")
                err = 0.0 if key == "None early_exit False" else grads_close(
                    grads["None early_exit False"], grads[key],
                    f"61 {key} against bwd_engine None")
                out["replay"][key] = dict(s=sec, launches=counts,
                                          max_abs_err=err)

        c_mega = cfg.replace(engine="mega")
        px = torch.arange(SCAN_W * SCAN_H, device=dev)
        cuda_mega.mega_trace_regen(tables, c_mega, px, px // SCAN_W, 0,
                                   SCAN_SPP)  # warm-up
        want, sec_d, cnt_d = run(lambda: cuda_mega.mega_trace_regen(
            tables, c_mega, px, px // SCAN_W, 0, SCAN_SPP))
        got, sec_g, cnt_g = run(lambda: cuda_mega.mega_trace_regen(
            tables, c_mega.replace(width=2 * SCAN_W, height=2 * SCAN_H), px,
            px // SCAN_W, 0, SCAN_SPP, 0, SCAN_W, SCAN_H))
        equal = bool(torch.equal(want, got))
        print(f"  B7 with width={SCAN_W}, height={SCAN_H} under a "
              f"{2 * SCAN_W}x{2 * SCAN_H} config: {sec_g:.4f} s, launches "
              f"{cnt_g}; cfg's size {sec_d:.4f} s, launches {cnt_d}; "
              f"bit-equal {equal}; {smi}", flush=True)
        if not equal or cnt_g.get("mega_regen", 0) <= 0:
            raise AssertionError("61: B7 with the frame size given != cfg's")
        out["regen_size"] = dict(s=sec_g, default_s=sec_d, bit_equal=equal,
                                 launches=cnt_g["mega_regen"])
        sec = time.time() - t_phase
        if sec > 60.0:
            raise AssertionError(f"61 took {sec:.2f} s (at most 60)")
    return out


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in counters().items()}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script needs a GPU")

    from rt_tpu_torch.ops import cuda_build, cuda_intersect, cuda_mega
    from rt_tpu_torch.ops import cuda_queue
    from rt_tpu_torch.scene.builders import cornell_spheres_scene
    from rt_tpu_torch.ops.camera import generate_rays
    from rt_tpu_torch.render import film
    from rt_tpu_torch.render.renderer import render
    from rt_tpu_torch.io.image import read_png
    from rt_tpu_torch.scene.builders import cover_scene
    from rt_tpu_torch.scene.builders import random_spheres_scene
    from rt_tpu_torch.scene.types import build_tables
    from rt_tpu_torch.diff.inverse import fit
    from rt_tpu_torch.diff.replay import make_replay_loss_fn

    t_all = time.time()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    with phase("1 device"):
        name = torch.cuda.get_device_name(0)
        try:
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                check=True).stdout.strip().splitlines()[0]
        except FileNotFoundError:
            smi = f"{name}, power limit not readable (no nvidia-smi)"
        print(smi)
        found = {m: importlib.util.find_spec(m) is not None
                 for m in ("triton", "PIL", "jax")}  # looked up, not imported
        print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
              f"CUDA {torch.version.cuda}, nvcc {cuda_build.find_nvcc()}, "
              f"devices {torch.cuda.device_count()}, installed {found}",
              flush=True)

    dense_max = default_dense_max()
    dense_builds = DENSE_BUILDS + (list(DENSE_GRID) if DENSE_GRID_ON else [])
    with phase(f"2 build (and B2-B7 with kDenseMax {dense_builds}; the "
               "registers of B1-B7 held to the parent's)"):
        # one nvcc per library, all started together
        scratch = [(k, dense_defines(d)) for d in dense_builds
                   for k in DENSE_LIBS]
        jobs = [(k, ()) for k in KERNELS] + scratch
        for k, d in jobs:  # build from the checkout's sources
            cuda_build.library_path(k, d).unlink(missing_ok=True)
        parent_build = None
        if PARENT:  # the parent's libraries, built beside these
            parent_build = subprocess.Popen(
                [sys.executable, "-c", f"import sys; sys.path.insert(0, "
                 f"{PARENT!r}); import chip_smoke; chip_smoke.build_all()"],
                cwd=PARENT)
        t0 = time.time()
        libs = build_all(scratch)
        build_s = time.time() - t0
        print(f"  built {len(libs)} libraries in {build_s:.2f} s")
        for (k, d), lib in zip(jobs, libs):
            print(f"  {os.path.relpath(lib, ROOT)}: nvcc "
                  f"{' '.join(cuda_build.flags(k, d))}")
            log = lib.with_name(lib.name + ".log").read_text().strip()
            for line in log.splitlines():
                print(f"  nvcc: {line}")
        regs = {f"{k}:{kk}": v for (k, d), lib in zip(jobs, libs) if not d
                for kk, v in registers_of(lib).items()}
        for (k, d), lib in zip(jobs, libs):
            if not d and k not in DENSE_LIBS:
                continue
            r = registers_of(lib)
            print(f"  {k} {' '.join(d) or f'(kDenseMax {dense_max})'}: "
                  f"{len(r)} instantiations, registers {min(r.values())}-"
                  f"{max(r.values())}", flush=True)
        if parent_build is not None:
            if parent_build.wait() != 0:
                raise AssertionError("the parent's build failed")
            old = ptxas_registers(PARENT)
        else:
            old = parent_regs()
        src = "its build" if PARENT else "PARENT_REGS"
        held = [k for k in regs if k.split(":")[0] in HELD_LIBS]
        moved = {k: (old.get(k), regs[k]) for k in held
                 if old.get(k) != regs[k]}
        print(f"  registers of {', '.join(HELD_LIBS)} against the parent's "
              f"({src}): {len(held)} instantiations, {len(moved)} moved "
              f"{moved}", flush=True)
        if moved:
            raise AssertionError("a held kernel changed its registers")
        for lib in MOVED_LIBS:
            pairs = {k.split(":")[1]: (old.get(k), v) for k, v in
                     sorted(regs.items()) if k.split(":")[0] == lib}
            print(f"  {lib} registers (parent's, this tree's; {src}): "
                  f"{len(pairs)} instantiations, "
                  f"{sum(a != b for a, b in pairs.values())} moved "
                  f"{pairs}", flush=True)
            spills = {"this tree": spills_of(libs[KERNELS.index(lib)])}
            if PARENT:
                spills["parent"] = spills_of(glob.glob(os.path.join(
                    PARENT, "rt_tpu_torch", "_build", f"lib{lib}-*.so"))[0])
            for who, sp in spills.items():
                print(f"  {lib} spill bytes (stores, loads), {who}: "
                      f"{ {k: v for k, v in sp.items() if any(v)} or 'none'}",
                      flush=True)
        if PARENT:
            # the table this tree holds when run without --parent
            table = {}
            for k, v in sorted(old.items()):
                lib, kern = k.split(":")
                table.setdefault(lib, {})[kern] = v
            print(f"  PARENT_REGS = {json.dumps(table)}", flush=True)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    try:
        mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, check=True).stdout.split()[0])
    except (FileNotFoundError, subprocess.CalledProcessError,
            ValueError, IndexError):
        mhz = None
    # a thread-instruction per lane a clock: 4 schedulers x 32 lanes
    issue_rate = sms * 128 * mhz * 1e6 if mhz else None
    issue_note = (f"{sms} SMs x 128 lanes x {mhz} MHz = {issue_rate} "
                  "instructions/s")

    sdef, cfg = cover_scene(width=W, height=H, spp=SPP, max_depth=DEPTH)
    tables = build_tables(sdef, device=dev)
    centers, radii = tables.sph_center, tables.sph_radius
    live = tables.sph_obj >= 0
    n_rows = centers.shape[0]
    n_live = tables.n_spheres     # the bounds count live rows only

    def truth(c, r, lv, o, d):
        return cuda_intersect.sphere_closest_hit_plain(
            c.double(), r.double(), lv, o.double(), d.double())[0]

    with phase("3 kernel vs plain"):
        rs = np.random.default_rng(0)
        ro_r = rs.normal(0, 3, (65536, 3)).astype(np.float32)
        rd_r = rs.normal(0, 1, (65536, 3)).astype(np.float32)
        rd_r /= np.linalg.norm(rd_r, axis=-1, keepdims=True)
        pix = torch.from_numpy(rs.integers(0, W * H, 65536)).to(dev)
        ro_c, rd_c = generate_rays(tables.camera, W, H, pix % W, pix // W, 0,
                                   0, cfg.enable_defocus)
        ro = torch.cat([torch.from_numpy(ro_r).to(dev), ro_c]).contiguous()
        rd = torch.cat([torch.from_numpy(rd_r).to(dev), rd_c]).contiguous()
        args = (centers, radii, live, ro, rd)
        err_a = compare_hits(*cuda_intersect.sphere_closest_hit(*args),
                             *cuda_intersect.sphere_closest_hit_plain(*args),
                             truth(*args), "65536 random + 65536 camera rays")

        # the main path's shape: every primary ray of the 1080p frame
        px = torch.arange(W * H, device=dev)
        ro_f, rd_f = generate_rays(tables.camera, W, H, px % W, px // W, 0,
                                   0, cfg.enable_defocus)
        full = (centers, radii, live, ro_f, rd_f)
        err_b = compare_hits(*cuda_intersect.sphere_closest_hit(*full),
                             *cuda_intersect.sphere_closest_hit_plain(*full),
                             truth(*full), f"{W}x{H} primary rays")
        k_ms, _ = cuda_ms(
            lambda: cuda_intersect.sphere_closest_hit(*full), 20)
        p_ms, _ = cuda_ms(
            lambda: cuda_intersect.sphere_closest_hit_plain(*full), 3)
        b = ro_f.shape[0]
        # the roots only where disc >= 0 (csrc/sphere_hit.cu): 23
        # operations there, the discriminant's 17 elsewhere
        roots = disc_pairs(*full)
        b1_pairs = dict(pairs=b * n_live, disc_nonnegative=roots)
        ops = (SPHERE_OPS_PER_PAIR * roots
               + SPHERE_DISC_OPS * (b * n_live - roots))
        nbytes = (b * (12 + 12 + 4 + 4)            # ro, rd in; t, pid out
                  + n_rows * (12 + 4 + 1))         # centers, radii, live
        bound_ms, bound_by = bound_of(ops, nbytes)
        b1_sass = b1_instructions(libs[KERNELS.index("sphere_hit")])
        b1_issue_ms = (1e3 * (b * n_live * b1_sass["miss_pair"]
                              + roots * b1_sass["root_pair"]) / issue_rate
                       if b1_sass and issue_rate else None)
        print(f"  sphere_closest_hit at B={b}, N={n_rows} ({n_live} live): "
              f"kernel "
              f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}: {ops:.4g} ops, {b * n_live} pairs of which "
              f"{roots} with disc >= 0, {nbytes:.4g} bytes); issued "
              f"instructions (cuobjdump -sass) {b1_sass}, issue bound "
              f"{b1_issue_ms} ms; {smi}", flush=True)

        # this B1 against the parent's, lane for lane, on all of phase 3's
        # rays
        b1_parent = None
        if PARENT:
            ro_all = torch.cat([ro, ro_f])
            rd_all = torch.cat([rd, rd_f])
            t_new, pid_new = cuda_intersect.sphere_closest_hit(
                centers, radii, live, ro_all, rd_all)
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "b1.pt")
                torch.save({"centers": centers.cpu(), "radii": radii.cpu(),
                            "live": live.cpu(), "ro": ro_all.cpu(),
                            "rd": rd_all.cpu()}, path)
                subprocess.run([sys.executable, os.path.join(
                    ROOT, "chip_smoke.py"), "--b1-hits", PARENT, path],
                    check=True)
                prev = torch.load(path + ".out")
            t_bits = t_new.cpu().view(torch.int32) != prev["t"].view(
                torch.int32)
            pid_off = pid_new.cpu() != prev["pid"]
            b1_parent = dict(rays=int(t_new.numel()),
                             t_bits_differ=int(t_bits.sum()),
                             pid_differs=int(pid_off.sum()),
                             lanes_differ=int((t_bits | pid_off).sum()))
            print(f"  sphere_closest_hit against the parent's B1 on "
                  f"{b1_parent['rays']} rays: {b1_parent['lanes_differ']} "
                  f"lanes differ (t bits {b1_parent['t_bits_differ']}, pid "
                  f"{b1_parent['pid_differs']})", flush=True)

    with phase("4 main path: cover_scene 1920x1080 depth 50 engine pallas"):
        cfg_main = cfg.replace(engine="pallas", rays_per_batch=1 << 21)
        stats = {}
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        img = render(tables, cfg_main, device="cuda", stats=stats)
        torch.cuda.synchronize()
        render_s = time.time() - t0
        launches = cuda_intersect.sphere_closest_hit.launches
        print(f"  render {render_s:.3f} s, "
              f"{W * H * SPP / render_s:.0f} paths/s, bounces "
              f"{stats.get('bounces')}, kernel launches {launches}; {smi}",
              flush=True)
        if launches <= 0 or launches != stats.get("bounces"):
            raise AssertionError(
                f"main path launched the kernel {launches} times for "
                f"{stats.get('bounces')} bounces")
        if tuple(img.shape) != (H, W, 3) or not bool(torch.isfinite(img).all()):
            raise AssertionError("render is not a finite [H,W,3] image")
        neg = film.negative_pixels(img)
        if neg:
            raise AssertionError(f"{neg} pixels with negative radiance")
        mean = (img / SPP).mean().item()
        print(f"  mean radiance {mean:.4f}", flush=True)
        if not 0.05 < mean < 2.0:
            raise AssertionError(f"implausible mean radiance {mean}")

    with phase("5 pallas vs plain engine at 192x108 depth 50"):
        s_small, c_small = cover_scene(width=SMALL_W, height=SMALL_H,
                                       spp=SPP, max_depth=DEPTH)
        t_small = build_tables(s_small, device=dev)
        img_k = render(t_small, c_small.replace(engine="pallas"),
                       device="cuda").cpu().numpy()
        img_p = render(t_small, c_small.replace(engine="plain"),
                       device="cuda").cpu().numpy()
        frac, mx = images_close(img_k, img_p, SPP)
        print(f"  {frac:.3%} pixels beyond 2e-3, max diff {mx:.4g}",
              flush=True)

    with phase("6 CLI"):
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "cover.png")
            cmd = [sys.executable, "-m", "rt_tpu_torch", "render", "--coded",
                   "cover", "-w", str(CLI_W), "--height", str(CLI_H),
                   "-spp", "2", "-d", "50", "-o", out,
                   "--log", os.path.join(tmp, "time.log")]
            res = subprocess.run(cmd, cwd=ROOT, capture_output=True,
                                 text=True, timeout=300)
            print("  " + (res.stdout + res.stderr).strip().replace("\n", "\n  "))
            if res.returncode != 0:
                raise AssertionError(f"CLI exited {res.returncode}")
            if "engine queue" not in res.stdout:
                raise AssertionError("the CLI's default engine is not queue")
            png = read_png(out)
            if png.shape != (CLI_H, CLI_W, 3) or png.max() == 0:
                raise AssertionError(f"CLI wrote a bad PNG {png.shape}")

    s16, c16 = cover_scene(width=W, height=H, spp=MAIN_SPP, max_depth=DEPTH)
    # the bench.py:67-92 shape: one launch of 1<<25 rays per frame, the
    # tapered compaction schedule (read by "mega"; "queue" needs none)
    c16 = c16.replace(rays_per_batch=1 << 25, compact_schedule=(2, 3, 5, 10),
                      compact_group=16)
    t16 = build_tables(s16, device=dev)
    if t16.mega.fam is not None:  # the kernels' sphere-only instantiation
        raise AssertionError("cover_scene has family tables")

    with phase("7 B2 / B3 kernels vs plain per lane at depth 1"):
        err_mega = err_queue = 0.0
        s_corn, c_corn = cornell_spheres_scene(width=256, height=256, spp=1,
                                               max_depth=1)
        t_corn = build_tables(s_corn, device=dev)
        for label, tb, cb, w_, h_ in (
                ("cover_scene", t16, c16, W, H),
                ("cornell_spheres_scene", t_corn, c_corn, 256, 256)):
            cb = cb.replace(max_depth=1)
            rs = np.random.default_rng(1)
            pix = torch.from_numpy(rs.integers(0, w_ * h_, LANES_1)).to(dev)
            ro1, rd1 = generate_rays(tb.camera, w_, h_, pix % w_, pix // w_,
                                     0, 0, cb.enable_defocus)
            args = (tb, cb, ro1, rd1, pix, 0, 11)
            k_m = cuda_mega.mega_trace(*args)
            k_q = cuda_queue.queue_trace(*args, check_once=True)
            # a pool of 8 blocks: each thread claims 32 rays by the refill
            k_s = cuda_queue.queue_trace(*args, check_once=True,
                                         pool_lanes=SMALL_POOL)
            p_m = cuda_mega.mega_trace(*args, plain=True)
            p_q = cuda_queue.queue_trace(*args, plain=True)
            if not torch.equal(p_m, p_q):
                raise AssertionError(f"{label}: plain mega != plain queue")
            err_mega = max(err_mega, lanes_close(k_m, p_m,
                                                 f"{label} B2 vs plain"))
            err_queue = max(err_queue, lanes_close(k_q, p_q,
                                                   f"{label} B3 vs plain"))
            err_queue = max(err_queue, lanes_close(
                k_s, p_q, f"{label} B3 with {SMALL_POOL} pool lanes vs "
                "plain"))
            if not torch.equal(k_s, k_q):
                raise AssertionError(f"{label}: B3's result depends on its "
                                     "pool size")

    with phase("8 B2 / B3 kernels vs plain as images"):
        s_small, c_small = cover_scene(width=SMALL_W, height=SMALL_H,
                                       spp=SPP, max_depth=DEPTH)
        t_small = build_tables(s_small, device=dev)
        c_small = c_small.replace(compact_schedule=(2, 3, 5, 10),
                                  compact_group=16)
        s_corn, c_corn = cornell_spheres_scene(width=96, height=96, spp=SPP,
                                               max_depth=8)
        t_corn = build_tables(s_corn, device=dev)
        for label, tb, cb, w_, h_ in (
                (f"cover {SMALL_W}x{SMALL_H} depth {DEPTH}", t_small, c_small,
                 SMALL_W, SMALL_H),
                ("cornell 96x96 depth 8 p_rr 0.9", t_corn, c_corn, 96, 96)):
            for name, fn in (("B2", cuda_mega.mega_trace),
                             ("B3", cuda_queue.queue_trace)):
                img_k = frame(tb, cb, w_, h_, fn, generate_rays)
                img_p = frame(tb, cb, w_, h_,
                              lambda *a, **k: fn(*a, plain=True, **k),
                              generate_rays)
                frac, mx = images_close(img_k, img_p, SPP)
                print(f"  {label}, {name} vs plain: {frac:.3%} pixels beyond "
                      f"2e-3, max diff {mx:.4g}", flush=True)

    with phase("9 B3 vs B2 on the card; B3 across step budgets"):
        px = torch.arange(W * H, device=dev)
        ro_f, rd_f = generate_rays(t16.camera, W, H, px % W, px // W, 0, 0,
                                   c16.enable_defocus)
        main_args = (t16, c16, ro_f, rd_f, px, 0, 0)
        q0 = cuda_queue.queue_trace(*main_args, check_once=True)
        m0 = cuda_mega.mega_trace(*main_args)
        d = (q0 - m0).abs().max(-1).values
        within = (d <= 1e-5).float().mean().item()
        print(f"  {W * H} lanes, depth {DEPTH}: queue vs mega max abs diff "
              f"{d.max().item():.4g}, {within:.6f} of lanes within 1e-5",
              flush=True)
        if within < 0.999:
            raise AssertionError("queue and mega kernels disagree")
        q64 = cuda_queue.queue_trace(t16, c16.replace(queue_steps=64),
                                     *main_args[2:], check_once=True)
        if not torch.equal(q64, q0):
            raise AssertionError("queue_steps=64 changed the result")
        print("  queue_steps 64 vs 0: bit-identical", flush=True)

    main = {}
    for engine in ("queue", "mega"):
        with phase(f"10 main path: cover_scene {W}x{H} depth {DEPTH} spp "
                   f"{MAIN_SPP} engine {engine}"):
            cfg_e = c16.replace(engine=engine)
            stats = {}
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.time()
            img = render(t16, cfg_e, device="cuda", stats=stats)
            torch.cuda.synchronize()
            sec = time.time() - t0
            counts = read_counts()
            paths = W * H * MAIN_SPP
            print(f"  render {sec:.3f} s, {paths / sec:.0f} paths/s, "
                  f"launches {counts}, ray-bounces {stats['ray_bounces']}, "
                  f"{stats['ray_bounces'] / paths:.4f} bounces per path; "
                  f"{smi}", flush=True)
            own = counts["queue_launch" if engine == "queue"
                         else "mega_segment"]
            if own <= 0 or own != stats["launches"]:
                raise AssertionError(f"{engine}: {own} kernel launches, "
                                     f"stats say {stats['launches']}")
            if stats["ray_bounces"] <= 0:
                raise AssertionError(f"{engine}: no ray-bounces")
            if tuple(img.shape) != (H, W, 3) or \
                    not bool(torch.isfinite(img).all()):
                raise AssertionError("render is not a finite [H,W,3] image")
            neg = film.negative_pixels(img)
            if neg:
                raise AssertionError(f"{neg} pixels with negative radiance")
            mean = (img / MAIN_SPP).mean().item()
            print(f"  mean radiance {mean:.4f}", flush=True)
            if not 0.05 < mean < 2.0:
                raise AssertionError(f"implausible mean radiance {mean}")
            main[engine] = dict(img=img.cpu().numpy(), launches=own,
                                sec=sec, bounces=stats["ray_bounces"])
    frac, mx = images_close(main["queue"]["img"], main["mega"]["img"],
                            MAIN_SPP)
    print(f"  queue vs mega frame: {frac:.3%} pixels beyond 2e-3, max diff "
          f"{mx:.4g}", flush=True)

    with phase(f"11 B2 / B3 vs plain and times at one trace call "
               f"({W * H} lanes, depth {DEPTH})"):
        rows_k = t16.mega.table.shape[0]   # live rows: what the kernels loop
        blocks = cuda_queue.grid_blocks(rows_k, dev)
        print(f"  queue grid: {blocks} blocks x {cuda_mega.THREADS} threads "
              f"= {blocks * cuda_mega.THREADS} pool lanes, {W * H} rays: "
              f"the refill runs", flush=True)
        rows = {}
        for name, fn in (("mega_segment", cuda_mega.mega_trace),
                         ("queue_launch", cuda_queue.queue_trace)):
            st = {}
            k_out = fn(*main_args, stats=st)
            ms, _ = cuda_ms(lambda: fn(*main_args), 5)
            reset_plain_counts()
            pms, p_out = cuda_ms(lambda: fn(*main_args, plain=True), 1)
            err = lanes_close(k_out, p_out, f"{name} vs plain")
            ops = hit_terms(st["ray_bounces"], calls=2)
            ops_all = st["ray_bounces"] * (SPHERE_OPS_PER_PAIR * rows_k
                                           + SETUP_OPS)
            nbytes = (W * H * (12 + 12 + 4 + 12)   # ro, rd, pixel in; rgb out
                      + rows_k * 17 * 4)           # the packed table
            b_ms, b_by = bound_of(ops, nbytes)
            rows[name] = dict(ms=ms, plain_ms=pms, bound_ms=b_ms,
                              bound_by=b_by, err=err,
                              bound_all_rows_ms=bound_of(ops_all, nbytes)[0],
                              rows_tested=rows_tested(calls=2)[0])
            print(f"  {name}: trace {ms:.4f} ms, plain {pms:.4f} ms, bound "
                  f"{b_ms:.4f} ms ({b_by}: {st['ray_bounces']} ray-bounces, "
                  f"{rows[name]['rows_tested']} (lane, row) pairs tested of "
                  f"{st['ray_bounces'] * rows_k}, {ops:.4g} ops, "
                  f"{nbytes:.4g} bytes; {b_ms / ms:.1%} of the bound; over "
                  f"all rows {rows[name]['bound_all_rows_ms']:.4f} ms); "
                  f"{smi}", flush=True)
        err_mega = max(err_mega, rows["mega_segment"].pop("err"))
        err_queue = max(err_queue, rows["queue_launch"].pop("err"))

    def adjoint_inputs(tb, cb, w_, h_, seed, g_std=None):
        """Camera rays of sample 0, their radiance (the queue kernel) and
        a seeded loss cotangent, of standard deviation g_std (by default
        1 / pixels, a mean loss's)."""
        pix = torch.arange(w_ * h_, device=dev)
        ro_, rd_ = generate_rays(tb.camera, w_, h_, pix % w_, pix // w_, 0,
                                 0, cb.enable_defocus)
        L = cuda_queue.queue_trace(tb, cb, ro_, rd_, pix, 0, 0)
        g = torch.from_numpy(np.random.default_rng(seed).normal(
            0, 1.0 / (w_ * h_) if g_std is None else g_std,
            (w_ * h_, 3)).astype(np.float32)).to(dev)
        return pix, ro_, rd_, L, g

    def atlas_held(want, got, label):
        """The atlas gradient's size against grads_close's limit, and
        proof that the check can fail there: the kernel's gradient with
        the atlas zeroed, or moved by one texel along TW (a hit credited
        to its neighbour), must not pass. Returns (max |a|, err / limit)."""
        a = want["images"].double()
        mag = float(a.abs().max())
        limit = 1e-5 + 1e-3 * mag
        ratio = float((a - got["images"].double()).abs().max()) / limit
        print(f"  {label} atlas: max |a| {mag:.4g}, limit {limit:.4g}, "
              f"err / limit {ratio:.3g}, texels with a gradient "
              f"{int((a.abs().sum(-1) > 0).sum())} of {a[..., 0].numel()}",
              flush=True)
        for how, wrong in (
                ("zeroed", torch.zeros_like(got["images"])),
                ("moved by one texel", torch.roll(got["images"], 1, 2))):
            try:
                with contextlib.redirect_stdout(io.StringIO()):
                    grads_close(want, dict(got, images=wrong), label)
            except AssertionError:
                continue
            raise AssertionError(f"{label}: an atlas gradient {how} passes "
                                 "the check")
        return mag, ratio

    err_b5 = err_b6 = 0.0
    with phase(f"12 B5 / B6 kernels vs plain at {SMALL_W}x{SMALL_H}"):
        s_small, c_small = cover_scene(width=SMALL_W, height=SMALL_H, spp=1,
                                       max_depth=DEPTH)
        # a bright constant sky (the cover scene's is black, and then
        # every path carries zero radiance): read with the constant sky
        s_small.background = (0.6, 0.7, 0.9)
        t_small = build_tables(s_small, device=dev)
        c_small = c_small.replace(compact_schedule=(2, 3, 5, 10),
                                  compact_group=16)
        for depth, bg_mode in ((1, "gradient"), (1, "constant"),
                               (DEPTH, "gradient"), (DEPTH, "constant")):
            cb = c_small.replace(max_depth=depth, background_mode=bg_mode)
            pix, ro_, rd_, L, g = adjoint_inputs(t_small, cb, SMALL_W,
                                                 SMALL_H, depth)
            args = (t_small, cb, ro_, rd_, pix, 0, 0, L, g, depth, False)
            plain = cuda_queue.queue_trace_adjoint(*args, plain=True)
            k_m = cuda_mega.mega_trace_adjoint(*args)
            k_q = cuda_queue.queue_trace_adjoint(*args, check_once=True)
            k_s = cuda_queue.queue_trace_adjoint(*args, check_once=True,
                                                 pool_lanes=SMALL_POOL)
            label = f"depth {depth}, {bg_mode} sky"
            err_b5 = max(err_b5, grads_close(plain, k_m, f"{label}: B5"))
            err_b6 = max(err_b6, grads_close(plain, k_q, f"{label}: B6"))
            err_b6 = max(err_b6, grads_close(
                plain, k_s, f"{label}: B6 with {SMALL_POOL} pool lanes"))
            grads_close(k_m, k_q, f"{label}: B6 vs B5")
            # a scattering hit takes g * (L - C_after) / att: none at
            # depth 1, where no radiance follows it
            if (float(plain["tex_color2"].abs().max()) > 0.0) != (depth > 1):
                raise AssertionError("the checker's odd colour took a "
                                     "wrong gradient")

    with phase(f"13 B5 / B6 vs plain and times at one adjoint call "
               f"({W * H} lanes, depth {DEPTH}, exact)"):
        pix, ro_, rd_, L, g = adjoint_inputs(t16, c16, W, H, 0)
        adj_args = (t16, c16, ro_, rd_, pix, 0, 0, L, g, DEPTH, False)
        ms16 = t16.mega
        n_slots = ms16.n_slots
        print(f"  gradient slots {n_slots} ({ms16.n_tex} texture + "
              f"{ms16.n_mat} material rows), accumulators in shared "
              f"memory: {cuda_mega.acc_fits_smem(n_slots)}; queue "
              f"adjoint grid "
              f"{cuda_queue.adjoint_grid_blocks(rows_k, n_slots, dev)} "
              f"blocks", flush=True)
        for name, fn in (("mega_adjoint_segment",
                          cuda_mega.mega_trace_adjoint),
                         ("queue_adjoint_launch",
                          cuda_queue.queue_trace_adjoint)):
            st = {}
            k_out = fn(*adj_args, stats=st)
            ms, _ = cuda_ms(lambda: fn(*adj_args), 5)
            reset_plain_counts()
            pms, p_out = cuda_ms(lambda: fn(*adj_args, plain=True), 1)
            err = grads_close(p_out, k_out, f"{name} vs plain")
            ops = (hit_terms(st["ray_bounces"], calls=2)
                   + st["ray_bounces"] * ADJOINT_OPS)
            ops_all = st["ray_bounces"] * (SPHERE_OPS_PER_PAIR * rows_k
                                           + SETUP_OPS + ADJOINT_OPS)
            nbytes = (W * H * (12 + 12 + 4 + 12 + 12)  # ro, rd, pixel, L, g
                      + rows_k * 18 * 4               # the packed table
                      + 8 * n_slots * 4)              # gradients out
            b_ms, b_by = bound_of(ops, nbytes)
            rows[name] = dict(ms=ms, plain_ms=pms, bound_ms=b_ms,
                              bound_by=b_by,
                              bound_all_rows_ms=bound_of(ops_all, nbytes)[0],
                              rows_tested=rows_tested(calls=2)[0])
            if name == "mega_adjoint_segment":
                err_b5 = max(err_b5, err)
            else:
                err_b6 = max(err_b6, err)
            print(f"  {name}: adjoint call {ms:.4f} ms, plain {pms:.4f} ms, "
                  f"bound {b_ms:.4f} ms ({b_by}: {st['ray_bounces']} "
                  f"ray-bounces, {rows[name]['rows_tested']} (lane, row) "
                  f"pairs tested, {ops:.4g} ops, {nbytes:.4g} bytes; "
                  f"{b_ms / ms:.1%} of the bound; over all rows "
                  f"{rows[name]['bound_all_rows_ms']:.4f} ms), "
                  f"{st['launches']} launches; {smi}", flush=True)

    s1, c1 = cover_scene(width=W, height=H, spp=1, max_depth=DEPTH)
    c1 = c1.replace(compact_schedule=(2, 3, 5, 10), compact_group=16)
    t1 = build_tables(s1, device=dev)
    px1 = torch.arange(W * H, device=dev)
    tgt1 = torch.rand((W * H, 3), generator=torch.Generator().manual_seed(0)
                      ).to(dev)
    train = {}
    for engine in ("queue", "mega"):
        for bwd_depth in (TRAIN_BWD_DEPTH, None):
            with phase(f"14 training step: cover_scene {W}x{H} depth "
                       f"{DEPTH} spp 1 engine {engine} bwd_depth "
                       f"{bwd_depth or 'exact'}"):
                cfg_e = c1.replace(engine=engine)
                loss_fn = make_replay_loss_fn(t1, cfg_e, 1, px1 % W,
                                              px1 // W, tgt1,
                                              bwd_depth=bwd_depth)
                params = {k: getattr(t1, k).clone().requires_grad_(True)
                          for k in ("tex_color", "mat_albedo")}
                reset_counts()
                torch.cuda.synchronize()
                t0 = time.time()
                loss = loss_fn(params)
                torch.cuda.synchronize()
                t_fwd = time.time() - t0
                loss.backward()
                torch.cuda.synchronize()
                t_step = time.time() - t0
                counts = read_counts()
                fwd_k, adj_k = (("queue_launch", "queue_adjoint_launch")
                                if engine == "queue" else
                                ("mega_segment", "mega_adjoint_segment"))
                print(f"  loss {float(loss.detach()):.6f}: forward "
                      f"{t_fwd:.4f} s, backward {t_step - t_fwd:.4f} s, "
                      f"step {t_step:.4f} s; launches {counts}; {smi}",
                      flush=True)
                if counts[fwd_k] <= 0 or counts[adj_k] <= 0:
                    raise AssertionError(f"{engine}: the step launched "
                                         f"{counts}")
                for k, v in params.items():
                    if v.grad is None or not bool(
                            torch.isfinite(v.grad).all()) or not float(
                            v.grad.abs().max()) > 0.0:
                        raise AssertionError(f"{engine}: bad gradient {k}")
                train[(engine, bwd_depth)] = dict(
                    fwd=t_fwd, step=t_step, launches=counts[adj_k],
                    grads={k: v.grad for k, v in params.items()})
    for engine in ("queue", "mega"):
        a = train[(engine, None)]["grads"]
        b = train[(engine, TRAIN_BWD_DEPTH)]["grads"]
        rel = max(float((a[k] - b[k]).abs().max())
                  / max(float(a[k].abs().max()), 1e-30) for k in a)
        print(f"  {engine}: bwd_depth {TRAIN_BWD_DEPTH} vs exact, max abs "
              f"gradient difference {rel:.4%} of max |g|", flush=True)
    for k in ("tex_color", "mat_albedo"):
        a = train[("mega", None)]["grads"][k].double()
        b = train[("queue", None)]["grads"][k].double()
        mag = max(float(a.abs().max()), 1e-12)
        err = float((a - b).abs().max())
        print(f"  exact step, {k}: queue vs mega max abs diff {err:.4g} "
              f"({err / (1e-5 + 1e-3 * mag):.4f} of the tolerance)",
              flush=True)
        if not err <= 1e-5 + 1e-3 * mag:
            raise AssertionError(f"the queue and mega steps disagree on {k}")

    with phase(f"15 fit(method='replay', steps=3) at {W}x{H} depth {DEPTH} "
               "spp 1"):
        target = render(t1, c1.replace(engine="queue"), device="cuda") \
            .cpu().numpy()
        rs = np.random.default_rng(7)
        init = {k: getattr(t1, k) * torch.from_numpy(rs.uniform(
                    0.6, 1.4, tuple(getattr(t1, k).shape)).astype(
                    np.float32)).to(dev)
                for k in ("tex_color", "mat_albedo")}
        # the optimizer's first step in this process, apart from fit's
        t0 = time.time()
        w0 = torch.zeros(4, device=dev, requires_grad=True)
        opt = torch.optim.Adam([w0], lr=0.1)
        w0.sum().backward()
        opt.step()
        torch.cuda.synchronize()
        print(f"  torch.optim.Adam's first step on the card: "
              f"{time.time() - t0:.3f} s", flush=True)
        t0 = time.time()
        got, hist = fit(t1, c1.replace(engine="queue"), target, spp=1,
                        steps=3, learning_rate=0.02, init_params=init,
                        method="replay", device="cuda")
        torch.cuda.synchronize()
        fit_s = time.time() - t0
        # the loss after the third step, on the same samples
        with torch.no_grad():
            final = float(make_replay_loss_fn(
                t1, c1.replace(engine="queue"), 1, px1 % W, px1 // W,
                torch.from_numpy(target.reshape(-1, 3)).to(dev))(
                {k: torch.from_numpy(v).to(dev) for k, v in got.items()}))
        print(f"  loss at steps 0-3: {hist + [final]} ({fit_s:.3f} s for "
              "3 steps)", flush=True)
        if not final < hist[0]:
            raise AssertionError(f"the fit loss did not fall: "
                                 f"{hist + [final]}")

    err_b4 = 0
    err_b7 = 0.0
    with phase("16 tables past the staged rows (ROADMAP C-7)"):
        for n, n_mat in ((3000, 64), (12000, 0)):
            s_r, c_r = random_spheres_scene(n, n_mat, width=128, height=96,
                                            max_depth=8)
            t_r = build_tables(s_r, device=dev)
            c_r = c_r.replace(compact_schedule=(2, 3, 5, 10),
                              compact_group=16)
            pix, ro_, rd_, L, g = adjoint_inputs(t_r, c_r, 128, 96, n)
            fwd = (t_r, c_r, ro_, rd_, pix, 0, 0)
            p_out = cuda_queue.queue_trace(*fwd, plain=True)
            label = (f"{t_r.mega.table.shape[0]} rows, {t_r.mega.n_slots} "
                     f"slots")
            err_queue = max(err_queue, lanes_close(
                cuda_queue.queue_trace(*fwd, check_once=True), p_out,
                f"{label}: B3 vs plain", frac=1.0))
            err_mega = max(err_mega, lanes_close(
                cuda_mega.mega_trace(*fwd), p_out, f"{label}: B2 vs plain",
                frac=1.0))
            adj = (*fwd, L, g, 8, False)
            plain = cuda_queue.queue_trace_adjoint(*adj, plain=True)
            err_b6 = max(err_b6, grads_close(
                plain, cuda_queue.queue_trace_adjoint(*adj, check_once=True),
                f"{label}: B6 vs plain"))
            err_b5 = max(err_b5, grads_close(
                plain, cuda_mega.mega_trace_adjoint(*adj),
                f"{label}: B5 vs plain"))
            err_b4 += capture_mismatch(
                cuda_mega.mega_capture(*fwd),
                cuda_mega.mega_capture(*fwd, plain=True),
                f"{label}: B4 vs plain")
            seg = (t_r, c_r, pix, 2, 2 * (c_r.max_depth + 1))
            err_b7 = max(err_b7, regen_mismatch(
                regen_segment(*seg, plain=False),
                regen_segment(*seg, plain=True),
                f"{label}: B7 vs plain, spp 2"))

    from profile_torch import FAMILY_FIELDS, tape_workload
    from rt_tpu_torch.diff import tape
    from rt_tpu_torch.diff.replay import make_replay_render
    from rt_tpu_torch.ops import mega_plain, mega_tables
    from rt_tpu_torch.render.integrator import RayState, _bounce

    small = {}
    with phase(f"17 B4 vs plain at {SMALL_W}x{SMALL_H} depth {DEPTH}"):
        s_c, c_c = cover_scene(width=SMALL_W, height=SMALL_H, spp=1,
                               max_depth=DEPTH)
        s_k, c_k = cornell_spheres_scene(width=SMALL_W, height=SMALL_H,
                                         spp=1, max_depth=DEPTH)
        for label, sd, cb in (("cover_scene", s_c, c_c),
                              ("cornell_spheres_scene p_rr 0.9", s_k,
                               c_k.replace(p_rr=0.9))):
            tb = build_tables(sd, device=dev)
            pix = torch.arange(SMALL_W * SMALL_H, device=dev)
            ro_, rd_ = generate_rays(tb.camera, SMALL_W, SMALL_H,
                                     pix % SMALL_W, pix // SMALL_W, 0, 0,
                                     cb.enable_defocus)
            args = (tb, cb, ro_, rd_, pix, 0, 0)
            got = cuda_mega.mega_capture(*args)
            want = cuda_mega.mega_capture(*args, plain=True)
            err_b4 += capture_mismatch(got, want, f"{label}: B4 vs plain")
            small[label] = (tb, cb, args, got)

    with phase(f"18 B4 vs the wavefront capture at {SMALL_W}x{SMALL_H}"):
        # The wavefront capture traces the integrator's bounce
        # (materials.shade: divisions, the unit ball pow(u, 1/3)), B4
        # the megakernels' (multiplications by 1/a and 1/r, the unit ball
        # exp(log(u)/3)): an ulp moves a path now and then, and from
        # there its codes differ. Gate: >= 99% of lanes agree on every
        # live code and on the death count (images_close's 1%).
        for label, (tb, cb, args, (codes, death)) in small.items():
            wave = tape.capture_tape(*args, engine="plain")
            ro_, rd_, pix = args[2], args[3], args[4]
            b = ro_.shape[0]
            st = RayState(ro_, rd_, torch.ones((b, 3), device=dev),
                          torch.zeros((b, 3), device=dev),
                          torch.ones(b, dtype=torch.bool, device=dev))
            alive_in, chain = [], torch.zeros(b, dtype=torch.int32,
                                              device=dev)
            for i in range(cb.max_depth):
                alive_in.append(st.alive)
                st = _bounce(tb, cb, st, pix, 0, 0, i)
                chain += st.alive.to(torch.int32)
            live = torch.stack(alive_in)
            lane_bad = ((wave != codes) & live).any(0) | (chain != death)
            share = 1.0 - float(lane_bad.float().mean())
            print(f"  {label}: {int(((wave != codes) & live).sum())} of "
                  f"{int(live.sum())} live codes differ, on "
                  f"{int(((wave != codes) & live).any(0).sum())} lanes; "
                  f"death differs from the integrator's alive chain on "
                  f"{int((chain != death).sum())} of {b} lanes; "
                  f"{share:.6f} of lanes agree on both", flush=True)
            if share < 0.99:
                raise AssertionError(f"{label}: B4 and the wavefront "
                                     "capture disagree")

    with phase(f"19 B4 vs plain and times at the main shape ({W * H} "
               f"lanes, depth {DEPTH})"):
        c1s = c1.replace(max_depth=DEPTH)
        ro_, rd_ = generate_rays(t1.camera, W, H, px1 % W, px1 // W, 0, 0,
                                 c1s.enable_defocus)
        cap_args = (t1, c1s, ro_, rd_, px1, 0, 0)
        ms_b4, got = cuda_ms(lambda: cuda_mega.mega_capture(*cap_args), 5)
        reset_plain_counts()
        pms_b4, want = cuda_ms(
            lambda: cuda_mega.mega_capture(*cap_args, plain=True), 1)
        b4_ops = hit_terms(0, calls=2)  # the setup is added below
        err_b4 += capture_mismatch(got, want, "B4 vs plain")
        death = got[1]
        ran = torch.zeros(W * H, dtype=torch.int32, device=dev)
        cuda_mega.mega_segment(mega_tables.scene_for(t1, c1s).table,
                               mega_plain.fresh_state(ro_, rd_),
                               px1.to(torch.int32), 0, 0, 0, DEPTH, depth=ran,
                               **mega_plain.trace_options(t1, c1s))
        want_ran = torch.where(death < DEPTH, death + 1, death)
        if not torch.equal(ran, want_ran):
            raise AssertionError(
                f"B4's death counts and B2's bounce counts disagree on "
                f"{int((ran != want_ran).sum())} lanes")
        bounces = int(ran.sum())
        rows_1 = t1.mega.table.shape[0]
        ops = b4_ops + bounces * SETUP_OPS
        ops_all = bounces * (SPHERE_OPS_PER_PAIR * rows_1 + SETUP_OPS)
        nbytes = (W * H * (13 * 4 + 4)         # fresh state, pixel in
                  + rows_1 * 18 * 4            # the packed table
                  + (DEPTH + 1) * W * H * 4)   # codes, death out
        b4_bound, b4_by = bound_of(ops, nbytes)
        print(f"  death consistent with B2's per-lane bounce counts on all "
              f"{W * H} lanes ({bounces} ray-bounces); mega_capture "
              f"{ms_b4:.4f} ms, plain {pms_b4:.4f} ms, bound "
              f"{b4_bound:.4f} ms ({b4_by}: {ops:.4g} ops, {nbytes:.4g} "
              f"bytes; {b4_bound / ms_b4:.1%} of the bound); {smi}",
              flush=True)
        rows["mega_capture"] = dict(ms=ms_b4, plain_ms=pms_b4,
                                    bound_ms=b4_bound, bound_by=b4_by,
                                    bound_all_rows_ms=bound_of(ops_all,
                                                               nbytes)[0])

    with phase(f"20 tape step: cover_scene {W}x{H} depth {DEPTH} spp 1, "
               "all fields (scripts/bench_tape_r3.py)"):
        t_tp, c_tp, p_tp, tgt_tp = tape_workload(W, H, DEPTH, dev)
        pix = torch.arange(W * H, device=dev)
        vg = tape.make_tape_vg(t_tp, c_tp, pix % W, pix // W, tgt_tp)
        vg(p_tp)  # the first step in this process: allocator, kernels
        times = {}
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        loss, grads = vg(p_tp, times=times)
        torch.cuda.synchronize()
        step_s = time.time() - t0
        tape_step_s = step_s
        tape_counts = read_counts()
        print(f"  loss {float(loss):.6f}: capture "
              f"{times['capture_s'] * 1e3:.2f} ms, replay forward "
              f"{times['forward_s']:.4f} s, backward "
              f"{times['backward_s']:.4f} s, step {step_s:.4f} s; widths "
              f"{times['widths']}; launches {tape_counts}; {smi}",
              flush=True)
        if tape_counts["mega_capture"] != 1:
            raise AssertionError(f"the tape step launched B4 "
                                 f"{tape_counts['mega_capture']} times")
        for k, g in grads.items():
            mx = float(g.abs().max())
            print(f"  max |g| {k}: {mx:.6g}", flush=True)
            if not bool(torch.isfinite(g).all()) or not mx > 0.0:
                raise AssertionError(f"tape step: bad gradient {k}")

    with phase(f"21 tape vs path replay (B6), radiometric, "
               f"{SMALL_W}x{SMALL_H} exact"):
        # The tape replays the integrator's bounce, the replay the
        # megakernels'; their paths part on a few lanes (phase 18), and a
        # small sphere's material row takes few lanes, so a parted lane
        # moves it by more than the reference's 1e-5 + 1e-3 max|g|:
        # held within 1e-5 + 3e-2 max|g| per field.
        t_s, c_s, _, tgt_s = tape_workload(SMALL_W, SMALL_H, DEPTH, dev)
        pix = torch.arange(SMALL_W * SMALL_H, device=dev)
        fields = ("tex_color", "mat_albedo")
        out = {}
        for name in ("tape", "replay"):
            p = {k: getattr(t_s, k).clone().requires_grad_(True)
                 for k in fields}
            if name == "tape":
                fn = tape.make_tape_loss_fn(t_s, c_s, 1, pix % SMALL_W,
                                            pix // SMALL_W, tgt_s)
            else:
                fn = make_replay_loss_fn(t_s, c_s.replace(engine="queue"), 1,
                                         pix % SMALL_W, pix // SMALL_W,
                                         tgt_s)
            fn(p).backward()
            out[name] = {k: v.grad.double() for k, v in p.items()}
        for k in fields:
            a, b = out["replay"][k], out["tape"][k]
            mag = float(a.abs().max())
            err = float((a - b).abs().max())
            print(f"  {k}: max abs diff {err:.4g}, max |g| {mag:.4g}: "
                  f"{err / (1e-5 + 1e-3 * mag):.4f} of the reference's "
                  f"tolerance, {err / (1e-5 + 3e-2 * mag):.4f} of this "
                  "one", flush=True)
            if not err <= 1e-5 + 3e-2 * mag:
                raise AssertionError(f"tape and replay disagree on {k}")

    with phase(f"22 fit(method='tape', steps=3) at {W}x{H} depth {DEPTH} "
               "spp 1"):
        target = render(t1, c1.replace(engine="queue"), device="cuda") \
            .cpu().numpy()
        rs = np.random.default_rng(9)
        init = {k: getattr(t1, k) * torch.from_numpy(rs.uniform(
                    0.6, 1.4, tuple(getattr(t1, k).shape)).astype(
                    np.float32)).to(dev)
                for k in ("tex_color", "mat_albedo")}
        t0 = time.time()
        got, hist = fit(t1, c1, target, spp=1, steps=3, learning_rate=0.02,
                        init_params=init, method="tape", device="cuda")
        torch.cuda.synchronize()
        fit_s = time.time() - t0
        with torch.no_grad():
            final = float(tape.make_tape_loss_fn(
                t1, c1, 1, px1 % W, px1 // W,
                torch.from_numpy(target.reshape(-1, 3)).to(dev))(
                {k: torch.from_numpy(v).to(dev) for k, v in got.items()}))
        loss_seq = hist + [final]
        print(f"  loss at steps 0-3: {loss_seq} ({fit_s:.3f} s for 3 "
              "steps)", flush=True)
        if not all(a > b for a, b in zip(loss_seq, loss_seq[1:])):
            raise AssertionError(f"the tape fit's loss did not fall at "
                                 f"every step: {loss_seq}")

    with phase(f"23 geom_spec on B4's tape at {SMALL_W}x{SMALL_H}, then "
               f"{W}x{H}"):
        def geom_spec_of(tb):
            n = tb.n_spheres  # the heroes: glass n-3, metal n-1
            return {"sph_radius": [(n - 1,), (n - 3,)],
                    "mat_fuzz": [(int(tb.sph_mat[n - 1]),)],
                    "mat_ior": [(int(tb.sph_mat[n - 3]),)]}

        spec = geom_spec_of(t_s)
        params = {k: getattr(t_s, k) for k in spec}
        pix = torch.arange(SMALL_W * SMALL_H, device=dev)
        lanes = {}
        for geom_tape in (True, False):
            plan = make_replay_render(t_s, c_s.replace(engine="queue"), 1,
                                      pix % SMALL_W, pix // SMALL_W,
                                      geom_spec=spec, geom_tape=geom_tape)
            img, _ = plan.forward(plan.base, 0)
            g = 2.0 * (img - tgt_s) / img.numel()   # the MSE's cotangent
            before = cuda_mega.mega_capture.launches
            tC = plan.tangents(params, 0)
            if (cuda_mega.mega_capture.launches > before) != geom_tape:
                raise AssertionError("geom_tape=True did not run B4")
            lanes[geom_tape] = torch.einsum("bc,kbc->kb", g, tC)
        # The two forms differ in the last bits of t (the leaf test's
        # oc = o - c against the full intersect's expanded quadratic);
        # near a grazing hit or total internal reflection a lane's
        # tangent is huge and moves far for that, and the sums are
        # dominated by such lanes (rt_tpu's own two forms differ by the
        # same, PERF.md). Gate: per lane within the reference's 4e-2 |a|
        # (plus 1e-6 of the largest lane) on >= 90% of the lanes that
        # carry a tangent.
        a, b = lanes[False], lanes[True]
        agree = (a - b).abs() <= 1e-6 * a.abs().max(1, keepdim=True).values \
            + 4e-2 * a.abs()
        carry = (a != 0) | (b != 0)
        names = [f"{f}{idx}" for f, idxs in sorted(spec.items())
                 for idx in idxs]
        for k, name in enumerate(names):
            share = float(agree[k][carry[k]].float().mean())
            print(f"  {name}: sum over lanes, tape {float(b[k].sum()):.6g}, "
                  f"full intersect {float(a[k].sum()):.6g}; "
                  f"{int(carry[k].sum())} lanes carry a tangent, "
                  f"{share:.4f} of them agree", flush=True)
            if share < 0.9:
                raise AssertionError(f"geom_tape: {name} disagrees with the "
                                     "full intersect")
        t_g, c_g, _, tgt_g = tape_workload(W, H, DEPTH, dev)
        spec = geom_spec_of(t_g)
        p = {k: getattr(t_g, k).clone().requires_grad_(True) for k in spec}
        fn = make_replay_loss_fn(t_g, c_g.replace(engine="queue"), 1,
                                 px1 % W, px1 // W, tgt_g, geom_spec=spec)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        loss = fn(p)
        loss.backward()
        torch.cuda.synchronize()
        geom_s = time.time() - t0
        counts = read_counts()
        got = {f: [float(p[f].grad[i]) for i in idxs]
               for f, idxs in spec.items()}
        print(f"  {W}x{H}: loss {float(loss.detach()):.6f}, step "
              f"{geom_s:.4f} s, launches {counts}; gradients {got}; {smi}",
              flush=True)
        if counts["mega_capture"] != 1 or counts["queue_launch"] <= 0:
            raise AssertionError(f"the geom_spec step launched {counts}")
        if not all(math.isfinite(v) for vs in got.values() for v in vs):
            raise AssertionError(f"geom_spec: bad gradients {got}")

    with phase(f"25 B7 vs plain at {SMALL_W}x{SMALL_H} depth {DEPTH} spp 4; "
               "segment schedules"):
        # why ops/camera.generate_rays divides by device tensors: torch
        # on the card divides by a Python number as a product with the
        # float32 reciprocal, which the kernel's division does not repeat
        x = torch.rand(1 << 20, device=dev, generator=torch.Generator(
            device=dev).manual_seed(0)) * W
        true_div = x / torch.full((), float(W - 1), device=dev)
        by_num = x / (W - 1)
        recip = float(np.float32(1.0) / np.float32(W - 1))
        print(f"  x / {W - 1} on the card equals the division by a device "
              f"tensor on {float((by_num == true_div).float().mean()):.4f} "
              f"of {x.numel()} values, x * fl(1/{W - 1}) on "
              f"{float((by_num == x * recip).float().mean()):.4f}",
              flush=True)
        s_c, c_c = cover_scene(width=SMALL_W, height=SMALL_H, spp=4,
                               max_depth=DEPTH)
        s_k, c_k = cornell_spheres_scene(width=SMALL_W, height=SMALL_H,
                                         spp=4, max_depth=DEPTH)
        pix = torch.arange(SMALL_W * SMALL_H, device=dev)
        for label, sd, cb in (
                ("cover_scene", s_c, c_c),
                ("cornell_spheres_scene, open lens, p_rr 0.9", open_lens(s_k),
                 c_k.replace(p_rr=0.9, enable_defocus=True))):
            tb = build_tables(sd, device=dev)
            cb = cb.replace(engine="mega")
            seg = (tb, cb, pix, 4, 4 * (DEPTH + 1))
            err_b7 = max(err_b7, regen_mismatch(
                regen_segment(*seg, plain=False),
                regen_segment(*seg, plain=True), f"{label}: B7 vs plain"))
            one = cuda_mega.mega_trace_regen(tb, cb, pix, pix // SMALL_W, 0, 4)
            launches_by = {}
            for rc in (-1, 5):
                for group in (16, 128):
                    for shrink in (True, False):
                        st = {}
                        got = cuda_mega.mega_trace_regen(
                            tb, cb.replace(regen_compact=rc,
                                           compact_group=group,
                                           regen_shrink=shrink),
                            pix, pix // SMALL_W, 0, 4, stats=st)
                        key = f"{rc}/{group}/{'shrink' if shrink else 'full'}"
                        launches_by[key] = st["launches"]
                        if not torch.equal(got, one):
                            raise AssertionError(
                                f"{label}: regen_compact {key} changed the "
                                "radiance")
            print(f"  {label}: every segment schedule bit-identical to one "
                  f"segment; launches by regen_compact/group/shrink "
                  f"{launches_by}", flush=True)

    regen_main = {}
    for rc in (0, -1):
        with phase(f"26 main path: cover_scene {W}x{H} depth {DEPTH} spp "
                   f"{MAIN_SPP} engine mega regen=True regen_compact {rc}"):
            cfg_r = c16.replace(engine="mega", regen=True, regen_compact=rc)
            stats = {}
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.time()
            ev[0].record()
            img = render(t16, cfg_r, device="cuda", stats=stats)
            ev[1].record()
            torch.cuda.synchronize()
            sec = time.time() - t0
            ev_ms = ev[0].elapsed_time(ev[1])
            counts = read_counts()
            paths = W * H * MAIN_SPP
            print(f"  render {sec:.4f} s = {paths / sec:.0f} paths/s (CUDA "
                  f"events {ev_ms:.3f} ms); launches {counts}, ray-bounces "
                  f"{stats['ray_bounces']}; {smi}", flush=True)
            own = counts["mega_regen"]
            if own <= 0 or own != stats["launches"] or sum(counts.values()) \
                    != own:
                raise AssertionError(f"the regen frame launched {counts}, "
                                     f"stats say {stats['launches']}")
            if stats["ray_bounces"] != main["mega"]["bounces"]:
                raise AssertionError(
                    f"regen traced {stats['ray_bounces']} ray-bounces, the "
                    f"megakernel frame {main['mega']['bounces']}")
            if tuple(img.shape) != (H, W, 3) or \
                    not bool(torch.isfinite(img).all()):
                raise AssertionError("render is not a finite [H,W,3] image")
            img = img.cpu().numpy()
            differ = float((img != main["mega"]["img"]).any(-1).mean())
            print(f"  against the megakernel frame of phase 10: "
                  f"{differ:.6%} of pixels differ, mega "
                  f"{main['mega']['sec']:.4f} s, queue "
                  f"{main['queue']['sec']:.4f} s", flush=True)
            if differ:
                raise AssertionError("the regen frame is not the megakernel "
                                     "frame bit for bit")
            regen_main[rc] = dict(launches=own, sec=sec)

    from rt_tpu_torch.render.renderer import _block_order

    with phase(f"27 B7 vs plain and times at one regen call ({W * H} lanes, "
               f"depth {DEPTH})"):
        c16m = c16.replace(engine="mega")
        px_b, py_b, pix_b = (torch.from_numpy(x).to(dev)
                             for x in _block_order(W, H))  # launch order
        seg2 = (t16, c16m, pix_b, 2, 2 * (DEPTH + 1))
        err_b7 = max(err_b7, regen_mismatch(
            regen_segment(*seg2, plain=False),
            regen_segment(*seg2, plain=True), "spp 2"))
        seg16 = (t16, c16m, pix_b, MAIN_SPP, MAIN_SPP * (DEPTH + 1))
        ms16, k16 = cuda_ms(lambda: regen_segment(*seg16, plain=False), 3)
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        reset_plain_counts()
        ev[0].record()
        p16 = regen_segment(*seg16, plain=True)
        ev[1].record()
        torch.cuda.synchronize()
        pms16 = ev[0].elapsed_time(ev[1])
        err_b7 = max(err_b7, regen_mismatch(k16, p16, f"spp {MAIN_SPP}"))
        bounces16 = int(k16[3].sum())
        ops = hit_terms(bounces16) + CAMERA_OPS * MAIN_SPP * W * H
        ops_all = (bounces16 * (SPHERE_OPS_PER_PAIR * rows_k + SETUP_OPS)
                   + CAMERA_OPS * MAIN_SPP * W * H)
        nbytes = (W * H * (4 + 4 + 13 * 4 + 4 + 4)  # pixel, py in; state,
                  + rows_k * 18 * 4)               # samp, bvec out; table
        b7_bound, b7_by = bound_of(ops, nbytes)
        # B2's lane occupancy over the same samples, one segment each
        occ2, kw16 = [], mega_plain.trace_options(t16, c16m)
        for smp in range(MAIN_SPP):
            ro_, rd_ = generate_rays(t16.camera, W, H, px_b, py_b, smp, 0,
                                     c16m.enable_defocus)
            d_s = torch.zeros(W * H, dtype=torch.int32, device=dev)
            cuda_mega.mega_segment(mega_tables.scene_for(t16, c16m).table,
                                   mega_plain.fresh_state(ro_, rd_),
                                   pix_b.to(torch.int32), smp, 0, 0, DEPTH,
                                   depth=d_s, **kw16)
            occ2.append(d_s)
        occ_b2 = lane_occupancy(*occ2)
        print(f"  mega_regen at spp {MAIN_SPP}: {ms16:.4f} ms per call "
              f"(phase 11's B2 trace call x {MAIN_SPP}: "
              f"{rows['mega_segment']['ms'] * MAIN_SPP:.4f} ms), plain "
              f"{pms16:.4f} ms, bound {b7_bound:.4f} ms ({b7_by}: "
              f"{bounces16} ray-bounces, (lane, row) pairs tested "
              f"{rows_tested()} + {MAIN_SPP} x "
              f"{W * H} camera rays, {ops:.4g} ops, {nbytes:.4g} bytes; "
              f"{b7_bound / ms16:.1%} of the bound); lane occupancy from "
              f"per-lane bounce counts: B7 {lane_occupancy(k16[3]):.4f}, "
              f"B2 one segment per sample {occ_b2:.4f}; {smi}", flush=True)
        rows["mega_regen"] = dict(ms=ms16, plain_ms=pms16, bound_ms=b7_bound,
                                  bound_by=b7_by,
                                  bound_all_rows_ms=bound_of(ops_all,
                                                             nbytes)[0])

    from rt_tpu_torch import cli

    with phase(f"28 B2 / B3 / B7 vs plain bit for bit at {SMALL_W}x{SMALL_H} "
               "on scenes with rects, cylinders and triangles"):
        px = torch.arange(SMALL_W * SMALL_H, device=dev)
        for label, (sd, cb) in (
                ("all-families scene, depth 40",
                 all_families_scene(SMALL_W, SMALL_H, 2, 40)),
                ("demo_scene.json, depth 40",
                 demo_scene(SMALL_W, SMALL_H, 2))):
            tb = build_tables(sd, device=dev)
            if tb.mega.fam is None:
                raise AssertionError(f"{label}: no family tables")
            cb = cb.replace(engine="mega", compact_schedule=(2, 3, 5, 10),
                            compact_group=16)
            ro_, rd_ = generate_rays(tb.camera, SMALL_W, SMALL_H,
                                     px % SMALL_W, px // SMALL_W, 0, 0,
                                     cb.enable_defocus)
            args = (tb, cb, ro_, rd_, px, 0, 0)
            for name, fn in (("B2", cuda_mega.mega_trace),
                             ("B3", cuda_queue.queue_trace)):
                k_out, p_out = fn(*args), fn(*args, plain=True)
                differ = int((k_out != p_out).any(-1).sum())
                print(f"  {label}: {name} vs plain on {px.numel()} lanes, "
                      f"{differ} lanes differ, mean radiance "
                      f"{float(k_out.mean()):.4f}", flush=True)
                if differ:
                    raise AssertionError(f"{label}: {name} is not its plain "
                                         "version bit for bit")
            seg = (tb, cb, px, 2, 2 * (cb.max_depth + 1))
            err_b7 = max(err_b7, regen_mismatch(
                regen_segment(*seg, plain=False),
                regen_segment(*seg, plain=True), f"{label}: B7 vs plain"))

    demo = {}
    with phase("29 main path: python -m rt_tpu_torch render -f "
               "scenes/demo_scene.json (960x540, spp 128, depth 40, engine "
               "queue)"):
        sd, cd = demo_scene()
        dw, dh, dspp = cd.width, cd.height, cd.samples_per_pixel
        with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.time()
            rc = cli.main(["render", "-f", DEMO])  # no -o: demo.png here
            torch.cuda.synchronize()
            sec = time.time() - t0
            counts = read_counts()
            png = read_png(os.path.join(tmp, sd.output_file))
        paths = dw * dh * dspp
        print(f"  CLI {sec:.4f} s = {paths / sec:.0f} paths/s ({paths} paths, "
              f"scene parse and table build included); launches {counts}; "
              f"{smi}", flush=True)
        if rc != 0 or counts["queue_launch"] <= 0 or \
                sum(counts.values()) != counts["queue_launch"]:
            raise AssertionError(f"the CLI exited {rc}, launched {counts}")
        if png.shape != (dh, dw, 3) or png.max() == 0:
            raise AssertionError(f"the CLI wrote a bad PNG {png.shape}")
        demo["cli"] = dict(sec=sec, launches=counts["queue_launch"])
        td = build_tables(sd, device=dev)
        # the CLI's configuration: the compaction schedule at depth >= 16
        cd = cd.replace(compact_schedule=(2, 3, 5, 10), compact_group=16)
        for key, engine, regen in (("queue", "queue", False),
                                   ("mega", "mega", False),
                                   ("regen", "mega", True)):
            st = {}
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.time()
            img = render(td, cd.replace(engine=engine, regen=regen),
                         device="cuda", stats=st)
            torch.cuda.synchronize()
            sec = time.time() - t0
            counts = read_counts()
            own = counts["mega_regen" if regen else
                         "queue_launch" if engine == "queue"
                         else "mega_segment"]
            print(f"  render {key}: {sec:.4f} s = {paths / sec:.0f} paths/s, "
                  f"launches {counts}, ray-bounces {st['ray_bounces']} "
                  f"({st['ray_bounces'] / paths:.4f} per path); {smi}",
                  flush=True)
            if own <= 0 or own != st["launches"] or \
                    sum(counts.values()) != own:
                raise AssertionError(f"{key}: launched {counts}, stats say "
                                     f"{st['launches']}")
            if tuple(img.shape) != (dh, dw, 3) or \
                    not bool(torch.isfinite(img).all()):
                raise AssertionError(f"{key}: not a finite image")
            neg = film.negative_pixels(img)
            if neg:
                raise AssertionError(f"{key}: {neg} negative pixels")
            demo[key] = dict(img=img.cpu().numpy(), sec=sec, launches=own,
                             bounces=st["ray_bounces"])
        frac, mx = images_close(demo["queue"]["img"], demo["mega"]["img"],
                                dspp)
        differ = float((demo["regen"]["img"] != demo["mega"]["img"]).any(
            -1).mean())
        print(f"  queue vs mega: {frac:.3%} pixels beyond 2e-3, max diff "
              f"{mx:.4g}; regen vs mega: {differ:.6%} of pixels differ; "
              f"mean radiance {float(demo['queue']['img'].mean()) / dspp:.4f}",
              flush=True)
        if differ or demo["regen"]["bounces"] != demo["mega"]["bounces"]:
            raise AssertionError("the regen frame is not the mega frame")

    def family_workload(label, sd, cb, spp, b7_spp=None):
        """A family scene at 1920x1080: its frames on queue, mega and
        regen (launches, paths/s, the regen frame against the mega frame
        bit for bit, the queue frame against it by images_close), then
        one B2 and one B3 trace call of sample 0 and one B7 call over
        b7_spp samples (by default all spp), each timed with CUDA events
        and held against its plain version on every lane, beside its
        bound."""
        b7_spp = b7_spp or spp
        cb = cb.replace(rays_per_batch=1 << 25,
                        compact_schedule=(2, 3, 5, 10), compact_group=16)
        tb = build_tables(sd, device=dev)
        w_, h_, depth = cb.width, cb.height, cb.max_depth
        paths = w_ * h_ * spp
        out = {"frames": {}}
        frames = {}
        for key, engine, regen in (("queue", "queue", False),
                                   ("mega", "mega", False),
                                   ("regen", "mega", True)):
            st = {}
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.time()
            img = render(tb, cb.replace(engine=engine, regen=regen),
                         device="cuda", stats=st)
            torch.cuda.synchronize()
            sec = time.time() - t0
            counts = read_counts()
            own = counts["mega_regen" if regen else
                         "queue_launch" if engine == "queue"
                         else "mega_segment"]
            print(f"  {label} frame {key}: {sec:.4f} s = "
                  f"{paths / sec:.0f} paths/s, launches {counts}, "
                  f"ray-bounces {st['ray_bounces']} "
                  f"({st['ray_bounces'] / paths:.4f} per path); {smi}",
                  flush=True)
            if own <= 0 or own != st["launches"] or \
                    sum(counts.values()) != own:
                raise AssertionError(f"{label} {key}: launched {counts}")
            if not bool(torch.isfinite(img).all()) or \
                    film.negative_pixels(img):
                raise AssertionError(f"{label} {key}: a bad image")
            frames[key] = img.cpu().numpy()
            out["frames"][key] = dict(sec=sec, launches=own,
                                      paths_per_s=paths / sec,
                                      ray_bounces=st["ray_bounces"])
        frac, mx = images_close(frames["queue"], frames["mega"], spp)
        differ = float((frames["regen"] != frames["mega"]).any(-1).mean())
        print(f"  {label}: queue vs mega {frac:.3%} pixels beyond 2e-3, "
              f"max diff {mx:.4g}; regen vs mega {differ:.6%} of pixels "
              "differ", flush=True)
        if differ:
            raise AssertionError(f"{label}: regen frame != mega frame")

        px_ = torch.arange(w_ * h_, device=dev)
        ro_, rd_ = generate_rays(tb.camera, w_, h_, px_ % w_, px_ // w_, 0,
                                 0, cb.enable_defocus)
        args = (tb, cb, ro_, rd_, px_, 0, 0)
        ops_row = hit_ops(tb)
        nbytes_tab = table_bytes(tb)
        for name, fn in (("mega_segment", cuda_mega.mega_trace),
                         ("queue_launch", cuda_queue.queue_trace)):
            st = {}
            k_out = fn(*args, stats=st)
            ms, _ = cuda_ms(lambda: fn(*args), 5)
            reset_plain_counts()
            pms, p_out = cuda_ms(lambda: fn(*args, plain=True), 1)
            differ = int((k_out != p_out).any(-1).sum())
            t_ops, t_bytes, t_hits = texel_terms(calls=2)
            ops = hit_terms(st["ray_bounces"], calls=2) + t_ops
            b_ms, b_by = bound_of(ops, w_ * h_ * (12 + 12 + 4 + 12)
                                  + nbytes_tab + t_bytes)
            texel_note = (f" + {t_hits} texel-sampled hits"
                          if t_hits else "")
            print(f"  {label} {name}: trace {ms:.4f} ms, plain {pms:.4f} ms "
                  f"({differ} of {w_ * h_} lanes differ), bound {b_ms:.4f} "
                  f"ms ({b_by}: {st['ray_bounces']} ray-bounces, (lane, "
                  f"row) pairs tested {rows_tested(calls=2)} of "
                  f"{st['ray_bounces']} x rows {tb.counts}{texel_note}, "
                  f"{ops:.4g} ops; {b_ms / ms:.1%} of the bound; over all "
                  f"rows {bound_of(st['ray_bounces'] * ops_row, 0)[0]:.4f} "
                  f"ms); {smi}", flush=True)
            if differ:
                raise AssertionError(f"{label}: {name} != plain")
            out[name] = dict(ms=ms, plain_ms=pms, bound_ms=b_ms,
                             bound_by=b_by, max_abs_err=0.0,
                             launches=out["frames"][
                                 "queue" if name == "queue_launch"
                                 else "mega"]["launches"])
        cbm = cb.replace(engine="mega")
        px_b, py_b, pix_b = (torch.from_numpy(x).to(dev)
                             for x in _block_order(w_, h_))
        seg = (tb, cbm, pix_b, b7_spp, b7_spp * (depth + 1))
        ms7, k7 = cuda_ms(lambda: regen_segment(*seg, plain=False), 3)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        reset_plain_counts()
        torch.cuda.synchronize()
        ev[0].record()
        p7 = regen_segment(*seg, plain=True)
        ev[1].record()
        torch.cuda.synchronize()
        pms7 = ev[0].elapsed_time(ev[1])
        err = regen_mismatch(k7, p7, f"{label} B7 vs plain, spp {b7_spp}")
        bounces = int(k7[3].sum())
        t_ops, t_bytes, _ = texel_terms()
        ops = hit_terms(bounces) + CAMERA_OPS * b7_spp * w_ * h_ + t_ops
        b_ms, b_by = bound_of(ops, w_ * h_ * (4 + 4 + 13 * 4 + 4 + 4)
                              + nbytes_tab + t_bytes)
        print(f"  {label} mega_regen at spp {b7_spp}: {ms7:.4f} ms per "
              f"call, "
              f"plain {pms7:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {bounces} "
              f"ray-bounces, (lane, row) pairs tested {rows_tested()} + "
              f"{b7_spp} x {w_ * h_} camera rays, {ops:.4g} ops; "
              f"{b_ms / ms7:.1%} of the bound); lane "
              f"occupancy {lane_occupancy(k7[3]):.4f}; {smi}", flush=True)
        out["mega_regen"] = dict(ms=ms7, plain_ms=pms7, bound_ms=b_ms,
                                 bound_by=b_by, max_abs_err=err,
                                 launches=out["frames"]["regen"]["launches"])
        return out

    families = {}
    with phase(f"30 cover_scene(lights=True) {W}x{H} depth {DEPTH} spp "
               f"{MAIN_SPP}: 487 spheres, an xy_rect and a cylinder light"):
        sd, cb = cover_scene(width=W, height=H, spp=MAIN_SPP,
                             max_depth=DEPTH, lights=True)
        # its B7 call over 4 samples: the plain version's spp 16 took 20 s
        families["cover_lights"] = family_workload("cover_lights", sd, cb,
                                                   MAIN_SPP, b7_spp=4)
    with phase(f"31 mesh_scene(plane441.obj) {W}x{H} depth 16 spp 4: 800 "
               "triangles and 3 spheres, gradient sky, exhaust background"):
        from rt_tpu_torch.scene.builders import mesh_scene

        sd, cb = mesh_scene(MESH, width=W, height=H, spp=4, max_depth=16)
        families["mesh"] = family_workload("mesh", sd, cb, 4)

    with phase(f"32 B4 / B5 / B6 vs plain at {SMALL_W}x{SMALL_H} on scenes "
               "with rects, cylinders and triangles"):
        for label, (sd, cb) in (
                ("all-families scene, depth 40",
                 all_families_scene(SMALL_W, SMALL_H, 1, 40)),
                ("demo_scene.json, depth 40",
                 demo_scene(SMALL_W, SMALL_H, 1))):
            tb = build_tables(sd, device=dev)
            for p_rr, bg_mode in ((0.0, "constant"), (0.9, "gradient")):
                cb_ = cb.replace(p_rr=p_rr, background_mode=bg_mode,
                                 compact_schedule=(2, 3, 5, 10),
                                 compact_group=16)
                pix, ro_, rd_, L, g = adjoint_inputs(tb, cb_, SMALL_W, SMALL_H,
                                                     0)
                args = (tb, cb_, ro_, rd_, pix, 0, 0)
                lab = f"{label}, p_rr {p_rr}, {bg_mode} sky"
                got = cuda_mega.mega_capture(*args)
                err_b4 += capture_mismatch(
                    got, cuda_mega.mega_capture(*args, plain=True),
                    f"{lab}: B4 vs plain")
                fams = sorted(set((got[0][got[0] >= 0] >> 24).tolist()))
                print(f"    families in B4's codes: {fams}", flush=True)
                if len(fams) < 3:
                    raise AssertionError(f"{lab}: codes of {fams} only")
                for depth_bwd, exh in ((cb_.max_depth, False), (3, True),
                                       (TRAIN_BWD_DEPTH, False)):
                    adj = (*args, L, g, depth_bwd, exh)
                    plain = cuda_queue.queue_trace_adjoint(*adj, plain=True)
                    k_m = cuda_mega.mega_trace_adjoint(*adj)
                    k_q = cuda_queue.queue_trace_adjoint(*adj,
                                                         check_once=True)
                    k_s = cuda_queue.queue_trace_adjoint(
                        *adj, check_once=True, pool_lanes=SMALL_POOL)
                    lab2 = f"{lab}, depth {depth_bwd}, exhaust {exh}"
                    err_b5 = max(err_b5, grads_close(plain, k_m,
                                                     f"{lab2}: B5"))
                    err_b6 = max(err_b6, grads_close(plain, k_q,
                                                     f"{lab2}: B6"))
                    err_b6 = max(err_b6, grads_close(
                        plain, k_s, f"{lab2}: B6 with {SMALL_POOL} pool "
                        "lanes"))
                    grads_close(k_m, k_q, f"{lab2}: B6 vs B5")
                # the rect light's emission lands in its texture row
                light = int(tb.mega.fam.rect[0, 31])
                if not float(plain["tex_color"][light].abs().max()) > 0.0:
                    raise AssertionError(f"{lab}: no gradient in the rect "
                                         f"light's texture row {light}")

    def family_b456(label, sd, cb, g_std=None):
        """One B4, B5 and B6 call of sample 0 on every pixel of a family
        scene, by CUDA events, against the plain version of the same call
        and the bound of B2's operation count on these rays; g_std as
        adjoint_inputs'."""
        cb = cb.replace(compact_schedule=(2, 3, 5, 10), compact_group=16)
        tb = build_tables(sd, device=dev)
        w_, h_, depth = cb.width, cb.height, cb.max_depth
        pix, ro_, rd_, L, g = adjoint_inputs(tb, cb, w_, h_, 0, g_std)
        args = (tb, cb, ro_, rd_, pix, 0, 0)
        nbytes_tab = table_bytes(tb)
        out = {}
        ms4, got = cuda_ms(lambda: cuda_mega.mega_capture(*args), 3)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        reset_plain_counts()
        ev[0].record()
        want = cuda_mega.mega_capture(*args, plain=True)
        ev[1].record()
        torch.cuda.synchronize()
        pms4 = ev[0].elapsed_time(ev[1])
        capture_mismatch(got, want, f"{label} B4 vs plain")
        death = got[1]
        bounces = int(torch.where(death < depth, death + 1, death).sum())
        b_ms, b_by = bound_of(hit_terms(bounces),
                              w_ * h_ * (13 * 4 + 4) + nbytes_tab
                              + (depth + 1) * w_ * h_ * 4)
        print(f"  {label} mega_capture: {ms4:.4f} ms, plain {pms4:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}: {bounces} ray-bounces, (lane, "
              f"row) pairs tested {rows_tested()}; {b_ms / ms4:.1%} of the "
              f"bound); {smi}", flush=True)
        out["mega_capture"] = dict(ms=ms4, plain_ms=pms4, bound_ms=b_ms,
                                   bound_by=b_by, max_abs_err=0, launches=1)
        adj = (*args, L, g, depth, False)
        for name, fn in (("mega_adjoint_segment",
                          cuda_mega.mega_trace_adjoint),
                         ("queue_adjoint_launch",
                          cuda_queue.queue_trace_adjoint)):
            st = {}
            k_out = fn(*adj, stats=st)
            ms, _ = cuda_ms(lambda: fn(*adj), 3)
            reset_plain_counts()
            pms, p_out = cuda_ms(lambda: fn(*adj, plain=True), 1)
            err = grads_close(p_out, k_out, f"{label} {name} vs plain")
            # a texel-sampled hit reads its sector and adds to it
            t_ops, t_bytes, _ = texel_terms(calls=2)
            b_ms, b_by = bound_of(
                hit_terms(st["ray_bounces"], calls=2)
                + st["ray_bounces"] * ADJOINT_OPS + t_ops,
                w_ * h_ * (12 + 12 + 4 + 12 + 12) + nbytes_tab
                + 8 * tb.mega.n_slots * 4 + 2 * t_bytes
                + (tb.mega.img.atlas.numel() * 4 if tb.mega.img is not None
                   else 0))
            print(f"  {label} {name}: adjoint call {ms:.4f} ms, plain "
                  f"{pms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: "
                  f"{st['ray_bounces']} ray-bounces, (lane, row) pairs "
                  f"tested {rows_tested(calls=2)}; "
                  f"{b_ms / ms:.1%} of the bound), {st['launches']} "
                  f"launches; {smi}", flush=True)
            out[name] = dict(ms=ms, plain_ms=pms, bound_ms=b_ms,
                             bound_by=b_by, max_abs_err=err,
                             launches=st["launches"])
            if tb.mega.img is not None:
                mag, ratio = atlas_held(p_out, k_out, f"{label} {name}")
                out[name].update(atlas_max_abs=mag, atlas_err_ratio=ratio)
        return out

    with phase(f"33 B4 / B5 / B6 vs plain and times at one call on "
               f"cover_scene(lights=True) {W}x{H} depth {DEPTH} and "
               f"mesh_scene {W}x{H} depth 16"):
        for key, (sd, cb) in (
                ("cover_lights", cover_scene(width=W, height=H, spp=1,
                                             max_depth=DEPTH, lights=True)),
                ("mesh", mesh_scene(MESH, width=W, height=H, spp=1,
                                    max_depth=16))):
            families[key].update(family_b456(key, sd, cb))

    fam_train = {}
    s_l, c_l = cover_scene(width=W, height=H, spp=1, max_depth=DEPTH,
                           lights=True)
    c_l = c_l.replace(compact_schedule=(2, 3, 5, 10), compact_group=16)
    t_l = build_tables(s_l, device=dev)
    for engine in ("queue", "mega"):
        for bwd_depth in (TRAIN_BWD_DEPTH, None):
            with phase(f"34 training step: cover_scene(lights=True) {W}x{H} "
                       f"depth {DEPTH} spp 1 engine {engine} bwd_depth "
                       f"{bwd_depth or 'exact'}"):
                loss_fn = make_replay_loss_fn(t_l, c_l.replace(engine=engine),
                                              1, px1 % W, px1 // W, tgt1,
                                              bwd_depth=bwd_depth)
                params = {k: getattr(t_l, k).clone().requires_grad_(True)
                          for k in ("tex_color", "mat_albedo")}
                reset_counts()
                torch.cuda.synchronize()
                t0 = time.time()
                loss = loss_fn(params)
                torch.cuda.synchronize()
                t_fwd = time.time() - t0
                loss.backward()
                torch.cuda.synchronize()
                t_step = time.time() - t0
                counts = read_counts()
                fwd_k, adj_k = (("queue_launch", "queue_adjoint_launch")
                                if engine == "queue" else
                                ("mega_segment", "mega_adjoint_segment"))
                print(f"  loss {float(loss.detach()):.6f}: forward "
                      f"{t_fwd:.4f} s, backward {t_step - t_fwd:.4f} s, "
                      f"step {t_step:.4f} s (sphere cover, phase 14: "
                      f"{train[(engine, bwd_depth)]['step']:.4f} s); "
                      f"launches {counts}; {smi}", flush=True)
                if counts[fwd_k] <= 0 or counts[adj_k] <= 0:
                    raise AssertionError(f"{engine}: the step launched "
                                         f"{counts}")
                light = int(t_l.mega.fam.rect[0, 31])
                for k, v in params.items():
                    if v.grad is None or not bool(
                            torch.isfinite(v.grad).all()) or not float(
                            v.grad.abs().max()) > 0.0:
                        raise AssertionError(f"{engine}: bad gradient {k}")
                if not float(params["tex_color"].grad[light].abs().max()) \
                        > 0.0:
                    raise AssertionError(f"{engine}: no gradient in the "
                                         f"light's texture row {light}")
                fam_train[(engine, bwd_depth)] = dict(
                    fwd=t_fwd, step=t_step, launches=counts[adj_k])

    fam_tape = {}
    with phase(f"35 tape steps: cover_scene(lights=True) {W}x{H} depth "
               f"{DEPTH} spp 1 with the rect and cylinder fields; "
               f"mesh_scene {W}x{H} depth 16 spp 1 with tri_v1..3"):
        t_a, c_a, p_a, tgt_a = tape_workload(W, H, DEPTH, dev, lights=True)
        s_m, c_m = mesh_scene(MESH, width=W, height=H, spp=1, max_depth=16)
        t_m = build_tables(s_m, device=dev)
        tgt_m = render(t_m, c_m.replace(samples_per_pixel=4, engine="queue",
                                        rays_per_batch=1 << 25),
                       device="cuda").reshape(-1, 3) / 4.0
        p_m = {k: getattr(t_m, k).clone()
               for k in ("tri_v1", "tri_v2", "tri_v3", "mat_albedo")}
        p_m["tri_v1"] = p_m["tri_v1"] + 0.005
        pix = torch.arange(W * H, device=dev)
        for key, tb, cb, p, tg in (("cover_lights", t_a, c_a, p_a, tgt_a),
                                   ("mesh", t_m, c_m, p_m, tgt_m)):
            vg = tape.make_tape_vg(tb, cb, pix % W, pix // W, tg)
            vg(p)  # allocator, kernels
            times = {}
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.time()
            loss, grads = vg(p, times=times)
            torch.cuda.synchronize()
            step_s = time.time() - t0
            counts = read_counts()
            print(f"  {key}: loss {float(loss):.6f}: capture "
                  f"{times['capture_s'] * 1e3:.2f} ms, replay forward "
                  f"{times['forward_s']:.4f} s, backward "
                  f"{times['backward_s']:.4f} s, step {step_s:.4f} s "
                  f"(sphere cover, phase 20: {tape_step_s:.4f} s); widths "
                  f"{times['widths']}; launches {counts}; {smi}",
                  flush=True)
            if counts["mega_capture"] != 1:
                raise AssertionError(f"{key}: the tape step launched B4 "
                                     f"{counts['mega_capture']} times")
            for k, gk in grads.items():
                mx = float(gk.abs().max())
                print(f"    max |g| {k}: {mx:.6g}", flush=True)
                if not bool(torch.isfinite(gk).all()):
                    raise AssertionError(f"{key}: non-finite gradient {k}")
            # fields with no interior gradient here (as under
            # method="ad"): cover_lights' rect and cylinder are its
            # lights, and an emitter adds P * emission wherever it is
            # hit; a triangle's v2 and v3 act only through its (u, v),
            # which the mesh's solid texture does not read
            zero, nonzero = ((FAMILY_FIELDS, ("sph_center", "tex_color"))
                             if key == "cover_lights" else
                             (("tri_v2", "tri_v3"), ("tri_v1",)))
            for k, gk in grads.items():
                mx = float(gk.abs().max())
                if (k in zero and mx != 0.0) or (k in nonzero and
                                                 not mx > 0.0):
                    raise AssertionError(f"{key}: gradient {k} is {mx}")
            fam_tape[key] = dict(step=step_s, launches=counts["mega_capture"])

    fit_cli = {}
    with phase("36 main path: python -m rt_tpu_torch fit -f "
               "scenes/demo_scene.json (960x540, depth 40, spp 4, 3 steps)"):
        sd, cd = demo_scene()
        p = sd.camera_params
        # the target: the light's emission x 0.8, the blue sphere green,
        # seen from 0.05 to the side (a pose for --camera to recover)
        sd.set_camera([p["lookfrom"][0] + 0.05] + p["lookfrom"][1:],
                      p["lookat"], p["vup"], p["vfov"], p["aperture"])
        td = build_tables(sd, device=dev)
        tc = td.tex_color.clone()
        tc[3] = tc[3] * 0.8
        tc[1] = torch.tensor([0.2, 0.6, 0.3], device=dev)
        import dataclasses
        img = render(dataclasses.replace(td, tex_color=tc),
                     cd.replace(engine="queue"),
                     device="cuda") / cd.samples_per_pixel
        base = ["fit", "-f", DEMO, "--target", "T.npz", "--fields",
                "tex_color,mat_albedo", "-spp", "4", "--steps", "3"]
        calls = (("replay", [], ("queue_launch", "queue_adjoint_launch")),
                 ("mega", ["--engine", "mega"],
                  ("mega_segment", "mega_adjoint_segment")),
                 ("tape", ["--method", "tape", "--fields",
                           "rect_k,cyl_radius,tex_color"],
                  ("mega_capture",)),
                 ("fd", ["--fd", "sph_center:1,0"],
                  ("queue_launch", "queue_adjoint_launch")),
                 ("camera", ["--camera", "lookfrom"], ("queue_launch",)))
        with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
            np.savez("T.npz", img=img.cpu().numpy())
            for key, extra, want in calls:
                out_dir = os.path.join(tmp, key)
                reset_counts()
                torch.cuda.synchronize()
                t0 = time.time()
                rc = cli.main(base + extra + ["--out", out_dir])
                torch.cuda.synchronize()
                sec = time.time() - t0
                counts = read_counts()
                files = {f: os.path.getsize(os.path.join(out_dir, f))
                         for f in ("recovered.npz", "after.png")
                         if os.path.exists(os.path.join(out_dir, f))}
                print(f"  fit {key}: exit {rc}, {sec:.4f} s (3 steps and "
                      f"the after.png render at spp {cd.samples_per_pixel}"
                      f"); launches {counts}; files {files}; {smi}",
                      flush=True)
                if rc != 0 or len(files) != 2 or \
                        any(counts[k] <= 0 for k in want):
                    raise AssertionError(f"fit {key}: exit {rc}, launched "
                                         f"{counts}, wrote {files}")
                fit_cli[key] = dict(sec=sec, launches=counts)

    # ---- next-event estimation, MIS and glossy (B2, B3, B5, B6 with
    # kNee) ----
    nee_rows = {}
    with phase(f"37 NEE: B2 / B3 vs plain bit for bit, B5 / B6 vs plain "
               f"at {SMALL_W}x{SMALL_H} depth 8"):
        px = torch.arange(SMALL_W * SMALL_H, device=dev)
        err_nee_b5 = err_nee_b6 = 0.0
        for label, (sd, cb) in (
                ("four light families", light_scene(SMALL_W, SMALL_H, 1, 8)),
                ("demo_scene.json", demo_scene(SMALL_W, SMALL_H, 1))):
            tb = build_tables(sd, device=dev)
            if tb.mega.lights is None:
                raise AssertionError(f"{label}: no light table")
            ro_, rd_ = generate_rays(tb.camera, SMALL_W, SMALL_H,
                                     px % SMALL_W, px // SMALL_W, 1, 0,
                                     cb.enable_defocus)
            for flags, kw in NEE_FLAGS.items():
                for p_rr in (0.0, 0.9):
                    c = cb.replace(max_depth=8, p_rr=p_rr, compact_every=2,
                                   queue_steps=3, **kw)
                    for name, fn, eng in (
                            ("B2", cuda_mega.mega_trace, "mega"),
                            ("B3", cuda_queue.queue_trace, "queue")):
                        ce = c.replace(engine=eng)
                        reset_counts()
                        k_out = fn(tb, ce, ro_, rd_, px, 1, 0)
                        counts = read_counts()
                        p_out = fn(tb, ce, ro_, rd_, px, 1, 0, plain=True)
                        differ = int((k_out != p_out).any(-1).sum())
                        print(f"  {label}, {flags}, p_rr {p_rr}: {name} vs "
                              f"plain on {px.numel()} lanes, {differ} lanes "
                              f"differ, mean radiance "
                              f"{float(k_out.mean()):.5f}, launches "
                              f"{sum(counts.values())}", flush=True)
                        if differ or sum(counts.values()) <= 0:
                            raise AssertionError(
                                f"{label} {flags}: {name} is not its plain "
                                "version bit for bit")
            c = cb.replace(max_depth=8, nee=True, compact_every=2)
            pix, ro_a, rd_a, L, g = adjoint_inputs(tb, c, SMALL_W, SMALL_H,
                                                   0)
            for p_rr in (0.0, 0.9):
                ca = c.replace(p_rr=p_rr)
                L = cuda_queue.queue_trace(tb, ca, ro_a, rd_a, pix, 0, 0)
                for depth_bwd, exh in ((8, False), (3, False)):
                    adj = (tb, ca, ro_a, rd_a, pix, 0, 0, L, g, depth_bwd,
                           exh)
                    plain = cuda_queue.queue_trace_adjoint(*adj, plain=True)
                    k_m = cuda_mega.mega_trace_adjoint(*adj)
                    k_q = cuda_queue.queue_trace_adjoint(*adj,
                                                         check_once=True)
                    lab = f"{label}, nee, p_rr {p_rr}, depth {depth_bwd}"
                    err_nee_b5 = max(err_nee_b5,
                                     grads_close(plain, k_m, f"{lab}: B5"))
                    err_nee_b6 = max(err_nee_b6,
                                     grads_close(plain, k_q, f"{lab}: B6"))
                    grads_close(k_m, k_q, f"{lab}: B6 vs B5")

    with phase(f"38 NEE at the bench shape: cover_scene(lights=True) {W}x{H} "
               f"depth {DEPTH} spp {MAIN_SPP}, nee and mis, queue and mega"):
        sd, cb = cover_scene(width=W, height=H, spp=MAIN_SPP,
                             max_depth=DEPTH, lights=True)
        # the CLI's schedule at depth >= 16, as phase 30's frames
        cb = cb.replace(rays_per_batch=1 << 25,
                        compact_schedule=(2, 3, 5, 10), compact_group=16)
        tb = build_tables(sd, device=dev)
        paths = W * H * MAIN_SPP
        frames, nee_frames = {}, {}
        for flags, kw in (("plain", {}), ("nee", dict(nee=True)),
                          ("mis", dict(nee=True, mis=True))):
            for engine in ("queue", "mega"):
                st = {}
                reset_counts()
                torch.cuda.synchronize()
                t0 = time.time()
                img = render(tb, cb.replace(engine=engine, **kw),
                             device="cuda", stats=st)
                torch.cuda.synchronize()
                sec = time.time() - t0
                counts = read_counts()
                own = counts["queue_launch" if engine == "queue"
                             else "mega_segment"]
                mean = float(img.mean()) / MAIN_SPP
                print(f"  {flags} {engine} frame: {sec:.4f} s = "
                      f"{paths / sec:.0f} paths/s, launches {counts}, "
                      f"ray-bounces {st['ray_bounces']}, mean radiance "
                      f"{mean:.6f}; {smi}", flush=True)
                if own <= 0 or sum(counts.values()) != own or \
                        not bool(torch.isfinite(img).all()) or \
                        film.negative_pixels(img):
                    raise AssertionError(f"{flags} {engine}: launched "
                                         f"{counts}, or a bad image")
                frames[(flags, engine)] = dict(
                    sec=sec, paths_per_s=paths / sec, launches=own,
                    ray_bounces=st["ray_bounces"], mean=mean)
                nee_frames[(flags, engine)] = img.cpu().numpy()
        for flags in ("nee", "mis"):
            frac, mx = images_close(nee_frames[(flags, "queue")],
                                    nee_frames[(flags, "mega")], MAIN_SPP)
            rel = abs(frames[(flags, "queue")]["mean"]
                      - frames[("plain", "queue")]["mean"]) \
                / frames[("plain", "queue")]["mean"]
            print(f"  {flags}: queue vs mega {frac:.3%} pixels beyond 2e-3, "
                  f"max diff {mx:.4g}; mean radiance against the frame "
                  f"without NEE {rel:.4%} apart", flush=True)
            # another estimator of the same image: the means agree
            if rel > 0.01:
                raise AssertionError(f"{flags}: the frame's mean is {rel:.2%}"
                                     " from the frame without NEE")
        # one trace call of sample 0 on every pixel, and one exact adjoint
        # call, against their plain versions and the bound
        px_ = torch.arange(W * H, device=dev)
        ro_, rd_ = generate_rays(tb.camera, W, H, px_ % W, px_ // W, 0, 0,
                                 cb.enable_defocus)
        nbytes_tab = table_bytes(tb) + tb.mega.lights.numel() * 4
        cn = cb.replace(nee=True)

        def nee_bound(ray_bounces, extra_bytes):
            """(ms, by, ops): the hit loops of the ray-bounces plus the
            shadow rays' any-hit rows the plain version just counted."""
            rows = mega_plain.shadow_occluded.rows
            rays = mega_plain.shadow_occluded.rays
            ops = (hit_terms(ray_bounces, calls=2)
                   + rays * SHADOW_SETUP_OPS
                   + sum(o * n for o, n in zip(FAMILY_OPS, rows)))
            return (*bound_of(ops, extra_bytes + nbytes_tab), ops, rays)

        for name, fn in (("mega_segment", cuda_mega.mega_trace),
                         ("queue_launch", cuda_queue.queue_trace)):
            args = (tb, cn.replace(engine="mega" if name == "mega_segment"
                                   else "queue"), ro_, rd_, px_, 0, 0)
            st = {}
            k_out = fn(*args, stats=st)
            ms, _ = cuda_ms(lambda: fn(*args), 5)
            reset_plain_counts()
            pms, p_out = cuda_ms(lambda: fn(*args, plain=True), 1)
            differ = int((k_out != p_out).any(-1).sum())
            b_ms, b_by, ops, rays = nee_bound(
                st["ray_bounces"], W * H * (12 + 12 + 4 + 12))
            print(f"  nee {name}: trace {ms:.4f} ms, plain {pms:.4f} ms "
                  f"({differ} of {W * H} lanes differ), bound {b_ms:.4f} ms "
                  f"({b_by}: {st['ray_bounces']} ray-bounces, (lane, row) "
                  f"pairs tested {rows_tested(calls=2)} + {rays} shadow rays "
                  f"with "
                  f"{mega_plain.shadow_occluded.rows} rows tested, "
                  f"{ops:.4g} ops; {b_ms / ms:.1%} of the bound); {smi}",
                  flush=True)
            if differ:
                raise AssertionError(f"nee {name} != plain")
            nee_rows[name] = dict(ms=ms, plain_ms=pms, bound_ms=b_ms,
                                  bound_by=b_by, max_abs_err=0.0,
                                  ray_bounces=st["ray_bounces"],
                                  shadow_rays=rays,
                                  frame_launches=frames[
                                      ("nee", "queue" if name ==
                                       "queue_launch" else "mega")][
                                      "launches"])
        pix, ro_a, rd_a, L, g = adjoint_inputs(tb, cn, W, H, 0)
        adj = (tb, cn, ro_a, rd_a, pix, 0, 0, L, g, DEPTH, False)
        for name, fn in (("mega_adjoint_segment",
                          cuda_mega.mega_trace_adjoint),
                         ("queue_adjoint_launch",
                          cuda_queue.queue_trace_adjoint)):
            st = {}
            k_out = fn(*adj, stats=st)
            ms, _ = cuda_ms(lambda: fn(*adj), 3)
            reset_plain_counts()
            pms, p_out = cuda_ms(lambda: fn(*adj, plain=True), 1)
            err = grads_close(p_out, k_out, f"nee {name} vs plain")
            b_ms, b_by, ops, rays = nee_bound(
                st["ray_bounces"], W * H * (12 + 12 + 4 + 12 + 12)
                + 8 * tb.mega.n_slots * 4)
            print(f"  nee {name}: exact adjoint call {ms:.4f} ms, plain "
                  f"{pms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: "
                  f"{st['ray_bounces']} ray-bounces, {rays} shadow rays, "
                  f"{ops:.4g} ops; {b_ms / ms:.1%} of the bound), "
                  f"{st.get('launches')} launches; {smi}", flush=True)
            nee_rows[name] = dict(ms=ms, plain_ms=pms, bound_ms=b_ms,
                                  bound_by=b_by, max_abs_err=err,
                                  ray_bounces=st["ray_bounces"],
                                  shadow_rays=rays,
                                  call_launches=st.get("launches"))

    with phase("39 main path: python -m rt_tpu_torch render -f "
               "scenes/demo_scene.json --nee, --mis, --mis --nee-glossy "
               "(960x540, spp 128, depth 40, engine queue)"):
        sd, cd = demo_scene()
        dw, dh, dspp = cd.width, cd.height, cd.samples_per_pixel
        nee_cli = {}
        for key, flags in (("nee", ["--nee"]), ("mis", ["--mis"]),
                           ("mis_glossy", ["--mis", "--nee-glossy"])):
            with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
                reset_counts()
                torch.cuda.synchronize()
                t0 = time.time()
                rc = cli.main(["render", "-f", DEMO, "-o", "d.ppm"] + flags)
                torch.cuda.synchronize()
                sec = time.time() - t0
                counts = read_counts()
                vals = np.array(open("d.ppm").read().split()[4:],
                                dtype=np.float64)
            paths = dw * dh * dspp
            print(f"  render {' '.join(flags)}: exit {rc}, {sec:.4f} s = "
                  f"{paths / sec:.0f} paths/s; launches {counts}; image "
                  f"{vals.size // 3} pixels, mean {vals.mean():.3f}; {smi}",
                  flush=True)
            if rc != 0 or counts["queue_launch"] <= 0 or \
                    sum(counts.values()) != counts["queue_launch"] or \
                    vals.size != dw * dh * 3 or \
                    not np.isfinite(vals).all() or vals.max() <= 0:
                raise AssertionError(f"render {flags}: exit {rc}, launched "
                                     f"{counts}, or a bad image")
            nee_cli[key] = dict(sec=sec, launches=counts["queue_launch"])

    with phase("40 main path: python -m rt_tpu_torch fit -f "
               "scenes/demo_scene.json --nee (960x540, depth 40, spp 4, 3 "
               "steps): replay, mega, tape (depth 16)"):
        sd, cd = demo_scene()
        p = sd.camera_params
        td = build_tables(sd, device=dev)
        tc = td.tex_color.clone()
        tc[3] = tc[3] * 0.8
        tc[1] = torch.tensor([0.2, 0.6, 0.3], device=dev)
        import dataclasses
        img = render(dataclasses.replace(td, tex_color=tc),
                     cd.replace(engine="queue", nee=True),
                     device="cuda") / cd.samples_per_pixel
        base = ["fit", "-f", DEMO, "--target", "T.npz", "--fields",
                "tex_color,mat_albedo", "-spp", "4", "--steps", "3", "--nee"]
        # the tape fit at depth 16: at 40 its replay took 27 s
        calls = (("replay", [], ("queue_launch", "queue_adjoint_launch")),
                 ("mega", ["--engine", "mega"],
                  ("mega_segment", "mega_adjoint_segment")),
                 ("tape", ["--method", "tape", "-d", "16"],
                  ("mega_capture",)))
        nee_fit = {}
        with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
            np.savez("T.npz", img=img.cpu().numpy())
            for key, extra, want in calls:
                out_dir = os.path.join(tmp, key)
                reset_counts()
                torch.cuda.synchronize()
                t0 = time.time()
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    rc = cli.main(base + extra + ["--out", out_dir])
                torch.cuda.synchronize()
                sec = time.time() - t0
                counts = read_counts()
                text = buf.getvalue()
                print("  " + text.strip().splitlines()[0], flush=True)
                print(f"  fit --nee {key}: exit {rc}, {sec:.4f} s (3 steps "
                      f"and the after.png render at spp "
                      f"{cd.samples_per_pixel}); launches {counts}; {smi}",
                      flush=True)
                if rc != 0 or not text.startswith("loss: ") or \
                        any(counts[k] <= 0 for k in want):
                    raise AssertionError(f"fit --nee {key}: exit {rc}, "
                                         f"launched {counts}")
                nee_fit[key] = dict(sec=sec, launches=counts)

    # ---- image textures (B2-B7 with kImages) ----
    img_tmp = tempfile.TemporaryDirectory()
    tmpd = img_tmp.name
    for name, size, seed in (("small_a.png", 64, 21), ("small_b.png", 64, 22),
                             ("mesh.png", 512, 23), ("demo_sphere.png", 512,
                                                     24),
                             ("demo_light.png", 512, 25)):
        seeded_png(os.path.join(tmpd, name), size, seed)
    from rt_tpu_torch.scene.assets import load_image_texture
    from rt_tpu_torch.scene.parser import parse_scene

    tex_demo = textured_demo_json(tmpd, "demo_sphere.png", "demo_light.png")
    small_a, small_b = (load_image_texture(os.path.join(tmpd, n))
                        for n in ("small_a.png", "small_b.png"))
    img_rows = {}
    err_img = {"b5": 0.0, "b6": 0.0}
    with phase(f"41 image textures: B2 / B3 vs plain bit for bit at "
               f"{SMALL_W}x{SMALL_H} depth 8 (nee off, nee, mis; p_rr 0 "
               "and 0.9), B4 / B7 vs plain, B5 / B6 vs plain with the "
               "atlas gradient"):
        px = torch.arange(SMALL_W * SMALL_H, device=dev)
        sd_d, cb_d = parse_scene(tex_demo)
        sd_d.resize(SMALL_W, SMALL_H)
        cb_d = cb_d.replace(width=SMALL_W, height=SMALL_H,
                            samples_per_pixel=1, max_depth=8)
        for label, (sd, cb) in (
                ("image families", image_families_scene(
                    SMALL_W, SMALL_H, 1, 8, small_a, small_b)),
                ("textured demo_scene.json", (sd_d, cb_d))):
            tb = build_tables(sd, device=dev)
            if tb.mega.img is None or not tb.nee_img:
                raise AssertionError(f"{label}: no atlas or no image light")
            ro_, rd_ = generate_rays(tb.camera, SMALL_W, SMALL_H,
                                     px % SMALL_W, px // SMALL_W, 1, 0,
                                     cb.enable_defocus)
            for flags, kw in (("none", {}), ("nee", dict(nee=True)),
                              ("nee+mis", dict(nee=True, mis=True))):
                for p_rr in (0.0, 0.9):
                    c = cb.replace(p_rr=p_rr, compact_every=2, queue_steps=3,
                                   **kw)
                    for name, fn, eng in (
                            ("B2", cuda_mega.mega_trace, "mega"),
                            ("B3", cuda_queue.queue_trace, "queue")):
                        ce = c.replace(engine=eng)
                        reset_counts()
                        k_out = fn(tb, ce, ro_, rd_, px, 1, 0)
                        counts = read_counts()
                        p_out = fn(tb, ce, ro_, rd_, px, 1, 0, plain=True)
                        differ = int((k_out != p_out).any(-1).sum())
                        print(f"  {label}, {flags}, p_rr {p_rr}: {name} vs "
                              f"plain on {px.numel()} lanes, {differ} lanes "
                              f"differ, mean radiance "
                              f"{float(k_out.mean()):.5f}, launches "
                              f"{sum(counts.values())}", flush=True)
                        if differ or sum(counts.values()) <= 0:
                            raise AssertionError(
                                f"{label} {flags}: {name} is not its plain "
                                "version bit for bit")
            c4 = cb.replace(p_rr=0.9)
            capture_mismatch(
                cuda_mega.mega_capture(tb, c4, ro_, rd_, px, 1, 0),
                cuda_mega.mega_capture(tb, c4, ro_, rd_, px, 1, 0,
                                       plain=True), f"{label}: B4 vs plain")
            c7 = cb.replace(engine="mega", p_rr=0.9)
            seg = (tb, c7, px, 2, 2 * (c7.max_depth + 1))
            regen_mismatch(regen_segment(*seg, plain=False),
                           regen_segment(*seg, plain=True),
                           f"{label}: B7 vs plain, spp 2")
            for nee in (False, True):
                ca = cb.replace(nee=nee, compact_every=2)
                pix, ro_a, rd_a, L, g = adjoint_inputs(tb, ca, SMALL_W,
                                                       SMALL_H, 0, 1e-3)
                adj = (tb, ca, ro_a, rd_a, pix, 0, 0, L, g, 8, False)
                plain = cuda_queue.queue_trace_adjoint(*adj, plain=True)
                k_m = cuda_mega.mega_trace_adjoint(*adj)
                k_q = cuda_queue.queue_trace_adjoint(*adj, check_once=True)
                lab = f"{label}, nee {nee}"
                err_img["b5"] = max(err_img["b5"], grads_close(
                    plain, k_m, f"{lab}: B5"))
                err_img["b6"] = max(err_img["b6"], grads_close(
                    plain, k_q, f"{lab}: B6"))
                grads_close(k_m, k_q, f"{lab}: B6 vs B5")
                atlas_held(plain, k_m, f"{lab}: B5")
                atlas_held(plain, k_q, f"{lab}: B6")

    with phase(f"42 mesh_scene(plane441.obj) textured by a 512x512 PNG, "
               f"taichi_tri_uv, {W}x{H} depth 16 spp 4: frames, B2 / B3 / "
               "B7 / B4 / B5 / B6 vs plain, the training and tape steps "
               "with the atlas"):
        from rt_tpu_torch.scene.builders import mesh_scene

        sd, cb = mesh_scene(MESH, width=W, height=H, spp=4, max_depth=16,
                            texture_path=os.path.join(tmpd, "mesh.png"))
        sd.taichi_tri_uv = True
        img_rows["mesh"] = family_workload("textured mesh", sd, cb, 4)
        sd1, cb1 = mesh_scene(MESH, width=W, height=H, spp=1, max_depth=16,
                              texture_path=os.path.join(tmpd, "mesh.png"))
        sd1.taichi_tri_uv = True
        # g of std 1e-3, as tests/test_torch_cuda.py's: a mean loss's
        # 1 / pixels leaves every texel's gradient under the 1e-5 term
        img_rows["mesh"].update(family_b456("textured mesh", sd1, cb1,
                                            g_std=1e-3))
        import dataclasses
        t_i = build_tables(sd1, device=dev)
        c_i = cb1.replace(compact_schedule=(2, 3, 5, 10), compact_group=16)
        # the target: the mesh's texture darkened by a quarter
        tgt_i = render(dataclasses.replace(t_i, images=t_i.images * 0.75),
                       c_i.replace(samples_per_pixel=4, engine="queue",
                                   rays_per_batch=1 << 25),
                       device="cuda").reshape(-1, 3) / 4.0
        pix = torch.arange(W * H, device=dev)
        img_train = {}
        for engine in ("queue", "mega"):
            loss_fn = make_replay_loss_fn(t_i, c_i.replace(engine=engine), 1,
                                          pix % W, pix // W, tgt_i)
            params = {k: getattr(t_i, k).clone().requires_grad_(True)
                      for k in ("images", "tex_color")}
            loss_fn(params).backward()  # allocator
            params = {k: v.detach().clone().requires_grad_(True)
                      for k, v in params.items()}
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.time()
            loss = loss_fn(params)
            torch.cuda.synchronize()
            t_fwd = time.time() - t0
            loss.backward()
            torch.cuda.synchronize()
            t_step = time.time() - t0
            counts = read_counts()
            gi = params["images"].grad
            print(f"  training step {engine}: loss "
                  f"{float(loss.detach()):.6f}, forward {t_fwd:.4f} s, "
                  f"backward {t_step - t_fwd:.4f} s, step {t_step:.4f} s; "
                  f"texels with a gradient "
                  f"{int((gi.abs().sum(-1) > 0).sum())} of "
                  f"{gi[..., 0].numel()}; launches {counts}; {smi}",
                  flush=True)
            adj_k = ("queue_adjoint_launch" if engine == "queue"
                     else "mega_adjoint_segment")
            if counts[adj_k] <= 0 or not bool(torch.isfinite(gi).all()) or \
                    not float(gi.abs().max()) > 0.0:
                raise AssertionError(f"{engine}: launched {counts}, or no "
                                     "atlas gradient")
            img_train[engine] = dict(step=t_step, launches=counts[adj_k])
        vg = tape.make_tape_vg(t_i, c_i, pix % W, pix // W, tgt_i)
        p_t = {k: getattr(t_i, k).clone() for k in ("images", "tex_color")}
        vg(p_t)
        times = {}
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        loss, grads = vg(p_t, times=times)
        torch.cuda.synchronize()
        tape_s = time.time() - t0
        counts = read_counts()
        print(f"  tape step: loss {float(loss):.6f}, capture "
              f"{times['capture_s'] * 1e3:.2f} ms, replay forward "
              f"{times['forward_s']:.4f} s, backward "
              f"{times['backward_s']:.4f} s, step {tape_s:.4f} s; max |g| "
              f"images {float(grads['images'].abs().max()):.6g}; launches "
              f"{counts}; {smi}", flush=True)
        if counts["mega_capture"] != 1 or not float(
                grads["images"].abs().max()) > 0.0:
            raise AssertionError(f"tape step: launched {counts}, or no "
                                 "atlas gradient")
        img_train["tape"] = dict(step=tape_s, launches=counts["mega_capture"])

    with phase(f"43 cover_scene textured (ground and diffuse hero sphere "
               f"by two 1024x1024 images) {W}x{H} depth {DEPTH} spp "
               f"{MAIN_SPP}: queue, mega, regen"):
        sd, cb = cover_scene(width=W, height=H, spp=MAIN_SPP,
                             max_depth=DEPTH)
        rs = np.random.default_rng(26)
        big = [rs.random((1024, 1024, 3), dtype=np.float32)
               for _ in range(2)]
        hero = next(o["material"] for o in sd.objects
                    if o["type"] == "sphere"
                    and o["center"] == [-4.0, 1.0, 0.0])
        sd.materials[0]["texture"] = sd.add_image_texture(big[0])  # ground
        sd.materials[hero]["texture"] = sd.add_image_texture(big[1])
        # phase 10's configuration: one launch of 1<<25 rays, the
        # compaction schedule of mega
        cb = cb.replace(rays_per_batch=1 << 25,
                        compact_schedule=(2, 3, 5, 10), compact_group=16)
        tb = build_tables(sd, device=dev)
        if tb.img_on != ("sphere",):
            raise AssertionError(f"textured cover: img_on {tb.img_on}")
        paths = W * H * MAIN_SPP
        frames = {}
        img_rows["cover"] = {"frames": {}}
        for key, engine, regen in (("queue", "queue", False),
                                   ("mega", "mega", False),
                                   ("regen", "mega", True)):
            st = {}
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.time()
            img = render(tb, cb.replace(engine=engine, regen=regen),
                         device="cuda", stats=st)
            torch.cuda.synchronize()
            sec = time.time() - t0
            counts = read_counts()
            own = counts["mega_regen" if regen else
                         "queue_launch" if engine == "queue"
                         else "mega_segment"]
            print(f"  textured cover frame {key}: {sec:.4f} s = "
                  f"{paths / sec:.0f} paths/s (untextured, phase 10 / 26: "
                  f"{main[key]['sec'] if key in main else regen_main[0]['sec']:.4f} s), "
                  f"launches {counts}, ray-bounces {st['ray_bounces']}; "
                  f"{smi}", flush=True)
            if own <= 0 or sum(counts.values()) != own or not bool(
                    torch.isfinite(img).all()) or film.negative_pixels(img):
                raise AssertionError(f"textured cover {key}: launched "
                                     f"{counts}, or a bad image")
            frames[key] = img.cpu().numpy()
            img_rows["cover"]["frames"][key] = dict(
                sec=sec, launches=own, paths_per_s=paths / sec,
                ray_bounces=st["ray_bounces"])
        frac, mx = images_close(frames["queue"], frames["mega"], MAIN_SPP)
        differ = float((frames["regen"] != frames["mega"]).any(-1).mean())
        print(f"  textured cover: queue vs mega {frac:.3%} pixels beyond "
              f"2e-3, max diff {mx:.4g}; regen vs mega {differ:.6%} of "
              "pixels differ", flush=True)
        if differ:
            raise AssertionError("textured cover: regen frame != mega frame")
        px_ = torch.arange(W * H, device=dev)
        ro_, rd_ = generate_rays(tb.camera, W, H, px_ % W, px_ // W, 0, 0,
                                 cb.enable_defocus)
        args = (tb, cb, ro_, rd_, px_, 0, 0)
        for name, fn in (("mega_segment", cuda_mega.mega_trace),
                         ("queue_launch", cuda_queue.queue_trace)):
            st = {}
            k_out = fn(*args, stats=st)
            ms, _ = cuda_ms(lambda: fn(*args), 5)
            reset_plain_counts()
            pms, p_out = cuda_ms(lambda: fn(*args, plain=True), 1)
            differ = int((k_out != p_out).any(-1).sum())
            t_ops, t_bytes, t_hits = texel_terms(calls=2)
            ops = hit_terms(st["ray_bounces"], calls=2) + t_ops
            b_ms, b_by = bound_of(ops, W * H * (12 + 12 + 4 + 12)
                                  + table_bytes(tb) + t_bytes)
            print(f"  textured cover {name}: trace {ms:.4f} ms (untextured, "
                  f"phase 11: {rows[name]['ms']:.4f} ms), plain {pms:.4f} "
                  f"ms ({differ} of {W * H} lanes differ), bound "
                  f"{b_ms:.4f} ms ({b_by}: {st['ray_bounces']} ray-bounces, "
                  f"(lane, row) pairs tested {rows_tested(calls=2)} + "
                  f"{t_hits} texel-sampled hits, "
                  f"{ops:.4g} ops; {b_ms / ms:.1%} of the bound); {smi}",
                  flush=True)
            if differ:
                raise AssertionError(f"textured cover: {name} != plain")
            img_rows["cover"][name] = dict(
                ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                max_abs_err=0.0, launches=img_rows["cover"]["frames"][
                    "queue" if name == "queue_launch" else "mega"][
                    "launches"])

    with phase("44 main path: python -m rt_tpu_torch render -f <textured "
               "demo_scene.json> (960x540, spp 128, depth 40) and --nee; "
               "fit ... --fields images (3 steps) with the replay and the "
               "tape"):
        sd, cd = parse_scene(tex_demo)
        dw, dh, dspp = cd.width, cd.height, cd.samples_per_pixel
        img_cli = {}
        for key, flags in (("render", []), ("render_nee", ["--nee"])):
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.time()
            rc = cli.main(["render", "-f", tex_demo, "-o",
                           os.path.join(tmpd, f"{key}.ppm"), "--log",
                           os.path.join(tmpd, "time.log")] + flags)
            torch.cuda.synchronize()
            sec = time.time() - t0
            counts = read_counts()
            vals = np.array(open(os.path.join(tmpd, f"{key}.ppm")).read()
                            .split()[4:], dtype=np.float64)
            paths = dw * dh * dspp
            print(f"  render {' '.join(flags)}: exit {rc}, {sec:.4f} s = "
                  f"{paths / sec:.0f} paths/s; launches {counts}; image "
                  f"{vals.size // 3} pixels, mean {vals.mean():.3f}; {smi}",
                  flush=True)
            if rc != 0 or counts["queue_launch"] <= 0 or \
                    sum(counts.values()) != counts["queue_launch"] or \
                    vals.size != dw * dh * 3 or vals.max() <= 0:
                raise AssertionError(f"render {flags}: exit {rc}, launched "
                                     f"{counts}, or a bad image")
            img_cli[key] = dict(sec=sec, launches=counts["queue_launch"])
        td = build_tables(sd, device=dev)
        # the target: the sphere's texture darkened by a quarter
        timg = td.images.clone()
        timg[0] = timg[0] * 0.75
        img = render(dataclasses.replace(td, images=timg),
                     cd.replace(engine="queue"),
                     device="cuda") / cd.samples_per_pixel
        np.savez(os.path.join(tmpd, "T_img.npz"), img=img.cpu().numpy())
        base = ["fit", "-f", tex_demo, "--target",
                os.path.join(tmpd, "T_img.npz"), "--fields", "images",
                "-spp", "4", "--steps", "3"]
        for key, extra, want in (
                ("replay", [], ("queue_launch", "queue_adjoint_launch")),
                ("tape", ["--method", "tape"], ("mega_capture",))):
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.time()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(base + extra
                              + ["--out", os.path.join(tmpd, f"fit_{key}")])
            torch.cuda.synchronize()
            sec = time.time() - t0
            counts = read_counts()
            text = buf.getvalue()
            print("  " + text.strip().splitlines()[0], flush=True)
            print(f"  fit --fields images {key}: exit {rc}, {sec:.4f} s (3 "
                  f"steps and the after.png render at spp {dspp}); launches "
                  f"{counts}; {smi}", flush=True)
            if rc != 0 or not text.startswith("loss: ") or \
                    any(counts[k] <= 0 for k in want):
                raise AssertionError(f"fit --fields images {key}: exit "
                                     f"{rc}, launched {counts}")
            img_cli[f"fit_{key}"] = dict(sec=sec, launches=counts)
    # ---- QMC, chunk culling and the spatial sort (B2-B7) ----
    from rt_tpu_torch.ops import mega_tables
    from rt_tpu_torch.scene.builders import mesh_scene

    err_flags = {"b5": 0.0, "b6": 0.0}

    def small_scenes():
        """The 192x108 scenes of phases 45-46: (label, SceneDef, cfg)."""
        yield ("cover, depth 12", *cover_scene(
            width=SMALL_W, height=SMALL_H, spp=1, max_depth=12))
        yield ("all-families scene, depth 12",
               *all_families_scene(SMALL_W, SMALL_H, 1, 12))
        yield ("cover_lights, depth 12", *cover_scene(
            width=SMALL_W, height=SMALL_H, spp=1, max_depth=12, lights=True))
        yield ("mesh_scene, depth 8", *mesh_scene(
            MESH, width=SMALL_W, height=SMALL_H, spp=1, max_depth=8))
        sd, cb = mesh_scene(MESH, width=SMALL_W, height=SMALL_H, spp=1,
                            max_depth=8,
                            texture_path=os.path.join(tmpd, "mesh.png"))
        sd.taichi_tri_uv = True
        yield "textured mesh, depth 8", sd, cb

    def kernels_vs_plain(tb, cb, label, nee=None):
        """B2 and B3 (bit for bit, with the light sampler's flags nee),
        B4 (codes and deaths) and B7 (every word; both without light
        sampling, by design) and B5 / B6 (grads_close, NEE without MIS or
        glossy) against their plain versions on the 192x108 frame under
        cb. Returns B4's (codes, death) and the rays."""
        px_ = torch.arange(SMALL_W * SMALL_H, device=dev)
        ro_, rd_ = generate_rays(tb.camera, SMALL_W, SMALL_H, px_ % SMALL_W,
                                 px_ // SMALL_W, 0, 0, cb.enable_defocus,
                                 cb.sampler)
        # queue_steps 3: B3's lanes resume across launches
        args = (tb, cb.replace(queue_steps=3, **(nee or {})), ro_, rd_, px_,
                0, 0)
        for name, fn in (("B2", cuda_mega.mega_trace),
                         ("B3", cuda_queue.queue_trace)):
            k_out, p_out = fn(*args), fn(*args, plain=True)
            differ = int((k_out != p_out).any(-1).sum())
            print(f"  {label} {nee or ''}: {name} vs plain on {px_.numel()} "
                  f"lanes, {differ} differ, mean radiance "
                  f"{float(k_out.mean()):.4f}", flush=True)
            if differ:
                raise AssertionError(f"{label}: {name} is not its plain "
                                     "version bit for bit")
        cap = (tb, cb, ro_, rd_, px_, 0, 0)
        got = cuda_mega.mega_capture(*cap)
        capture_mismatch(got, cuda_mega.mega_capture(*cap, plain=True),
                         f"{label}: B4 vs plain")
        seg = (tb, cb, px_, 2, 2 * (cb.max_depth + 1))
        regen_mismatch(regen_segment(*seg, plain=False),
                       regen_segment(*seg, plain=True), f"{label}: B7 vs "
                       "plain")
        ca = cb.replace(nee=bool(nee), queue_steps=3)
        L = cuda_queue.queue_trace(tb, ca, ro_, rd_, px_, 0, 0)
        g = torch.from_numpy(np.random.default_rng(5).normal(
            0, 1.0 / px_.numel(), (px_.numel(), 3)).astype(np.float32)).to(dev)
        adj = (tb, ca, ro_, rd_, px_, 0, 0, L, g, ca.max_depth, False)
        plain = cuda_queue.queue_trace_adjoint(*adj, plain=True)
        err_flags["b5"] = max(err_flags["b5"], grads_close(
            plain, cuda_mega.mega_trace_adjoint(*adj), f"{label}: B5"))
        err_flags["b6"] = max(err_flags["b6"], grads_close(
            plain, cuda_queue.queue_trace_adjoint(*adj, check_once=True),
            f"{label}: B6"))
        return got, (ro_, rd_, px_)

    def code_ties(tb, cb, ro_, rd_, got, want):
        """Where B4's culled codes and the unculled plain capture's differ
        on a lane alive entering the bounce (its first such bounce): the
        count, and how many are ties, both winners at the same t within
        float32 rounding on that bounce's ray (diff/tape._known_t), which
        the plain bounce without culling replays to."""
        from rt_tpu_torch.diff.tape import _known_t

        (kc, kd), (pc, pd) = got, want
        depth = kc.shape[0]
        live = (torch.arange(depth, device=dev)[:, None]
                <= torch.minimum(kd, pd)[None, :])
        diff = (kc != pc) & live
        lanes = torch.nonzero(diff.any(0))[:, 0]
        if lanes.numel() == 0:
            return 0, 0
        first = torch.argmax(diff[:, lanes].to(torch.int8), 0)
        c0 = cb.replace(cull_chunks=False)
        kw = mega_plain.trace_options(tb, c0)
        tab = mega_tables.scene_for(tb, c0).table
        state = mega_plain.fresh_state(ro_[lanes], rd_[lanes])
        ties = 0
        for b in range(depth):
            at = torch.nonzero(first == b)[:, 0]
            if at.numel():
                o, d = state[0:3, at].T, state[3:6, at].T
                a, w = kc[b, lanes[at]].long(), pc[b, lanes[at]].long()
                ta = _known_t(tb, o, d, a >> 24, a & 0xFFFFFF)
                tw = _known_t(tb, o, d, w >> 24, w & 0xFFFFFF)
                ties += int(((a >= 0) & (w >= 0) & ((ta - tw).abs()
                                                    <= 1e-6 * tw.abs()))
                            .sum())
            state = mega_plain.do_bounce_plain(tab, state, lanes, 0, b, 0,
                                               **kw)
        return lanes.numel(), ties

    with phase(f"45 QMC: B2 / B3 / B4 / B7 vs plain bit for bit, B5 / B6 "
               f"within 1e-5 + 1e-3 max|g| at {SMALL_W}x{SMALL_H}"):
        for label, sd, cb in small_scenes():
            if label.startswith("mesh_scene"):
                continue  # phase 46 runs it; its texture twin runs here
            tb = build_tables(sd, device=dev)
            cq = cb.replace(sampler="qmc", compact_schedule=(2, 3, 5, 10),
                            compact_group=16)
            kernels_vs_plain(tb, cq, f"{label}, qmc",
                             dict(nee=True, mis=True)
                             if label.startswith("cover_lights") else None)
        sd, cb = cover_scene(width=SMALL_W, height=SMALL_H, spp=1,
                             max_depth=12)
        kernels_vs_plain(build_tables(sd, device=dev),
                         cb.replace(sampler="qmc", p_rr=0.9,
                                    cull_chunks=False),
                         "cover, qmc, p_rr 0.9, no culling")

    ties_seen = {}
    with phase(f"46 culling: B2-B7 vs plain at {SMALL_W}x{SMALL_H}, B4's "
               "codes against the capture without culling, and a wrong "
               "emitter row under mis"):
        for label, sd, cb in small_scenes():
            if label.startswith("all-families"):
                continue
            tb = build_tables(sd, device=dev)
            cc = cb.replace(cull_chunks=True, compact_schedule=(2, 3, 5, 10),
                            compact_group=16)
            cull = mega_tables.scene_for(tb, cc).cull
            print(f"  {label}: sphere chunks "
                  f"{None if cull.sph is None else cull.sph.shape[0]}, "
                  f"triangle chunks "
                  f"{None if cull.tri is None else cull.tri.shape[0]}",
                  flush=True)
            for nee in ((None, dict(nee=True), dict(nee=True, mis=True))
                        if label.startswith("cover_lights") else (None,)):
                got, (ro_, rd_, px_) = kernels_vs_plain(tb, cc, label, nee)
            want = cuda_mega.mega_capture(tb, cc.replace(cull_chunks=False),
                                          ro_, rd_, px_, 0, 0, plain=True)
            n_diff, n_ties = code_ties(tb, cc, ro_, rd_, got, want)
            ties_seen[label] = (n_diff, n_ties)
            print(f"  {label}: B4's culled codes against the unculled plain "
                  f"capture: {n_diff} lanes differ, {n_ties} of them on a "
                  "tie", flush=True)
            if n_diff != n_ties:
                raise AssertionError(f"{label}: culled codes differ off a "
                                     "tie")
        # MIS's emitter match names a SceneTables row: a light table whose
        # sphere lights name another row must change the frame
        tl = build_tables(light_scene(SMALL_W, SMALL_H, 1, 8)[0], device=dev)
        cm = light_scene(SMALL_W, SMALL_H, 1, 8)[1].replace(
            nee=True, mis=True, engine="mega", cull_chunks=True)
        px_ = torch.arange(SMALL_W * SMALL_H, device=dev)
        ro_, rd_ = generate_rays(tl.camera, SMALL_W, SMALL_H, px_ % SMALL_W,
                                 px_ // SMALL_W, 0, 0, False)
        args = (tl, cm, ro_, rd_, px_, 0, 0)
        right = cuda_mega.mega_trace(*args)
        if not torch.equal(right, cuda_mega.mega_trace(*args, plain=True)):
            raise AssertionError("light scene under mis: B2 != plain")
        orig = tl.mega
        lights = orig.lights.clone()
        sph = lights[:, mega_tables.L_FAM] == 0.0
        lights[sph, mega_tables.L_ROW] = (lights[sph, mega_tables.L_ROW]
                                          + 1.0) % tl.n_spheres
        tl.__dict__["mega"] = dataclasses.replace(orig, lights=lights)
        try:
            wrong = cuda_mega.mega_trace(*args)
        finally:
            tl.__dict__["mega"] = orig
        moved = int((wrong != right).any(-1).sum())
        print(f"  light scene, nee + mis, culled: sorted sphere rows "
              f"{mega_tables.scene_for(tl, cm).cull.sph_rows.tolist()}; "
              f"with the sphere lights' rows moved by one, {moved} of "
              f"{px_.numel()} lanes differ from the plain version", flush=True)
        if moved == 0:
            raise AssertionError("a wrong emitter row passed the check")

    settings = {"rng, no culling": dict(cull_chunks=False),
                "rng, culling": {}, "qmc, culling": dict(sampler="qmc"),
                "spatial sort": dict(compact_sort="spatial")}
    flag_frames = {}
    with phase(f"47 frames at {W}x{H} in four settings (rng without and "
               "with culling, qmc, the spatial sort): cover depth 50 spp "
               "16, cover_lights depth 50 spp 16, mesh depth 16 spp 4; one "
               "B2 / B3 call each against the rows the lanes tested"):
        for label, (sd, cb), spp in (
                ("cover", (s16, c16), MAIN_SPP),
                ("cover_lights", cover_scene(width=W, height=H, spp=MAIN_SPP,
                                             max_depth=DEPTH, lights=True),
                 MAIN_SPP),
                ("mesh", mesh_scene(MESH, width=W, height=H, spp=4,
                                    max_depth=16), 4)):
            tb = t16 if label == "cover" else build_tables(sd, device=dev)
            # regen_compact -1: B7's segments regroup lanes, so the
            # spatial sort moves them there too
            cb = cb.replace(rays_per_batch=1 << 25,
                            compact_schedule=(2, 3, 5, 10), compact_group=16,
                            regen_compact=-1)
            rows_all = sum(tb.counts)
            imgs = {}
            out = flag_frames[label] = {}
            for key, over in settings.items():
                cs = cb.replace(**over)
                rec = out[key] = {}
                for engine, regen in (("queue", False), ("mega", False),
                                      ("mega", True)):
                    st = {}
                    reset_counts()
                    torch.cuda.synchronize()
                    t0 = time.time()
                    img = render(tb, cs.replace(engine=engine, regen=regen),
                                 device="cuda", stats=st)
                    torch.cuda.synchronize()
                    sec = time.time() - t0
                    counts = read_counts()
                    name = ("regen" if regen else engine)
                    own = counts["mega_regen" if regen else "queue_launch"
                                 if engine == "queue" else "mega_segment"]
                    if own <= 0 or own != st["launches"] or \
                            not bool(torch.isfinite(img).all()):
                        raise AssertionError(f"{label} {key} {name}: "
                                             f"launches {counts}")
                    imgs[(key, name)] = img.cpu().numpy()
                    rec[name] = dict(sec=sec, launches=own,
                                     ray_bounces=st["ray_bounces"])
                    print(f"  {label} {key} {name}: {sec:.4f} s = "
                          f"{W * H * spp / sec:.0f} paths/s, {own} launches, "
                          f"{st['ray_bounces']} ray-bounces; {smi}",
                          flush=True)
                if key == "spatial sort":
                    continue  # its calls are "rng, culling"'s
                px_ = torch.arange(W * H, device=dev)
                ro_, rd_ = generate_rays(tb.camera, W, H, px_ % W, px_ // W,
                                         0, 0, cs.enable_defocus, cs.sampler)
                args = (tb, cs, ro_, rd_, px_, 0, 0)
                reset_plain_counts()
                p_out = cuda_mega.mega_trace(*args, plain=True)
                for name, fn in (("mega_segment", cuda_mega.mega_trace),
                                 ("queue_launch", cuda_queue.queue_trace)):
                    st = {}
                    k_out = fn(*args, stats=st)
                    ms, _ = cuda_ms(lambda: fn(*args), 3)
                    if not torch.equal(k_out, p_out):
                        raise AssertionError(f"{label} {key}: {name} != "
                                             "plain")
                    ops = hit_terms(st["ray_bounces"])
                    nbytes = W * H * (12 + 12 + 4 + 12) + table_bytes(tb)
                    b_ms, b_by = bound_of(ops, nbytes)
                    b_all = bound_of(st["ray_bounces"] * hit_ops(tb),
                                     nbytes)[0]
                    tested = sum(rows_tested())
                    rec[name] = dict(ms=ms, ray_bounces=st["ray_bounces"],
                                     rows_tested=tested, bound_ms=b_ms,
                                     bound_by=b_by, bound_all_rows_ms=b_all)
                    print(f"  {label} {key} {name}: call {ms:.4f} ms, "
                          f"{st['ray_bounces']} ray-bounces, {tested} (lane,"
                          f" row) pairs tested of "
                          f"{st['ray_bounces'] * rows_all} "
                          f"({tested / (st['ray_bounces'] * rows_all):.2%}), "
                          f"bound {b_ms:.4f} ms ({b_by}; {b_ms / ms:.1%} of "
                          f"it), over all rows {b_all:.4f} ms "
                          f"({b_all / ms:.1%}); {smi}", flush=True)
            frac, mx = images_close(imgs[("rng, no culling", "queue")],
                                    imgs[("rng, culling", "queue")], spp)
            same = all(np.array_equal(imgs[("spatial sort", e)],
                                      imgs[("rng, culling", e)])
                       for e in ("mega", "regen"))
            print(f"  {label}: culled vs unculled queue frame {frac:.3%} "
                  f"pixels beyond 2e-3, max diff {mx:.4g}; spatial vs dead "
                  f"sort (mega, regen) bit-equal: {same}", flush=True)
            if not same:
                raise AssertionError(f"{label}: the spatial sort changed a "
                                     "frame")

    ab, parent_ab = {}, {}
    with phase(f"48 the runtime flags at phases 11 / 13's shape ({W * H} "
               f"lanes, depth {DEPTH}): B2 / B3 / B5 / B6 under rng without "
               "and with culling and qmc with culling, in turns"):
        ab_cfgs = {"rng, no culling": c16.replace(cull_chunks=False),
                   "rng, culling": c16,
                   "qmc, culling": c16.replace(sampler="qmc")}
        calls = {"mega_segment": (cuda_mega.mega_trace, main_args),
                 "queue_launch": (cuda_queue.queue_trace, main_args),
                 "mega_adjoint_segment": (cuda_mega.mega_trace_adjoint,
                                          adj_args),
                 "queue_adjoint_launch": (cuda_queue.queue_trace_adjoint,
                                          adj_args)}
        order = list(ab_cfgs) + list(ab_cfgs)[::-1]
        for name, (fn, a) in calls.items():
            times = {k: [] for k in ab_cfgs}
            for key in order:
                cfg_k = ab_cfgs[key]
                args_k = (a[0], cfg_k) + tuple(a[2:])
                times[key].append(cuda_ms(lambda: fn(*args_k), 3)[0])
            ab[name] = {k: sum(v) / len(v) for k, v in times.items()}
            base = ab[name]["rng, no culling"]
            print(f"  {name}: " + ", ".join(
                f"{k} {v:.4f} ms ({v / base:.3f})"
                for k, v in ab[name].items()) + f"; {smi}", flush=True)
        if PARENT:
            # the parent's tree beside this one, in turns: parent, this,
            # this, parent, each in its own process
            got = {}
            for root in (PARENT, ROOT, ROOT, PARENT, PARENT, ROOT):
                res = subprocess.run(
                    [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                     "--ab-times", root], capture_output=True, text=True,
                    check=True)
                got.setdefault(root, []).append(
                    json.loads(res.stdout.strip().splitlines()[-1]))
            for key in got[ROOT][0]:
                ps = [r[key] for r in got[PARENT]]
                cs = [r[key] for r in got[ROOT]]
                p, c = float(np.mean(ps)), float(np.mean(cs))
                name, _, label = key.partition(" ")
                if name in calls and not label:
                    ab[name]["parent, rng, no culling"] = p
                    ab[name]["this tree in its own process"] = c
                else:
                    parent_ab[key] = dict(parent=ps, this=cs)
                unit = "s" if key.endswith(" s") else "ms"
                print(f"  {key}{'' if label else ' (rng, no culling)'}: "
                      f"parent {p:.4f} {unit} "
                      f"({', '.join(f'{v:.4f}' for v in ps)}), this tree "
                      f"{c:.4f} {unit} "
                      f"({', '.join(f'{v:.4f}' for v in cs)}): "
                      f"{c / p:.3f}; {smi}", flush=True)

    with phase("49 main path: python -m rt_tpu_torch render -f "
               "scenes/demo_scene.json --sampler qmc and --no-cull (960x540, "
               "spp 128, depth 40); fit(sampler='qmc') on it (replay on "
               "queue and mega, tape; 3 steps, spp 4)"):
        sd, cd = demo_scene()
        dw, dh, dspp = cd.width, cd.height, cd.samples_per_pixel
        flag_cli = {}
        for key, flags in (("qmc", ["--sampler", "qmc"]),
                           ("no_cull", ["--no-cull"])):
            with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
                reset_counts()
                torch.cuda.synchronize()
                t0 = time.time()
                rc = cli.main(["render", "-f", DEMO, "-o", "d.ppm"] + flags)
                torch.cuda.synchronize()
                sec = time.time() - t0
                counts = read_counts()
                vals = np.array(open("d.ppm").read().split()[4:],
                                dtype=np.float64)
            print(f"  render {' '.join(flags)}: exit {rc}, {sec:.4f} s = "
                  f"{dw * dh * dspp / sec:.0f} paths/s; launches {counts}; "
                  f"mean {vals.mean():.3f}; {smi}", flush=True)
            if rc != 0 or counts["queue_launch"] <= 0 or \
                    vals.size != dw * dh * 3 or not np.isfinite(vals).all():
                raise AssertionError(f"render {flags}: exit {rc}, launched "
                                     f"{counts}, or a bad image")
            flag_cli[key] = dict(sec=sec, launches=counts["queue_launch"])
        td = build_tables(sd, device=dev)
        cq = cd.replace(samples_per_pixel=4, sampler="qmc",
                        compact_schedule=(2, 3, 5, 10), compact_group=16)
        target = (render(td, cq.replace(engine="queue"), device="cuda")
                  / 4).cpu().numpy()
        rs = np.random.default_rng(9)
        init = {k: getattr(td, k) * torch.from_numpy(rs.uniform(
                    0.6, 1.4, tuple(getattr(td, k).shape)).astype(
                    np.float32)).to(dev)
                for k in ("tex_color", "mat_albedo")}
        for key, engine, method, want in (
                ("replay", "queue", "replay", "queue_adjoint_launch"),
                ("mega", "mega", "replay", "mega_adjoint_segment"),
                ("tape", "queue", "tape", "mega_capture")):
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.time()
            _, hist = fit(td, cq.replace(engine=engine), target,
                          fields=("tex_color", "mat_albedo"), spp=4, steps=3,
                          learning_rate=0.05, init_params=init,
                          method=method, device="cuda")
            torch.cuda.synchronize()
            sec = time.time() - t0
            counts = read_counts()
            print(f"  fit(sampler='qmc') {key}: loss {hist}, {sec:.4f} s for "
                  f"3 steps; launches {counts}; {smi}", flush=True)
            if not hist[-1] < hist[0] or counts[want] <= 0:
                raise AssertionError(f"fit qmc {key}: loss {hist}, "
                                     f"launches {counts}")
            flag_cli[f"fit_{key}"] = dict(sec=sec, launches=counts)
    # ---- B2 / B3 / B6's warp-cooperative closest hit (bounce.cuh
    # warp_hit) ----
    builds = [None] + dense_builds

    def build_name(d):
        return (f"kDenseMax {dense_max} (default)" if d is None
                else f"kDenseMax {d}")

    warp = {"dense_max": dense_max, "ties": {}, "calls": {}}
    with phase(f"50 B2-B7's warp-cooperative hit in the "
               f"default build (kDenseMax {dense_max}) and the scratch "
               f"builds with kDenseMax {dense_builds}: ties at "
               f"{SMALL_W}x{SMALL_H} (duplicated spheres in one chunk and "
               "across two, the grid mesh's shared edges); one call at "
               f"{W}x{H} on cover, cover_lights with nee, the mesh and the "
               "textured mesh (B7 at spp 2; B4 with p_rr 0 and 0.9 on the "
               "ties), against the plain versions, timed in turns"):
        from rt_tpu_torch.ops import mega_plain, mega_tables
        from rt_tpu_torch.scene.builders import mesh_scene

        sd_tie, cb_tie = tie_scene(SMALL_W, SMALL_H, 12)
        for label, sd, cb in (
                ("duplicated spheres, depth 12", sd_tie, cb_tie),
                ("mesh, depth 8", *mesh_scene(MESH, width=SMALL_W,
                                              height=SMALL_H, spp=1,
                                              max_depth=8))):
            tb = build_tables(sd, device=dev)
            ms_ = mega_tables.scene_for(tb, cb)
            px_ = torch.arange(SMALL_W * SMALL_H, device=dev)
            ro_, rd_ = generate_rays(tb.camera, SMALL_W, SMALL_H,
                                     px_ % SMALL_W, px_ // SMALL_W, 0, 0,
                                     cb.enable_defocus)
            dup = None
            if label.startswith("duplicated"):
                # the primary rays whose winner is a duplicated sphere
                chunks = ms_.cull.sph.shape[0]
                _, fam, row = mega_plain.closest_hit(
                    ms_.table, *ro_.T, *rd_.T, 1e-3, cull=ms_.cull)
                dup = int((mega_plain.scene_rows(ms_.cull, fam, row)
                           > 0).sum())
                print(f"  {label}: {chunks} sphere chunks, {dup} of "
                      f"{px_.numel()} primary rays take a duplicated "
                      "sphere", flush=True)
                if chunks < 3 or dup == 0:
                    raise AssertionError("the tie scene has no ties")
            args = (tb, cb, ro_, rd_, px_, 0, 0)
            want = cuda_queue.queue_trace(*args, plain=True)
            want_m = cuda_mega.mega_trace(*args, plain=True)
            g = torch.from_numpy(np.random.default_rng(7).normal(
                0, 1e-3, (px_.numel(), 3)).astype(np.float32)).to(dev)
            adj = args + (want, g, cb.max_depth, False)
            g_plain = cuda_queue.queue_trace_adjoint(*adj, plain=True)
            regen = (tb, cb.replace(engine="mega"), px_, px_ // SMALL_W, 3,
                     2)
            want_r = cuda_mega.mega_trace_regen(*regen, plain=True)
            cap = {p: (tb, cb.replace(p_rr=p), *args[2:]) for p in (0.0, 0.9)}
            want_c = {p: cuda_mega.mega_capture(*a, plain=True)
                      for p, a in cap.items()}
            for d in builds:
                with dense_schedule(d):
                    for steps in (0, 3):
                        got = cuda_queue.queue_trace(
                            tb, cb.replace(queue_steps=steps), *args[2:],
                            check_once=True)
                        n_bad = int((got != want).any(-1).sum())
                        print(f"  {label}, {build_name(d)}, queue_steps "
                              f"{steps}: B3 lanes differing from plain "
                              f"{n_bad} of {px_.numel()}", flush=True)
                        if n_bad:
                            raise AssertionError(f"{label}: B3 != plain")
                    for every in (None, 2):  # segments: default, 2 bounces
                        cm = cb if every is None else cb.replace(
                            compact_every=every)
                        got = cuda_mega.mega_trace(tb, cm, *args[2:])
                        n_bad = int((got != want_m).any(-1).sum())
                        print(f"  {label}, {build_name(d)}, compact_every "
                              f"{every}: B2 lanes differing from plain "
                              f"{n_bad} of {px_.numel()}", flush=True)
                        if n_bad:
                            raise AssertionError(f"{label}: B2 != plain")
                    g6 = cuda_queue.queue_trace_adjoint(*adj,
                                                        check_once=True)
                    e6 = grads_close(g_plain, g6, f"{label}, "
                                     f"{build_name(d)}: B6 vs plain")
                    g5 = cuda_mega.mega_trace_adjoint(*adj)
                    e5 = grads_close(g_plain, g5, f"{label}, "
                                     f"{build_name(d)}: B5 vs plain")
                    grads_close(g5, g6, f"{label}, {build_name(d)}: B6 "
                                "vs B5")
                    err_flags["b6"] = max(err_flags["b6"], e6)
                    err_flags["b5"] = max(err_flags["b5"], e5)
                    got = cuda_mega.mega_trace_regen(*regen)
                    n_bad = int((got != want_r).any(-1).sum())
                    print(f"  {label}, {build_name(d)}: B7 spp 2 pixels "
                          f"differing from plain {n_bad} of {px_.numel()}",
                          flush=True)
                    if n_bad:
                        raise AssertionError(f"{label}: B7 != plain")
                    for p, a in cap.items():  # raises on a difference
                        capture_mismatch(cuda_mega.mega_capture(*a),
                                         want_c[p], f"{label}, "
                                         f"{build_name(d)}, p_rr {p}: B4 "
                                         "vs plain")
            warp["ties"][label] = dict(lanes=px_.numel(),
                                       duplicated_winners=dup)

        sass = row_instructions(libs[KERNELS.index("queue")])
        sass_b2 = row_instructions(libs[KERNELS.index("mega")],
                                   "mega_kernel<01000>")
        sass_b4 = row_instructions(libs[KERNELS.index("capture")],
                                   "capture_kernel<010>")
        print(f"  issued instructions (cuobjdump -sass) of the queue "
              f"library, queue_kernel<01000>: {sass}; of the mega library, "
              f"mega_kernel<01000>: {sass_b2}; of the capture library, "
              f"capture_kernel<010>: {sass_b4}; issue rate {issue_note}",
              flush=True)
        warp["sass_instructions"] = sass
        warp["sass_instructions_b2"] = sass_b2
        warp["sass_instructions_b4"] = sass_b4
        with tempfile.TemporaryDirectory() as wtmp:
            for label, tb, cb in warp_scenes(wtmp, dev):
                px_ = torch.arange(W * H, device=dev)
                rays = generate_rays(tb.camera, W, H, px_ % W, px_ // W, 0,
                                     0, cb.enable_defocus, cb.sampler)
                args = (tb, cb, *rays, px_, 0, 0)
                st = {}
                reset_plain_counts()
                want = cuda_queue.queue_trace(*args, plain=True, stats=st)
                pairs = rows_tested()
                nbytes = W * H * (12 + 12 + 4 + 12) + table_bytes(tb)
                b_ms, b_by = bound_of(hit_terms(st["ray_bounces"]), nbytes)
                def issue_of(sa):
                    if sa and issue_rate and sa["sphere_row"] and \
                            sa["triangle_row"]:
                        return 1e3 * (pairs[0] * sa["sphere_row"]
                                      + pairs[3] * sa["triangle_row"]) \
                            / issue_rate
                    return None

                issue_ms, issue_b2_ms, issue_b4_ms = (
                    issue_of(sass), issue_of(sass_b2), issue_of(sass_b4))
                am = (tb, cb.replace(compact_schedule=c16.compact_schedule,
                                     compact_group=c16.compact_group),
                      *args[2:])
                need = [list(h) for h in mega_plain.closest_hit.need]
                want_m = cuda_mega.mega_trace(*am, plain=True)
                g = torch.from_numpy(np.random.default_rng(8).normal(
                    0, 1.0 / (W * H), (W * H, 3)).astype(np.float32)).to(dev)
                adj = args + (want, g, cb.max_depth, False)
                adm = am + (want, g, cb.max_depth, False)
                g_plain = cuda_queue.queue_trace_adjoint(*adj, plain=True)
                regen = (tb, am[1].replace(engine="mega"), px_, px_ // W, 0,
                         2)
                want_r = cuda_mega.mega_trace_regen(*regen, plain=True)
                want_c = cuda_mega.mega_capture(*args, plain=True)
                timed = {  # WARP_KERNELS' calls
                    "queue_launch": lambda: cuda_queue.queue_trace(*args),
                    "queue_adjoint_launch":
                        lambda: cuda_queue.queue_trace_adjoint(*adj),
                    "mega_segment": lambda: cuda_mega.mega_trace(*am),
                    "mega_adjoint_segment":
                        lambda: cuda_mega.mega_trace_adjoint(*adm),
                    "mega_regen": lambda: cuda_mega.mega_trace_regen(*regen),
                    "mega_capture": lambda: cuda_mega.mega_capture(*args)}
                times = {d: {k: [] for k in WARP_KERNELS} for d in builds}
                for i, d in enumerate(builds + builds[::-1]):
                    with dense_schedule(d):
                        if i < len(builds):  # the first visit checks
                            got = cuda_queue.queue_trace(*args)
                            if not torch.equal(got, want):
                                raise AssertionError(
                                    f"{label}, {build_name(d)}: B3 != plain")
                            if not torch.equal(cuda_mega.mega_trace(*am),
                                               want_m):
                                raise AssertionError(
                                    f"{label}, {build_name(d)}: B2 != plain")
                            g6 = cuda_queue.queue_trace_adjoint(*adj)
                            e6 = grads_close(g_plain, g6, f"{label}, "
                                             f"{build_name(d)}: B6 vs plain")
                            g5 = cuda_mega.mega_trace_adjoint(*adm)
                            e5 = grads_close(g_plain, g5, f"{label}, "
                                             f"{build_name(d)}: B5 vs plain")
                            grads_close(g5, g6, f"{label}, "
                                        f"{build_name(d)}: B6 vs B5")
                            err_flags["b6"] = max(err_flags["b6"], e6)
                            err_flags["b5"] = max(err_flags["b5"], e5)
                            if not torch.equal(
                                    cuda_mega.mega_trace_regen(*regen),
                                    want_r):
                                raise AssertionError(
                                    f"{label}, {build_name(d)}: B7 != plain")
                            capture_mismatch(cuda_mega.mega_capture(*args),
                                             want_c, f"{label}, "
                                             f"{build_name(d)}: B4 vs plain")
                        for k, fn in timed.items():
                            times[d][k].append(cuda_ms(fn, 3)[0])
                rec = warp["calls"][label] = dict(
                    ray_bounces=st["ray_bounces"], rows_tested=pairs,
                    bound_ms=b_ms, bound_by=b_by, issue_bound_ms=issue_ms,
                    issue_bound_b2_ms=issue_b2_ms,
                    issue_bound_b4_ms=issue_b4_ms,
                    warp_need={"sphere": need[0], "triangle": need[3]},
                    **{k: {} for k in WARP_KERNELS})
                for d in builds:  # the default build (None) first
                    ms_d = {k: float(np.mean(v)) for k, v in times[d].items()}
                    for k, v in ms_d.items():
                        rec[k][build_name(d)] = v
                    print(f"  {label}, {build_name(d)}: " + ", ".join(
                        f"{WARP_KERNELS[k]} {v:.4f} ms "
                        f"({v / rec[k][build_name(None)]:.3f})"
                        for k, v in ms_d.items()) + f"; {smi}", flush=True)
                eff = {fam: sum(n * v for n, v in enumerate(h))
                       / max(1, mega_plain.WARP * sum(h[1:]))
                       for fam, h in rec["warp_need"].items() if sum(h)}
                print(f"  {label}: {st['ray_bounces']} ray-bounces, (lane, "
                      f"row) pairs tested {pairs}, FP32 bound {b_ms:.4f} ms "
                      f"({b_by}), issue bound of the pairs {issue_ms} ms "
                      f"(B3's SASS), {issue_b2_ms} ms (B2's), {issue_b4_ms} "
                      f"ms (B4's); "
                      f"the plain queue's 32-lane groups: lanes needing a "
                      f"chunk the group visits, per lane of 32 {eff}",
                      flush=True)

        # the main path's frame (phase 10's queue frame) in each build
        frame_s = {d: [] for d in builds}
        cq = c16.replace(engine="queue")
        render(t16, cq, device="cuda")  # warm-up
        for rep in range(4):
            for d in (builds if rep % 2 == 0 else builds[::-1]):
                with dense_schedule(d):
                    torch.cuda.synchronize()
                    t0 = time.time()
                    render(t16, cq, device="cuda")
                    torch.cuda.synchronize()
                    frame_s[d].append(time.time() - t0)
        warp["frames"] = {build_name(d): v for d, v in frame_s.items()}
        for d, v in frame_s.items():
            print(f"  cover frame {W}x{H} spp {MAIN_SPP} queue, "
                  f"{build_name(d)}: mean {np.mean(v):.4f} s "
                  f"({', '.join(f'{x:.4f}' for x in v)}); {smi}", flush=True)

    img_tmp.cleanup()

    drv = driver_phases(dev, smi, c16, t16, main["queue"]["img"], cli)
    bvh_rec = bvh_phase(dev, smi, cli)
    example = example_phase(dev, smi)
    par = parallel_phases(dev, smi, c16, t16)
    oracle = oracle_phase(smi)
    iface = interface_phase(dev, smi)

    def iface_entry(name):
        """A kernel's launches in phase 61's runs that launched it."""
        return {k: v["launches"][name] for part in ("loops", "replay")
                for k, v in iface[part].items() if name in v["launches"]}

    def par_entry(name):
        """A kernel's launches in phases 57-58 (each rank's in 58) and in
        phase 59's frames."""
        return {
            "p57": {k: v["launches"][name] for k, v in par["p57"].items()
                    if name in v.get("launches", {})},
            "p58": {k: [r.get(name, 0) for r in v["launches"]]
                    for k, v in par["p58"].items()
                    if any(name in r for r in v["launches"])},
            "p59": {k: v["launches"][name] for k, v in oracle.items()
                    if name in v["launches"]}}

    def example_entry(name):
        """A kernel's launches in each demo of phase 56 that launched it."""
        return {k: v["launches"][name] for k, v in example.items()
                if name in v["launches"]}

    def img_entry(name, train_key=None, fit_key=None):
        """A kernel's numbers with image textures, for its entry in the
        kernels line: its call on the textured mesh (and cover) at
        1920x1080, its launches in a training step and a CLI fit, its
        largest error at 192x108 (phase 41)."""
        out = {"mesh": img_rows["mesh"][name]}
        if name in img_rows["cover"]:
            out["cover"] = img_rows["cover"][name]
        if train_key:
            out["training_step_launches"] = img_train[train_key]["launches"]
        if fit_key:
            out["cli_fit_launches"] = img_cli[fit_key]["launches"][name]
        out["max_abs_err_small"] = (err_img["b5"] if name ==
                                    "mega_adjoint_segment" else
                                    err_img["b6"] if name ==
                                    "queue_adjoint_launch" else 0.0)
        return out

    # phase 48's frames against --parent, by the kernel whose entry
    # carries them
    frame_of = {"queue frame s": "queue_launch",
                "render -f demo s": "queue_launch",
                "mega frame s": "mega_segment",
                "regen frame s": "mega_regen",
                "mega replay step s": "mega_adjoint_segment",
                "tape step s": "mega_capture",
                "tape capture ms": "mega_capture",
                "hybrid frame s": "sphere_closest_hit"}

    def parent_entry(name):
        """Phase 48's A/B against --parent of the kernel `name`: its calls
        and the frames of its engine."""
        return {k: v for k, v in parent_ab.items()
                if k == name or k.startswith(name + " ")
                or frame_of.get(k) == name}

    def warp_entry(name):
        """The warp-cooperative hit's numbers for a B2-B7 entry in the
        kernels line: phase 50's ties, calls (this kernel's time
        per build) and SASS counts, and phase 48's A/B against
        --parent."""
        calls = {lab: {**{k: v for k, v in rec.items()
                          if k not in WARP_KERNELS},
                       "ms": rec[name]}
                 for lab, rec in warp["calls"].items()}
        sass_key = {"mega_segment": "sass_instructions_b2",
                    "mega_capture": "sass_instructions_b4"}.get(
                        name, "sass_instructions")
        return {"dense_max": dense_max, "ties": warp["ties"],
                "sass_instructions": warp[sass_key],
                "calls": calls, "cover_frames_s": warp["frames"],
                "parent_ab": parent_entry(name)}

    def family_rows(name):
        """A kernel's numbers on the family workloads, for its entry in
        the kernels line."""
        return {k: v[name] for k, v in families.items()}

    def flag_entry(name, frame=None):
        """A kernel's numbers under the samplers and culling settings,
        for its entry in the kernels line: phase 47's frames (frame: the
        engine) and calls, phase 48's times."""
        out = {}
        if frame:
            out["frames"] = {lab: {k: v[frame] for k, v in f.items()}
                             for lab, f in flag_frames.items()}
        calls = {lab: {k: v[name] for k, v in f.items() if name in v}
                 for lab, f in flag_frames.items()}
        if any(calls.values()):
            out["calls"] = calls
        if name in ab:
            out["ab_ms"] = ab[name]
        return out

    print(f"[62 summary] total {time.time() - t_all:.2f} s; {smi}", flush=True)
    print(json.dumps({"kernels": [{
        "name": "sphere_closest_hit",
        "route": "cuda",
        "source": "rt_tpu_torch/csrc/sphere_hit.cu",
        "replaces": "rt_tpu/ops/pallas_intersect.py:42",
        "launches": launches,
        "max_abs_err": max(err_a, err_b),
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "pairs": b1_pairs,
        "issue_bound_ms": b1_issue_ms,
        "sass_instructions": b1_sass,
        "against_parent": b1_parent,
        "parent_ab": parent_entry("sphere_closest_hit"),
        "example": example_entry("sphere_closest_hit"),
        "parallel": par_entry("sphere_closest_hit"),
        # the hybrid cover frame walks its BVH in place of this kernel
        "bvh_hybrid_cover_frame": bvh_rec["frames"]["cover pallas bvh"],
        "loop_scan": iface_entry("sphere_closest_hit"),
    }, {
        "name": "mega_segment",
        "route": "cuda",
        "source": "rt_tpu_torch/csrc/mega.cu",
        "replaces": "rt_tpu/ops/pallas_mega.py:1899",
        "launches": main["mega"]["launches"],
        "max_abs_err": err_mega,
        **rows["mega_segment"],
        "library_ms": None,
        "families": family_rows("mega_segment"),
        "img": img_entry("mega_segment"),
        "nee": {**nee_rows["mega_segment"],
                "cli_fit_launches": nee_fit["mega"]["launches"][
                    "mega_segment"]},
        "qmc_cull": flag_entry("mega_segment", "mega"),
        "warp_hit": warp_entry("mega_segment"),
        "example": example_entry("mega_segment"),
        "parallel": par_entry("mega_segment"),
        "drivers": {"animate_mega": drv["animate"]["dna_mega"],
                    "adaptive_round_lanes": drv["adaptive"]["round_lanes"]},
    }, {
        "name": "queue_launch",
        "route": "cuda",
        "source": "rt_tpu_torch/csrc/queue.cu",
        "replaces": "rt_tpu/ops/pallas_queue.py:122",
        "launches": main["queue"]["launches"],
        "max_abs_err": err_queue,
        **rows["queue_launch"],
        "library_ms": None,
        "cli_demo_launches": demo["cli"]["launches"],
        "cli_fit_launches": {k: v["launches"]["queue_launch"]
                             for k, v in fit_cli.items()},
        "families": family_rows("queue_launch"),
        "img": {**img_entry("queue_launch"),
                "cli_render_launches": {k: img_cli[k]["launches"] for k in
                                        ("render", "render_nee")}},
        "nee": {**nee_rows["queue_launch"],
                "cli_render_launches": {k: v["launches"]
                                        for k, v in nee_cli.items()},
                "cli_fit_launches": nee_fit["replay"]["launches"][
                    "queue_launch"]},
        "qmc_cull": {**flag_entry("queue_launch", "queue"),
                     "cli_render": {k: v for k, v in flag_cli.items()
                                    if not k.startswith("fit_")},
                     "fit_qmc": {k: v for k, v in flag_cli.items()
                                 if k.startswith("fit_")}},
        "warp_hit": warp_entry("queue_launch"),
        "example": example_entry("queue_launch"),
        "parallel": par_entry("queue_launch"),
        "drivers": {"animate": {k: v for k, v in drv["animate"].items()
                                if k != "dna_mega"},
                    "progressive": drv["progressive"]["queue"],
                    "b3_sample_base_64_ms": drv["progressive"][
                        "b3_base64_ms"],
                    "adaptive": drv["adaptive"], "cli": drv["cli"]},
        "bvh_cli": bvh_rec["cli"],
    }, {
        "name": "mega_adjoint_segment",
        "route": "cuda",
        "source": "rt_tpu_torch/csrc/mega_adjoint.cu",
        "replaces": "rt_tpu/ops/pallas_mega.py:2183",
        "launches": train[("mega", TRAIN_BWD_DEPTH)]["launches"],
        "max_abs_err": max(err_b5, err_flags["b5"]),
        **rows["mega_adjoint_segment"],
        "library_ms": None,
        "cli_fit_launches": fit_cli["mega"]["launches"][
            "mega_adjoint_segment"],
        # launches: cover_lights' training step (phase 34); mesh, which
        # has no training step, the exact call of phase 33
        "families": {**family_rows("mega_adjoint_segment"),
                     "cover_lights": {
                         **families["cover_lights"]["mega_adjoint_segment"],
                         "launches": fam_train[
                             ("mega", TRAIN_BWD_DEPTH)]["launches"]}},
        "img": img_entry("mega_adjoint_segment", train_key="mega"),
        "nee": {**nee_rows["mega_adjoint_segment"],
                "max_abs_err_small": err_nee_b5,
                "cli_fit_launches": nee_fit["mega"]["launches"][
                    "mega_adjoint_segment"]},
        "qmc_cull": {**flag_entry("mega_adjoint_segment"),
                     "max_abs_err_small": err_flags["b5"]},
        "warp_hit": warp_entry("mega_adjoint_segment"),
        "example": example_entry("mega_adjoint_segment"),
        "parallel": par_entry("mega_adjoint_segment"),
        "bwd_engine": iface_entry("mega_adjoint_segment"),
    }, {
        "name": "queue_adjoint_launch",
        "route": "cuda",
        "source": "rt_tpu_torch/csrc/queue_adjoint.cu",
        "replaces": "rt_tpu/ops/pallas_queue.py:543",
        "launches": train[("queue", TRAIN_BWD_DEPTH)]["launches"],
        "max_abs_err": max(err_b6, err_flags["b6"]),
        **rows["queue_adjoint_launch"],
        "library_ms": None,
        "cli_fit_launches": fit_cli["replay"]["launches"][
            "queue_adjoint_launch"],
        "families": {**family_rows("queue_adjoint_launch"),
                     "cover_lights": {
                         **families["cover_lights"]["queue_adjoint_launch"],
                         "launches": fam_train[
                             ("queue", TRAIN_BWD_DEPTH)]["launches"]}},
        "img": img_entry("queue_adjoint_launch", train_key="queue",
                         fit_key="fit_replay"),
        "nee": {**nee_rows["queue_adjoint_launch"],
                "max_abs_err_small": err_nee_b6,
                "cli_fit_launches": nee_fit["replay"]["launches"][
                    "queue_adjoint_launch"]},
        "qmc_cull": {**flag_entry("queue_adjoint_launch"),
                     "max_abs_err_small": err_flags["b6"]},
        "warp_hit": warp_entry("queue_adjoint_launch"),
        "example": example_entry("queue_adjoint_launch"),
        "parallel": par_entry("queue_adjoint_launch"),
        "bwd_engine": iface_entry("queue_adjoint_launch"),
    }, {
        "name": "mega_capture",
        "route": "cuda",
        "source": "rt_tpu_torch/csrc/capture.cu",
        "replaces": "rt_tpu/ops/pallas_mega.py:1978",
        "launches": tape_counts["mega_capture"],
        "max_abs_err": err_b4,
        **rows["mega_capture"],
        "library_ms": None,
        "cli_fit_launches": fit_cli["tape"]["launches"]["mega_capture"],
        "families": {k: {**v, "launches": fam_tape[k]["launches"]}
                     for k, v in family_rows("mega_capture").items()},
        "img": img_entry("mega_capture", train_key="tape",
                         fit_key="fit_tape"),
        "qmc_cull": {"culled_codes_off_unculled_and_ties": ties_seen},
        "warp_hit": warp_entry("mega_capture"),
        "example": example_entry("mega_capture"),
        "parallel": par_entry("mega_capture"),
    }, {
        "name": "mega_regen",
        "route": "cuda",
        "source": "rt_tpu_torch/csrc/regen.cu",
        "replaces": "rt_tpu/ops/pallas_mega.py:2288",
        "launches": regen_main[0]["launches"],
        "max_abs_err": err_b7,
        **rows["mega_regen"],
        "library_ms": None,
        "families": family_rows("mega_regen"),
        "img": img_entry("mega_regen"),
        "qmc_cull": flag_entry("mega_regen", "regen"),
        "drivers": {"progressive": drv["progressive"]["regen"]},
        "bvh_bit_equal": "library regen" in bvh_rec["cli"]["bit_equal"],
        "warp_hit": warp_entry("mega_regen"),
        "example": example_entry("mega_regen"),
        "parallel": par_entry("mega_regen"),
        "frame_size": iface["regen_size"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="smoke run of rt_tpu_torch on "
                                 "one CUDA GPU (see the module doc)")
    ap.add_argument("--parent", default=None,
                    help="another checkout of the port: phase 2 compares "
                         "registers, phase 3 its B1 lane for lane and "
                         "phase 48 times its B1-B7, the replay and tape "
                         "steps and frames beside this tree's")
    ap.add_argument("--ab-times", default=None, metavar="ROOT",
                    help="only time B1-B7, the replay and tape steps and "
                         "frames (phase 48's helper) with the package of "
                         "ROOT")
    ap.add_argument("--b1-hits", nargs=2, default=None,
                    metavar=("ROOT", "PATH"),
                    help="only run B1 of the package of ROOT on the rays "
                         "saved in PATH (phase 3's helper)")
    ap.add_argument("--parallel-rank", nargs=2, default=None,
                    metavar=("RANK", "DIR"),
                    help="only run phase 58's rank RANK of two, its file "
                         "store and outputs in DIR (phase 58's helper)")
    ap.add_argument("--dense-grid", action="store_true",
                    help=f"phase 50 also builds and times B2-B7 with "
                         f"kDenseMax {DENSE_GRID}")
    opts = ap.parse_args()
    DENSE_GRID_ON = opts.dense_grid
    if opts.parallel_rank:
        if not torch.cuda.is_available():
            raise SystemExit("chip_smoke: no CUDA device")
        sys.exit(parallel_rank(int(opts.parallel_rank[0]),
                               opts.parallel_rank[1]))
    if opts.ab_times or opts.b1_hits:
        if not torch.cuda.is_available():
            raise SystemExit("chip_smoke: no CUDA device")
        if opts.b1_hits:
            sys.exit(b1_hits(os.path.abspath(opts.b1_hits[0]),
                             opts.b1_hits[1]))
        sys.exit(ab_times(os.path.abspath(opts.ab_times)))
    PARENT = os.path.abspath(opts.parent) if opts.parent else None
    sys.exit(main())
