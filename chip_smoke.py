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
(ROADMAP C-7). Each phase prints its
seconds; any failure raises and the script exits non-zero without its
result line. The last line of standard output is the JSON result
{"ok": true, "device": {...}}; the line before it lists each kernel with
its launches on its path, its error against the plain version, its time,
the plain version's time and its bound on this card.

Needs one CUDA GPU and nvcc; imports neither JAX nor the JAX package.
Writes only to rt_tpu_torch/_build/ (ignored by git) and a temporary
directory that it removes.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_FP32_OPS = 67e12      # FP32 outside the tensor cores, op/s
PEAK_HBM_BYTES = 3.35e12   # HBM3, byte/s
# FP32 operations per (ray, sphere) pair in csrc/sphere_hit.cu's inner
# loop and bounce.cuh's hit loop, FMA counted as two and the sqrt as one
# (see the notes there)
SPHERE_OPS_PER_PAIR = 23
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

W, H, SPP, DEPTH = 1920, 1080, 2, 50     # rt_tpu bench.py:67-71 shape
MAIN_SPP = 16                            # bench.py's one-launch spp
SMALL_W, SMALL_H = 192, 108              # engine compare
CLI_W, CLI_H = 320, 180
LANES_1 = 65536                          # per-lane kernel compares
SMALL_POOL = 2048                        # B3 pool lanes of the refill check
TRAIN_BWD_DEPTH = 8      # the reference's production truncation
GRAD_FIELDS = ("tex_color", "tex_color2", "mat_albedo", "background")


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


def counters():
    from rt_tpu_torch.ops import cuda_intersect, cuda_mega, cuda_queue

    return {"sphere_closest_hit": cuda_intersect.sphere_closest_hit,
            "mega_segment": cuda_mega.mega_segment,
            "queue_launch": cuda_queue.queue_launch,
            "mega_adjoint_segment": cuda_mega.mega_adjoint_segment,
            "queue_adjoint_launch": cuda_queue.queue_adjoint_launch}


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

    with phase("2 build"):
        # one nvcc per source, all started together
        kernels = ["sphere_hit", "mega", "queue", "mega_adjoint",
                   "queue_adjoint"]
        for k in kernels:  # build from the checkout's sources
            cuda_build.library_path(k).unlink(missing_ok=True)
        t0 = time.time()
        with concurrent.futures.ThreadPoolExecutor(len(kernels)) as ex:
            libs = list(ex.map(cuda_build.build, kernels))
        build_s = time.time() - t0
        print(f"  built {len(libs)} libraries in {build_s:.2f} s")
        for k, lib in zip(kernels, libs):
            print(f"  {os.path.relpath(lib, ROOT)}: nvcc "
                  f"{' '.join(cuda_build.flags(k))}")
            log = lib.with_name(lib.name + ".log").read_text().strip()
            for line in log.splitlines():
                print(f"  nvcc: {line}")

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
        ops = SPHERE_OPS_PER_PAIR * b * n_live
        nbytes = (b * (12 + 12 + 4 + 4)            # ro, rd in; t, pid out
                  + n_rows * (12 + 4 + 1))         # centers, radii, live
        bound_ms = max(ops / PEAK_FP32_OPS, nbytes / PEAK_HBM_BYTES) * 1e3
        bound_by = ("operations" if ops / PEAK_FP32_OPS
                    >= nbytes / PEAK_HBM_BYTES else "bytes")
        print(f"  sphere_closest_hit at B={b}, N={n_rows} ({n_live} live): "
              f"kernel "
              f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}: {ops:.4g} ops, {nbytes:.4g} bytes); "
              f"{smi}", flush=True)

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
                   "-spp", "2", "-d", "50", "-o", out]
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
            pms, p_out = cuda_ms(lambda: fn(*main_args, plain=True), 1)
            err = lanes_close(k_out, p_out, f"{name} vs plain")
            ops = st["ray_bounces"] * (SPHERE_OPS_PER_PAIR * rows_k
                                       + SETUP_OPS)
            nbytes = (W * H * (12 + 12 + 4 + 12)   # ro, rd, pixel in; rgb out
                      + rows_k * 17 * 4)           # the packed table
            b_ms = max(ops / PEAK_FP32_OPS, nbytes / PEAK_HBM_BYTES) * 1e3
            b_by = ("operations" if ops / PEAK_FP32_OPS
                    >= nbytes / PEAK_HBM_BYTES else "bytes")
            rows[name] = dict(ms=ms, plain_ms=pms, bound_ms=b_ms,
                              bound_by=b_by, err=err)
            print(f"  {name}: trace {ms:.4f} ms, plain {pms:.4f} ms, bound "
                  f"{b_ms:.4f} ms ({b_by}: {st['ray_bounces']} ray-bounces "
                  f"x {rows_k} rows, {ops:.4g} ops, {nbytes:.4g} bytes; "
                  f"{b_ms / ms:.1%} of the bound); {smi}", flush=True)
        err_mega = max(err_mega, rows["mega_segment"].pop("err"))
        err_queue = max(err_queue, rows["queue_launch"].pop("err"))

    def adjoint_inputs(tb, cb, w_, h_, seed):
        """Camera rays of sample 0, their radiance (the queue kernel) and
        a seeded loss cotangent."""
        pix = torch.arange(w_ * h_, device=dev)
        ro_, rd_ = generate_rays(tb.camera, w_, h_, pix % w_, pix // w_, 0,
                                 0, cb.enable_defocus)
        L = cuda_queue.queue_trace(tb, cb, ro_, rd_, pix, 0, 0)
        g = torch.from_numpy(np.random.default_rng(seed).normal(
            0, 1.0 / (w_ * h_), (w_ * h_, 3)).astype(np.float32)).to(dev)
        return pix, ro_, rd_, L, g

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
            pms, p_out = cuda_ms(lambda: fn(*adj_args, plain=True), 1)
            err = grads_close(p_out, k_out, f"{name} vs plain")
            ops = st["ray_bounces"] * (SPHERE_OPS_PER_PAIR * rows_k
                                       + SETUP_OPS + ADJOINT_OPS)
            nbytes = (W * H * (12 + 12 + 4 + 12 + 12)  # ro, rd, pixel, L, g
                      + rows_k * 18 * 4               # the packed table
                      + 8 * n_slots * 4)              # gradients out
            b_ms = max(ops / PEAK_FP32_OPS, nbytes / PEAK_HBM_BYTES) * 1e3
            b_by = ("operations" if ops / PEAK_FP32_OPS
                    >= nbytes / PEAK_HBM_BYTES else "bytes")
            rows[name] = dict(ms=ms, plain_ms=pms, bound_ms=b_ms,
                              bound_by=b_by)
            if name == "mega_adjoint_segment":
                err_b5 = max(err_b5, err)
            else:
                err_b6 = max(err_b6, err)
            print(f"  {name}: adjoint call {ms:.4f} ms, plain {pms:.4f} ms, "
                  f"bound {b_ms:.4f} ms ({b_by}: {st['ray_bounces']} "
                  f"ray-bounces x {rows_k} rows, {ops:.4g} ops, "
                  f"{nbytes:.4g} bytes; {b_ms / ms:.1%} of the bound), "
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

    print(f"[17 summary] total {time.time() - t_all:.2f} s; {smi}", flush=True)
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
    }, {
        "name": "mega_segment",
        "route": "cuda",
        "source": "rt_tpu_torch/csrc/mega.cu",
        "replaces": "rt_tpu/ops/pallas_mega.py:1899",
        "launches": main["mega"]["launches"],
        "max_abs_err": err_mega,
        **rows["mega_segment"],
        "library_ms": None,
    }, {
        "name": "queue_launch",
        "route": "cuda",
        "source": "rt_tpu_torch/csrc/queue.cu",
        "replaces": "rt_tpu/ops/pallas_queue.py:122",
        "launches": main["queue"]["launches"],
        "max_abs_err": err_queue,
        **rows["queue_launch"],
        "library_ms": None,
    }, {
        "name": "mega_adjoint_segment",
        "route": "cuda",
        "source": "rt_tpu_torch/csrc/mega_adjoint.cu",
        "replaces": "rt_tpu/ops/pallas_mega.py:2183",
        "launches": train[("mega", TRAIN_BWD_DEPTH)]["launches"],
        "max_abs_err": err_b5,
        **rows["mega_adjoint_segment"],
        "library_ms": None,
    }, {
        "name": "queue_adjoint_launch",
        "route": "cuda",
        "source": "rt_tpu_torch/csrc/queue_adjoint.cu",
        "replaces": "rt_tpu/ops/pallas_queue.py:543",
        "launches": train[("queue", TRAIN_BWD_DEPTH)]["launches"],
        "max_abs_err": err_b6,
        **rows["queue_adjoint_launch"],
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
