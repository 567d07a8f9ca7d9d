"""The persistent ray queue B3: the hand-written CUDA kernel, the host
loop that relaunches it, and its plain PyTorch emulation (the
counterpart of rt_tpu/ops/pallas_queue.py `_queue_kernel` :122,
`_pack_into` :75, `queue_launch` :310 and `queue_trace` :404, for
spheres with solid and checker textures, no NEE, sampler "rng").

`queue_trace` runs csrc/queue.cu (built by nvcc at first use,
ops/cuda_build.py) for CUDA tensors and raises if it cannot; for CPU
tensors it runs `queue_trace_plain`. `queue_launch.launches` counts
kernel launches, and nothing else.

Contract (both versions, and the TPU kernel): the primary rays ro, rd
[B,3] with their pixel and sample ids are traced to their ends through
the megakernel's bounce body, one bounce per step, each lane carrying
its own bounce counter as the RNG's bounce coordinate; the result is
the [B,3] radiance per input lane, equal to `cuda_mega.mega_trace`'s
per lane. `cfg.queue_steps` is the budget of steps per launch (0: one
launch drains the batch); the lanes in flight when a launch ends wait
in the pool for the next one, so the result has the same bits whatever
the budget. Every lane completes exactly once (the wrapper checks that
the done count equals B; `check_once=True` also counts the writes per
lane).

`queue_trace_adjoint` is the backward of one sample of the path-replay
gradient on the queue's adjoint B6 (csrc/queue_adjoint.cu, the
counterpart of `_queue_adjoint_kernel` :543, `queue_adjoint_launch`
:736 and `queue_trace_adjoint` :829): the same pool and refill, each
lane carrying its radiance L and cotangent g, and no radiance output;
the [8, n_slots] gradient block persists across launches.
`queue_adjoint_launch.launches` counts its launches. Its plain version
is ops/adjoint_plain.py.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from rt_tpu_torch.ops import adjoint_plain, cuda_build
from rt_tpu_torch.ops import cuda_mega
from rt_tpu_torch.ops import mega_plain as mp

POOL_I = 4  # int32 pool rows: slot (-1 empty), pixel, sample, bounce
# pool lanes of the plain emulation unless the caller sets them (the
# result does not depend on them; the kernel's pool is a few 100k lanes)
PLAIN_POOL_LANES = 1 << 16


@functools.lru_cache(maxsize=None)
def _library():
    lib = cuda_build.load("queue")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.queue_grid_blocks.argtypes = [ci, ci]
    lib.queue_grid_blocks.restype = ci
    lib.queue_launch.argtypes = [
        vp, ci,                       # table, rows
        vp, vp, vp, vp, ci, ci,       # ro, rd, pixel, sample, sample, b
        vp, vp, vp,                   # pool_f, pool_i, counters
        vp, vp, vp,                   # out, depth, written
        ci, ci,                       # max_depth, budget
        *cuda_mega.SCALAR_TYPES,
        ci, ci, vp]                   # blocks, threads, stream
    lib.queue_launch.restype = ci
    lib.queue_error_string.argtypes = [ci]
    lib.queue_error_string.restype = ctypes.c_char_p
    return lib


def grid_blocks(rows: int, device, threads: int = cuda_mega.THREADS) -> int:
    """Blocks the card holds at once for a table of `rows` rows: the
    persistent grid (pool lanes = blocks * threads), queried from CUDA
    once per card, row count and block size."""
    dev = torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return _grid_blocks(int(rows), index, int(threads))


@functools.lru_cache(maxsize=None)
def _grid_blocks(rows: int, index: int, threads: int) -> int:
    lib = _library()
    with torch.cuda.device(index):
        blocks = lib.queue_grid_blocks(rows, threads)
    if blocks <= 0:
        msg = lib.queue_error_string(-blocks).decode() if blocks else \
            "no block fits on a multiprocessor"
        raise RuntimeError(f"queue_grid_blocks failed: {msg} ({blocks})")
    return blocks


def queue_launch(tab, ro, rd, pixel, sample, pool_f, pool_i, counters, out,
                 *, seed, max_depth, budget, t_min=1e-3, p_rr=0.0,
                 grad_bg=False, bg, exhaust_bg=False, depth=None,
                 written=None, blocks, threads=cuda_mega.THREADS):
    """One launch of the queue kernel on CUDA tensors (see queue.cu for
    the operands). pool_f [13, blocks*threads], pool_i [4, blocks*threads]
    and counters [2] carry the queue from one launch to the next."""
    dev = ro.device
    if dev.type != "cuda":
        raise ValueError(f"queue_launch: unsupported device {dev}")
    b = ro.shape[0]
    lanes = int(blocks) * int(threads)
    chk = cuda_build.check_tensor
    cuda_mega.check_table(tab, dev)
    chk("ro", ro, torch.float32, (b, 3), dev)
    chk("rd", rd, torch.float32, (b, 3), dev)
    chk("pixel", pixel, torch.int32, (b,), dev)
    samp_ptr, samp = cuda_mega.lane_ints("sample", sample, b, dev)
    chk("pool_f", pool_f, torch.float32, (mp.NSTATE, lanes), dev)
    chk("pool_i", pool_i, torch.int32, (POOL_I, lanes), dev)
    chk("counters", counters, torch.int32, (2,), dev)
    chk("out", out, torch.float32, (b, 3), dev)
    ptrs = []
    for name, x in (("depth", depth), ("written", written)):
        if x is not None:
            chk(name, x, torch.int32, (b,), dev)
        ptrs.append(None if x is None else x.data_ptr())
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.queue_launch(
            tab.data_ptr(), tab.shape[0], ro.data_ptr(), rd.data_ptr(),
            pixel.data_ptr(), samp_ptr, samp, b, pool_f.data_ptr(),
            pool_i.data_ptr(), counters.data_ptr(), out.data_ptr(), *ptrs,
            int(max_depth), int(budget),
            *cuda_mega._scalars(seed, t_min, p_rr, grad_bg, bg, exhaust_bg),
            int(blocks), int(threads), stream)
    if rc != 0:
        msg = lib.queue_error_string(rc).decode()
        raise RuntimeError(f"queue_launch failed: {msg} ({rc})")
    queue_launch.launches += 1


queue_launch.launches = 0


def _operands(tables, cfg, ro, pixel, sample_idx):
    dev = ro.device
    pix = pixel.to(device=dev, dtype=torch.int32).reshape(-1).contiguous()
    sample = cuda_mega.lane_vector(sample_idx, dev)
    return (tables.mega.table, pix,
            int(sample_idx) if sample is None else sample,
            mp.trace_options(tables, cfg))


def queue_trace(tables, cfg, ro, rd, pixel, sample_idx, seed, *,
                plain: bool = False, stats: Optional[dict] = None,
                check_once: bool = False,
                pool_lanes: Optional[int] = None) -> torch.Tensor:
    """Trace the primary rays ro, rd [B,3] to radiance [B,3] through the
    persistent queue (see the module doc). CPU tensors, or plain=True
    (the comparisons on the card), run queue_trace_plain. pool_lanes
    sizes the pool: the plain version's, or the kernel's rounded up to
    whole blocks and at most the grid the card holds at once (its
    default). stats, when given, gains "launches" and "ray_bounces".

    Pre-condition: mega_tables.mega_supported(tables)."""
    if plain or ro.device.type == "cpu":
        return queue_trace_plain(
            tables, cfg, ro, rd, pixel, sample_idx, seed, stats=stats,
            check_once=check_once,
            pool_lanes=pool_lanes or PLAIN_POOL_LANES)
    dev = ro.device
    tab, pix, sample, kw = _operands(tables, cfg, ro, pixel, sample_idx)
    b = ro.shape[0]
    out = torch.empty((b, 3), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    ro, rd = ro.contiguous(), rd.contiguous()
    blocks = grid_blocks(tab.shape[0], dev)
    if pool_lanes is not None:
        blocks = min(blocks, max(1, -(-int(pool_lanes) // cuda_mega.THREADS)))
    lanes = blocks * cuda_mega.THREADS
    pool_f = torch.empty((mp.NSTATE, lanes), dtype=torch.float32, device=dev)
    pool_i = torch.empty((POOL_I, lanes), dtype=torch.int32, device=dev)
    pool_i[0] = -1
    counters = torch.zeros(2, dtype=torch.int32, device=dev)
    depth = (torch.zeros(b, dtype=torch.int32, device=dev)
             if stats is not None else None)
    written = (torch.zeros(b, dtype=torch.int32, device=dev)
               if check_once else None)
    budget = max(0, int(cfg.queue_steps))
    # every launch advances some lane one bounce, so this bounds a queue
    # that makes no progress
    max_launches = b * (cfg.max_depth + 1) + 1
    launches = 0
    while True:
        queue_launch(tab, ro, rd, pix, sample, pool_f, pool_i, counters,
                     out, seed=seed, max_depth=cfg.max_depth, budget=budget,
                     exhaust_bg=cfg.exhaust_mode == "background",
                     depth=depth, written=written, blocks=blocks, **kw)
        launches += 1
        done = int(counters[1])  # one small host read per launch
        if done >= b or budget == 0 or launches >= max_launches:
            break
    if done != b:
        raise RuntimeError(f"queue_trace: {done} of {b} lanes completed "
                           f"after {launches} launches")
    if written is not None and not bool((written == 1).all()):
        raise RuntimeError("queue_trace: a lane completed other than once")
    cuda_mega.record_stats(stats, launches, depth)
    return out


def queue_trace_plain(tables, cfg, ro, rd, pixel, sample_idx, seed, *,
                      stats: Optional[dict] = None,
                      check_once: bool = False,
                      pool_lanes: int = PLAIN_POOL_LANES) -> torch.Tensor:
    """The plain version: a pool of `pool_lanes` lanes, one bounce per
    step, empty lanes refilled in index order from the fresh rays, and
    `cfg.queue_steps` steps per launch (0: until drained)."""
    dev = ro.device
    tab, pix_in, sample, kw = _operands(tables, cfg, ro, pixel, sample_idx)
    exhaust_bg = cfg.exhaust_mode == "background"
    b = ro.shape[0]
    per_lane = isinstance(sample, torch.Tensor)
    p = int(pool_lanes)
    pool = torch.zeros((mp.NSTATE, p), dtype=torch.float32, device=dev)
    slot = torch.full((p,), -1, dtype=torch.long, device=dev)
    pix = torch.zeros(p, dtype=torch.long, device=dev)
    smp = torch.zeros(p, dtype=torch.long, device=dev)
    bounce = torch.zeros(p, dtype=torch.long, device=dev)
    out = torch.empty((b, 3), dtype=torch.float32, device=dev)
    depth = torch.zeros(b, dtype=torch.int32, device=dev)
    written = torch.zeros(b, dtype=torch.int32, device=dev)
    budget = max(0, int(cfg.queue_steps))
    cursor = done = launches = 0
    while done < b:
        launches += 1
        step = 0
        while budget == 0 or step < budget:
            empty = torch.nonzero(slot < 0)[:, 0][:b - cursor]
            if empty.numel():
                new = torch.arange(cursor, cursor + empty.numel(), device=dev)
                slot[empty] = new
                pool[:, empty] = mp.fresh_state(ro[new], rd[new])
                pix[empty] = pix_in[new].long()
                smp[empty] = sample[new].long() if per_lane else sample
                bounce[empty] = 0
                cursor += empty.numel()
            busy = slot >= 0
            if not bool(busy.any()):
                break
            go = torch.nonzero(busy & (bounce < cfg.max_depth)
                               & (pool[mp.ALIVE] > 0.0))[:, 0]
            if go.numel():
                pool[:, go] = mp.do_bounce_plain(
                    tab, pool[:, go], pix[go], smp[go], bounce[go], seed,
                    **kw)
                bounce[go] += 1
            exh = busy & (pool[mp.ALIVE] > 0.0) & (bounce >= cfg.max_depth)
            if exhaust_bg and bool(exh.any()):
                mp.exhaust(pool, exh, kw["bg"], kw["grad_bg"])
            pool[mp.ALIVE] = torch.where(exh, 0.0, pool[mp.ALIVE])
            fin = torch.nonzero(busy & ~(pool[mp.ALIVE] > 0.0))[:, 0]
            if fin.numel():
                s = slot[fin]
                out[s] = pool[mp.C:mp.C + 3, fin].T
                depth[s] = bounce[fin].to(torch.int32)
                written[s] += 1
                done += fin.numel()
                slot[fin] = -1
            step += 1
    if check_once and not bool((written == 1).all()):
        raise RuntimeError("queue_trace_plain: a lane completed other than "
                           "once")
    cuda_mega.record_stats(stats, launches, depth)
    return out


@functools.lru_cache(maxsize=None)
def _adjoint_library():
    lib = cuda_build.load("queue_adjoint")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.queue_adjoint_grid_blocks.argtypes = [ci, ci, ci, ci]
    lib.queue_adjoint_grid_blocks.restype = ci
    lib.queue_adjoint_launch.argtypes = [
        vp, ci,                       # table, rows
        vp, vp, vp, vp, ci,           # ro, rd, pixel, sample, sample
        vp, vp, ci,                   # L, g, b
        vp, vp, vp,                   # pool_f, pool_i, counters
        vp, ci, ci,                   # grad, n_slots, shared_acc
        vp, vp,                       # depth, written
        ci, ci,                       # max_depth, budget
        *cuda_mega.SCALAR_TYPES,
        ci, ci, vp]                   # blocks, threads, stream
    lib.queue_adjoint_launch.restype = ci
    lib.queue_adjoint_error_string.argtypes = [ci]
    lib.queue_adjoint_error_string.restype = ctypes.c_char_p
    return lib


def adjoint_grid_blocks(rows: int, n_slots: int, device,
                        threads: int = cuda_mega.THREADS) -> int:
    """The persistent grid of the queue adjoint (blocks the card holds at
    once with its shared memory: the staged table, and the accumulators
    when cuda_mega.acc_fits_smem), once per card and shape."""
    dev = torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return _adjoint_grid_blocks(int(rows), int(n_slots), index, int(threads))


@functools.lru_cache(maxsize=None)
def _adjoint_grid_blocks(rows, n_slots, index, threads):
    lib = _adjoint_library()
    with torch.cuda.device(index):
        blocks = lib.queue_adjoint_grid_blocks(
            rows, n_slots, int(cuda_mega.acc_fits_smem(n_slots)), threads)
    if blocks <= 0:
        msg = lib.queue_adjoint_error_string(-blocks).decode() if blocks \
            else "no block fits on a multiprocessor"
        raise RuntimeError(f"queue_adjoint_grid_blocks failed: {msg} "
                           f"({blocks})")
    return blocks


def queue_adjoint_launch(tab, ro, rd, pixel, sample, L, gcot, pool_f,
                         pool_i, counters, grad, *, seed, max_depth, budget,
                         t_min=1e-3, p_rr=0.0, grad_bg=False,
                         bg, exhaust_bg=False, depth=None, written=None,
                         blocks, threads=cuda_mega.THREADS):
    """One launch of the queue adjoint on CUDA tensors (see
    queue_adjoint.cu for the operands). pool_f [19, blocks*threads],
    pool_i [4, blocks*threads], counters [2] and grad [8, n_slots] carry
    the replay from one launch to the next."""
    dev = ro.device
    if dev.type != "cuda":
        raise ValueError(f"queue_adjoint_launch: unsupported device {dev}")
    b = ro.shape[0]
    lanes = int(blocks) * int(threads)
    chk = cuda_build.check_tensor
    cuda_mega.check_table(tab, dev)
    for name, x in (("ro", ro), ("rd", rd), ("L", L), ("gcot", gcot)):
        chk(name, x, torch.float32, (b, 3), dev)
    chk("pixel", pixel, torch.int32, (b,), dev)
    samp_ptr, samp = cuda_mega.lane_ints("sample", sample, b, dev)
    chk("pool_f", pool_f, torch.float32, (cuda_mega.ADJ_ROWS, lanes), dev)
    chk("pool_i", pool_i, torch.int32, (POOL_I, lanes), dev)
    chk("counters", counters, torch.int32, (2,), dev)
    n_slots = grad.shape[1] if grad.dim() == 2 else 0
    chk("grad", grad, torch.float32, (adjoint_plain.ACC_ROWS, n_slots), dev)
    ptrs = []
    for name, x in (("depth", depth), ("written", written)):
        if x is not None:
            chk(name, x, torch.int32, (b,), dev)
        ptrs.append(None if x is None else x.data_ptr())
    lib = _adjoint_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.queue_adjoint_launch(
            tab.data_ptr(), tab.shape[0], ro.data_ptr(), rd.data_ptr(),
            pixel.data_ptr(), samp_ptr, samp, L.data_ptr(), gcot.data_ptr(),
            b, pool_f.data_ptr(), pool_i.data_ptr(), counters.data_ptr(),
            grad.data_ptr(), n_slots, int(cuda_mega.acc_fits_smem(n_slots)),
            *ptrs,
            int(max_depth), int(budget),
            *cuda_mega._scalars(seed, t_min, p_rr, grad_bg, bg, exhaust_bg),
            int(blocks), int(threads), stream)
    if rc != 0:
        msg = lib.queue_adjoint_error_string(rc).decode()
        raise RuntimeError(f"queue_adjoint_launch failed: {msg} ({rc})")
    queue_adjoint_launch.launches += 1


queue_adjoint_launch.launches = 0


def queue_trace_adjoint(tables, cfg, ro, rd, pixel, sample_idx, seed, L,
                        gcot, depth_bwd: int, exhaust: bool, *,
                        plain: bool = False, stats: Optional[dict] = None,
                        check_once: bool = False,
                        pool_lanes: Optional[int] = None) -> dict:
    """The radiometric backward of one sample of the path-replay
    gradient on the queue adjoint B6 (see the module doc): the contract
    of cuda_mega.mega_trace_adjoint, replayed through the persistent
    queue with cfg.queue_steps steps per launch. CPU tensors, or
    plain=True, run adjoint_plain.trace_adjoint_plain. pool_lanes caps
    the pool (whole blocks, at most the grid the card holds at once);
    check_once counts each lane's completions; stats gains "launches"
    and "ray_bounces".

    Pre-condition: mega_tables.mega_supported(tables)."""
    if plain or ro.device.type == "cpu":
        return adjoint_plain.trace_adjoint_plain(
            tables, cfg, ro, rd, pixel, sample_idx, seed, L, gcot,
            depth_bwd, exhaust, stats=stats)
    dev = ro.device
    ms = tables.mega
    tab, pix, sample, kw = _operands(tables, cfg, ro, pixel, sample_idx)
    b = ro.shape[0]
    grad = torch.zeros((adjoint_plain.ACC_ROWS, ms.n_slots),
                       dtype=torch.float32, device=dev)
    if b == 0:
        return adjoint_plain.split_grads(grad, ms, kw["grad_bg"])
    ro, rd = ro.contiguous(), rd.contiguous()
    L = L.to(torch.float32).contiguous()
    gcot = gcot.to(torch.float32).contiguous()
    blocks = adjoint_grid_blocks(tab.shape[0], ms.n_slots, dev)
    if pool_lanes is not None:
        blocks = min(blocks, max(1, -(-int(pool_lanes) // cuda_mega.THREADS)))
    lanes = blocks * cuda_mega.THREADS
    pool_f = torch.empty((cuda_mega.ADJ_ROWS, lanes), dtype=torch.float32,
                         device=dev)
    pool_i = torch.empty((POOL_I, lanes), dtype=torch.int32, device=dev)
    pool_i[0] = -1
    counters = torch.zeros(2, dtype=torch.int32, device=dev)
    depth = (torch.zeros(b, dtype=torch.int32, device=dev)
             if stats is not None else None)
    written = (torch.zeros(b, dtype=torch.int32, device=dev)
               if check_once else None)
    budget = max(0, int(cfg.queue_steps))
    max_launches = b * (int(depth_bwd) + 1) + 1
    launches = 0
    while True:
        queue_adjoint_launch(
            tab, ro, rd, pix, sample, L, gcot, pool_f, pool_i, counters,
            grad, seed=seed, max_depth=int(depth_bwd), budget=budget,
            exhaust_bg=exhaust, depth=depth,
            written=written, blocks=blocks, **kw)
        launches += 1
        done = int(counters[1])  # one small host read per launch
        if done >= b or budget == 0 or launches >= max_launches:
            break
    if done != b:
        raise RuntimeError(f"queue_trace_adjoint: {done} of {b} lanes "
                           f"completed after {launches} launches")
    if written is not None and not bool((written == 1).all()):
        raise RuntimeError("queue_trace_adjoint: a lane completed other "
                           "than once")
    cuda_mega.record_stats(stats, launches, depth)
    return adjoint_plain.split_grads(grad, ms, kw["grad_bg"])
