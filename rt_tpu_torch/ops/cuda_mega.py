"""The forward megakernel B2: the hand-written CUDA kernel, its plain
PyTorch version, and the segmented trace around them (the counterpart of
rt_tpu/ops/pallas_mega.py `_mega_kernel` :1899, `mega_segment` :2460,
`_compact` :2716 and `mega_trace` :2934, for spheres with solid and
checker textures, no NEE, sampler "rng").

`mega_segment` launches csrc/mega.cu (built by nvcc at first use,
ops/cuda_build.py) for CUDA tensors and raises if it cannot; for CPU
tensors it runs `mega_segment_plain`. `mega_segment.launches` counts
kernel launches, and nothing else.

Contract of one segment (both versions, and the TPU kernel): the ray
state [13, B] (ops/mega_plain.py rows; the first `n` lanes are traced)
advances per lane while `bounce < max_depth` and the lane is alive,
drawing its RNG at (seed, pixel, sample, start_bounce + bounce,
purpose). `exhaust_bg` credits the sky to the lanes still alive at the
end (the final segment of a trace only). The state is updated in place;
`depth`, when given, gains each lane's number of bounces.

`mega_trace` runs the reference's segment schedule (`compact_every`,
`compact_schedule`) with a stable group partition between segments
(groups of `compact_group` lanes with any live lane first), traces only
the live prefix of the next segment (`compact_shrink`), and undoes the
composed permutation once at the end. Per-lane radiance does not depend on the
schedule (the tests hold it bit-equal on the CPU).

`mega_trace_adjoint` is the backward of one sample of the path-replay
gradient on the adjoint megakernel B5 (csrc/mega_adjoint.cu, the
counterpart of `_adjoint_kernel` :2183, `adjoint_segment` :2568 and
`mega_trace_adjoint` :3079): the same segments and group partition,
with each lane's radiance L and cotangent g carried beside its state,
and the gradients of the texture, material and background rows summed
into one [8, n_slots] block. `mega_adjoint_segment.launches` counts its
launches. Its plain version is ops/adjoint_plain.py.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from rt_tpu_torch.ops import adjoint_plain, cuda_build
from rt_tpu_torch.ops import mega_plain as mp
from rt_tpu_torch.ops.mega_tables import S_COLS

THREADS = 256
# the most table rows the int32 offsets of the kernels address
MAX_ROWS = (1 << 31) // S_COLS - 1
# the adjoints keep their accumulators (6 * n_slots + 3 floats) in each
# block's shared memory up to this size, else in global memory
ACC_SMEM_MAX = 96 * 1024
# rows of the adjoint's lane state: the forward's 13, then L and g
ADJ_ROWS = mp.NSTATE + 6


def _scalars(seed, t_min, p_rr, grad_bg, bg, exhaust_bg):
    """The scene / option scalars every launcher of mega.cu and queue.cu
    takes, in their C order. bg: the sky colour as 3 host floats."""
    comp = (1.0 / p_rr) if p_rr > 0.0 else 1.0
    return (ctypes.c_uint32(int(seed) & 0xFFFFFFFF), ctypes.c_float(t_min),
            ctypes.c_float(p_rr), ctypes.c_float(comp), int(bool(grad_bg)),
            ctypes.c_float(bg[0]), ctypes.c_float(bg[1]),
            ctypes.c_float(bg[2]), int(bool(exhaust_bg)))


SCALAR_TYPES = [ctypes.c_uint32, ctypes.c_float, ctypes.c_float,
                ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                ctypes.c_float, ctypes.c_int]


@functools.lru_cache(maxsize=None)
def _library():
    lib = cuda_build.load("mega")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.mega_segment_launch.argtypes = [
        vp, ci,                       # table, rows
        vp, ctypes.c_longlong, ci,    # state, stride, n
        vp, vp, ci,                   # pixel, sample (or null), sample
        ci, ci,                       # start_bounce, max_depth
        *SCALAR_TYPES,
        vp, ci, vp]                   # depth (or null), threads, stream
    lib.mega_segment_launch.restype = ci
    lib.mega_error_string.argtypes = [ci]
    lib.mega_error_string.restype = ctypes.c_char_p
    return lib


def check_table(tab, device):
    n = tab.shape[0] if tab.dim() == 2 else -1
    cuda_build.check_tensor("table", tab, torch.float32, (n, S_COLS), device)
    if not 0 < n <= MAX_ROWS:
        raise ValueError(f"table: {n} rows, want 1..{MAX_ROWS}")


def lane_ints(name, x, n, device):
    """A per-lane int32 operand: (pointer, scalar) for the C launcher."""
    if isinstance(x, torch.Tensor) and x.dim() > 0:
        cuda_build.check_tensor(name, x, torch.int32, (x.shape[0],), device)
        if x.shape[0] < n:
            raise ValueError(f"{name}: {x.shape[0]} lanes, want >= {n}")
        return x.data_ptr(), 0
    return None, int(x)


def mega_segment_plain(tab, state, pixel, sample, seed, start_bounce,
                       max_depth, *, n=None, t_min=1e-3, p_rr=0.0,
                       grad_bg=False, bg, exhaust_bg=False, depth=None):
    """The plain version of one segment (see the module doc)."""
    n = state.shape[1] if n is None else n
    sub = state[:, :n]
    per_lane = isinstance(sample, torch.Tensor) and sample.dim() > 0
    for b in range(max_depth):
        idx = torch.nonzero(sub[mp.ALIVE] > 0.0)[:, 0]
        if idx.numel() == 0:
            break
        samp = sample[idx] if per_lane else sample
        sub[:, idx] = mp.do_bounce_plain(
            tab, sub[:, idx], pixel[idx], samp, start_bounce + b, seed,
            t_min=t_min, p_rr=p_rr, grad_bg=grad_bg, bg=bg)
        if depth is not None:
            depth[idx] += 1
    if exhaust_bg:
        mp.exhaust(sub, torch.ones(n, dtype=torch.bool, device=sub.device),
                   bg, grad_bg)
    return state


def mega_segment(tab, state, pixel, sample, seed, start_bounce, max_depth,
                 *, n=None, t_min=1e-3, p_rr=0.0, grad_bg=False, bg,
                 exhaust_bg=False, depth=None, threads=THREADS):
    """One segment (see the module doc): the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    dev = state.device
    if dev.type == "cpu":
        return mega_segment_plain(
            tab, state, pixel, sample, seed, start_bounce, max_depth, n=n,
            t_min=t_min, p_rr=p_rr, grad_bg=grad_bg, bg=bg,
            exhaust_bg=exhaust_bg, depth=depth)
    if dev.type != "cuda":
        raise ValueError(f"mega_segment: unsupported device {dev}")
    if state.dim() != 2 or state.shape[0] != mp.NSTATE:
        raise ValueError(f"state: shape {tuple(state.shape)}, want (13, B)")
    stride = state.shape[1]
    n = stride if n is None else int(n)
    cuda_build.check_tensor("state", state, torch.float32,
                            (mp.NSTATE, stride), dev)
    check_table(tab, dev)
    if not 0 <= n <= stride:
        raise ValueError(f"n = {n}, want 0..{stride}")
    pix_ptr, _ = lane_ints("pixel", pixel, n, dev)
    if pix_ptr is None:
        raise ValueError("pixel: want a per-lane int32 tensor")
    samp_ptr, samp = lane_ints("sample", sample, n, dev)
    depth_ptr = None
    if depth is not None:
        depth_ptr, _ = lane_ints("depth", depth, n, dev)
    if n == 0:
        return state
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mega_segment_launch(
            tab.data_ptr(), tab.shape[0], state.data_ptr(), stride, n,
            pix_ptr, samp_ptr, samp, int(start_bounce), int(max_depth),
            *_scalars(seed, t_min, p_rr, grad_bg, bg, exhaust_bg),
            depth_ptr, int(threads), stream)
    if rc != 0:
        msg = lib.mega_error_string(rc).decode()
        raise RuntimeError(f"mega_segment launch failed: {msg} ({rc})")
    mega_segment.launches += 1
    return state


mega_segment.launches = 0


def schedule(cfg) -> list:
    """Segment lengths of one trace (pallas_mega.py:2981-3013)."""
    ce = cfg.compact_every
    explicit = tuple(cfg.compact_schedule or ())
    if explicit:
        # consume the schedule up to max_depth (clamping the last
        # segment), then append the remainder as one segment
        out, left = [], cfg.max_depth
        for s in explicit:
            if s <= 0 or left == 0:
                continue
            s = min(s, left)
            out.append(s)
            left -= s
        if left:
            out.append(left)
        return out
    if ce == 0 or ce >= cfg.max_depth:
        return [cfg.max_depth]
    if ce > 0:
        out = [ce] * (cfg.max_depth // ce)
        if cfg.max_depth % ce:
            out.append(cfg.max_depth % ce)
        return out
    # auto (-1): geometric early-heavy schedule 1, 2, 4, 8, ...
    out, seg, left = [], 1, cfg.max_depth
    while left > 0:
        s = min(seg, left)
        out.append(s)
        left -= s
        seg *= 2
    return out


def lane_vector(x, device):
    """A per-lane sample index tensor as int32 on device, or None for a
    scalar index."""
    return (x.to(device=device, dtype=torch.int32).reshape(-1)
            if isinstance(x, torch.Tensor) and x.dim() > 0 else None)


def _padded_lanes(state, pixel, sample_idx, bp):
    """The trace's lanes, padded with dead lanes to bp: state [R, bp],
    pixel [bp] i32 and the sample (a [bp] i32 tensor, or an int)."""
    dev = state.device
    b = state.shape[1]
    pix = pixel.to(device=dev, dtype=torch.int32).reshape(-1)
    samp = lane_vector(sample_idx, dev)
    if bp > b:
        pad = torch.zeros((state.shape[0], bp - b), dtype=torch.float32,
                          device=dev)
        state = torch.cat([state, pad], dim=1)
        pix = torch.cat([pix, pix.new_zeros(bp - b)])
        if samp is not None:
            samp = torch.cat([samp, samp.new_zeros(bp - b)])
    return state, pix, (samp if samp is not None else int(sample_idx))


def _segmented(state, pix, sample, depth, segs, cfg, run):
    """Run the segments `segs` over the lanes: run(state, pix, sample,
    depth, start_bounce, seg, n_live, last) traces lanes [0, n_live) of
    state in place. Between segments, whole groups of cfg.compact_group
    lanes are partitioned stably, groups with a live lane first (rows of
    state, pix, a per-lane sample and depth move together), and with
    cfg.compact_shrink only the live prefix is traced next.

    Returns (state, depth, orig_g, launches), state and depth in the
    last partition's lane order: orig_g [groups] is each group's
    original index (None for one segment)."""
    rows, bp = state.shape
    group = max(1, int(cfg.compact_group))
    compact = len(segs) > 1
    g = bp // group if compact else 0
    orig_g = torch.arange(g, device=state.device) if compact else None
    per_lane = isinstance(sample, torch.Tensor)
    n_live = bp
    done = launches = 0
    for i, seg in enumerate(segs):
        last = i == len(segs) - 1
        run(state, pix, sample, depth, done, seg, n_live, last)
        launches += 1
        done += seg
        if last:
            break
        alive_g = (state[mp.ALIVE].view(g, group) > 0.0).any(-1)
        live_groups = int(alive_g.sum())
        if live_groups == 0:
            break
        # stable partition of whole groups, any-live groups first
        perm = torch.argsort((~alive_g).to(torch.int8), stable=True)
        state = state.view(rows, g, group)[:, perm].reshape(rows, bp)
        pix = pix.view(g, group)[perm].reshape(bp)
        if per_lane:
            sample = sample.view(g, group)[perm].reshape(bp)
        if depth is not None:
            depth = depth.view(g, group)[perm].reshape(bp)
        orig_g = orig_g[perm]
        # trace only the live prefix (compact_shrink, as _segment_shrunk)
        n_live = live_groups * group if cfg.compact_shrink else bp
    return state, depth, orig_g, launches


def _padded_size(b, segs, cfg):
    group = max(1, int(cfg.compact_group))
    return -(-b // group) * group if len(segs) > 1 else b


def record_stats(stats, launches, depth):
    """Add a trace's launches and its lanes' bounces (depth) to stats."""
    if stats is not None:
        stats["launches"] = stats.get("launches", 0) + launches
        stats["ray_bounces"] = (stats.get("ray_bounces", 0)
                                + int(depth.sum()))


def mega_trace(tables, cfg, ro, rd, pixel, sample_idx, seed, *,
               plain: bool = False, stats: Optional[dict] = None
               ) -> torch.Tensor:
    """Trace the primary rays ro, rd [B,3] to radiance [B,3] through the
    megakernel (see the module doc). plain=True runs the plain version
    on any device (the comparisons on the card use it). stats, when
    given, gains "launches" (segments run) and "ray_bounces".

    Pre-condition: mega_tables.mega_supported(tables)."""
    dev = ro.device
    b = ro.shape[0]
    tab = tables.mega.table
    segs = schedule(cfg)
    bp = _padded_size(b, segs, cfg)
    # pad lanes enter dead: they trace nothing and are cut at the end
    state, pix, sample = _padded_lanes(mp.fresh_state(ro, rd), pixel,
                                       sample_idx, bp)
    depth = (torch.zeros(bp, dtype=torch.int32, device=dev)
             if stats is not None else None)
    seg_fn = mega_segment_plain if plain else mega_segment
    kw = mp.trace_options(tables, cfg)
    exhaust = cfg.exhaust_mode == "background"

    def run(state, pix, sample, depth, start, seg, n_live, last):
        seg_fn(tab, state, pix, sample, seed, start, seg, n=n_live,
               exhaust_bg=exhaust and last, depth=depth, **kw)

    state, depth, orig_g, launches = _segmented(state, pix, sample, depth,
                                               segs, cfg, run)
    rgb = state[mp.C:mp.C + 3]
    if orig_g is not None:
        # undo the composed group permutation once
        inv = torch.argsort(orig_g)
        g = orig_g.shape[0]
        rgb = rgb.reshape(3, g, bp // g)[:, inv].reshape(3, bp)
    record_stats(stats, launches, depth)
    return rgb[:, :b].T.contiguous()


def mega_adjoint_segment(tab, state, pixel, sample, seed, start_bounce,
                         max_depth, grad, *, n=None, t_min=1e-3, p_rr=0.0,
                         grad_bg=False, bg, exhaust_bg=False, depth=None,
                         threads=THREADS):
    """One segment of the adjoint megakernel B5 (csrc/mega_adjoint.cu)
    on CUDA tensors: state [19, stride] (the forward's 13 rows, then L
    and g), lanes [0, n) replayed in place; grad [8, n_slots] is added
    to, through per-block accumulators in shared memory when they fit
    (acc_fits_smem)."""
    dev = state.device
    if dev.type != "cuda":
        raise ValueError(f"mega_adjoint_segment: unsupported device {dev}")
    if state.dim() != 2 or state.shape[0] != ADJ_ROWS:
        raise ValueError(f"state: shape {tuple(state.shape)}, want "
                         f"({ADJ_ROWS}, B)")
    stride = state.shape[1]
    n = stride if n is None else int(n)
    cuda_build.check_tensor("state", state, torch.float32,
                            (ADJ_ROWS, stride), dev)
    check_table(tab, dev)
    n_slots = grad.shape[1] if grad.dim() == 2 else 0
    cuda_build.check_tensor("grad", grad, torch.float32,
                            (adjoint_plain.ACC_ROWS, n_slots), dev)
    if not 0 <= n <= stride:
        raise ValueError(f"n = {n}, want 0..{stride}")
    pix_ptr, _ = lane_ints("pixel", pixel, n, dev)
    if pix_ptr is None:
        raise ValueError("pixel: want a per-lane int32 tensor")
    samp_ptr, samp = lane_ints("sample", sample, n, dev)
    depth_ptr = None
    if depth is not None:
        depth_ptr, _ = lane_ints("depth", depth, n, dev)
    if n == 0:
        return state
    lib = _adjoint_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mega_adjoint_launch(
            tab.data_ptr(), tab.shape[0], state.data_ptr(), stride, n,
            pix_ptr, samp_ptr, samp, int(start_bounce), int(max_depth),
            *_scalars(seed, t_min, p_rr, grad_bg, bg, exhaust_bg),
            grad.data_ptr(), n_slots, int(acc_fits_smem(n_slots)), depth_ptr,
            int(threads), stream)
    if rc != 0:
        msg = lib.mega_adjoint_error_string(rc).decode()
        raise RuntimeError(f"mega_adjoint_segment launch failed: {msg} "
                           f"({rc})")
    mega_adjoint_segment.launches += 1
    return state


mega_adjoint_segment.launches = 0


def acc_fits_smem(n_slots: int) -> bool:
    """Whether the adjoints keep their accumulators in shared memory."""
    return (6 * n_slots + 3) * 4 <= ACC_SMEM_MAX


@functools.lru_cache(maxsize=None)
def _adjoint_library():
    lib = cuda_build.load("mega_adjoint")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.mega_adjoint_launch.argtypes = [
        vp, ci,                       # table, rows
        vp, ctypes.c_longlong, ci,    # state, stride, n
        vp, vp, ci,                   # pixel, sample (or null), sample
        ci, ci,                       # start_bounce, max_depth
        *SCALAR_TYPES,
        vp, ci, ci,                   # grad, n_slots, shared_acc
        vp, ci, vp]                   # depth (or null), threads, stream
    lib.mega_adjoint_launch.restype = ci
    lib.mega_adjoint_error_string.argtypes = [ci]
    lib.mega_adjoint_error_string.restype = ctypes.c_char_p
    return lib


def mega_trace_adjoint(tables, cfg, ro, rd, pixel, sample_idx, seed, L,
                       gcot, depth_bwd: int, exhaust: bool, *,
                       plain: bool = False, stats: Optional[dict] = None
                       ) -> dict:
    """The radiometric backward of one sample of the path-replay
    gradient on the adjoint megakernel B5 (the counterpart of
    pallas_mega.mega_trace_adjoint :3079): replay the primary rays ro, rd
    [B,3] for depth_bwd bounces under the forward's segment schedule and
    group partition, with L (the sample's radiance [B,3]) and gcot (its
    cotangent [B,3]). exhaust: credit the sky's gradient to lanes alive
    after the last bounce (an exact replay of an exhaust_mode
    "background" forward). Returns {"tex_color", "tex_color2",
    "mat_albedo", "background"} (ops/adjoint_plain.split_grads).

    CPU tensors, or plain=True, run adjoint_plain.trace_adjoint_plain.
    stats, when given, gains "launches" and "ray_bounces".

    Pre-condition: mega_tables.mega_supported(tables)."""
    if plain or ro.device.type == "cpu":
        return adjoint_plain.trace_adjoint_plain(
            tables, cfg, ro, rd, pixel, sample_idx, seed, L, gcot,
            depth_bwd, exhaust, stats=stats)
    dev = ro.device
    ms = tables.mega
    kw = mp.trace_options(tables, cfg)
    segs = schedule(cfg.replace(max_depth=int(depth_bwd)))
    b = ro.shape[0]
    bp = _padded_size(b, segs, cfg)
    lanes = torch.cat([mp.fresh_state(ro, rd), L.T.to(torch.float32),
                       gcot.T.to(torch.float32)])
    state, pix, sample = _padded_lanes(lanes, pixel, sample_idx, bp)
    depth = (torch.zeros(bp, dtype=torch.int32, device=dev)
             if stats is not None else None)
    grad = torch.zeros((adjoint_plain.ACC_ROWS, ms.n_slots),
                       dtype=torch.float32, device=dev)

    def run(state, pix, sample, depth, start, seg, n_live, last):
        mega_adjoint_segment(ms.table, state, pix, sample, seed, start, seg,
                             grad, n=n_live, exhaust_bg=exhaust and last,
                             depth=depth, **kw)

    _, depth, _, launches = _segmented(state, pix, sample, depth, segs, cfg,
                                      run)
    record_stats(stats, launches, depth)
    return adjoint_plain.split_grads(grad, ms, kw["grad_bg"])
