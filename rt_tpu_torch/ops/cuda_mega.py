"""The forward megakernel B2: the hand-written CUDA kernel, its plain
PyTorch version, and the segmented trace around them (the counterpart of
rt_tpu/ops/pallas_mega.py `_mega_kernel` :1899, `mega_segment` :2460,
`_compact` :2716 and `mega_trace` :2934, for spheres, rects, cylinders
and triangles with solid, checker and image textures, NEE / MIS / glossy
light sampling, the samplers "rng" and "qmc" (`qmc`), chunk culling
(`cull`, mega_tables.Cull: the sorted tables' chunk boxes, which the
launchers take with the sorted sphere table, scene_for)).

`mega_segment` launches csrc/mega.cu (built by nvcc at first use,
ops/cuda_build.py) for CUDA tensors and raises if it cannot; for CPU
tensors it runs `mega_segment_plain`. `mega_segment.launches` counts
kernel launches, and nothing else.

Contract of one segment (both versions, and the TPU kernel): the ray
state [13, B] (ops/mega_plain.py rows; the first `n` lanes are traced)
against the sphere table and the family tables `fam`
(mega_tables.Families, or None for a scene of spheres only)
advances per lane while `bounce < max_depth` and the lane is alive,
drawing its RNG at (seed, pixel, sample, start_bounce + bounce,
purpose). `exhaust_bg` credits the sky to the lanes still alive at the
end (the final segment of a trace only). `nee` (mega_plain.Nee, or None)
turns on light sampling: the kernel's kNee instantiation, with the
light table and the MIS / glossy flags. `img` (mega_tables.Images, or
None) turns on image textures: the kImages instantiation, with the
atlas and the UV tables. The state is updated in place;
`depth`, when given, gains each lane's number of bounces.

`mega_trace` runs the reference's segment schedule (`compact_every`,
`compact_schedule`) with a stable group permutation between segments
(groups of `compact_group` lanes with any live lane first; with
`compact_sort` "spatial" ordered by direction octant and Morton cell,
group_order), traces only
the live prefix of the next segment (`compact_shrink`), and undoes the
composed permutation once at the end. Per-lane radiance does not depend on the
schedule (the tests hold it bit-equal on the CPU).

`mega_trace_adjoint` is the backward of one sample of the path-replay
gradient on the adjoint megakernel B5 (csrc/mega_adjoint.cu, the
counterpart of `_adjoint_kernel` :2183, `adjoint_segment` :2568 and
`mega_trace_adjoint` :3079): the same segments and group partition,
with each lane's radiance L and cotangent g carried beside its state,
and the gradients of the texture, material and background rows summed
into one [8, n_slots] block, with image textures the atlas's into one
[Ni * TH * TW, 3] buffer. `mega_adjoint_segment.launches` counts its
launches. Its plain version is ops/adjoint_plain.py.

`mega_capture` is the tape capture on kernel B4 (csrc/capture.cu, the
counterpart of `_capture_kernel` :1978, `capture_segment` :2056 and
`mega_capture` :2144): one launch over all lanes, no segments, writing
each bounce's winner code and each lane's death count for the tape
replay (diff/tape.py). `mega_capture.launches` counts its launches. Its
plain version is `mega_plain.capture_plain`.

`mega_trace_regen` renders the whole spp loop of a pixel batch on the
regeneration kernel B7 (csrc/regen.cu, the counterpart of
`_regen_kernel` :2288, `mega_regen` :3226, `regen_schedule` :3316 and
`mega_trace_regen` :3368): a lane whose path ends starts its pixel's
next sample in the same launch. `mega_regen` runs one segment of it and
counts its launches in `mega_regen.launches`; its plain version is
`mega_plain.regen_plain`. Segments follow `regen_schedule`
(cfg.regen_compact), with the group partition of pending lanes between
them and, with cfg.regen_shrink, only the pending prefix traced next;
the radiance sums do not depend on the schedule.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from rt_tpu_torch.ops import adjoint_plain, cuda_build, mega_tables
from rt_tpu_torch.ops import mega_plain as mp
from rt_tpu_torch.ops.mega_tables import (F_COLS, NL_COLS, S_COLS,
                                          SPH_CHUNK, U_COLS, scene_for)

THREADS = 256
# the most table rows the int32 offsets of the kernels address
MAX_ROWS = (1 << 31) // S_COLS - 1
# the adjoints keep their accumulators (6 * n_slots + 3 floats) in each
# block's shared memory up to this size, else in global memory
ACC_SMEM_MAX = 96 * 1024
# rows of the adjoint's lane state: the forward's 13, then L and g
ADJ_ROWS = mp.NSTATE + 6
# the tape code keeps the family in bits 24+ (diff/tape.TAPE_SHIFT), so a
# row must be below 2^24
MAX_CODE_ROWS = 1 << 24


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
# the family tables of every launcher (bounce.cuh RTT_FAMILY_ARGS)
FAMILY_TYPES = [ctypes.c_void_p, ctypes.c_int] * 3
# the light table and NEE flags of the forward launchers (RTT_NEE_ARGS)
NEE_TYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
# the atlas, its height and width and the UV tables (RTT_IMG_ARGS)
IMG_TYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p]
# the sampler flag, the chunk boxes and the SceneTables rows of the
# sorted families (RTT_SORT_ARGS)
SORT_TYPES = [ctypes.c_int] + [ctypes.c_void_p] * 4


def family_args(fam, device):
    """The family tables (mega_tables.Families, or None) as the C
    launchers take them: (pointer or None, rows) for rect, cyl, tri."""
    if fam is None:
        return (None, 0) * 3
    out = []
    for name, tab in zip(("rect", "cyl", "tri"), fam):
        n = tab.shape[0] if tab.dim() == 2 else -1
        cuda_build.check_tensor(name, tab, torch.float32, (n, F_COLS),
                                device)
        if n > MAX_ROWS:
            raise ValueError(f"{name}: {n} rows, want at most {MAX_ROWS}")
        out += [tab.data_ptr() if n else None, n]
    return tuple(out)


def image_args(img, fam, device):
    """The atlas and UV tables (mega_tables.Images, or None) as the C
    launchers take them: (atlas pointer or None, TH, TW, then the rect,
    cylinder and triangle UV tables' pointers, each with as many rows as
    its family table of `fam`)."""
    if img is None:
        return (None, 0, 0, None, None, None)
    atlas = img.atlas
    shape = tuple(atlas.shape) if atlas.dim() == 4 else (-1,)
    cuda_build.check_tensor("atlas", atlas, torch.float32,
                            shape[:3] + (3,), device)
    if atlas.numel() // 3 >= 1 << 31:
        raise ValueError(f"atlas: {atlas.numel() // 3} texels, want fewer "
                         "than 2^31 (the kernels' int32 texel index)")
    out = [atlas.data_ptr(), shape[1], shape[2]]
    rows = [t.shape[0] for t in fam] if fam is not None else [0, 0, 0]
    for name, tab, n in zip(("uv_rect", "uv_cyl", "uv_tri"), img[1:], rows):
        cuda_build.check_tensor(name, tab, torch.float32, (n, U_COLS), device)
        out.append(tab.data_ptr() if n else None)
    return tuple(out)


def sort_args(qmc, cull, tab, fam, device):
    """The sampler flag and the chunk boxes (mega_tables.Cull, or None)
    as the C launchers take them: (qmc, sphere boxes, triangle boxes,
    sphere rows, triangle rows), a pointer None where that family is not
    sorted. The boxes cover the sphere table `tab` and the triangle table
    of `fam` in chunks of SPH_CHUNK rows."""
    if cull is None:
        return (int(bool(qmc)), None, None, None, None)
    cull.check(tab)
    out = [int(bool(qmc))]
    n_rows = (tab.shape[0], fam.tri.shape[0] if fam is not None else 0)
    for name, boxes, n in (("sph", cull.sph, n_rows[0]),
                           ("tri", cull.tri, n_rows[1])):
        k = -(-n // SPH_CHUNK)
        if boxes is not None:
            cuda_build.check_tensor(f"cull.{name}", boxes, torch.float32,
                                    (k, 8), device)
        out.append(None if boxes is None else boxes.data_ptr())
    for name, rows, n in (("sph_rows", cull.sph_rows, n_rows[0]),
                          ("tri_rows", cull.tri_rows, n_rows[1])):
        if rows is not None:
            cuda_build.check_tensor(f"cull.{name}", rows, torch.int32, (n,),
                                    device)
        out.append(None if rows is None else rows.data_ptr())
    return tuple(out)


def nee_args(nee, device):
    """The light table and flags (mega_plain.Nee, or None) as the C
    launchers take them: (pointer or None, n_lights, mis, glossy)."""
    if nee is None:
        return (None, 0, 0, 0)
    lights = nee.lights
    n = lights.shape[0] if lights.dim() == 2 else -1
    cuda_build.check_tensor("lights", lights, torch.float32, (n, NL_COLS),
                            device)
    if n < 1:
        raise ValueError("lights: want at least one light row")
    return (lights.data_ptr(), n, int(bool(nee.mis)), int(bool(nee.glossy)))


@functools.lru_cache(maxsize=None)
def _library(defines: tuple = ()):
    """csrc/mega.cu's library with its C signatures (`defines`: a scratch
    build's, see cuda_build.flags)."""
    lib = cuda_build.load("mega", defines)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.mega_segment_launch.argtypes = [
        vp, ci,                       # table, rows
        *FAMILY_TYPES,                # rect, rows, cyl, rows, tri, rows
        *IMG_TYPES,                   # atlas, th, tw, uv_rect, _cyl, _tri
        vp, ctypes.c_longlong, ci,    # state, stride, n
        vp, vp, ci,                   # pixel, sample (or null), sample
        ci, ci,                       # start_bounce, max_depth
        *SCALAR_TYPES,
        *SORT_TYPES,                  # qmc, boxes, rows (or null)
        *NEE_TYPES,                   # lights, n_lights, mis, glossy
        vp, ci, vp]                   # depth (or null), threads, stream
    lib.mega_segment_launch.restype = ci
    lib.mega_error_string.argtypes = [ci]
    lib.mega_error_string.restype = ctypes.c_char_p
    return lib


def check_threads(threads):
    """The warp-cooperative hit of B2, B4, B5 and B7 wants every lane of
    a warp in every bounce: a block of whole warps."""
    if int(threads) <= 0 or int(threads) % mp.WARP:
        raise ValueError(f"threads = {threads}, want a multiple of "
                         f"{mp.WARP}")


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
                       grad_bg=False, bg, exhaust_bg=False, depth=None,
                       fam=None, nee=None, img=None, qmc=False, cull=None):
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
            t_min=t_min, p_rr=p_rr, grad_bg=grad_bg, bg=bg, fam=fam,
            nee=nee, img=img, qmc=qmc, cull=cull)
        if depth is not None:
            depth[idx] += 1
    if exhaust_bg:
        mp.exhaust(sub, torch.ones(n, dtype=torch.bool, device=sub.device),
                   bg, grad_bg)
    return state


def mega_segment(tab, state, pixel, sample, seed, start_bounce, max_depth,
                 *, n=None, t_min=1e-3, p_rr=0.0, grad_bg=False, bg,
                 exhaust_bg=False, depth=None, fam=None, nee=None, img=None,
                 qmc=False, cull=None, threads=THREADS):
    """One segment (see the module doc): the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    dev = state.device
    if dev.type == "cpu":
        return mega_segment_plain(
            tab, state, pixel, sample, seed, start_bounce, max_depth, n=n,
            t_min=t_min, p_rr=p_rr, grad_bg=grad_bg, bg=bg,
            exhaust_bg=exhaust_bg, depth=depth, fam=fam, nee=nee, img=img,
            qmc=qmc, cull=cull)
    if dev.type != "cuda":
        raise ValueError(f"mega_segment: unsupported device {dev}")
    if state.dim() != 2 or state.shape[0] != mp.NSTATE:
        raise ValueError(f"state: shape {tuple(state.shape)}, want (13, B)")
    stride = state.shape[1]
    n = stride if n is None else int(n)
    cuda_build.check_tensor("state", state, torch.float32,
                            (mp.NSTATE, stride), dev)
    check_table(tab, dev)
    fam_args = family_args(fam, dev)
    img_args = image_args(img, fam, dev)
    light_args = nee_args(nee, dev)
    cull_args = sort_args(qmc, cull, tab, fam, dev)
    if not 0 <= n <= stride:
        raise ValueError(f"n = {n}, want 0..{stride}")
    check_threads(threads)
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
            tab.data_ptr(), tab.shape[0], *fam_args, *img_args,
            state.data_ptr(),
            stride, n,
            pix_ptr, samp_ptr, samp, int(start_bounce), int(max_depth),
            *_scalars(seed, t_min, p_rr, grad_bg, bg, exhaust_bg),
            *cull_args, *light_args, depth_ptr, int(threads), stream)
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


def group_order(state, live, group: int, sort: str = "dead"):
    """The stable order of the groups of `group` lanes of a segmented
    trace (`_compact` :2745-2777): groups with a live lane ([lanes]
    bool) first; with sort "spatial" those ordered by the direction
    octant of their live lanes' mean direction, then by the Morton cell
    (18 bits) of their mean origin in the live groups' bounding box, so
    that a block of lanes holds rays that meet the same chunks."""
    g = live.shape[0] // group
    alive_g = live.view(g, group).any(-1)
    if sort != "spatial":
        return torch.argsort((~alive_g).to(torch.int8), stable=True)
    af = live.to(torch.float32).view(g, group)
    cnt = torch.clamp(af.sum(-1), min=1.0)

    def gmean(x):
        return (x.reshape(g, group) * af).sum(-1) / cnt

    mx, my, mz = (gmean(state[k]) for k in range(3))
    ddx, ddy, ddz = (gmean(state[k]) for k in range(3, 6))
    inf = torch.full((), float("inf"), device=state.device)

    def q(v):
        lo = torch.where(alive_g, v, inf).min()
        hi = torch.where(alive_g, v, -inf).max()
        span = torch.where(hi > lo, hi - lo, torch.ones_like(lo))
        return torch.clamp((v - lo) / span * 255.0, 0.0, 255.0).to(
            torch.int64)

    morton = mega_tables.morton3(q(mx), q(my), q(mz)) >> 6
    octant = ((ddx > 0).to(torch.int64) * 4 + (ddy > 0).to(torch.int64) * 2
              + (ddz > 0).to(torch.int64))
    key = torch.where(alive_g, octant * (1 << 18) + morton, 1 << 24)
    return torch.argsort(key, stable=True)


def _segmented(state, ints, segs, group, shrink, run, pending=None,
               sort: str = "dead"):
    """Run the segments `segs` over the lanes: run(state, ints, start,
    seg, n_live, last) advances lanes [0, n_live) of state in place,
    start being the sum of the earlier segments. ints: per-lane tensors
    that move with their lanes (pixel ids, a per-lane sample, depth, ...;
    an entry that is not a tensor of one value per lane stays as it
    is). Between segments, whole groups of `group` lanes are
    permuted stably by group_order (cfg.compact_sort), groups with a
    pending lane first (pending(state, ints) -> [lanes] bool; by default
    the alive lanes), and with `shrink` only the pending prefix is traced
    next.

    Returns (state, ints, orig_g, launches), state and ints in the last
    partition's lane order: orig_g [groups] is each group's original
    index (None for one segment)."""
    rows, bp = state.shape
    group = max(1, int(group))
    compact = len(segs) > 1
    g = bp // group if compact else 0
    orig_g = torch.arange(g, device=state.device) if compact else None
    ints = list(ints)
    n_live = bp
    done = launches = 0
    for i, seg in enumerate(segs):
        last = i == len(segs) - 1
        run(state, ints, done, seg, n_live, last)
        launches += 1
        done += seg
        if last:
            break
        live = (state[mp.ALIVE] > 0.0 if pending is None
                else pending(state, ints))
        live_groups = int(live.view(g, group).any(-1).sum())
        if live_groups == 0:
            break
        perm = group_order(state, live, group, sort)
        state = state.view(rows, g, group)[:, perm].reshape(rows, bp)
        ints = [x.view(g, group)[perm].reshape(bp)
                if isinstance(x, torch.Tensor) and x.dim() > 0 else x
                for x in ints]
        orig_g = orig_g[perm]
        # trace only the pending prefix (as _segment_shrunk)
        n_live = live_groups * group if shrink else bp
    return state, ints, orig_g, launches


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
    tab = scene_for(tables, cfg).table
    segs = schedule(cfg)
    bp = _padded_size(b, segs, cfg)
    # pad lanes enter dead: they trace nothing and are cut at the end
    state, pix, sample = _padded_lanes(mp.fresh_state(ro, rd), pixel,
                                       sample_idx, bp)
    depth = (torch.zeros(bp, dtype=torch.int32, device=dev)
             if stats is not None else None)
    seg_fn = mega_segment_plain if plain else mega_segment
    kw = mp.trace_options(tables, cfg)
    nee = mp.nee_options(tables, cfg)
    exhaust = cfg.exhaust_mode == "background"

    def run(state, ints, start, seg, n_live, last):
        pix, sample, depth = ints
        seg_fn(tab, state, pix, sample, seed, start, seg, n=n_live,
               exhaust_bg=exhaust and last, depth=depth, nee=nee, **kw)

    state, (_, _, depth), orig_g, launches = _segmented(
        state, (pix, sample, depth), segs, cfg.compact_group,
        cfg.compact_shrink, run, sort=cfg.compact_sort)
    record_stats(stats, launches, depth)
    return _radiance(state, orig_g, b)


def _radiance(state, orig_g, b):
    """The first b lanes' radiance [b, 3] in their original order, from
    a segmented trace's state and group order (_segmented)."""
    rgb = state[mp.C:mp.C + 3]
    if orig_g is not None:
        # undo the composed group permutation once
        inv = torch.argsort(orig_g)
        g = orig_g.shape[0]
        bp = rgb.shape[1]
        rgb = rgb.reshape(3, g, bp // g)[:, inv].reshape(3, bp)
    return rgb[:, :b].T.contiguous()


def mega_adjoint_segment(tab, state, pixel, sample, seed, start_bounce,
                         max_depth, grad, *, n=None, t_min=1e-3, p_rr=0.0,
                         grad_bg=False, bg, exhaust_bg=False, depth=None,
                         fam=None, nee=None, img=None, gimg=None,
                         qmc=False, cull=None, threads=THREADS):
    """One segment of the adjoint megakernel B5 (csrc/mega_adjoint.cu)
    on CUDA tensors: state [19, stride] (the forward's 13 rows, then L
    and g), lanes [0, n) replayed in place; grad [8, n_slots] is added
    to, through per-block accumulators in shared memory when they fit
    (acc_fits_smem); fam, img: the family tables and the images, as
    mega_segment, and with img the atlas gradient gimg [Ni * TH * TW,
    3], added to; nee: the light table (mega_plain.Nee without MIS or
    glossy), or None; qmc, cull: the sampler and the chunk boxes, as
    mega_segment."""
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
    fam_args = family_args(fam, dev)
    img_args = image_args(img, fam, dev)
    gimg_ptr = atlas_grad_ptr(img, gimg, dev)
    if nee is not None and (nee.mis or nee.glossy):
        raise ValueError("mega_adjoint_segment: the adjoint takes NEE "
                         "without mis or nee_glossy")
    light_args = nee_args(nee, dev)[:2]
    cull_args = sort_args(qmc, cull, tab, fam, dev)
    n_slots = grad.shape[1] if grad.dim() == 2 else 0
    cuda_build.check_tensor("grad", grad, torch.float32,
                            (adjoint_plain.ACC_ROWS, n_slots), dev)
    if not 0 <= n <= stride:
        raise ValueError(f"n = {n}, want 0..{stride}")
    check_threads(threads)
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
            tab.data_ptr(), tab.shape[0], *fam_args, *img_args,
            state.data_ptr(), stride, n,
            pix_ptr, samp_ptr, samp, int(start_bounce), int(max_depth),
            *_scalars(seed, t_min, p_rr, grad_bg, bg, exhaust_bg),
            *cull_args, *light_args, grad.data_ptr(), n_slots,
            int(acc_fits_smem(n_slots)), gimg_ptr, depth_ptr, int(threads),
            stream)
    if rc != 0:
        msg = lib.mega_adjoint_error_string(rc).decode()
        raise RuntimeError(f"mega_adjoint_segment launch failed: {msg} "
                           f"({rc})")
    mega_adjoint_segment.launches += 1
    return state


mega_adjoint_segment.launches = 0


def atlas_grad_ptr(img, gimg, device):
    """The atlas gradient's pointer for an adjoint launcher (None without
    image textures), checked against the atlas."""
    if img is None:
        return None
    if gimg is None:
        raise ValueError("gimg: an adjoint with image textures needs the "
                         "atlas gradient")
    cuda_build.check_tensor("gimg", gimg, torch.float32,
                            (img.atlas[..., 0].numel(), 3), device)
    return gimg.data_ptr()


def acc_fits_smem(n_slots: int) -> bool:
    """Whether the adjoints keep their accumulators in shared memory."""
    return (6 * n_slots + 3) * 4 <= ACC_SMEM_MAX


@functools.lru_cache(maxsize=None)
def _adjoint_library(defines: tuple = ()):
    """csrc/mega_adjoint.cu's library (`defines` as _library's)."""
    lib = cuda_build.load("mega_adjoint", defines)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.mega_adjoint_launch.argtypes = [
        vp, ci,                       # table, rows
        *FAMILY_TYPES,                # rect, rows, cyl, rows, tri, rows
        *IMG_TYPES,                   # atlas, th, tw, uv_rect, _cyl, _tri
        vp, ctypes.c_longlong, ci,    # state, stride, n
        vp, vp, ci,                   # pixel, sample (or null), sample
        ci, ci,                       # start_bounce, max_depth
        *SCALAR_TYPES,
        *SORT_TYPES,                  # qmc, boxes, rows (or null)
        vp, ci,                       # lights (or null), n_lights
        vp, ci, ci,                   # grad, n_slots, shared_acc
        vp,                           # gimg (or null)
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
    "mat_albedo", "background", "images"} (ops/adjoint_plain.split_grads).

    CPU tensors, or plain=True, run adjoint_plain.trace_adjoint_plain.
    stats, when given, gains "launches" and "ray_bounces".

    Pre-condition: mega_tables.mega_supported(tables)."""
    if plain or ro.device.type == "cpu":
        return adjoint_plain.trace_adjoint_plain(
            tables, cfg, ro, rd, pixel, sample_idx, seed, L, gcot,
            depth_bwd, exhaust, early_exit=True, stats=stats)
    dev = ro.device
    ms = scene_for(tables, cfg)
    kw = mp.trace_options(tables, cfg)
    nee = mp.nee_options(tables, cfg, adjoint=True)
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
    gimg = adjoint_plain.atlas_grad(ms, dev)

    def run(state, ints, start, seg, n_live, last):
        pix, sample, depth = ints
        mega_adjoint_segment(ms.table, state, pix, sample, seed, start, seg,
                             grad, n=n_live, exhaust_bg=exhaust and last,
                             depth=depth, nee=nee, gimg=gimg, **kw)

    _, (_, _, depth), _, launches = _segmented(
        state, (pix, sample, depth), segs, cfg.compact_group,
        cfg.compact_shrink, run, sort=cfg.compact_sort)
    record_stats(stats, launches, depth)
    return adjoint_plain.split_grads(grad, ms, kw["grad_bg"], gimg)


@functools.lru_cache(maxsize=None)
def _capture_library(defines: tuple = ()):
    """csrc/capture.cu's library (`defines` as _library's)."""
    lib = cuda_build.load("capture", defines)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.capture_launch.argtypes = [
        vp, ci,                       # table, rows
        *FAMILY_TYPES,                # rect, rows, cyl, rows, tri, rows
        vp, ctypes.c_longlong, ci,    # state, stride, n
        vp, ci, ci,                   # pixel, sample, max_depth
        *SCALAR_TYPES,
        *SORT_TYPES,                  # qmc, boxes, rows (or null)
        vp, vp, ci, vp]               # codes, death, threads, stream
    lib.capture_launch.restype = ci
    lib.capture_error_string.argtypes = [ci]
    lib.capture_error_string.restype = ctypes.c_char_p
    return lib


def mega_capture(tables, cfg, ro, rd, pixel, sample_idx, seed, *,
                 plain: bool = False, threads: int = THREADS):
    """Trace the primary rays ro, rd [B,3] for cfg.max_depth bounces and
    return (codes [max_depth, B] int32, death [B] int32): per bounce the
    winner's tape code (`family << 24 | row`, -1 on a miss and after the
    lane's death), per lane the number of bounces after which
    it is still alive (see mega_plain.capture_plain). sample_idx: one
    sample index for every lane (an int, or a tensor whose first element
    is taken, as the reference does).

    CUDA tensors launch kernel B4 (csrc/capture.cu) once and raise if it
    cannot (threads: whole warps, see check_threads); CPU tensors, or
    plain=True, run mega_plain.capture_plain.
    Every family's table must hold fewer than MAX_CODE_ROWS rows, the
    rows a code holds. Pre-condition: mega_tables.mega_supported(tables)."""
    dev = ro.device
    tab = scene_for(tables, cfg).table
    kw = mp.trace_options(tables, cfg)
    kw.pop("img")   # no code or death depends on a texel
    sizes = [tab.shape[0]] + ([t.shape[0] for t in kw["fam"]]
                              if kw["fam"] is not None else [])
    if max(sizes) > MAX_CODE_ROWS:
        raise ValueError(f"mega_capture: table rows {sizes}; a tape code "
                         f"holds rows below {MAX_CODE_ROWS}")
    state = mp.fresh_state(ro.detach(), rd.detach())
    b = state.shape[1]
    max_depth = int(cfg.max_depth)
    sample = int(sample_idx.reshape(-1)[0]) if isinstance(
        sample_idx, torch.Tensor) else int(sample_idx)
    if plain or dev.type == "cpu":
        pix = pixel.to(device=dev, dtype=torch.int64).reshape(-1)
        return mp.capture_plain(tab, state, pix, sample, seed, max_depth,
                                **kw)
    if dev.type != "cuda":
        raise ValueError(f"mega_capture: unsupported device {dev}")
    check_threads(threads)
    check_table(tab, dev)
    fam_args = family_args(kw["fam"], dev)
    cull_args = sort_args(kw["qmc"], kw["cull"], tab, kw["fam"], dev)
    pix = pixel.to(device=dev, dtype=torch.int32).reshape(-1).contiguous()
    pix_ptr, _ = lane_ints("pixel", pix, b, dev)
    codes = torch.empty((max_depth, b), dtype=torch.int32, device=dev)
    death = torch.empty(b, dtype=torch.int32, device=dev)
    if b == 0 or max_depth == 0:
        return codes, death.zero_()
    lib = _capture_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.capture_launch(
            tab.data_ptr(), tab.shape[0], *fam_args, state.data_ptr(), b, b,
            pix_ptr,
            sample, max_depth,
            *_scalars(seed, kw["t_min"], kw["p_rr"], kw["grad_bg"], kw["bg"],
                      False),
            *cull_args, codes.data_ptr(), death.data_ptr(), int(threads),
            stream)
    if rc != 0:
        msg = lib.capture_error_string(rc).decode()
        raise RuntimeError(f"mega_capture launch failed: {msg} ({rc})")
    mega_capture.launches += 1
    return codes, death


mega_capture.launches = 0


@functools.lru_cache(maxsize=None)
def _regen_library(defines: tuple = ()):
    """csrc/regen.cu's library (`defines` as _library's)."""
    lib = cuda_build.load("regen", defines)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.mega_regen_launch.argtypes = [
        vp, ci,                       # table, rows
        *FAMILY_TYPES,                # rect, rows, cyl, rows, tri, rows
        *IMG_TYPES,                   # atlas, th, tw, uv_rect, _cyl, _tri
        vp,                           # camera (19 host floats)
        vp, ctypes.c_longlong, ci,    # state, stride, n
        vp, vp, vp, vp,               # pixel, py, samp, bvec
        ci, ci, ci, ci, ci,           # sample_base, spp, seg_iters,
                                      # max_depth, init
        ci, ci, ci,                   # width, height, defocus
        *SCALAR_TYPES,
        *SORT_TYPES,                  # qmc, boxes, rows (or null)
        vp, ci, vp]                   # depth (or null), threads, stream
    lib.mega_regen_launch.restype = ci
    lib.mega_regen_error_string.argtypes = [ci]
    lib.mega_regen_error_string.restype = ctypes.c_char_p
    return lib


def mega_regen(tab, cam, state, pixel, py, samp, bvec, sample_base, seed,
               seg_iters, *, max_depth, spp, init, width, height, defocus,
               n=None, t_min=1e-3, p_rr=0.0, grad_bg=False, bg,
               exhaust_bg=False, depth=None, fam=None, img=None, qmc=False,
               cull=None, threads=THREADS):
    """One segment of the regeneration kernel B7 (the contract of
    mega_plain.regen_plain): csrc/regen.cu for CUDA tensors, the plain
    version for CPU tensors. state [13, B] f32, pixel, py, samp, bvec
    (and depth) [B] int32; lanes [0, n) advance in place; fam, img, qmc,
    cull: the family tables, the images, the sampler (also of the camera
    rays) and the chunk boxes, as mega_segment. Returns (state, samp,
    bvec)."""
    dev = state.device
    opts = dict(max_depth=max_depth, spp=spp, init=init, width=width,
                height=height, defocus=defocus, n=n, t_min=t_min, p_rr=p_rr,
                grad_bg=grad_bg, bg=bg, exhaust_bg=exhaust_bg, depth=depth,
                fam=fam, img=img, qmc=qmc, cull=cull)
    if dev.type == "cpu":
        return mp.regen_plain(tab, cam, state, pixel, py, samp, bvec,
                              sample_base, seed, seg_iters, **opts)
    if dev.type != "cuda":
        raise ValueError(f"mega_regen: unsupported device {dev}")
    if state.dim() != 2 or state.shape[0] != mp.NSTATE:
        raise ValueError(f"state: shape {tuple(state.shape)}, want (13, B)")
    stride = state.shape[1]
    n = stride if n is None else int(n)
    cuda_build.check_tensor("state", state, torch.float32,
                            (mp.NSTATE, stride), dev)
    check_table(tab, dev)
    fam_args = family_args(fam, dev)
    img_args = image_args(img, fam, dev)
    cull_args = sort_args(qmc, cull, tab, fam, dev)
    if not 0 <= n <= stride:
        raise ValueError(f"n = {n}, want 0..{stride}")
    if len(cam) != 19:
        raise ValueError(f"cam: {len(cam)} floats, want 19")
    check_threads(threads)
    ptrs = []
    for name, x in (("pixel", pixel), ("py", py), ("samp", samp),
                    ("bvec", bvec)):
        ptr, _ = lane_ints(name, x, n, dev)
        if ptr is None:
            raise ValueError(f"{name}: want a per-lane int32 tensor")
        ptrs.append(ptr)
    depth_ptr = None
    if depth is not None:
        depth_ptr, _ = lane_ints("depth", depth, n, dev)
    if n == 0:
        return state, samp, bvec
    lib = _regen_library()
    cam_c = (ctypes.c_float * 19)(*cam)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mega_regen_launch(
            tab.data_ptr(), tab.shape[0], *fam_args, *img_args, cam_c,
            state.data_ptr(),
            stride, n,
            *ptrs, int(sample_base), int(spp), int(seg_iters),
            int(max_depth), int(bool(init)), int(width), int(height),
            int(bool(defocus)),
            *_scalars(seed, t_min, p_rr, grad_bg, bg, exhaust_bg),
            *cull_args, depth_ptr, int(threads), stream)
    if rc != 0:
        msg = lib.mega_regen_error_string(rc).decode()
        raise RuntimeError(f"mega_regen launch failed: {msg} ({rc})")
    mega_regen.launches += 1
    return state, samp, bvec


mega_regen.launches = 0


def regen_schedule(spp: int, max_depth: int, every: int,
                   growth: int = 2):
    """Iteration budgets of the segmented regen loop
    (pallas_mega.regen_schedule :3316). every=0: one segment covering
    the worst case; every=N>0: N-iteration segments; every=-1 (auto):
    a head of 3*spp iterations (5*spp when growth is 4, the shrink
    mode's), then geometric segments. The budgets sum to
    spp*(max_depth+1), a lane's worst case, so the trace completes
    whatever the schedule."""
    total = spp * (max_depth + 1)
    if every == 0 or every >= total:
        return [total]
    if every > 0:
        sched = [every] * (total // every)
        if total % every:
            sched.append(total % every)
        return sched
    head = (5 if growth == 4 else 3) * spp
    sched, left, seg = [], total, head
    while left > 0:
        s = min(seg, left)
        sched.append(s)
        left -= s
        seg = growth * spp if len(sched) == 1 else seg * growth
    return sched


def mega_trace_regen(tables, cfg, pixel, py, seed, spp, sample_base=0,
                     width=None, height=None, *, plain: bool = False,
                     stats: Optional[dict] = None) -> torch.Tensor:
    """The radiance sum [B, 3] over the samples [sample_base, sample_base
    + spp) of the pixels `pixel` (ids py * width + px) in rows `py` ([B]
    integer tensors) of a width x height frame (None: cfg's), traced on
    the regeneration kernel B7 (see the module doc); the camera rays are
    the frame's, as generate_rays makes them at that size. Per pixel it equals the sum of spp per-sample
    mega_trace calls on generate_rays's camera rays, added in sample
    order. plain=True runs the plain version on any device. stats, when
    given, gains "launches" (segments run) and "ray_bounces".

    The reference takes a later segment's shrunken width from the
    previous frame's counts (`_shrink_plans`, with a full-width guard
    segment), as a host read through the TPU's link was dear; here the
    pending groups are counted after every segment, as mega_trace does.

    Pre-condition: mega_tables.mega_supported(tables)."""
    dev = pixel.device
    ms = scene_for(tables, cfg)
    b = pixel.shape[0]
    shrink = bool(cfg.regen_shrink)
    segs = regen_schedule(int(spp), int(cfg.max_depth),
                          int(cfg.regen_compact), growth=4 if shrink else 2)
    group = max(1, int(cfg.compact_group))
    bp = -(-b // group) * group if len(segs) > 1 else b
    end = int(sample_base) + int(spp)
    ints = torch.zeros((4, bp), dtype=torch.int32, device=dev)
    ints[0, :b] = pixel.to(device=dev, dtype=torch.int32)
    ints[1, :b] = py.to(device=dev, dtype=torch.int32)
    # pad lanes enter dead and owe nothing: never traced, cut at the end
    ints[2] = end - 1
    pix, pyv, samp, bvec = ints
    state = torch.zeros((mp.NSTATE, bp), dtype=torch.float32, device=dev)
    depth = (torch.zeros(bp, dtype=torch.int32, device=dev)
             if stats is not None else None)
    seg_fn = mp.regen_plain if plain else mega_regen
    kw = mp.trace_options(tables, cfg)
    opts = dict(max_depth=int(cfg.max_depth), spp=int(spp),
                width=int(cfg.width if width is None else width),
                height=int(cfg.height if height is None else height),
                defocus=bool(cfg.enable_defocus),
                exhaust_bg=cfg.exhaust_mode == "background", **kw)

    def run(state, ints, start, seg, n_live, last):
        pix, pyv, samp, bvec, depth = ints
        first = start == 0  # segment 0 makes the camera rays of the lanes
        seg_fn(ms.table, ms.cam, state, pix, pyv, samp, bvec, sample_base,
               seed, seg, init=first, n=min(n_live, b) if first else n_live,
               depth=depth, **opts)

    def pending(state, ints):
        return (state[mp.ALIVE] > 0.0) | (ints[2] + 1 < end)

    state, (_, _, _, _, depth), orig_g, launches = _segmented(
        state, (pix, pyv, samp, bvec, depth), segs, group, shrink, run,
        pending, sort=cfg.compact_sort)
    record_stats(stats, launches, depth)
    return _radiance(state, orig_g, b)
