"""Winner-tape reverse-mode gradients: record each path's discrete
structure, differentiate the smooth remainder with autograd
(rt_tpu/diff/tape.py).

The path replay (diff/replay.py) gives the radiometric fields their
gradients in closed form, and the geometry only in forward mode, one
tangent direction per component. The tape covers every continuous
parameter in one backward pass, in two steps:

  1. CAPTURE (no gradient): trace each path once and record, per bounce,
     only the closest-hit winner's (family, index) as one int32 code per
     lane and bounce (`ptype << 24 | pid`, -1 on a miss). Every other
     discrete decision (roulette, the Schlick coin, scatter or absorb,
     the unit-ball draw) is a pure hash of the counter RNG's (pixel,
     sample, bounce, purpose) coordinates (ops/rng.py) and needs no
     storage. On CUDA the capture is one launch of kernel B4
     (ops/cuda_mega.mega_capture, csrc/capture.cu); elsewhere the
     wavefront loop records the port's intersect, as the reference does
     off the TPU.
  2. REPLAY (autograd): run the bounce loop again with each hit
     recomputed against the KNOWN winner only (the per-lane leaf tests of
     ops/intersect.py, one per family), so every bounce is an
     O(1)-per-lane closed-form function of the scene tables, and let
     autograd differentiate it: geometry (sphere centres and radii, rect
     planes and bounds, cylinder radii and z windows, triangle vertices),
     materials (albedo, fuzz, IOR), textures, background and the camera
     at once.

Memory is held at O(B * sqrt(depth)) by two-level recomputation:
`torch.utils.checkpoint` around segments of ~sqrt(depth) bounces, and
again around each bounce. The RNG is a hash, so no generator state is
kept (preserve_rng_state=False). `make_tape_vg` is the fast step of
`fit(method="tape")`: one capture launch, then a replay of the lanes
sorted by death, each segment cut to the lanes still alive.

The estimator is method="ad"'s: with the same parameters the taped
winner is the one the full intersect picks, the comparisons autograd
does not differentiate are the decisions the tape froze, and the
interior chains (hit distance, normal, scatter direction, Schlick
blend) are the same. Silhouette terms are not captured.

With cfg.nee the capture runs without light sampling (winner codes and
deaths do not depend on it: NEE draws its own RNG purposes and never
changes a path), and the replay adds each bounce's direct term, under
mis and nee_glossy too, as the wavefront integrator does
(render/integrator.nee_emission, nee_bounce): Le and the light sample's
geometry differentiate, the shadow test is a recomputed any-hit and
carries no gradient (rt_tpu/diff/tape.py:228-337).

Scope: spheres, rects, cylinders and triangles with solid / checker /
image textures, NEE / MIS / glossy, the samplers "rng" and "qmc"
(rng.resolve; the capture's codes name SceneTables rows under chunk
culling too), and every field of
TAPE_FIELDS (the reference's names). The replay's texel gather is
geom.take_rows over the flattened atlas (ops/materials.py), so autograd
scatter-adds the "images" gradient with index_add_; the capture's codes
do not depend on a texel.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from rt_tpu_torch.config import (
    RenderConfig,
    check_supported,
    engine_name,
    nee_on,
)
from rt_tpu_torch.diff.inverse import apply_params, masked_mse
from rt_tpu_torch.ops import cuda_mega, materials, rng
from rt_tpu_torch.ops.camera import generate_rays
from rt_tpu_torch.ops.intersect import (
    PTYPE_CYLINDER,
    PTYPE_RECT,
    PTYPE_SPHERE,
    PTYPE_TRIANGLE,
    _attributes,
    cylinder_leaf_test,
    intersect,
    rect_leaf_test,
    sphere_leaf_test,
    triangle_leaf_test,
)
from rt_tpu_torch.ops.mega_tables import mega_supported
from rt_tpu_torch.render.integrator import (
    background_color,
    initial_prev_diff,
    nee_bounce,
    nee_emission,
)
from rt_tpu_torch.scene.types import CameraDef, SceneTables

TAPE_SHIFT = 24                     # code = ptype << 24 | pid ; -1 = miss
_PID_MASK = (1 << TAPE_SHIFT) - 1
_T_MIN = 1e-3                       # the reference's shadow-acne epsilon

# every continuous scene parameter the tape replay differentiates (the
# reference's tuple); "camera" takes a whole CameraDef
TAPE_FIELDS = (
    "mat_albedo", "mat_fuzz", "mat_ior",
    "tex_color", "tex_color2", "background", "images",
    "sph_center", "sph_radius",
    "rect_k", "rect_lo", "rect_hi",
    "cyl_radius", "cyl_zmin", "cyl_zmax",
    "tri_v1", "tri_v2", "tri_v3",
    "camera",
)

# keep every sample's codes (spp * depth * B int32s, 2 GiB) ahead of the
# replay up to this count; beyond it each sample's replay captures again
# when the backward recomputes it
STORE_TAPE_MAX = 1 << 29


def check_fields(names) -> None:
    """Refuse parameter names the tape does not differentiate."""
    bad = sorted(set(names) - set(TAPE_FIELDS))
    if bad:
        raise ValueError(f"tape gradients cover {TAPE_FIELDS}; got {bad}")


def capture_tape(tables: SceneTables, cfg: RenderConfig, ro, rd, pixel,
                 sample, seed, engine: Optional[str] = None):
    """Trace (ro, rd) [B,3] and record each bounce's closest-hit winner:
    codes [max_depth, B] int32, `ptype << 24 | pid` on a hit, -1 on a
    miss. No gradient flows through it.

    engine: "mega" runs kernel B4 (ops/cuda_mega.mega_capture; its plain
    version on CPU tensors), whose lanes record -1 after their death;
    "plain" ("xla") or "pallas" the wavefront loop over the port's intersect
    (the latter on kernel B1), whose dead lanes record what their stale
    ray hits until every lane is dead. The replay masks both alike.
    None: "mega" on CUDA tensors of a megakernel scene, else "plain",
    as the reference picks its kernel on the TPU and XLA elsewhere."""
    check_supported(cfg)
    if engine is None:
        engine = ("mega" if ro.device.type == "cuda"
                  and mega_supported(tables) else "plain")
    with torch.no_grad():
        if engine == "mega":
            if not mega_supported(tables):
                raise ValueError("capture engine 'mega' needs a megakernel "
                                 "scene")
            # winner codes do not depend on light sampling
            codes, _ = cuda_mega.mega_capture(tables, cfg.replace(nee=False),
                                              ro, rd, pixel, sample, seed)
            return codes
        engine = engine_name(engine)
        if engine not in ("plain", "pallas"):
            raise ValueError(f"capture engine must be 'mega', 'plain' or "
                             f"'pallas'; got {engine!r}")
        smp = rng.resolve(cfg.sampler)
        o, d = ro.detach(), rd.detach()
        b = o.shape[0]
        alive = torch.ones(b, dtype=torch.bool, device=o.device)
        codes = torch.full((cfg.max_depth, b), -1, dtype=torch.int32,
                           device=o.device)
        for i in range(cfg.max_depth):
            if not bool(alive.any()):
                break
            survive = torch.ones_like(alive)
            if cfg.p_rr > 0.0:
                survive = smp.uniform(seed, pixel, sample, i,
                                      rng.RR) <= cfg.p_rr
            hit = intersect(tables, o, d, engine=engine,
                            traversal=cfg.traversal)
            ball = smp.in_unit_ball(seed, pixel, sample, i)
            refl_u = smp.uniform(seed, pixel, sample, i, rng.DIEL_REFL)
            sc, _ = materials.shade(tables, hit.mat, d, hit.normal,
                                    hit.front_face, hit.u, hit.v, hit.p,
                                    ball, refl_u)
            codes[i] = torch.where(
                hit.hit, (hit.ptype << TAPE_SHIFT) | hit.pid, -1).to(
                    torch.int32)
            scattered = alive & survive & hit.hit & sc.ok
            o = torch.where(scattered[:, None], hit.p, o)
            d = torch.where(scattered[:, None], sc.direction, d)
            alive = scattered
        return codes


def _known_t(tables: SceneTables, o, d, ptype, pid):
    """Hit distance against each lane's KNOWN winner: the leaf test of
    its family, selected by ptype (rt_tpu/diff/tape.py:182-204), O(1) per
    lane, differentiable in the primitive. The clamp keeps an
    out-of-family pid inside the family's table before the gather; the
    where then gives that lane neither a value nor a gradient."""
    t = torch.full(o.shape[:1], math.inf, dtype=o.dtype, device=o.device)
    for pt, leaf, n in zip(
            (PTYPE_SPHERE, PTYPE_RECT, PTYPE_CYLINDER, PTYPE_TRIANGLE),
            (sphere_leaf_test, rect_leaf_test, cylinder_leaf_test,
             triangle_leaf_test), tables.counts):
        if n:
            pc = torch.clamp(pid, 0, n - 1)
            t = torch.where(ptype == pt, leaf(tables, pc, o, d, _T_MIN), t)
    return t


def _attributes_for_tape(tables: SceneTables, o, d, code):
    """The differentiable hit record against the taped winner `code` [B],
    shared by the tape replay and the tangent replay of diff/replay.py
    (geom_tape). The isfinite guard leaves a lane whose leaf test
    disagrees with the capture in the last bits (a grazing hit, the t_min
    edge: the capture's expanded quadratic against the leaf's `oc` form)
    dead instead of carrying an infinite hit point."""
    hit_mask = code >= 0
    ptype = torch.where(hit_mask, code >> TAPE_SHIFT, 0).to(torch.int32)
    pid = torch.where(hit_mask, code & _PID_MASK, 0).to(torch.int32)
    t = _known_t(tables, o, d, ptype, pid)
    valid = hit_mask & torch.isfinite(t)
    t = torch.where(valid, t, 1.0)
    return _attributes(tables, o, d, valid, t, ptype, pid,
                       torch.where(valid, pid, -1))


def _tape_bounce(tables: SceneTables, cfg: RenderConfig, st, code, pixel,
                 sample, seed, bounce, rr_comp):
    """One differentiable bounce against the taped winner: the
    integrator's _bounce (render/integrator.py) with the full intersect
    replaced by the known-winner recompute. st = (o, d, throughput, rgb,
    alive, prev_diff); prev_diff is NEE's carry (integrator
    initial_prev_diff), unused without light sampling."""
    o, d, tp, rgb, alive, prev_diff = st
    nee = nee_on(cfg, tables)
    smp = rng.resolve(cfg.sampler)
    survive = torch.ones_like(alive)
    if cfg.p_rr > 0.0:
        survive = smp.uniform(seed, pixel, sample, bounce, rng.RR) <= cfg.p_rr

    hit_mask = code >= 0
    hit = _attributes_for_tape(tables, o, d, code)
    ball = smp.in_unit_ball(seed, pixel, sample, bounce)
    refl_u = smp.uniform(seed, pixel, sample, bounce, rng.DIEL_REFL)
    sc, em = materials.shade(tables, hit.mat, d, hit.normal, hit.front_face,
                             hit.u, hit.v, hit.p, ball, refl_u)
    bg = background_color(tables, cfg, d)

    live = alive & survive
    scattered = live & hit.hit & sc.ok
    emitter = live & hit.hit & ~sc.ok
    missed = live & ~hit_mask
    if nee:
        em = nee_emission(tables, cfg, hit, o, em, prev_diff)
    contrib = (torch.where((scattered | emitter)[:, None], em, 0.0)
               + torch.where(missed[:, None], bg, 0.0))
    rgb = rgb + tp * contrib
    if nee:
        ld, prev_diff = nee_bounce(tables, cfg, hit, sc, d, scattered, pixel,
                                   sample, seed, bounce)
        rgb = rgb + tp * ld
    tp = torch.where(scattered[:, None], tp * sc.attenuation * rr_comp, tp)
    o = torch.where(scattered[:, None], hit.p, o)
    d = torch.where(scattered[:, None], sc.direction, d)
    return o, d, tp, rgb, scattered, prev_diff


def _rr_comp(cfg: RenderConfig) -> float:
    return 1.0 / cfg.p_rr if cfg.p_rr > 0.0 else 1.0


def _fresh(cfg, ro, rd):
    b = ro.shape[0]
    return (ro, rd,
            torch.ones((b, 3), dtype=torch.float32, device=ro.device),
            torch.zeros((b, 3), dtype=torch.float32, device=ro.device),
            torch.ones((b,), dtype=torch.bool, device=ro.device),
            initial_prev_diff(cfg, b, ro.device))


def _ckpt(fn, *args):
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _exhaust(tables, cfg, st):
    """The radiance, with the sky credited to lanes alive at the end when
    cfg.exhaust_mode is "background"."""
    o, d, tp, rgb, alive, _ = st
    if cfg.exhaust_mode == "background":
        bg = background_color(tables, cfg, d)
        rgb = rgb + torch.where(alive[:, None], tp * bg, 0.0)
    return rgb


def replay_tape(tables: SceneTables, cfg: RenderConfig, ro, rd, codes,
                pixel, sample, seed, segment: Optional[int] = None):
    """Differentiable radiance [B,3] of the taped paths.

    Two-level recomputation: the bounces run in segments of `segment`
    (default ~sqrt(depth)) bounces, each segment under a checkpoint that
    keeps only its entry state, and each bounce under a checkpoint
    again, so the backward holds O(B * (depth/segment + segment)) ray
    states instead of every bounce's shading intermediates."""
    depth = codes.shape[0]
    if segment is None:
        segment = max(1, int(round(depth ** 0.5)))
    segment = min(segment, depth)
    rr_comp = _rr_comp(cfg)

    def one_bounce(i, *st):
        return _tape_bounce(tables, cfg, st, codes[i], pixel, sample, seed,
                            i, rr_comp)

    def seg_body(start, *st):
        for i in range(start, start + segment):
            st = _ckpt(one_bounce, i, *st)
        return st

    st = _fresh(cfg, ro, rd)
    n_full = depth // segment
    for k in range(n_full):
        st = _ckpt(seg_body, k * segment, *st)
    for i in range(n_full * segment, depth):
        st = _ckpt(one_bounce, i, *st)
    return _exhaust(tables, cfg, st)


def _pixels(cfg, px, py, device):
    px = torch.as_tensor(px).to(device=device, dtype=torch.int64)
    py = torch.as_tensor(py).to(device=device, dtype=torch.int64)
    return px, py, py * cfg.width + px


def make_tape_render(tables: SceneTables, cfg: RenderConfig, spp: int,
                     px, py, tape_engine: Optional[str] = None,
                     segment: Optional[int] = None):
    """img_fn(params, sample_base=0) -> mean taped-replay radiance [B,3]
    of the pixel batch (px, py) over spp samples, differentiable by
    autograd in every ported TAPE_FIELDS entry of params (a dict of
    tensors; "camera" a CameraDef of tensors).

    Every sample's codes are captured before the replays when they fit
    (spp * depth * B <= STORE_TAPE_MAX int32s): they carry no gradient,
    so keeping them costs no autograd state and spares the backward a
    second capture. Beyond that each sample's capture and replay run
    under one checkpoint, and the backward captures again."""
    check_supported(cfg)
    dev = tables.sph_center.device
    px, py, pixel = _pixels(cfg, px, py, dev)
    seed = int(cfg.seed) & 0xFFFFFFFF
    b = px.shape[0]
    spp = int(spp)
    store_tape = spp * cfg.max_depth * b <= STORE_TAPE_MAX

    def img_fn(params: Dict, sample_base=0):
        check_fields(params)
        tbl = apply_params(tables, params)
        s0 = int(sample_base)

        def rays(s):
            return generate_rays(tbl.camera, cfg.width, cfg.height, px, py,
                                 s, seed, cfg.enable_defocus, cfg.sampler)

        def capture(s):
            with torch.no_grad():
                ro, rd = rays(s)
            return capture_tape(tbl, cfg, ro, rd, pixel, s, seed,
                                engine=tape_engine)

        def replay(s, codes):
            ro, rd = rays(s)
            return replay_tape(tbl, cfg, ro, rd, codes, pixel, s, seed,
                               segment=segment)

        acc = torch.zeros((b, 3), dtype=torch.float32, device=dev)
        if store_tape:
            codes_all = [capture(s0 + i) for i in range(spp)]
            for i in range(spp):
                acc = acc + replay(s0 + i, codes_all[i])
        else:
            for i in range(spp):
                acc = acc + _ckpt(lambda s: replay(s, capture(s)), s0 + i)
        return acc / float(spp)

    return img_fn


def make_tape_loss_fn(tables: SceneTables, cfg: RenderConfig, spp: int,
                      px, py, target, tape_engine: Optional[str] = None,
                      segment: Optional[int] = None,
                      n_valid: Optional[int] = None, row_offset: int = 0):
    """(params, sample_base=0) -> scalar MSE against target rows [B,3];
    its backward gives reverse-mode gradients of every parameter in
    params in one pass. n_valid masks rows whose global index
    (row_offset + the row) is >= n_valid out of the mean and divides by
    3 * n_valid (inverse.masked_mse)."""
    img_fn = make_tape_render(tables, cfg, spp, px, py,
                              tape_engine=tape_engine, segment=segment)
    dev = tables.sph_center.device
    target = torch.as_tensor(target).to(device=dev, dtype=torch.float32)

    def loss_fn(params, sample_base=0):
        se = (img_fn(params, sample_base) - target) ** 2
        return masked_mse(se, n_valid, row_offset)

    return loss_fn


def _flatten(params: Dict):
    """[(name, field or None, tensor)] for every tensor of params; a
    CameraDef contributes its fields."""
    out = []
    for k, v in params.items():
        if isinstance(v, CameraDef):
            out += [(k, f.name, getattr(v, f.name))
                    for f in dataclasses.fields(v)]
        else:
            out.append((k, None, v))
    return out


def _unflatten(flat, values) -> Dict:
    out, cams = {}, {}
    for (k, f, _), v in zip(flat, values):
        if f is None:
            out[k] = v
        else:
            cams.setdefault(k, {})[f] = v
    for k, fields in cams.items():
        out[k] = CameraDef(**fields)
    return out


def make_tape_vg(tables: SceneTables, cfg: RenderConfig, px, py, target,
                 schedule=(1, 1, 2, 4, 8, 16), min_width: int = 1 << 16,
                 spp: int = 1, n_valid: Optional[int] = None,
                 row_offset: int = 0):
    """The fast all-parameters step of fit(method="tape"):
    step(params, sample_base=0) -> (loss, grads), the spp-sample tape
    estimate of the MSE against target rows [B,3] and its gradient for
    every parameter of params (grads has params' keys and shapes).

      1. CAPTURE: one launch of kernel B4 per sample
         (ops/cuda_mega.mega_capture; its plain version on the CPU)
         gives every bounce's code and every lane's death count.
      2. REPLAY: the lanes are sorted by death, most bounces first
         (stable), so the lanes alive at any bounce are a prefix whose
         length the host reads from the death counts once per step. The
         replay then runs in segments of `schedule` bounces (the rest of
         the depth appended), each on the smallest power-of-two width
         (at least min_width) that covers its live prefix; the dead
         suffix is carried frozen and joined back by torch.cat. A lane
         sorts by the most bounces over the samples, plus one bounce of
         slack for a lane whose replay outlives the kernel's alive chain
         by an ulp-flipped decision (its next code is -1, so it dies in
         that bounce). The loss compares against the target in the same
         order, so nothing is unsorted inside the differentiated path.
         Each bounce runs under a checkpoint.

    Work drops from B * depth lane-bounces to about B times the mean
    path length. n_valid and row_offset mask the rows of a rank's slab
    by their global index, as inverse.masked_mse does. Pre-condition:
    mega_supported(tables)."""
    if not mega_supported(tables):
        raise ValueError("make_tape_vg: the capture kernel needs a "
                         "megakernel scene (mega_supported)")
    check_supported(cfg)
    dev = tables.sph_center.device
    px, py, pixel = _pixels(cfg, px, py, dev)
    seed = int(cfg.seed) & 0xFFFFFFFF
    b = int(px.shape[0])
    spp = int(spp)
    target = torch.as_tensor(target).to(device=dev, dtype=torch.float32)
    depth = int(cfg.max_depth)
    rr_comp = _rr_comp(cfg)

    sched, left = [], depth
    for s in schedule:
        if left <= 0:
            break
        s = min(int(s), left)
        sched.append(s)
        left -= s
    if left:
        sched.append(left)
    starts = np.cumsum([0] + sched[:-1]).tolist()

    def rays(tbl, pxs, pys, s):
        return generate_rays(tbl.camera, cfg.width, cfg.height, pxs, pys, s,
                             seed, cfg.enable_defocus, cfg.sampler)

    def capture(tbl, s0):
        with torch.no_grad():
            codes, deaths = [], []
            for i in range(spp):
                ro, rd = rays(tbl, px, py, s0 + i)
                c, dth = cuda_mega.mega_capture(tbl, cfg.replace(nee=False),
                                                ro, rd, pixel, s0 + i, seed)
                codes.append(c)
                deaths.append(dth)
            death = torch.stack(deaths).amax(0)
            d_eff = torch.clamp(death + 1, max=depth - 1)
            order = torch.argsort(-d_eff, stable=True)
            cnt = torch.stack([(d_eff >= s).sum() for s in starts[1:]]
                              ).tolist() if len(starts) > 1 else []
        return codes, order, cnt

    def bucket(n):
        if n <= min_width:
            return min(min_width, b)
        return min(b, 1 << int(math.ceil(math.log2(n))))

    def replay_sorted(tbl, codes_s, order, pid_s, s, widths):
        """One sample's sorted, shrinking replay -> radiance [B,3] in
        sorted order."""
        ro, rd = rays(tbl, pid_s % cfg.width, pid_s // cfg.width, s)
        st = _fresh(cfg, ro, rd)
        done = 0
        for k, seg in enumerate(sched):
            w = b if k == 0 else widths[k - 1]
            sub = tuple(x[:w] for x in st)
            codes_seg = codes_s[done:done + seg][:, order[:w]]
            pix_w = pid_s[:w]

            def one_bounce(i, *st_, _codes=codes_seg, _pix=pix_w,
                           _done=done):
                return _tape_bounce(tbl, cfg, st_, _codes[i - _done], _pix,
                                    s, seed, i, rr_comp)

            for i in range(done, done + seg):
                sub = _ckpt(one_bounce, i, *sub)
            st = tuple(torch.cat([n_, x[w:]]) if w < b else n_
                       for n_, x in zip(sub, st))
            done += seg
        return _exhaust(tbl, cfg, st)

    def step(params: Dict, sample_base=0, times: Optional[dict] = None):
        """(loss, grads). times, when given, gains the seconds of the
        capture, the replay's forward and its backward ("capture_s",
        "forward_s", "backward_s"), each phase closed by a device
        synchronize, and the replay widths ("widths")."""
        check_fields(params)
        s0 = int(sample_base)
        flat = _flatten(params)
        leaves = [v.detach().requires_grad_(True) for _, _, v in flat]
        p = _unflatten(flat, leaves)
        clock = _Clock(times, dev)
        with torch.enable_grad():
            tbl = apply_params(tables, p)
            codes, order, cnt = capture(tbl, s0)
            widths = tuple(bucket(n) for n in cnt)
            clock.lap("capture_s")
            pid_s = pixel[order]
            acc = None
            for i in range(spp):
                img = replay_sorted(tbl, codes[i], order, pid_s, s0 + i,
                                    widths)
                acc = img if acc is None else acc + img
            loss = masked_mse((acc / float(spp) - target[order]) ** 2,
                              n_valid, row_offset, rows=order)
            clock.lap("forward_s")
            # parameters no path reads (an atlas no primitive samples)
            # get zero gradients, as the reference's
            grads = (torch.autograd.grad(loss, leaves, allow_unused=True)
                     if loss.requires_grad else [None] * len(leaves))
            clock.lap("backward_s")
        if times is not None:
            times["widths"] = (b,) + widths
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(leaves, grads)]
        return loss.detach(), _unflatten(flat, grads)

    step.schedule = tuple(sched)
    return step


class _Clock:
    """Seconds between laps, each closed by a device synchronize; does
    nothing when times is None."""

    def __init__(self, times: Optional[dict], device):
        self.times, self.device = times, device
        self.t = time.perf_counter() if times is not None else 0.0

    def lap(self, name: str) -> None:
        if self.times is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.times[name] = self.times.get(name, 0.0) + now - self.t
        self.t = now


def leaves_of(params: Dict):
    """Every tensor of a parameter dict, a CameraDef's fields included
    (what an optimizer of these parameters steps)."""
    return [v for _, _, v in _flatten(params)]

