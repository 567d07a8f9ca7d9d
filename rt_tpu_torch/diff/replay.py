"""Path-replay backward: O(B)-memory gradients of the radiometric
parameters through a `torch.autograd.Function` (rt_tpu/diff/replay.py).

The forward renders with any engine and keeps nothing but each sample's
radiance L. The backward replays each path bounce by bounce from the
counter RNG (every draw is a pure hash of its coordinates, so the
replay consumes the forward's streams) and accumulates the suffix
identity of the reference's module doc: with the prefix throughput P_b
and the colour C_b accumulated through bounce b,

    dL/datt_b = (L - C_b) / att_b      (per channel, where att_b != 0)
    dL/demission_b = dL/dbackground_b = P_{b-1}.

The replay runs on the adjoint kernel of `bwd_engine`, by default the
forward's engine: "queue" on B6 (ops/cuda_queue.queue_trace_adjoint),
"mega" on B5 (ops/cuda_mega.mega_trace_adjoint), as the reference
chooses (:563-564); "plain" ("xla") and "pallas", a CPU tensor, or
bwd_kernel=False on the plain adjoint (ops/adjoint_plain.py), where the
reference replays on its per-bounce intersector. All of them replay
with the megakernels' bounce (ops/mega_plain.py), whose bits are the
queue and mega forwards' own. bwd_early_exit stops the plain adjoint's
and the tangent replay's loops once no lane is alive; without it (the
reference's default) they run depth_bwd bounces, the dead lanes adding
nothing, so the gradients are the same bits.

Parameters that act through the hit geometry or the scattered direction
(GEOM_FIELDS: sphere centres and radii, metal fuzz, dielectric IOR) have
no such identity. For the components a caller selects (`geom_spec`), a
forward-mode TANGENT replay re-simulates each path and pushes K one-hot
parameter directions through every bounce with `torch.func.jvp`, mapped
over the K directions by `torch.func.vmap` (the primal runs once). The
bounce's hit is recomputed against the winner taped by the capture
kernel B4 (diff/tape.py, geom_tape=True: O(1) per lane), or by the full
plain intersect (geom_tape=False). The discrete decisions are
comparisons, so they carry no tangent: sampling stays detached.

With cfg.nee (on a scene with lights) both replays reproduce the
forward's light sampling term for term (rt_tpu/diff/replay.py:195-330,
:449-478): the direct term is one more per-bounce contribution, whose
Le and albedo factors the adjoints credit (ops/adjoint_plain.py) with
the geometry inside it detached, and whose geometry the tangent replay
differentiates; the shadow factor is a bool and carries nothing. The
suffix identity covers the single-technique lambertian estimator only,
so mis or nee_glossy raise ValueError, as the reference's replay does
(their gradients ride the tape or "ad").

Scope: REPLAY_FIELDS (tex_color, tex_color2, mat_albedo, background,
images) and GEOM_FIELDS by geom_spec, spheres, rects, cylinders and
triangles with solid / checker / image textures, NEE, the samplers
"rng" and "qmc" (rng.resolve), chunk culling on the kernels. A
family row's cotangents land in its gradient slot (its texture row, or
its material's), so a rect light's emission trains its tex_color row.
A texel-sampled hit's, and an image-textured light's, land in the
texel of the atlas ("images"): texture recovery from renders, where
only the texels some path reads receive a gradient. The adjoint
kernels add them with one atomic per texel-sampled hit into a global
[Ni, TH, TW, 3] buffer, at any atlas size (the reference's TPU kernel
keeps per-tile planes and sends large atlases off the kernel,
`adjoint_atlas_ok`).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence

import torch

from rt_tpu_torch.config import (
    ENGINES,
    RenderConfig,
    check_supported,
    engine_name,
    nee_on,
)
from rt_tpu_torch.diff.inverse import apply_params, masked_mse
from rt_tpu_torch.diff.tape import _attributes_for_tape, capture_tape
from rt_tpu_torch.ops import adjoint_plain, cuda_mega, cuda_queue
from rt_tpu_torch.ops import materials, rng
from rt_tpu_torch.ops.camera import generate_rays
from rt_tpu_torch.ops.intersect import intersect
from rt_tpu_torch.ops.mega_tables import mega_supported
from rt_tpu_torch.render.integrator import (
    background_color,
    nee_bounce,
    nee_emission,
    trace,
)
from rt_tpu_torch.scene.types import SceneTables

REPLAY_FIELDS = ("mat_albedo", "tex_color", "tex_color2", "background",
                 "images")
GEOM_FIELDS = ("sph_center", "sph_radius", "mat_fuzz", "mat_ior")
# the fields the suffix identity differentiates (all of the reference's)
PORTED_FIELDS = REPLAY_FIELDS

# store per-sample radiance up to this many floats (spp * B * 3); beyond
# it the backward recomputes L per sample (the reference's _STORE_L_MAX)
STORE_L_MAX = 1 << 28


def _adjoint(cfg: RenderConfig, bwd_engine: Optional[str],
             bwd_kernel: Optional[bool], early_exit: bool):
    """The replay of one sample on bwd_engine's adjoint (None: cfg's
    engine; see the module doc)."""
    if bwd_engine is not None and bwd_engine not in ENGINES:
        raise ValueError(f"unknown bwd_engine {bwd_engine!r} (want "
                         f"{ENGINES})")
    engine = engine_name(cfg.engine if bwd_engine is None else bwd_engine)
    plain = functools.partial(adjoint_plain.trace_adjoint_plain,
                              early_exit=early_exit)
    if bwd_kernel is False:
        return plain
    if engine == "queue":
        return cuda_queue.queue_trace_adjoint
    if engine == "mega":
        return cuda_mega.mega_trace_adjoint
    if bwd_kernel:
        raise ValueError(f"bwd_kernel=True: engine {engine!r} has no "
                         "adjoint kernel (want 'queue' or 'mega')")
    return plain


class ReplayRender:
    """img_fn(params, sample_base=0) -> mean radiance [B,3] of the pixel
    batch (px, py) over spp samples, differentiable in params by path
    replay. See make_replay_render."""

    def __init__(self, tables: SceneTables, cfg: RenderConfig, spp: int,
                 px, py, bwd_engine: Optional[str] = None, geom_spec=None,
                 bwd_depth: Optional[int] = None,
                 bwd_early_exit: bool = False,
                 bwd_kernel: Optional[bool] = None,
                 geom_tape: Optional[bool] = None):
        check_supported(cfg)
        self.nee = nee_on(cfg, tables)
        if self.nee and (cfg.mis or cfg.nee_glossy):
            raise ValueError(
                "cfg.mis / nee_glossy: the path-replay suffix identity "
                "reproduces the single-technique lambertian NEE term; MIS "
                "and glossy gradients ride the tape estimator (fit "
                "--method tape) or autograd (method 'ad')")
        self.base = tables
        self.cfg = cfg
        self.spp = int(spp)
        dev = tables.sph_center.device
        self.px = torch.as_tensor(px).to(device=dev, dtype=torch.int64)
        self.py = torch.as_tensor(py).to(device=dev, dtype=torch.int64)
        self.pixel = self.py * cfg.width + self.px
        self.seed = int(cfg.seed) & 0xFFFFFFFF
        self.depth_bwd = (min(int(bwd_depth), cfg.max_depth) if bwd_depth
                          else cfg.max_depth)
        # the exhaust credit is right only when the replay reaches the
        # forward's depth
        self.exhaust_bwd = (cfg.exhaust_mode == "background"
                            and self.depth_bwd == cfg.max_depth)
        self.early_exit = bool(bwd_early_exit)
        self.adjoint = _adjoint(cfg, bwd_engine, bwd_kernel,
                                self.early_exit)
        self.store_L = self.spp * self.px.shape[0] * 3 <= STORE_L_MAX
        self.geom_spec = dict(geom_spec or {})
        self.geom_flat = _geom_components(tables, self.geom_spec)
        self.geom_tape = (dev.type == "cuda" and mega_supported(tables)
                          if geom_tape is None else bool(geom_tape))

    def rays(self, tbl, sample):
        return generate_rays(tbl.camera, self.cfg.width, self.cfg.height,
                             self.px, self.py, sample, self.seed,
                             self.cfg.enable_defocus, self.cfg.sampler)

    def radiance(self, tbl, sample):
        ro, rd = self.rays(tbl, sample)
        return trace(tbl, self.cfg, ro, rd, self.pixel, sample, self.seed)

    def forward(self, tbl, s0: int):
        """(mean radiance [B,3], the per-sample radiances or None)."""
        acc = torch.zeros((self.px.shape[0], 3), dtype=torch.float32,
                          device=self.px.device)
        Ls = [] if self.store_L else None
        for i in range(self.spp):
            L = self.radiance(tbl, s0 + i)
            acc = acc + L
            if Ls is not None:
                Ls.append(L)
        return acc / float(self.spp), Ls

    def backward(self, tbl, s0: int, Ls, g) -> Dict[str, torch.Tensor]:
        gs = (g / float(self.spp)).to(torch.float32).contiguous()
        grads = None
        for i in range(self.spp):
            s = s0 + i
            L = Ls[i] if Ls is not None else self.radiance(tbl, s)
            ro, rd = self.rays(tbl, s)
            gk = self.adjoint(tbl, self.cfg, ro, rd, self.pixel, s,
                              self.seed, L, gs, self.depth_bwd,
                              self.exhaust_bwd)
            grads = gk if grads is None else {
                k: grads[k] + gk[k] for k in grads}
        return grads

    def geom_backward(self, params, s0: int, g):
        """d(g . img)/d(direction k) [K] for each geom_spec component,
        summed over the samples by the tangent replay."""
        gs = (g / float(self.spp)).to(torch.float32)
        dirs = torch.zeros(len(self.geom_flat), dtype=torch.float32,
                           device=gs.device)
        for i in range(self.spp):
            tC = self.tangents(params, s0 + i)
            dirs = dirs + torch.einsum("bc,kbc->k", gs, tC)
        return dirs

    def tangents(self, params: Dict[str, torch.Tensor], sample: int):
        """The radiance tangents [K, B, 3] of one sample's lanes along the
        K geom_spec directions, at the parameters `params` (a dict that
        holds every geom_spec field): the tangent replay of the module
        doc. It runs depth_bwd bounces, or with bwd_early_exit stops
        when no lane is alive, the bounces after that changing
        nothing."""
        cfg, base = self.cfg, self.base
        params = {k: v.detach() for k, v in params.items()}
        tbl = apply_params(base, params)
        k = len(self.geom_flat)
        tans = {f: torch.zeros((k,) + tuple(v.shape), dtype=torch.float32,
                               device=v.device) for f, v in params.items()}
        for j, (f, idx) in enumerate(self.geom_flat):
            tans[f][(j,) + idx] = 1.0
        s = int(sample)
        pixel, seed = self.pixel, self.seed
        smp = rng.resolve(cfg.sampler)
        ro, rd = self.rays(tbl, s)
        if self.geom_tape:
            codes = capture_tape(tbl, cfg, ro, rd, pixel, s, seed)
        rr_comp = 1.0 / cfg.p_rr if cfg.p_rr > 0.0 else 1.0
        b = ro.shape[0]
        o, d = ro, rd
        P = torch.ones((b, 3), dtype=torch.float32, device=ro.device)
        C = torch.zeros_like(P)
        alive = torch.ones(b, dtype=torch.bool, device=ro.device)
        # NEE's carry: the previous bounce sampled a light
        pd = torch.zeros(b, dtype=torch.bool, device=ro.device)
        tcfg = cfg.replace(engine="plain")
        to, td, tP, tC = (torch.zeros((k, b, 3), dtype=torch.float32,
                                      device=ro.device) for _ in range(4))
        for i in range(self.depth_bwd):
            if self.early_exit and not bool(alive.any()):
                break
            survive = torch.ones_like(alive)
            if cfg.p_rr > 0.0:
                survive = smp.uniform(seed, pixel, s, i, rng.RR) <= cfg.p_rr
            live = alive & survive
            ball = smp.in_unit_ball(seed, pixel, s, i)
            refl_u = smp.uniform(seed, pixel, s, i, rng.DIEL_REFL)
            code = codes[i] if self.geom_tape else None

            def f(o, d, P, C, pp, code=code, live=live, ball=ball,
                  refl_u=refl_u, pd=pd, i=i):
                t2 = apply_params(base, pp)
                hit = (_attributes_for_tape(t2, o, d, code) if code is not None
                       else intersect(t2, o, d, engine="plain",
                                      traversal=cfg.traversal))
                sc, em = materials.shade(t2, hit.mat, d, hit.normal,
                                         hit.front_face, hit.u, hit.v,
                                         hit.p, ball, refl_u)
                bg = background_color(t2, cfg, d)
                scattered = live & hit.hit & sc.ok
                emitter = live & hit.hit & ~sc.ok
                missed = live & ~hit.hit
                lam = scattered
                if self.nee:
                    em = nee_emission(t2, tcfg, hit, o, em, pd)
                contrib = (torch.where((scattered | emitter)[:, None], em,
                                       0.0)
                           + torch.where(missed[:, None], bg, 0.0))
                if self.nee:
                    # the direct term with its geometry attached; the
                    # shadow test carries no tangent
                    ld, lam = nee_bounce(t2, tcfg, hit, sc, d, scattered,
                                         pixel, s, seed, i)
                    contrib = contrib + ld
                C2 = C + P * contrib
                P2 = torch.where(scattered[:, None],
                                 P * sc.attenuation * rr_comp, P)
                o2 = torch.where(scattered[:, None], hit.p, o)
                d2 = torch.where(scattered[:, None], sc.direction, d)
                return (o2, d2, P2, C2, scattered.to(torch.float32),
                        lam.to(torch.float32))

            (o, d, P, C, sc_f, lam_f), (to, td, tP, tC, _, _) = _push(
                f, (o, d, P, C, params), (to, td, tP, tC, tans))
            alive = sc_f > 0.5
            pd = lam_f > 0.5
        if self.exhaust_bwd:
            def f2(d, P, C, pp):
                bg = background_color(apply_params(base, pp), cfg, d)
                return C + torch.where(alive[:, None], P * bg, 0.0)

            _, tC = _push(f2, (d, P, C, params), (td, tP, tC, tans))
        return tC

    def __call__(self, params: Dict[str, torch.Tensor], sample_base=0):
        for k in params:
            _check_field(k, self.geom_spec)
        missing = set(self.geom_spec) - set(params)
        if missing:
            raise ValueError(f"geom_spec fields {sorted(missing)} are not "
                             "in params")
        names = tuple(params)
        return _Replay.apply(self, names, int(sample_base),
                             *(params[k] for k in names))


class _Replay(torch.autograd.Function):
    """Forward on cfg.engine; backward on the matching adjoint."""

    @staticmethod
    def forward(ctx, plan, names, s0, *values):
        tbl = apply_params(plan.base, {k: v.detach() for k, v in
                                       zip(names, values)})
        img, Ls = plan.forward(tbl, s0)
        ctx.plan, ctx.names, ctx.s0, ctx.tbl, ctx.Ls = plan, names, s0, tbl, Ls
        return img

    @staticmethod
    def backward(ctx, g):
        plan, tbl = ctx.plan, ctx.tbl
        grads = {}
        if set(ctx.names) & set(PORTED_FIELDS):
            grads = plan.backward(tbl, ctx.s0, ctx.Ls, g)
        ctx.Ls = None
        dev = tbl.sph_center.device
        if set(ctx.names) & set(GEOM_FIELDS):
            params = {k: getattr(tbl, k) for k in ctx.names}
            for k in ctx.names:
                if k in GEOM_FIELDS:
                    grads[k] = torch.zeros_like(params[k])
            if plan.geom_flat:
                dirs = plan.geom_backward(params, ctx.s0, g)
                for j, (f, idx) in enumerate(plan.geom_flat):
                    grads[f][idx] += dirs[j]
        return (None, None, None, *(
            grads[k].to(dev).reshape(getattr(tbl, k).shape)
            for k in ctx.names))


def _push(f, primals, tangents):
    """(f(*primals), the tangents of its outputs along each of the K
    directions stacked in `tangents`): forward mode through f, mapped
    over the leading axis of the tangents; the primal runs once."""
    def jvp(*tans):
        return torch.func.jvp(f, primals, tans)

    return torch.func.vmap(jvp, out_dims=(None, 0))(*tangents)


def _geom_components(tables: SceneTables, geom_spec) -> list:
    """geom_spec {field: [component index tuple, ...]} as a flat list of
    (field, index) in sorted field order, each checked against its
    table's shape (an index out of range would drop its gradient)."""
    bad = set(geom_spec) - set(GEOM_FIELDS)
    if bad:
        raise ValueError(f"geom_spec fields must be in {GEOM_FIELDS}; got "
                         f"{sorted(bad)}")
    flat = [(f, tuple(int(i) for i in idx))
            for f, idxs in sorted(geom_spec.items()) for idx in idxs]
    for f, idx in flat:
        shape = tuple(getattr(tables, f).shape)
        if len(idx) != len(shape) or any(
                not 0 <= i < n for i, n in zip(idx, shape)):
            raise ValueError(f"geom_spec component {f}{idx} out of bounds "
                             f"for table shape {shape}")
    return flat


def _check_field(name: str, geom_spec: Dict) -> None:
    if name in PORTED_FIELDS or name in geom_spec:
        return
    raise ValueError(
        f"replay gradients cover {PORTED_FIELDS} plus geom_spec fields "
        f"{sorted(geom_spec)} of {GEOM_FIELDS}; got {name!r} (pass "
        "geom_spec, or use the tape or ad methods)")


def make_replay_render(tables: SceneTables, cfg: RenderConfig, spp: int,
                       px, py, bwd_engine: Optional[str] = None,
                       geom_spec: Optional[Dict[str, Sequence[tuple]]]
                       = None,
                       bwd_depth: Optional[int] = None,
                       bwd_early_exit: bool = False,
                       bwd_kernel: Optional[bool] = None,
                       geom_tape: Optional[bool] = None) -> ReplayRender:
    """Build img_fn(params, sample_base=0) -> mean radiance [B,3] with a
    path-replay backward (see the module doc). params: a dict of
    PORTED_FIELDS tensors, and of the geom_spec fields, of the tables'
    shapes. px, py: the fixed pixel batch. The parameters come in the
    reference's order (rt_tpu/diff/replay.py:94-105).

    bwd_engine names the adjoint of the radiometric backward: None that
    of cfg.engine, "queue" B6, "mega" B5, "plain" / "xla" / "pallas" the
    plain adjoint; another name raises ValueError. bwd_depth truncates
    the replays (not the forward) at that bounce; the exhaust credit
    then is skipped. bwd_early_exit stops the plain adjoint's and the
    tangent replay's loops once no lane is alive (the gradients do not
    change). bwd_kernel: None runs the adjoint kernel of bwd_engine
    ("queue", "mega"), False the plain adjoint.

    geom_spec {field: [component index tuple, ...]} selects GEOM_FIELDS
    components for the tangent replay, e.g. {"sph_radius": [(0,)]};
    the other components of those fields get zero gradient. geom_tape:
    recompute each tangent bounce's hit against the winner taped by
    diff/tape.capture_tape (kernel B4 on CUDA) rather than the full
    plain intersect; None means True on CUDA for a megakernel scene,
    False elsewhere, as the reference's backend rule. With cfg.nee on a
    scene with lights, mis or nee_glossy raise ValueError (the module
    doc)."""
    return ReplayRender(tables, cfg, spp, px, py, bwd_engine=bwd_engine,
                        geom_spec=geom_spec, bwd_depth=bwd_depth,
                        bwd_early_exit=bwd_early_exit,
                        bwd_kernel=bwd_kernel, geom_tape=geom_tape)


def make_replay_loss_fn(tables: SceneTables, cfg: RenderConfig, spp: int,
                        px, py, target, bwd_engine: Optional[str] = None,
                        geom_spec: Optional[Dict[str, Sequence[tuple]]]
                        = None,
                        bwd_depth: Optional[int] = None,
                        n_valid: Optional[int] = None,
                        bwd_early_exit: bool = False,
                        bwd_kernel: Optional[bool] = None,
                        geom_tape: Optional[bool] = None, *,
                        row_offset: int = 0):
    """(params, sample_base=0) -> scalar MSE against target rows [B,3],
    with the replay backward underneath (see make_replay_render; the
    parameters in the reference's order, rt_tpu/diff/replay.py:619-628,
    then the port's own). n_valid masks rows whose global index
    (row_offset + the row) is >= n_valid out of the mean and divides by
    3 * n_valid (inverse.masked_mse: a rank's slab of a padded frame)."""
    img_fn = make_replay_render(tables, cfg, spp, px, py, bwd_engine,
                                geom_spec, bwd_depth, bwd_early_exit,
                                bwd_kernel, geom_tape)
    dev = tables.sph_center.device
    target = torch.as_tensor(target).to(device=dev, dtype=torch.float32)

    def loss_fn(params, sample_base=0):
        se = (img_fn(params, sample_base) - target) ** 2
        return masked_mse(se, n_valid, row_offset)

    return loss_fn
