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

The replay runs on the adjoint kernel of the forward's engine:
`engine="queue"` on B6 (ops/cuda_queue.queue_trace_adjoint), "mega" on
B5 (ops/cuda_mega.mega_trace_adjoint), as the reference chooses
(:563-564); "plain" and "pallas", a CPU tensor, or bwd_kernel=False on
the plain adjoint (ops/adjoint_plain.py). All of them replay with the
megakernels' bounce (ops/mega_plain.py), whose bits are the queue and
mega forwards' own.

Scope of this slice: REPLAY_FIELDS but "images" (tex_color, tex_color2,
mat_albedo, background), spheres with solid / checker textures, no NEE,
sampler "rng". The forward-mode tangent replay of GEOM_FIELDS
(geom_spec) and the image atlas raise NotImplementedError.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from rt_tpu_torch.config import RenderConfig, check_supported
from rt_tpu_torch.diff.inverse import apply_params
from rt_tpu_torch.ops import adjoint_plain, cuda_mega, cuda_queue
from rt_tpu_torch.ops.camera import generate_rays
from rt_tpu_torch.render.integrator import trace
from rt_tpu_torch.scene.types import SceneTables

REPLAY_FIELDS = ("mat_albedo", "tex_color", "tex_color2", "background",
                 "images")
GEOM_FIELDS = ("sph_center", "sph_radius", "mat_fuzz", "mat_ior")
# the fields this slice differentiates
PORTED_FIELDS = REPLAY_FIELDS[:4]

# store per-sample radiance up to this many floats (spp * B * 3); beyond
# it the backward recomputes L per sample (the reference's _STORE_L_MAX)
STORE_L_MAX = 1 << 28


def _adjoint(cfg: RenderConfig, bwd_kernel: Optional[bool]):
    """The replay of one sample for cfg's engine (see the module doc)."""
    if bwd_kernel is False:
        return adjoint_plain.trace_adjoint_plain
    if cfg.engine == "queue":
        return cuda_queue.queue_trace_adjoint
    if cfg.engine == "mega":
        return cuda_mega.mega_trace_adjoint
    if bwd_kernel:
        raise ValueError(f"bwd_kernel=True: engine {cfg.engine!r} has no "
                         "adjoint kernel (want 'queue' or 'mega')")
    return adjoint_plain.trace_adjoint_plain


class ReplayRender:
    """img_fn(params, sample_base=0) -> mean radiance [B,3] of the pixel
    batch (px, py) over spp samples, differentiable in params by path
    replay. See make_replay_render."""

    def __init__(self, tables: SceneTables, cfg: RenderConfig, spp: int,
                 px, py, bwd_depth: Optional[int] = None,
                 bwd_kernel: Optional[bool] = None):
        check_supported(cfg)
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
        self.adjoint = _adjoint(cfg, bwd_kernel)
        self.store_L = self.spp * self.px.shape[0] * 3 <= STORE_L_MAX

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

    def __call__(self, params: Dict[str, torch.Tensor], sample_base=0):
        for k in params:
            _check_field(k)
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
        grads = ctx.plan.backward(ctx.tbl, ctx.s0, ctx.Ls, g)
        ctx.Ls = None
        return (None, None, None, *(
            grads[k].to(ctx.tbl.sph_center.device).reshape(
                getattr(ctx.tbl, k).shape) for k in ctx.names))


def _check_field(name: str) -> None:
    if name in PORTED_FIELDS:
        return
    if name == "images":
        raise NotImplementedError(
            "replay gradients of 'images': image textures and the adjoint "
            "atlas are not ported yet (ROADMAP Queue A-4, B2(c))")
    if name in GEOM_FIELDS:
        raise NotImplementedError(
            f"replay gradients of {name!r}: the tangent replay (geom_spec) "
            "is not ported yet (ROADMAP Queue A-1)")
    raise ValueError(f"replay gradients cover {PORTED_FIELDS}; got "
                     f"{name!r}")


def make_replay_render(tables: SceneTables, cfg: RenderConfig, spp: int,
                       px, py, geom_spec=None,
                       bwd_depth: Optional[int] = None,
                       bwd_kernel: Optional[bool] = None) -> ReplayRender:
    """Build img_fn(params, sample_base=0) -> mean radiance [B,3] with a
    path-replay backward (see the module doc). params: a dict of
    PORTED_FIELDS tensors of the tables' shapes. px, py: the fixed pixel
    batch. bwd_depth truncates the replay (not the forward) at that
    bounce; the exhaust credit then is skipped. bwd_kernel: None runs
    the adjoint kernel of cfg.engine ("queue", "mega"), False the plain
    adjoint."""
    if geom_spec:
        raise NotImplementedError(
            "geom_spec: the forward-mode tangent replay is not ported yet "
            "(ROADMAP Queue A-1)")
    if cfg.nee or cfg.mis or cfg.nee_glossy:
        raise NotImplementedError(
            "replay gradients with nee / mis / nee_glossy: NEE is not "
            "ported yet (ROADMAP Queue A-5)")
    return ReplayRender(tables, cfg, spp, px, py, bwd_depth=bwd_depth,
                        bwd_kernel=bwd_kernel)


def make_replay_loss_fn(tables: SceneTables, cfg: RenderConfig, spp: int,
                        px, py, target, geom_spec=None,
                        bwd_depth: Optional[int] = None,
                        n_valid: Optional[int] = None,
                        bwd_kernel: Optional[bool] = None):
    """(params, sample_base=0) -> scalar MSE against target rows [B,3],
    with the replay backward underneath. n_valid masks rows >= n_valid
    out of the mean."""
    img_fn = make_replay_render(tables, cfg, spp, px, py,
                                geom_spec=geom_spec, bwd_depth=bwd_depth,
                                bwd_kernel=bwd_kernel)
    dev = tables.sph_center.device
    target = torch.as_tensor(target).to(device=dev, dtype=torch.float32)
    n_rows = img_fn.px.shape[0]
    if n_valid is not None and n_valid == n_rows:
        n_valid = None

    def loss_fn(params, sample_base=0):
        se = (img_fn(params, sample_base) - target) ** 2
        if n_valid is None:
            return torch.mean(se)
        keep = (torch.arange(n_rows, device=dev) < n_valid)[:, None]
        return torch.where(keep, se, 0.0).sum() / float(3 * n_valid)

    return loss_fn
