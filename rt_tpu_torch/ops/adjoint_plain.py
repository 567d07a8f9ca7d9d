"""The plain PyTorch version of the adjoint kernels B5 (csrc/mega_adjoint.cu)
and B6 (csrc/queue_adjoint.cu): the radiometric backward of the
path-replay gradient for one sample (the counterpart of
rt_tpu/ops/pallas_mega.py `do_bounce`'s adjoint block :1700-1800 and the
`_adjoint_kernel` epilogue :2255-2285, for spheres with solid and
checker textures, no NEE, sampler "rng", no image atlas).

The replay runs `mega_plain.bounce_plain`, the forward's own bounce, so
C_after, the attenuation and P are the forward's bits, and adds each
bounce's suffix-identity cotangents (rt_tpu/diff/replay.py's module
doc) to the gradient slot of the sphere hit:

  - a scattered, non-dielectric hit: g * (L - C_after) / att, per
    channel, where att != 0;
  - a light: g * P (P: the throughput before the bounce);
  - a miss: g * P to the background, when the sky is the constant
    colour (grad_bg off);
  - with `exhaust`, a lane still alive after the last bounce: g * P to
    the background (the forward credited it the sky).

A checker's odd parity routes the cotangent to the albedo2 rows. The
accumulators are the reference's [8, n_slots] block: rows 0-2 the
primary colour (texture rows, then material rows), rows 3-5 the checker
odd colour, row 6 columns 0-2 the background. `split_grads` cuts it into
the reference's dict. Every lane's cotangent is the kernels'; the sums
are taken by `index_add_` here and by float atomics there, whose order
differs, so kernel and plain agree within float rounding only.
"""

from __future__ import annotations

from typing import Optional

import torch

from rt_tpu_torch.ops import mega_plain as mp

ACC_ROWS = 8
BG_ROW = 6


def split_grads(acc: torch.Tensor, mega, grad_bg: bool) -> dict:
    """The [8, n_slots] accumulators as the reference's gradient dict:
    tex_color, tex_color2 [n_tex, 3], mat_albedo [n_mat, 3],
    background [3] (zero under the gradient sky)."""
    n_tex, n_mat = mega.n_tex, mega.n_mat
    bg = (torch.zeros(3, dtype=acc.dtype, device=acc.device) if grad_bg
          else acc[BG_ROW, 0:3].clone())
    return {"tex_color": acc[0:3, :n_tex].T.contiguous(),
            "tex_color2": acc[3:6, :n_tex].T.contiguous(),
            "mat_albedo": acc[0:3, n_tex:n_tex + n_mat].T.contiguous(),
            "background": bg}


def accumulate(acc, bn: mp.Bounce, L, g, grad_bg: bool) -> None:
    """Add one bounce's cotangents to acc [8, n_slots] in place. L, g:
    [3, B] rows of the lanes that bounced."""
    s_mask = bn.scattered & ~bn.is_die
    c_after = bn.state[mp.C:mp.C + 3]
    cots = []
    for k in range(3):
        att = bn.att[k]
        ok = att != 0.0
        catt = torch.where(s_mask & ok,
                           g[k] * (L[k] - c_after[k])
                           / torch.where(ok, att, 1.0), 0.0)
        cots.append(catt + torch.where(bn.emitter, g[k] * bn.tp[k], 0.0))
    cot = torch.stack(cots)
    lanes = torch.nonzero(s_mask | bn.emitter)[:, 0]
    if lanes.numel():
        slot = bn.slot[lanes]
        sel = cot[:, lanes]
        odd = bn.use2[lanes]
        acc[0:3].index_add_(1, slot, torch.where(odd, 0.0, sel))
        acc[3:6].index_add_(1, slot, torch.where(odd, sel, 0.0))
    if not grad_bg:
        tp = torch.stack(bn.tp)
        acc[BG_ROW, 0:3] += torch.where(bn.missed, g * tp, 0.0).sum(1)


def trace_adjoint_plain(tables, cfg, ro, rd, pixel, sample_idx, seed, L,
                        gcot, depth_bwd: int, exhaust: bool, *,
                        stats: Optional[dict] = None) -> dict:
    """Replay the primary rays ro, rd [B,3] for `depth_bwd` bounces from
    the counter RNG and return the gradient dict of sum(gcot * L) (see
    the module doc). L: the sample's radiance [B,3] from the forward;
    gcot: its cotangent [B,3]. stats, when given, gains "ray_bounces".

    Pre-condition: mega_tables.mega_supported(tables)."""
    ms = tables.mega
    kw = mp.trace_options(tables, cfg)
    dev = ro.device
    state = mp.fresh_state(ro, rd)
    lt, gt = L.T.to(torch.float32), gcot.T.to(torch.float32)
    pix = pixel.to(device=dev, dtype=torch.long).reshape(-1)
    per_lane = isinstance(sample_idx, torch.Tensor) and sample_idx.dim() > 0
    smp = (sample_idx.to(device=dev, dtype=torch.long).reshape(-1)
           if per_lane else int(sample_idx))
    acc = torch.zeros((ACC_ROWS, ms.n_slots), dtype=torch.float32,
                      device=dev)
    bounces = 0
    for b in range(int(depth_bwd)):
        idx = torch.nonzero(state[mp.ALIVE] > 0.0)[:, 0]
        if idx.numel() == 0:
            break
        bn = mp.bounce_plain(ms.table, state[:, idx], pix[idx],
                             smp[idx] if per_lane else smp, b, seed, **kw)
        state[:, idx] = bn.state
        accumulate(acc, bn, lt[:, idx], gt[:, idx], kw["grad_bg"])
        bounces += idx.numel()
    if exhaust and not kw["grad_bg"]:
        live = state[mp.ALIVE] > 0.0
        tp = state[mp.TP:mp.TP + 3]
        acc[BG_ROW, 0:3] += torch.where(live, gt * tp, 0.0).sum(1)
    if stats is not None:
        stats["ray_bounces"] = stats.get("ray_bounces", 0) + bounces
    return split_grads(acc, ms, kw["grad_bg"])
