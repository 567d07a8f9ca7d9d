"""The plain PyTorch version of the adjoint kernels B5 (csrc/mega_adjoint.cu)
and B6 (csrc/queue_adjoint.cu): the radiometric backward of the
path-replay gradient for one sample (the counterpart of
rt_tpu/ops/pallas_mega.py `do_bounce`'s adjoint block :1700-1800 and the
`_adjoint_kernel` epilogue :2255-2285, for spheres, rects, cylinders
and triangles with solid, checker and image textures, NEE without MIS
or glossy, the samplers "rng" and "qmc", chunk culling).

The replay runs `mega_plain.bounce_plain`, the forward's own bounce, so
C_after, the attenuation and P are the forward's bits, and adds each
bounce's suffix-identity cotangents (rt_tpu/diff/replay.py's module
doc) to the gradient slot of the primitive hit (`mega_plain.
winner_attrs`: a sphere row's column 17, a family row's column 31, so a
rect light's emission lands in its texture row):

  - a scattered, non-dielectric hit: g * (L - C_after) / att, per
    channel, where att != 0;
  - a light: g * P * w (P: the throughput before the bounce; w the
    emission's weight, 0 under NEE after a light-sampled bounce);
  - under NEE, a light-sampling bounce's direct term tp * alb * Le * okl
    (pallas_mega.py:1725-1760): g * tp * Le * okl to the winner's slot
    (with the attenuation's cotangent, so a checker's parity routes it),
    and g * tp * alb * okl to the sampled light's slot, routed by the
    light's own checker parity at the sample point;
  - a miss: g * P to the background, when the sky is the constant
    colour (grad_bg off);
  - with `exhaust`, a lane still alive after the last bounce: g * P to
    the background (the forward credited it the sky).

A checker's odd parity routes the cotangent to the albedo2 rows. A
texel-sampled winner's cotangent goes to its texel of the image atlas
and not to its slot, and so does an image-textured light's
(pallas_mega.py:1741-1790): the atlas gradient [Ni*TH*TW, 3] beside
the accumulators. The accumulators are the reference's [8, n_slots]
block: rows 0-2 the primary colour (texture rows, then material rows),
rows 3-5 the checker odd colour, row 6 columns 0-2 the background.
`split_grads` cuts it, with the atlas gradient, into the reference's
dict. Every lane's cotangent is the kernels'; the sums
are taken by `index_add_` here and by float atomics there, whose order
differs, so kernel and plain agree within float rounding only.
"""

from __future__ import annotations

from typing import Optional

import torch

from rt_tpu_torch.ops import mega_plain as mp
from rt_tpu_torch.ops.mega_tables import scene_for

ACC_ROWS = 8
BG_ROW = 6


def split_grads(acc: torch.Tensor, mega, grad_bg: bool,
                gimg: Optional[torch.Tensor] = None) -> dict:
    """The [8, n_slots] accumulators and the atlas gradient gimg (the
    flattened atlas's [Ni*TH*TW, 3], or None for a scene without image
    textures) as the reference's gradient dict: tex_color, tex_color2
    [n_tex, 3], mat_albedo [n_mat, 3], background [3] (zero under the
    gradient sky), images [Ni, TH, TW, 3] (zero without image
    textures)."""
    n_tex, n_mat = mega.n_tex, mega.n_mat
    bg = (torch.zeros(3, dtype=acc.dtype, device=acc.device) if grad_bg
          else acc[BG_ROW, 0:3].clone())
    images = (gimg.reshape(mega.atlas_shape) if gimg is not None else
              torch.zeros(mega.atlas_shape, dtype=acc.dtype,
                          device=acc.device))
    return {"tex_color": acc[0:3, :n_tex].T.contiguous(),
            "tex_color2": acc[3:6, :n_tex].T.contiguous(),
            "mat_albedo": acc[0:3, n_tex:n_tex + n_mat].T.contiguous(),
            "background": bg, "images": images}


def atlas_grad(mega, device) -> Optional[torch.Tensor]:
    """A zero atlas gradient [Ni*TH*TW, 3] for a scene with image
    textures, else None."""
    if mega.img is None:
        return None
    return torch.zeros((mega.img.atlas[..., 0].numel(), 3),
                       dtype=torch.float32, device=device)


def _credit(acc, slot, odd, cot, gimg=None, texel=None) -> None:
    """Add the cotangents cot [3, n] to the gradient slots slot [n]: the
    primary colour's rows, or where odd the checker odd colour's; a lane
    whose texel [n] is not -1 adds its cotangent to that row of the
    atlas gradient gimg instead."""
    if texel is not None:
        on = texel >= 0
        gimg.index_add_(0, texel[on], cot[:, on].T)
        slot, odd, cot = slot[~on], odd[~on], cot[:, ~on]
    acc[0:3].index_add_(1, slot, torch.where(odd, 0.0, cot))
    acc[3:6].index_add_(1, slot, torch.where(odd, cot, 0.0))


def accumulate(acc, bn: mp.Bounce, L, g, grad_bg: bool,
               gimg: Optional[torch.Tensor] = None) -> None:
    """Add one bounce's cotangents to acc [8, n_slots] and, with image
    textures, to the atlas gradient gimg, in place. L, g: [3, B] rows of
    the lanes that bounced."""
    s_mask = bn.scattered & ~bn.is_die
    c_after = bn.state[mp.C:mp.C + 3]
    cots = []
    for k in range(3):
        att = bn.att[k]
        ok = att != 0.0
        catt = torch.where(s_mask & ok,
                           g[k] * (L[k] - c_after[k])
                           / torch.where(ok, att, 1.0), 0.0)
        gp = g[k] * bn.tp[k]
        if bn.em_scale is not None:
            gp = gp * bn.em_scale
        cot = catt + torch.where(bn.emitter, gp, 0.0)
        if bn.okl is not None:   # the direct term's Le factor
            cot = cot + g[k] * bn.tp[k] * bn.le[k] * bn.okl
        cots.append(cot)
    cot = torch.stack(cots)
    lanes = torch.nonzero(s_mask | bn.emitter)[:, 0]
    if lanes.numel():
        _credit(acc, bn.slot[lanes], bn.use2[lanes], cot[:, lanes], gimg,
                None if bn.texel is None else bn.texel[lanes])
    if bn.okl is not None:
        # the direct term's emission factor, to the light's slot; a
        # light-sampling (lambertian) lane's attenuation is its albedo
        lanes = torch.nonzero(bn.okl != 0.0)[:, 0]
        if lanes.numel():
            lcot = torch.stack([g[k] * bn.tp[k] * bn.att[k] * bn.okl
                                for k in range(3)])
            _credit(acc, bn.lslot[lanes], bn.lodd[lanes], lcot[:, lanes],
                    gimg, None if bn.ltexel is None else bn.ltexel[lanes])
    if not grad_bg:
        tp = torch.stack(bn.tp)
        acc[BG_ROW, 0:3] += torch.where(bn.missed, g * tp, 0.0).sum(1)


def trace_adjoint_plain(tables, cfg, ro, rd, pixel, sample_idx, seed, L,
                        gcot, depth_bwd: int, exhaust: bool, *,
                        early_exit: bool = False,
                        stats: Optional[dict] = None) -> dict:
    """Replay the primary rays ro, rd [B,3] for `depth_bwd` bounces from
    the counter RNG and return the gradient dict of sum(gcot * L) (see
    the module doc). L: the sample's radiance [B,3] from the forward;
    gcot: its cotangent [B,3]. Each bounce replays the lanes alive
    before it; early_exit ends the loop once none is (the later bounces,
    over no lane, credit nothing), as the kernels B5 and B6 end. stats, when given, gains "bounces"
    (the loop's bounces) and "ray_bounces".

    Pre-condition: mega_tables.mega_supported(tables)."""
    ms = scene_for(tables, cfg)
    kw = mp.trace_options(tables, cfg)
    nee = mp.nee_options(tables, cfg, adjoint=True)
    dev = ro.device
    state = mp.fresh_state(ro, rd)
    lt, gt = L.T.to(torch.float32), gcot.T.to(torch.float32)
    pix = pixel.to(device=dev, dtype=torch.long).reshape(-1)
    per_lane = isinstance(sample_idx, torch.Tensor) and sample_idx.dim() > 0
    smp = (sample_idx.to(device=dev, dtype=torch.long).reshape(-1)
           if per_lane else int(sample_idx))
    acc = torch.zeros((ACC_ROWS, ms.n_slots), dtype=torch.float32,
                      device=dev)
    gimg = atlas_grad(ms, dev)
    bounces = loops = 0
    for b in range(int(depth_bwd)):
        idx = torch.nonzero(state[mp.ALIVE] > 0.0)[:, 0]
        if early_exit and idx.numel() == 0:
            break
        loops += 1
        bn = mp.bounce_plain(ms.table, state[:, idx], pix[idx],
                             smp[idx] if per_lane else smp, b, seed,
                             nee=nee, **kw)
        state[:, idx] = bn.state
        accumulate(acc, bn, lt[:, idx], gt[:, idx], kw["grad_bg"], gimg)
        bounces += idx.numel()
    if exhaust and not kw["grad_bg"]:
        live = state[mp.ALIVE] > 0.0
        tp = state[mp.TP:mp.TP + 3]
        acc[BG_ROW, 0:3] += torch.where(live, gt * tp, 0.0).sum(1)
    if stats is not None:
        stats["bounces"] = stats.get("bounces", 0) + loops
        stats["ray_bounces"] = stats.get("ray_bounces", 0) + bounces
    return split_grads(acc, ms, kw["grad_bg"], gimg)
