"""Differentiable rendering and the inverse-rendering loop
(rt_tpu/diff/inverse.py).

Scene parameters are tensors of `SceneTables`; a parameter set is a dict
of field names, swapped in with `dataclasses.replace` (`apply_params`),
so every step builds new tables and their packed form
(`SceneTables.mega`) is never stale. Every random draw is a pure hash of
its coordinates (ops/rng.py), so sampling is detached: gradients flow
through the radiometric terms only, as in the reference.

Two estimators of this slice:

  "ad"     — autograd through the plain wavefront engine
             (`engine="plain"`, the reference's scan-AD route `_diff_cfg`);
             O(B * depth) memory; the tests' ground truth.
  "replay" — the path-replay backward (diff/replay.py): the forward on
             cfg.engine, the backward on its adjoint kernel (B6 for
             "queue", B5 for "mega"), O(B) memory.

"tape" (B4) and the FD / camera / hybrid estimators are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from rt_tpu_torch.config import RenderConfig, resolve_device
from rt_tpu_torch.render.renderer import render_block
from rt_tpu_torch.scene.types import SceneTables

# Differentiable table fields (the reference's PARAM_FIELDS :42)
PARAM_FIELDS = (
    "mat_albedo", "mat_fuzz", "mat_ior",
    "tex_color", "tex_color2",
    "sph_center", "sph_radius",
    "background",
)


def extract_params(tables: SceneTables,
                   fields: Sequence[str] = PARAM_FIELDS
                   ) -> Dict[str, torch.Tensor]:
    return {f: getattr(tables, f) for f in fields}


def apply_params(tables: SceneTables,
                 params: Dict[str, torch.Tensor]) -> SceneTables:
    """New tables with `params` in place of their fields (and so a new
    packed form, built at first use)."""
    return dataclasses.replace(tables, **params)


def _diff_cfg(cfg: RenderConfig) -> RenderConfig:
    """method="ad" differentiates the plain wavefront engine, whose loop
    autograd records (the reference needs its fixed-trip scan loop)."""
    return cfg.replace(engine="plain", loop="while")


def make_loss_fn(tables: SceneTables, cfg: RenderConfig, spp: int,
                 n_valid: Optional[int] = None):
    """(params, px, py, target, sample_base=0) -> scalar MSE of the
    spp-sample render estimate against target rows [B,3], differentiable
    by autograd. n_valid masks rows >= n_valid out of the mean."""
    cfg = _diff_cfg(cfg)
    seed = int(cfg.seed) & 0xFFFFFFFF

    def loss_fn(params, px, py, target, sample_base=0):
        tbl = apply_params(tables, params)
        acc = render_block(tbl, cfg, px, py, int(sample_base), spp, seed,
                           cfg.width, cfg.height)
        se = (acc / float(spp) - target) ** 2
        if n_valid is None or n_valid == px.shape[0]:
            return torch.mean(se)
        keep = (torch.arange(se.shape[0], device=se.device)
                < n_valid)[:, None]
        return torch.where(keep, se, 0.0).sum() / float(3 * n_valid)

    return loss_fn


def make_train_step(tables: SceneTables, cfg: RenderConfig, spp: int,
                    optimizer: torch.optim.Optimizer,
                    n_valid: Optional[int] = None):
    """step(params, px, py, target, sample_base=0) -> loss (a float):
    one autograd step of make_loss_fn on `optimizer`, whose parameters
    are the tensors of `params`."""
    loss_fn = make_loss_fn(tables, cfg, spp, n_valid)

    def step(params, px, py, target, sample_base=0):
        optimizer.zero_grad()
        loss = loss_fn(params, px, py, target, sample_base)
        loss.backward()
        optimizer.step()
        return float(loss.detach())

    return step


def fit(tables: SceneTables, cfg: RenderConfig, target_image,
        fields: Sequence[str] = ("mat_albedo",), spp: int = 4,
        steps: int = 50, learning_rate: float = 5e-2,
        init_params: Optional[Dict[str, torch.Tensor]] = None,
        method: str = "ad", geom_spec=None,
        bwd_depth: Optional[int] = None, resample: bool = False,
        device="cuda") -> Tuple[Dict[str, np.ndarray], list]:
    """Inverse-rendering loop: recover `fields` of the scene from a target
    mean-radiance image [H,W,3] (row 0 = bottom scanline) with Adam
    (torch.optim.Adam; optax.adam's defaults), on `device` (CUDA unless
    the caller passes "cpu").

    method: "ad" (autograd through the plain engine) or "replay" (the
    path-replay backward on cfg.engine's adjoint kernel, diff/replay.py;
    bwd_depth truncates its replay). resample=True moves the sample
    window every step (SGD over fresh samples); else every step renders
    the same samples.

    Returns (recovered params as NumPy arrays, per-step loss history)."""
    if method == "tape":
        raise NotImplementedError(
            "method='tape': the winner-tape estimator and its capture "
            "kernel are not ported yet (ROADMAP Queue A-1, B4)")
    if method not in ("ad", "replay"):
        raise ValueError(f"method must be 'ad', 'replay' or 'tape'; got "
                         f"{method!r}")
    dev = resolve_device(device)
    tables = tables.to(dev)
    params = (dict(init_params) if init_params is not None
              else extract_params(tables, fields))
    params = {k: torch.as_tensor(v).to(device=dev, dtype=torch.float32)
              .detach().clone().requires_grad_(True)
              for k, v in params.items()}
    optimizer = torch.optim.Adam(list(params.values()), lr=learning_rate)

    n_pix = cfg.width * cfg.height
    pix = torch.arange(n_pix, device=dev)
    px, py = pix % cfg.width, pix // cfg.width
    tgt = torch.as_tensor(np.asarray(target_image, np.float32)).reshape(
        -1, 3).to(dev)

    if method == "replay":
        from rt_tpu_torch.diff.replay import make_replay_loss_fn

        replay_loss = make_replay_loss_fn(tables, cfg, spp, px, py, tgt,
                                          geom_spec=geom_spec,
                                          bwd_depth=bwd_depth)

        def step(s0):
            optimizer.zero_grad()
            loss = replay_loss(params, s0)
            loss.backward()
            optimizer.step()
            return float(loss.detach())
    else:
        if geom_spec:
            raise ValueError("geom_spec belongs to method='replay'")
        train = make_train_step(tables, cfg, spp, optimizer)

        def step(s0):
            return train(params, px, py, tgt, s0)

    history = [step(k * spp if resample else 0) for k in range(steps)]
    return ({k: v.detach().cpu().numpy() for k, v in params.items()},
            history)
