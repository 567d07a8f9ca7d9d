"""Differentiable rendering and the inverse-rendering loop
(rt_tpu/diff/inverse.py).

Scene parameters are tensors of `SceneTables`; a parameter set is a dict
of field names, swapped in with `dataclasses.replace` (`apply_params`),
so every step builds new tables and their packed form
(`SceneTables.mega`) is never stale. Every random draw is a pure hash of
its coordinates (ops/rng.py), so sampling is detached: gradients flow
through the radiometric terms only, as in the reference.

The estimators of the port:

  "ad"     — autograd through the plain wavefront engine
             (`engine="plain"`, the reference's scan-AD route `_diff_cfg`);
             O(B * depth) memory; the tests' ground truth.
  "replay" — the path-replay backward (diff/replay.py): the forward on
             cfg.engine, the backward on its adjoint kernel (B6 for
             "queue", B5 for "mega"), O(B) memory; geometry, fuzz and IOR
             components by the forward-mode tangent replay (geom_spec).
  "tape"   — the winner tape (diff/tape.py): capture each bounce's
             winner on kernel B4, then autograd through a replay against
             the known winners, every continuous field in one backward.

The FD / camera / hybrid estimators are not ported yet (ROADMAP A-1(d)).
Every entry point raises NotImplementedError for a scene with a rect,
cylinder or triangle (ROADMAP Queue B4(b), B5(b), B6(b)).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from rt_tpu_torch.config import RenderConfig, resolve_device
from rt_tpu_torch.ops.mega_tables import mega_supported, \
    require_spheres_only
from rt_tpu_torch.render.renderer import render_block
from rt_tpu_torch.scene.types import CameraDef, SceneTables

# Differentiable table fields (the reference's PARAM_FIELDS :42); the
# tape also takes "camera" (diff/tape.TAPE_FIELDS)
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


def _trainable(v, dev):
    """A parameter value as a float32 leaf on dev that requires grad; a
    CameraDef (the "camera" parameter) field by field."""
    if isinstance(v, CameraDef):
        return CameraDef(**{f.name: _trainable(getattr(v, f.name), dev)
                            for f in dataclasses.fields(v)})
    return (torch.as_tensor(v).to(device=dev, dtype=torch.float32)
            .detach().clone().requires_grad_(True))


def _to_numpy(v):
    if isinstance(v, CameraDef):
        return CameraDef(**{f.name: _to_numpy(getattr(v, f.name))
                            for f in dataclasses.fields(v)})
    return v.detach().cpu().numpy()


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
    require_spheres_only(tables, "make_loss_fn")
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

    method: "ad" (autograd through the plain engine), "replay" (the
    path-replay backward on cfg.engine's adjoint kernel, diff/replay.py;
    bwd_depth truncates its replay; geom_spec selects geometry / fuzz /
    IOR components for its tangent replay) or "tape" (the winner tape,
    diff/tape.py: make_tape_vg, whose capture is kernel B4 on the card,
    for a megakernel scene, else make_tape_loss_fn; "camera" may then be
    a parameter, a CameraDef). resample=True moves the sample window
    every step (SGD over fresh samples); else every step renders the
    same samples.

    Returns (recovered params as NumPy arrays, a CameraDef of them for
    "camera", and the per-step loss history)."""
    if method not in ("ad", "replay", "tape"):
        raise ValueError(f"method must be 'ad', 'replay' or 'tape'; got "
                         f"{method!r}")
    require_spheres_only(tables, "fit")
    dev = resolve_device(device)
    tables = tables.to(dev)
    params = (dict(init_params) if init_params is not None
              else extract_params(tables, fields))
    params = {k: _trainable(v, dev) for k, v in params.items()}
    from rt_tpu_torch.diff import tape  # tape.py imports this module

    if method == "tape":
        tape.check_fields(params)
    leaves = tape.leaves_of(params)
    optimizer = torch.optim.Adam(leaves, lr=learning_rate)

    n_pix = cfg.width * cfg.height
    pix = torch.arange(n_pix, device=dev)
    px, py = pix % cfg.width, pix // cfg.width
    tgt = torch.as_tensor(np.asarray(target_image, np.float32)).reshape(
        -1, 3).to(dev)

    if method == "tape" and mega_supported(tables):
        # the fast step: one B4 capture, the death-sorted replay
        vg = tape.make_tape_vg(tables, cfg, px, py, tgt, spp=spp)

        def step(s0):
            optimizer.zero_grad()
            loss, grads = vg(params, s0)
            for x, g in zip(leaves, tape.leaves_of(grads)):
                x.grad = g
            optimizer.step()
            return float(loss)
    elif method == "tape":
        tape_loss = tape.make_tape_loss_fn(tables, cfg, spp, px, py, tgt)

        def step(s0):
            optimizer.zero_grad()
            loss = tape_loss(params, s0)
            loss.backward()
            optimizer.step()
            return float(loss.detach())
    elif method == "replay":
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
    return {k: _to_numpy(v) for k, v in params.items()}, history
