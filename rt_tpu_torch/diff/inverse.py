"""Differentiable rendering and the inverse-rendering loop
(rt_tpu/diff/inverse.py).

Scene parameters are tensors of `SceneTables`; a parameter set is a dict
of field names, swapped in with `dataclasses.replace` (`apply_params`),
so every step builds new tables and their packed form
(`SceneTables.mega`, `mega_culled`) is never stale. Every random draw is
a pure hash of its coordinates (ops/rng.py, or ops/qmc.py under
cfg.sampler "qmc"), so sampling is detached: gradients flow
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

Beside `fit`, the common-random-numbers finite-difference estimators
(the reference's :348-700): `fit_fd` (geometry components by central
differences), `fit_camera` (the camera pose, through `make_camera`) and
`fit_hybrid` (the path replay for the radiometric fields, central
differences for geometry components, in one Adam loop). Every sample is
a pure hash of its (pixel, sample, bounce) coordinates, so the +eps and
-eps probes trace identical random streams and the Monte-Carlo noise
cancels in their difference. The 2K probes of a step are K pairs of
forward renders on cfg.engine (a Python loop; the reference batches them
under one lax.map); the differences and the Adam update stay on the
device, and a step reads back one scalar, its loss.

Every estimator takes scenes of spheres, rects, cylinders and triangles
with solid / checker / image textures ("images", the atlas, is a field
of "ad", "replay" and "tape": texture recovery), and cfg.nee (light
sampling in the forward and in every gradient; mis / nee_glossy with
"ad", "tape" and the finite differences, while the path replay refuses
them with ValueError, as the reference's does).

With a mesh (parallel/mesh.py), `fit` and `fit_hybrid` train data
parallel over the ranks of the process group, as the reference's
shard the pixel batch over every device: the frame's pixel list is
padded as parallel/sharded._padded_pixel_list pads it (target rows
padded with row 0), each rank takes its slab, masks its rows by their
global index (< H*W) and divides by the whole frame's 3*H*W
(`masked_mse`), so the ranks' losses and gradients sum to the
single-process ones. Each step sums every gradient and the loss (and
fit_hybrid's probe losses, before they are differenced) over the ranks
in one all_reduce, then takes the Adam step: the parameters stay equal
on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from rt_tpu_torch.config import RenderConfig, resolve_device
from rt_tpu_torch.ops.camera import make_camera
from rt_tpu_torch.ops.mega_tables import mega_supported
from rt_tpu_torch.parallel.mesh import Mesh
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
    """method="ad" differentiates the plain wavefront engine under the
    caller's loop: autograd records either, and a dead lane adds nothing
    to the gradient (the reference forces its fixed-trip scan loop, as
    lax.while_loop has no transpose)."""
    return cfg.replace(engine="plain")


def masked_mse(se: torch.Tensor, n_valid: Optional[int] = None,
               row_offset: int = 0, rows: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """The MSE of squared errors se [B,3] over the rows whose global
    index is below n_valid, divided by 3 * n_valid. A row's global index
    is row_offset + its index in se, or row_offset + rows[i] where the
    rows come in another order (rows: their indices in the caller's
    batch). A rank's slab of a padded frame passes its offset and the
    frame's pixel count, so the ranks' losses sum to the frame's MSE.
    n_valid None (or every row valid at offset 0) is the plain mean."""
    n = se.shape[0]
    if n_valid is None or (row_offset == 0 and rows is None
                           and n_valid == n):
        return torch.mean(se)
    idx = torch.arange(n, device=se.device) if rows is None else rows
    keep = (idx + row_offset < n_valid)[:, None]
    return torch.where(keep, se, 0.0).sum() / float(3 * n_valid)


def make_loss_fn(tables: SceneTables, cfg: RenderConfig, spp: int,
                 n_valid: Optional[int] = None, row_offset: int = 0):
    """(params, px, py, target, sample_base=0) -> scalar MSE of the
    spp-sample render estimate against target rows [B,3], differentiable
    by autograd. n_valid masks rows whose global index (row_offset + the
    row) is >= n_valid out of the mean and divides by 3 * n_valid
    (masked_mse)."""
    cfg = _diff_cfg(cfg)
    seed = int(cfg.seed) & 0xFFFFFFFF

    def loss_fn(params, px, py, target, sample_base=0):
        tbl = apply_params(tables, params)
        acc = render_block(tbl, cfg, px, py, int(sample_base), spp, seed,
                           cfg.width, cfg.height)
        se = (acc / float(spp) - target) ** 2
        return masked_mse(se, n_valid, row_offset)

    return loss_fn


def _reduce_grads(mesh: Optional[Mesh], leaves, loss: torch.Tensor,
                  extra: Sequence[torch.Tensor] = ()):
    """Sum every leaf's .grad, the loss and `extra` over the mesh's
    ranks in one collective; a leaf whose grad is None on every rank
    keeps None. Returns (loss, extra) summed; without a mesh, as they
    are."""
    if mesh is None or mesh.group is None:
        return loss, list(extra)
    has = torch.tensor([x.grad is not None for x in leaves],
                       dtype=torch.float32, device=loss.device)
    grads = [torch.zeros_like(x) if x.grad is None else x.grad
             for x in leaves]
    out = mesh.all_reduce_sum(grads + [has, loss.detach()] + list(extra))
    n = len(leaves)
    for x, g, h in zip(leaves, out[:n], out[n].tolist()):
        x.grad = g if h > 0 else None
    return out[n + 1], out[n + 2:]


def make_train_step(tables: SceneTables, cfg: RenderConfig, spp: int,
                    optimizer: torch.optim.Optimizer,
                    mesh: Optional[Mesh] = None,
                    n_valid: Optional[int] = None, row_offset: int = 0):
    """step(params, px, py, target, sample_base=0) -> loss (a float):
    one autograd step of make_loss_fn on `optimizer`, whose parameters
    are the tensors of `params`. With a mesh, (px, py, target) are this
    rank's slab, whose rows start at row_offset of the padded frame of
    n_valid pixels: the gradients and the loss are summed over the
    ranks before the step."""
    loss_fn = make_loss_fn(tables, cfg, spp, n_valid, row_offset)

    def step(params, px, py, target, sample_base=0):
        optimizer.zero_grad()
        loss = loss_fn(params, px, py, target, sample_base)
        loss.backward()
        loss, _ = _reduce_grads(mesh, [x for g in optimizer.param_groups
                                       for x in g["params"]], loss)
        optimizer.step()
        return float(loss.detach())

    return step


def fit(tables: SceneTables, cfg: RenderConfig, target_image,
        fields: Sequence[str] = ("mat_albedo",), spp: int = 4,
        steps: int = 50, learning_rate: float = 5e-2,
        init_params: Optional[Dict[str, torch.Tensor]] = None,
        method: str = "ad", geom_spec=None,
        bwd_depth: Optional[int] = None, resample: bool = False,
        device="cuda", mesh: Optional[Mesh] = None
        ) -> Tuple[Dict[str, np.ndarray], list]:
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
    same samples. mesh (parallel/mesh.make_mesh): train over its ranks,
    each on its slab of the frame, on the mesh's device (see the module
    doc); the parameters and the history are the same on every rank.

    Returns (recovered params as NumPy arrays, a CameraDef of them for
    "camera", and the per-step loss history)."""
    if method not in ("ad", "replay", "tape"):
        raise ValueError(f"method must be 'ad', 'replay' or 'tape'; got "
                         f"{method!r}")
    dev = mesh.device if mesh is not None else resolve_device(device)
    tables = tables.to(dev)
    params = (dict(init_params) if init_params is not None
              else extract_params(tables, fields))
    params = {k: _trainable(v, dev) for k, v in params.items()}
    from rt_tpu_torch.diff import tape  # tape.py imports this module

    if method == "tape":
        tape.check_fields(params)
    leaves = tape.leaves_of(params)
    optimizer = torch.optim.Adam(leaves, lr=learning_rate)
    px, py, tgt, row0, n_valid = _pixel_rows(cfg, target_image, dev, mesh)

    if method == "tape" and mega_supported(tables):
        # the fast step: one B4 capture, the death-sorted replay
        vg = tape.make_tape_vg(tables, cfg, px, py, tgt, spp=spp,
                               n_valid=n_valid, row_offset=row0)

        def step(s0):
            optimizer.zero_grad()
            loss, grads = vg(params, s0)
            for x, g in zip(leaves, tape.leaves_of(grads)):
                x.grad = g
            loss, _ = _reduce_grads(mesh, leaves, loss)
            optimizer.step()
            return float(loss)
    elif method in ("tape", "replay"):
        if method == "tape":
            loss_of = tape.make_tape_loss_fn(
                tables, cfg, spp, px, py, tgt, n_valid=n_valid,
                row_offset=row0)
        else:
            from rt_tpu_torch.diff.replay import make_replay_loss_fn

            # the early exit: the same gradients, no bounce over no lane
            loss_of = make_replay_loss_fn(
                tables, cfg, spp, px, py, tgt, geom_spec=geom_spec,
                bwd_depth=bwd_depth, n_valid=n_valid, bwd_early_exit=True,
                row_offset=row0)

        def step(s0):
            optimizer.zero_grad()
            loss = loss_of(params, s0)
            loss.backward()
            loss, _ = _reduce_grads(mesh, leaves, loss)
            optimizer.step()
            return float(loss.detach())
    else:
        if geom_spec:
            raise ValueError("geom_spec belongs to method='replay'")
        train = make_train_step(tables, cfg, spp, optimizer, mesh,
                                n_valid, row0)

        def step(s0):
            return train(params, px, py, tgt, s0)

    history = [step(k * spp if resample else 0) for k in range(steps)]
    return {k: _to_numpy(v) for k, v in params.items()}, history


def _frame(cfg: RenderConfig, target_image, dev):
    """The whole frame's pixel coordinates px, py [H*W] (row 0 the bottom
    scanline) and the target image [H,W,3] as rows [H*W, 3], on dev."""
    pix = torch.arange(cfg.width * cfg.height, device=dev)
    tgt = torch.as_tensor(np.asarray(target_image, np.float32)).reshape(
        -1, 3).to(dev)
    return pix % cfg.width, pix // cfg.width, tgt


def _pixel_rows(cfg: RenderConfig, target_image, dev,
                mesh: Optional[Mesh]):
    """(px, py, target rows, row offset, n_valid) of this process: the
    whole frame (offset 0, n_valid None) without a mesh; with one, this
    rank's slab of the frame padded over the mesh's ranks as
    parallel/sharded._padded_pixel_list pads it (target rows padded with
    row 0), its first row's index in the padded frame, and H*W."""
    if mesh is None:
        return _frame(cfg, target_image, dev) + (0, None)
    from rt_tpu_torch.parallel.sharded import _padded_pixel_list

    px, py, n_pix = _padded_pixel_list(cfg.width, cfg.height, mesh.size)
    flat = np.asarray(target_image, np.float32).reshape(-1, 3)
    pad = px.shape[0] - n_pix
    if pad:
        flat = np.concatenate([flat, np.broadcast_to(flat[:1], (pad, 3))])
    per = px.shape[0] // mesh.size
    lo = mesh.rank * per
    rows = slice(lo, lo + per)
    return (torch.from_numpy(px[rows]).to(dev, torch.int64),
            torch.from_numpy(py[rows]).to(dev, torch.int64),
            torch.from_numpy(np.ascontiguousarray(flat[rows])).to(dev),
            lo, n_pix)


def _flatten_fd_components(fd_params) -> list:
    """[(field, component tuple)] of {field: [component, ...]}; a bare int
    component is a 1-tuple, so {"sph_radius": [0]} reads as
    {"sph_radius": [(0,)]} (the reference's :60)."""
    out = []
    for f, idxs in fd_params.items():
        for idx in idxs:
            out.append((f, tuple(int(i) for i in idx)
                        if isinstance(idx, (tuple, list, np.ndarray))
                        else (int(idx),)))
    return out


def _shifted(params: Dict[str, torch.Tensor], field: str, idx: tuple,
             delta: float) -> Dict[str, torch.Tensor]:
    """params with component idx of `field` moved by delta (a float32
    add, as the reference's .at[].add)."""
    v = params[field].detach().clone()
    v[idx] += delta
    return {**params, field: v}


def _render_loss(tables: SceneTables, cfg: RenderConfig, px, py, tgt,
                 spp: int, sample_base: int = 0,
                 n_valid: Optional[int] = None,
                 row_offset: int = 0) -> torch.Tensor:
    """The MSE of the spp-sample estimate of the pixels (px, py) on
    cfg.engine against tgt rows, as a 0-d tensor on the device (a
    forward render: no gradient is recorded); n_valid and row_offset
    mask a rank's slab as masked_mse does."""
    with torch.no_grad():
        acc = render_block(tables, cfg, px, py, int(sample_base), int(spp),
                           int(cfg.seed) & 0xFFFFFFFF, cfg.width, cfg.height)
        return masked_mse((acc / float(spp) - tgt) ** 2, n_valid,
                          row_offset)


def fd_losses(loss_of, params: Dict[str, torch.Tensor], flat_idx,
              eps: float) -> torch.Tensor:
    """The probe losses [2K] of central differences with common random
    numbers: rows 2j and 2j+1 are loss_of(params) with component j of
    flat_idx moved by +eps and -eps (loss_of returns a 0-d device
    tensor)."""
    return torch.stack([loss_of(_shifted(params, f, idx, d))
                        for f, idx in flat_idx for d in (eps, -eps)])


def fd_from_losses(losses: torch.Tensor, params: Dict[str, torch.Tensor],
                   flat_idx, eps: float) -> Dict[str, torch.Tensor]:
    """The gradient of fd_losses' probes: (loss(+eps) - loss(-eps)) /
    (2 eps) per component of flat_idx, zero for the components not
    listed."""
    grads = {f: torch.zeros_like(v) for f, v in params.items()}
    for j, (f, idx) in enumerate(flat_idx):
        grads[f][idx] = (losses[2 * j] - losses[2 * j + 1]) / (2 * eps)
    return grads


def fd_gradient(loss_of, params: Dict[str, torch.Tensor], flat_idx,
                eps: float) -> Dict[str, torch.Tensor]:
    """Central differences with common random numbers: for each (field,
    component) of flat_idx, (loss(+eps) - loss(-eps)) / (2 eps), where
    loss_of(params) is a 0-d device tensor; zero for the components not
    listed. Runs on the device; reads nothing back."""
    if not flat_idx:
        return {f: torch.zeros_like(v) for f, v in params.items()}
    return fd_from_losses(fd_losses(loss_of, params, flat_idx, eps),
                          params, flat_idx, eps)


def _adam_step(optimizer, leaves, grads) -> None:
    """One Adam update of leaves with the given gradients (on the
    device, outside autograd)."""
    for x, g in zip(leaves, grads):
        x.grad = g.to(x.dtype)
    optimizer.step()


def fit_fd(tables: SceneTables, cfg: RenderConfig, target_image, fd_params,
           spp: int = 8, steps: int = 60, learning_rate: float = 2e-2,
           eps: float = 2e-2, device="cuda"
           ) -> Tuple[Dict[str, np.ndarray], list]:
    """Geometry recovery by central differences with common random
    numbers + Adam (rt_tpu/diff/inverse.py `fit_fd` :348).

    Detached-sampling gradients do not see the silhouette term of a
    geometry parameter (moving a sphere mostly changes which pixels it
    covers); central differences do, and with the counter RNG the +eps
    and -eps probes trace identical random streams, so the estimate is
    clean at low spp. fd_params: {field: [component, ...]}, e.g.
    {"sph_center": [(0, 0), (0, 2)]} moves sphere 0's x and z; any
    float table of SceneTables may be named (rect_k, cyl_radius, tri_v1,
    ...). Each step renders the 2K probes and the unperturbed frame on
    cfg.engine (on `device`, CUDA unless the caller passes "cpu").

    Returns (the optimized fields as NumPy arrays, the history of the
    unperturbed loss at each step)."""
    dev = resolve_device(device)
    tables = tables.to(dev)
    px, py, tgt = _frame(cfg, target_image, dev)
    params = {f: _trainable(getattr(tables, f), dev) for f in fd_params}
    flat_idx = _flatten_fd_components(fd_params)
    leaves = list(params.values())
    optimizer = torch.optim.Adam(leaves, lr=learning_rate)

    def loss_of(pp):
        return _render_loss(apply_params(tables, pp), cfg, px, py, tgt, spp)

    history = []
    for _ in range(steps):
        cur = {k: v.detach() for k, v in params.items()}
        grads = fd_gradient(loss_of, cur, flat_idx, eps)
        base = loss_of(cur)
        _adam_step(optimizer, leaves, [grads[k] for k in params])
        history.append(float(base))
    return {k: _to_numpy(v) for k, v in params.items()}, history


CAMERA_RAW = {"lookfrom": 3, "lookat": 3, "vfov_deg": 1, "aperture": 1}


def camera_loss(tables: SceneTables, cfg: RenderConfig, target_image,
                init: Dict[str, object],
                recover: Sequence[str] = ("lookfrom",), spp: int = 8,
                device="cuda"):
    """The pose-recovery problem of fit_camera: (raw0, slots, loss_of).
    raw0 [K] f32 on the device: the recovered components of init, in
    `recover` order; slots: (name, offset into raw, size) per name;
    loss_of({"raw": raw}) -> 0-d tensor: the MSE of the spp-sample render
    on cfg.engine through the camera ops/camera.make_camera builds from
    init with raw's components in place."""
    bad = set(recover) - set(CAMERA_RAW)
    if bad:
        raise ValueError(f"recover must be among {sorted(CAMERA_RAW)}; got "
                         f"{sorted(bad)}")
    dev = resolve_device(device)
    tables = tables.to(dev)
    px, py, tgt = _frame(cfg, target_image, dev)
    aspect = cfg.width / cfg.height
    slots, raw0 = [], []
    for name in recover:
        v = np.atleast_1d(np.asarray(init[name], np.float32))
        slots.append((name, len(raw0), v.size))
        raw0.extend(v.tolist())
    fixed = {n: torch.as_tensor(np.asarray(init[n], np.float32), device=dev)
             for n in ("lookfrom", "lookat", "vup", "vfov_deg", "aperture")}

    def loss_of(pp):
        vals = dict(fixed)
        for name, off, sz in slots:
            vals[name] = pp["raw"][off] if sz == 1 else \
                pp["raw"][off:off + sz]
        cam = make_camera(vals["lookfrom"], vals["lookat"], vals["vup"],
                          vals["vfov_deg"], aspect, vals["aperture"],
                          focus_dist=init.get("focus_dist"))
        return _render_loss(dataclasses.replace(tables, camera=cam), cfg,
                            px, py, tgt, spp)

    raw = torch.as_tensor(np.asarray(raw0, np.float32), device=dev)
    return raw, slots, loss_of


def fit_camera(tables: SceneTables, cfg: RenderConfig, target_image,
               init: Dict[str, object],
               recover: Sequence[str] = ("lookfrom",), spp: int = 8,
               steps: int = 120, learning_rate: float = 4e-3, eps=None,
               device="cuda") -> Tuple[Dict[str, object], list]:
    """Camera POSE recovery by central differences with common random
    numbers + Adam (rt_tpu/diff/inverse.py `fit_camera` :427): find the
    thin-lens camera that produced target_image.

    init: the starting raw camera {"lookfrom": [3], "lookat": [3], "vup":
    [3], "vfov_deg", "aperture", optional "focus_dist"}; `recover` names
    which of lookfrom / lookat / vfov_deg / aperture move (the rest stay
    at init); the frame comes from ops/camera.make_camera (camera_loss).
    eps: the probe half-step per raw component (default 2e-2 for
    vfov_deg, whose degrees move the image ~50x less per unit than scene
    units, 2e-3 else). Each step renders the 2K probes and the
    unperturbed frame on cfg.engine.

    Returns (init with the recovered values, the loss history)."""
    raw0, slots, loss_of = camera_loss(tables, cfg, target_image, init,
                                       recover, spp, device)
    k = raw0.shape[0]
    if eps is None:
        eps = [2e-2 if n == "vfov_deg" else 2e-3
               for n, _, sz in slots for _ in range(sz)]
    else:
        eps = np.broadcast_to(np.asarray(eps, np.float32), (k,)).tolist()
    raw = raw0.clone().requires_grad_(True)
    optimizer = torch.optim.Adam([raw], lr=learning_rate)
    history = []
    for _ in range(steps):
        cur = {"raw": raw.detach()}
        g = torch.zeros_like(cur["raw"])
        for j in range(k):
            g[j] = fd_gradient(loss_of, cur, [("raw", (j,))],
                               float(eps[j]))["raw"][j]
        base = loss_of(cur)
        _adam_step(optimizer, [raw], [g])
        history.append(float(base))

    out = dict(init)
    raw_np = raw.detach().cpu().numpy()
    for name, off, sz in slots:
        out[name] = (float(raw_np[off]) if sz == 1
                     else raw_np[off:off + sz].copy())
    return out, history


def fit_hybrid(tables: SceneTables, cfg: RenderConfig, target_image,
               replay_fields: Sequence[str] = ("tex_color",),
               fd_params=None, spp: int = 4, fd_spp: Optional[int] = None,
               steps: int = 60, learning_rate: float = 3e-2,
               eps: float = 2e-2, bwd_depth: Optional[int] = None,
               resample: bool = False, device="cuda",
               mesh: Optional[Mesh] = None
               ) -> Tuple[Dict[str, np.ndarray], list]:
    """Joint radiometric + geometry recovery in one Adam loop
    (rt_tpu/diff/inverse.py `fit_hybrid` :541).

    `replay_fields` (albedo, emission, background) take the path-replay
    gradient (diff/replay.py: the forward on cfg.engine, the backward on
    its adjoint kernel); `fd_params` geometry components ({field:
    [component, ...]}, fields of replay.GEOM_FIELDS) take central
    differences with common random numbers over fd_spp samples (default
    spp), which see the silhouette term the replay drops. The geometry
    fields ride the replay's forward with an empty geom_spec (their
    replay gradient is zero and is overwritten by the FD estimate), so
    both estimators see the same parameters. resample=True moves the
    sample window every step. mesh: train over its ranks as fit does;
    the probe losses are summed over the ranks with the gradients, in
    one all_reduce, before they are differenced.

    Returns (the optimized fields as NumPy arrays, the replay loss at
    each step)."""
    from rt_tpu_torch.diff.replay import make_replay_loss_fn

    fd_params = dict(fd_params or {})
    fd_spp = spp if fd_spp is None else int(fd_spp)
    dev = mesh.device if mesh is not None else resolve_device(device)
    tables = tables.to(dev)
    px, py, tgt, row0, n_valid = _pixel_rows(cfg, target_image, dev, mesh)
    params = {k: _trainable(v, dev) for k, v in extract_params(
        tables, tuple(replay_fields) + tuple(fd_params)).items()}
    leaves = list(params.values())
    optimizer = torch.optim.Adam(leaves, lr=learning_rate)
    replay_loss = make_replay_loss_fn(
        tables, cfg, spp, px, py, tgt,
        geom_spec={f: [] for f in fd_params}, bwd_depth=bwd_depth,
        n_valid=n_valid, bwd_early_exit=True, row_offset=row0)
    flat_idx = _flatten_fd_components(fd_params)

    history = []
    for step in range(steps):
        s0 = step * max(spp, fd_spp) if resample else 0
        optimizer.zero_grad()
        loss = replay_loss(params, s0)
        loss.backward()
        probes = []
        if flat_idx:
            probes = [fd_losses(
                lambda pp: _render_loss(apply_params(tables, pp), cfg, px,
                                        py, tgt, fd_spp, s0, n_valid, row0),
                {k: v.detach() for k, v in params.items()}, flat_idx,
                eps)]
        loss, probes = _reduce_grads(mesh, leaves, loss, probes)
        grads = {k: v.grad for k, v in params.items()}
        if flat_idx:
            fd = fd_from_losses(probes[0], params, flat_idx, eps)
            for f, idx in flat_idx:
                grads[f][idx] = fd[f][idx]
        _adam_step(optimizer, leaves, [grads[k] for k in params])
        history.append(float(loss.detach()))
    return {k: _to_numpy(v) for k, v in params.items()}, history
