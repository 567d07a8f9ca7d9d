"""Progressive rendering with exact checkpoint / resume
(rt_tpu/render/progressive.py).

The accumulator is (pixel_sum, samples_done). Every random draw is a
pure function of (pixel, sample, bounce, purpose) (ops/rng.py), so
rendering samples [k, spp) after a restart draws exactly the paths of
the uninterrupted render: there is no RNG state to save. The sums are
bit-equal to a one-shot render where the passes add the samples in the
order `render` does, which one-sample passes do (render adds each sample
into the frame in turn); longer passes add a pass's partial sum, which
associates otherwise (about k * 2^-24 of the sum for k passes). A
fingerprint of the scene and config guards against resuming with other
inputs.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Callable, Optional

import numpy as np
import torch

from rt_tpu_torch.config import RenderConfig, resolve_device
from rt_tpu_torch.scene.types import SceneTables


def _fingerprint(tables: SceneTables, cfg: RenderConfig) -> str:
    """A hash of the config knobs that set the sample streams and the
    estimator, and of the bytes of every tensor of the tables (with its
    name, dtype and shape)."""
    h = hashlib.sha256()
    h.update(json.dumps({
        "width": cfg.width, "height": cfg.height,
        "max_depth": cfg.max_depth, "seed": cfg.seed,
        "background_mode": cfg.background_mode,
        "exhaust_mode": cfg.exhaust_mode, "p_rr": cfg.p_rr,
        "enable_defocus": cfg.enable_defocus,
        # resuming under another sample sequence (rng / qmc) or another
        # estimator (nee on / off) would mix two streams in one sum
        "sampler": cfg.sampler, "nee": cfg.nee,
    }, sort_keys=True).encode())
    for name, leaf in sorted(tables.leaves().items()):
        arr = leaf.detach().cpu().contiguous().numpy()
        h.update(f"{name}:{arr.dtype}:{arr.shape}".encode())
        h.update(arr.tobytes())
    return h.hexdigest()[:32]


@dataclasses.dataclass
class Checkpoint:
    pixel_sum: np.ndarray   # [H,W,3] raw radiance sums (bottom-up rows)
    samples_done: int
    fingerprint: str

    def save(self, path: str) -> None:
        # write to a temp name of this writer's own (an open file handle
        # stops numpy from appending ".npz"), then replace atomically; a
        # stale or another process's temp file is never promoted
        tmp = f"{path}.{os.getpid()}.tmp.npz"
        with open(tmp, "wb") as f:
            np.savez_compressed(f,
                                pixel_sum=self.pixel_sum,
                                samples_done=self.samples_done,
                                fingerprint=self.fingerprint)
        os.replace(tmp, path)

    @staticmethod
    def load(path: str) -> "Checkpoint":
        with np.load(path, allow_pickle=False) as z:
            return Checkpoint(pixel_sum=z["pixel_sum"],
                              samples_done=int(z["samples_done"]),
                              fingerprint=str(z["fingerprint"]))


def render_progressive(
    tables: SceneTables,
    cfg: RenderConfig,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 16,
    samples_per_pass: Optional[int] = None,
    callback: Optional[Callable[[torch.Tensor, int], None]] = None,
    progress: bool = False,
    device="cuda",
):
    """Render cfg.samples_per_pixel samples in passes on `device` (CUDA
    unless the caller passes "cpu"), checkpointing to checkpoint_path
    every checkpoint_every samples and at the end; an existing
    checkpoint of the same fingerprint is resumed, another raises
    ValueError. samples_per_pass defaults to min(checkpoint_every,
    max(1, spp // 8)). callback(image_sum, samples_done) fires after
    every pass. Returns (pixel_sum [H,W,3] on the device, samples_done)."""
    from rt_tpu_torch.render.renderer import render

    dev = resolve_device(device)
    tables = tables.to(dev)
    fp = _fingerprint(tables, cfg)
    start = 0
    acc = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32,
                      device=dev)

    if checkpoint_path and os.path.exists(checkpoint_path):
        ck = Checkpoint.load(checkpoint_path)
        if ck.fingerprint != fp:
            raise ValueError(
                "checkpoint does not match scene/config "
                f"({ck.fingerprint} != {fp})")
        acc = torch.from_numpy(ck.pixel_sum.astype(np.float32)).to(dev)
        start = ck.samples_done

    spp = cfg.samples_per_pixel
    if samples_per_pass is None:
        samples_per_pass = min(checkpoint_every, max(1, spp // 8))

    s = start
    since_ck = 0
    while s < spp:
        k = min(samples_per_pass, spp - s)
        # samples [s, s+k) only: the uninterrupted render's coordinates
        part = render(tables, cfg.replace(samples_per_pixel=k),
                      sample_offset=s, device=dev)
        acc = acc + part
        s += k
        since_ck += k
        if progress:
            print(f"\rsamples {s}/{spp}", end="", flush=True)
        if callback is not None:
            callback(acc, s)
        if checkpoint_path and (since_ck >= checkpoint_every or s >= spp):
            Checkpoint(acc.cpu().numpy(), s, fp).save(checkpoint_path)
            since_ck = 0
    if progress:
        print()
    return acc, s
