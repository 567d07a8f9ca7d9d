"""Camera ray generation (rt_tpu/ops/camera.py:54-82,
gpu-version/camera.cuh:31-39), with the thin-lens defocus of the
CPU/Taichi versions (cmake-cpu-version/camera.h:33-37)."""

from __future__ import annotations

import torch

from rt_tpu_torch.ops import rng
from rt_tpu_torch.scene.types import CameraDef


def generate_rays(cam: CameraDef, width, height, px, py, sample_idx, seed,
                  enable_defocus: bool, sampler: str = "rng"):
    """px, py: [B] integer pixel coords (x right, y up from bottom).
    Returns (ro [B,3], rd [B,3]) on px's device."""
    if sampler != "rng":
        raise NotImplementedError(
            f"sampler={sampler!r}: QMC is not ported yet (ROADMAP Queue A-6)")
    pixel = py.to(torch.int64) * width + px.to(torch.int64)
    ru = rng.uniform(seed, pixel, sample_idx, 0, rng.PIXEL_U)
    rv = rng.uniform(seed, pixel, sample_idx, 0, rng.PIXEL_V)
    # ((w-1) or 1): a 1-pixel-wide/tall frame would divide by zero
    s = (px.to(torch.float32) + ru) / ((width - 1) or 1)
    t = (py.to(torch.float32) + rv) / ((height - 1) or 1)

    if enable_defocus:
        disk = rng.in_unit_disk(seed, pixel, sample_idx, 0)
        rd_lens = cam.lens_radius * disk
        offset = (cam.u[None, :] * rd_lens[:, :1]
                  + cam.v[None, :] * rd_lens[:, 1:2])
    else:
        offset = torch.zeros((px.shape[0], 3), dtype=torch.float32,
                             device=px.device)

    origin = cam.origin[None, :] + offset
    direction = (cam.lower_left[None, :]
                 + s[:, None] * cam.horizontal[None, :]
                 + t[:, None] * cam.vertical[None, :]
                 - cam.origin[None, :] - offset)
    return origin, direction
