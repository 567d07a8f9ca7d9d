"""Film: accumulated radiance sums -> displayable images
(rt_tpu/render/film.py).

  - PPM path (write_color, gpu-version/color.cuh:43-95): scale by 1/spp,
    gamma via sqrt, clamp to [0, 0.999], * 256, top row first.
  - PNG path (write_image, color.cuh:15-35): the same without gamma —
    the reference's PNG writer applies none: finalize(..., gamma=False).

Sums may be tensors on any device or NumPy arrays; the scaling runs in
float64 where the sum lies, and the 8-bit image comes back as NumPy.
"""

from __future__ import annotations

import numpy as np
import torch


def negative_pixels(image_sum) -> int:
    """Count of pixels with any negative channel (color.cuh:49-52)."""
    return int((torch.as_tensor(image_sum) < 0.0).any(dim=-1).sum())


def finalize_u8(image_sum, spp: int, gamma: bool) -> torch.Tensor:
    """finalize's u8 image [H,W,3] as a tensor where the sum lies (the
    animation pipeline downloads it without waiting)."""
    img = torch.as_tensor(image_sum).to(torch.float64) / float(spp)
    if gamma:
        img = torch.sqrt(torch.clamp(img, min=0.0))
    u8 = (256.0 * torch.clamp(img, 0.0, 0.999)).to(torch.uint8)
    return u8.flip(0)


def finalize(image_sum, spp: int, gamma: bool) -> np.ndarray:
    """1/spp scale (+ sqrt gamma) -> u8 [H,W,3], rows flipped so row 0 =
    top scanline (the reference writes j = height-1 .. 0)."""
    return finalize_u8(image_sum, spp, gamma).cpu().numpy()


def to_ppm(image_sum, spp: int, gamma: bool = True) -> str:
    """ASCII P3 PPM matching output_image + write_color."""
    u8 = finalize(image_sum, spp, gamma=gamma)
    h, w, _ = u8.shape
    lines = [f"P3\n{w} {h}\n255\n"]
    lines.extend(f"{r} {g} {b}\n" for r, g, b in u8.reshape(-1, 3))
    return "".join(lines)


def to_png_u8(image_sum, spp: int, gamma: bool = False) -> np.ndarray:
    """u8 image for the PNG writer. gamma=False matches the reference's
    write_image (no sqrt, color.cuh:21-29)."""
    return finalize(image_sum, spp, gamma=gamma)
