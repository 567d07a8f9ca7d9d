"""Top-level render driver: pixel tiling, sample batching, accumulation
(rt_tpu/render/renderer.py).

A "tile" is a flat batch of pixels; each launch traces (tile x samples)
rays through the full bounce loop and adds into a per-pixel accumulator
on the device, sample after sample. The result stays on the device
until the caller downloads it. `render_pixels` traces any subset of the
frame's pixels, each from its own sample index (adaptive sampling).

With cfg.regen and engine "mega" (rt_tpu/render/renderer.py:116-155),
each tile of up to rays_per_batch pixels runs its whole spp loop on the
regeneration kernel (ops/cuda_mega.mega_trace_regen): the camera rays
are made in the kernel, and the image is the per-sample launches' bit
for bit. regen with any other engine is ignored, as in the reference.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from rt_tpu_torch.config import RenderConfig, check_supported, \
    resolve_device
from rt_tpu_torch.ops.camera import generate_rays
from rt_tpu_torch.ops.cuda_mega import mega_trace_regen
from rt_tpu_torch.ops.mega_tables import mega_supported
from rt_tpu_torch.render.integrator import trace
from rt_tpu_torch.scene.types import SceneTables


def render_block(tables: SceneTables, cfg: RenderConfig, px, py,
                 sample_start, n_samples: int, seed: int, width: int,
                 height: int, stats: Optional[dict] = None, acc0=None):
    """Trace n_samples samples for the pixel batch (px, py) [B] and return
    the radiance SUM [B,3] (not yet divided by spp). sample_start is one
    sample index, or a [B] integer tensor of per-lane starts (adaptive
    sampling's per-pixel streams). acc0, when given, is the batch's sum
    so far: each sample adds to it in turn, so a frame's sum associates
    in sample order however its samples are split into launches."""
    pixel = py.to(torch.int64) * width + px.to(torch.int64)
    acc = (torch.zeros((px.shape[0], 3), dtype=torch.float32,
                       device=px.device) if acc0 is None else acc0)
    for i in range(n_samples):
        sample = sample_start + i
        ro, rd = generate_rays(tables.camera, width, height, px, py, sample,
                               seed, cfg.enable_defocus, cfg.sampler)
        acc = acc + trace(tables, cfg, ro, rd, pixel, sample, seed,
                          stats=stats)
    return acc


def render_pixels(tables: SceneTables, cfg: RenderConfig, px, py,
                  sample_start, n_samples: int, seed: int, width: int,
                  height: int, device="cuda") -> torch.Tensor:
    """The radiance sum [B,3] of n_samples samples of the pixels (px, py)
    [B] (rt_tpu/render/renderer.py `render_pixels` :62), on `device`
    (CUDA unless the caller passes "cpu"). sample_start: one sample index
    for every lane, or a [B] integer tensor or array of per-lane starts,
    lane i drawing samples sample_start[i] .. + n_samples - 1. Every
    engine takes per-lane samples (the kernels through
    ops/cuda_mega.lane_vector); the lanes may be any subset of the frame
    in any order."""
    dev = resolve_device(device)
    check_supported(cfg)
    tables = tables.to(dev)
    px = torch.as_tensor(px).to(device=dev, dtype=torch.int32)
    py = torch.as_tensor(py).to(device=dev, dtype=torch.int32)
    if isinstance(sample_start, (torch.Tensor, np.ndarray)) and \
            np.ndim(sample_start) > 0:
        sample_start = torch.as_tensor(sample_start).to(
            device=dev, dtype=torch.int64).reshape(-1)
    else:
        sample_start = int(sample_start)
    return render_block(tables, cfg, px, py, sample_start, int(n_samples),
                        int(seed) & 0xFFFFFFFF, width, height)


@functools.lru_cache(maxsize=8)
def _block_order(w: int, h: int, bx: int = 64, by: int = 32):
    """Pixels ordered in bx*by screen blocks instead of scanlines (the
    reference's order, kept so tiles hold the same pixels). The counter
    RNG keys on the absolute pixel id, so ordering cannot change the
    image."""
    pix = np.arange(w * h, dtype=np.int32)
    px_all = (pix % w).astype(np.int32)
    py_all = (pix // w).astype(np.int32)
    block = (py_all // by) * ((w + bx - 1) // bx) + (px_all // bx)
    order = np.argsort(block, kind="stable")
    return px_all[order], py_all[order], pix[order]


@functools.lru_cache(maxsize=8)
def _device_order(w: int, h: int, device: str):
    """_block_order's px, py, pixel ids (int32) and pixel ids (int64, the
    unpermute's index) on device, uploaded once per (w, h, device) as the
    reference's _device_tile caches its tiles: progressive passes,
    adaptive rounds and animation frames render the same frame size
    many times."""
    dev = torch.device(device)
    px_all, py_all, pix = _block_order(w, h)
    pix_dev = torch.from_numpy(pix).to(dev)
    return (torch.from_numpy(px_all).to(dev),
            torch.from_numpy(py_all).to(dev), pix_dev, pix_dev.long())


def render(tables: SceneTables, cfg: RenderConfig, sample_offset: int = 0,
           device="cuda", stats: Optional[dict] = None,
           samples_per_launch: Optional[int] = None,
           progress: bool = False) -> torch.Tensor:
    """Render the full frame on `device` (CUDA unless the caller passes
    "cpu"). Returns the raw radiance sum [H,W,3] as a tensor on that
    device, row 0 = BOTTOM scanline (writers flip). The image stays on
    the device (the reference's device_out=True); a caller that wants
    it on the host calls .cpu().

    sample_offset shifts the absolute sample indices (progressive and
    resumed renders draw the stream coordinates an uninterrupted render
    would). samples_per_launch: the samples each launch covers (None:
    as many as fit rays_per_batch, or the whole spp loop on the regen
    kernel); the tile is then rays_per_batch // samples_per_launch
    pixels. Without regen the samples add into the frame in sample
    order whatever the split, so the image is the same bit for bit.
    progress prints the tiles done. stats, when given, collects
    stats["bounces"] (see integrator.trace), or with the kernel engines
    stats["launches"] and stats["ray_bounces"]."""
    dev = resolve_device(device)
    check_supported(cfg)
    tables = tables.to(dev)
    w, h = cfg.width, cfg.height
    spp = cfg.samples_per_pixel
    n_pix = w * h
    use_regen = cfg.regen and cfg.engine == "mega" and not cfg.nee \
        and mega_supported(tables)

    if use_regen:
        # the spp loop runs in the kernel: the rays in flight are the
        # tile's pixels, whatever the samples a launch covers
        if samples_per_launch is None:
            samples_per_launch = spp
        tile = min(n_pix, cfg.rays_per_batch)
    else:
        # pick tile size so tile*samples_per_launch ~ rays_per_batch
        if samples_per_launch is None:
            samples_per_launch = max(1, min(
                spp, cfg.rays_per_batch // max(n_pix, 1)))
        tile = min(n_pix, max(1, cfg.rays_per_batch // samples_per_launch))
    n_tiles = -(-n_pix // tile)

    px_dev, py_dev, pix_dev, pix_long = _device_order(w, h, str(dev))
    acc = torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)
    seed = int(cfg.seed) & 0xFFFFFFFF
    for ti in range(n_tiles):
        sl = slice(ti * tile, min((ti + 1) * tile, n_pix))
        px, py = px_dev[sl], py_dev[sl]
        s = 0
        while s < spp:
            k = min(samples_per_launch, spp - s)
            if use_regen:
                acc[sl] += mega_trace_regen(
                    tables, cfg, pix_dev[sl], py, seed, k,
                    sample_base=sample_offset + s, width=w, height=h,
                    stats=stats)
            else:
                acc[sl] = render_block(tables, cfg, px, py,
                                       sample_offset + s, k, seed, w, h,
                                       stats=stats, acc0=acc[sl])
            s += k
        if progress:
            print(f"\rtile {ti + 1}/{n_tiles}", end="", flush=True)
    if progress:
        print()
    out = torch.empty_like(acc)
    out[pix_long] = acc  # undo the block order
    return out.reshape(h, w, 3)
