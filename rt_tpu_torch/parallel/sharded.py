"""Full-frame rendering over the (tile, sample) mesh
(rt_tpu/parallel/sharded.py).

  - the flat pixel list is split over the "tile" axis: each rank traces
    its own contiguous slab of pixels,
  - every pixel's samples are split over the "sample" axis: rank k of S
    renders the block [k * spp/S, (k+1) * spp/S) of sample indices,
  - the scene tables are whole on every rank.

Each rank renders its slab with renderer.render_block on cfg.engine
(through integrator.trace: B3 on "queue", B2 on "mega", B1 on "pallas";
no regen, as in the reference), writes its partial sums at the slab's
place in a zero frame of the padded pixel list, and one all_reduce(SUM)
over the ranks gives every rank the whole frame. That one collective is
both the reference's psum over "sample" and its gather of the tiles:
slabs are disjoint and radiance is non-negative, so the zeros add
nothing.

The counter RNG keys every draw on the absolute (pixel, sample), so a
(N, 1) mesh gives the frame of renderer.render bit for bit; with a
sample axis above 1 the sums associate otherwise (within 1e-5).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from rt_tpu_torch.config import RenderConfig, check_supported
from rt_tpu_torch.parallel.mesh import (SAMPLE_AXIS, TILE_AXIS, Mesh,
                                        default_mesh)
from rt_tpu_torch.render.renderer import render_block
from rt_tpu_torch.scene.types import SceneTables

_LANE = 128  # the reference pads pixel slabs to the TPU lane width


def _padded_pixel_list(width: int, height: int, n_tile: int):
    """Flat (px, py) int32 arrays in scanline order, padded so each of
    n_tile slabs is a whole number of 128-pixel lanes, and the frame's
    pixel count. Pad pixels re-trace pixel 0 (dropped on unpad)."""
    n_pix = width * height
    per = -(-n_pix // n_tile)
    per = -(-per // _LANE) * _LANE
    total = per * n_tile
    pix = np.arange(total, dtype=np.int32)
    pix = np.where(pix < n_pix, pix, 0)
    return (pix % width).astype(np.int32), (pix // width).astype(np.int32), \
        n_pix


@functools.lru_cache(maxsize=8)
def _device_slab(width: int, height: int, n_tile: int, tile: int,
                 device: str):
    """(px, py) of tile `tile`'s slab of the padded pixel list on device,
    the padded list's length and the frame's pixel count, built and
    uploaded once per (frame size, mesh, device), as the renderer caches
    its pixel order (renderer._device_order): animation frames render
    the same size many times, and at 1080p the list takes tens of ms of
    host NumPy."""
    px, py, n_pix = _padded_pixel_list(width, height, n_tile)
    per = px.shape[0] // n_tile
    sl = slice(tile * per, (tile + 1) * per)
    dev = torch.device(device)
    return (torch.from_numpy(px[sl]).to(dev),
            torch.from_numpy(py[sl]).to(dev), px.shape[0], n_pix)


def render_sharded(tables: SceneTables, cfg: RenderConfig,
                   mesh: Optional[Mesh] = None,
                   samples_per_launch: Optional[int] = None,
                   progress: bool = False) -> np.ndarray:
    """The raw radiance sums [H,W,3] (row 0 the bottom scanline) of the
    frame rendered over the mesh. spp rounds UP to a multiple of the
    sample axis, so callers normalise by render_sharded_ex's count."""
    img, _ = render_sharded_ex(tables, cfg, mesh, samples_per_launch,
                               progress)
    return img


def render_sharded_ex(tables: SceneTables, cfg: RenderConfig,
                      mesh: Optional[Mesh] = None,
                      samples_per_launch: Optional[int] = None,
                      progress: bool = False, stats: Optional[dict] = None):
    """(img, spp): the frame's radiance sums [H,W,3] as a NumPy array on
    every rank, and the samples per pixel it holds (cfg's spp rounded up
    to a multiple of the sample axis). mesh: default_mesh() when None
    (a world of one without a process group). samples_per_launch splits
    a rank's samples into launches (default: one; with progress, about
    eight), each adding to the running sum in sample order. stats, when
    given, collects the engine's counts on this rank (see
    integrator.trace)."""
    if mesh is None:
        mesh = default_mesh()
    check_supported(cfg)
    dev = mesh.device
    tables = tables.to(dev)
    w, h = cfg.width, cfg.height
    n_tile, n_sample = mesh.shape[TILE_AXIS], mesh.shape[SAMPLE_AXIS]
    spp = -(-cfg.samples_per_pixel // n_sample) * n_sample
    spp_local = spp // n_sample

    tile, k = mesh.coords
    px_d, py_d, total, n_pix = _device_slab(w, h, n_tile, tile, str(dev))
    per = total // n_tile
    sl = slice(tile * per, (tile + 1) * per)
    if samples_per_launch is None:
        samples_per_launch = spp_local if not progress else max(
            1, spp_local // 8)

    seed = int(cfg.seed) & 0xFFFFFFFF
    acc = None
    s = 0
    while s < spp_local:
        n = min(samples_per_launch, spp_local - s)
        acc = render_block(tables, cfg, px_d, py_d, k * spp_local + s, n,
                           seed, w, h, stats=stats, acc0=acc)
        s += n
        if progress:
            print(f"\rsample {s}/{spp_local} per rank", end="", flush=True)
    if progress:
        print()

    frame = torch.zeros((total, 3), dtype=torch.float32, device=dev)
    frame[sl] = acc
    (frame,) = mesh.all_reduce_sum([frame])
    return frame[:n_pix].cpu().numpy().reshape(h, w, 3), spp


__all__ = ["render_sharded", "render_sharded_ex", "render_block"]
