"""Adaptive sampling: spend the path budget where the noise is
(rt_tpu/render/adaptive.py).

The reference renders a fixed spp everywhere (gpu-version/main.cu:95-101).
This driver is the rt_tpu extension: a two-stage allocator on top of the
(pixel_sum, n_samples) accumulator.

  - The BASE pass renders spp_base samples of every pixel through the
    normal render path, as two halves; the per-pixel disagreement of the
    half means is the error estimate sigma_p.
  - Each ADAPTIVE round selects the top-B pixels by the score
    box3(sigma)_p / n_p (B fixed, padded to 128 lanes; relative=True
    divides by luminance) and renders k more samples of just those
    pixels through `render_pixels`.
  - Every selected pixel continues its own sample stream at index n_p:
    per-lane sample indices on every engine (the kernels B2 / B3 carry
    a per-lane sample vector), so under sampler="qmc" each pixel draws
    one contiguous scrambled-Sobol' prefix.
  - Every allocation uses only earlier rounds' data, so a run is a pure
    function of (scene, cfg, budget). The budget arithmetic is integer:
    the total spend n.sum() does not depend on the image.
  - After each round the selected pixels' sigma is refreshed from the
    round mean against the running mean (an EMA), so late fireflies
    bubble back up.

The estimator is sum_p / n_p (adaptive_mean).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from rt_tpu_torch.config import RenderConfig, resolve_device
from rt_tpu_torch.render.renderer import render, render_pixels
from rt_tpu_torch.scene.types import SceneTables


def _luminance(img3):
    return (0.2126 * img3[..., 0] + 0.7152 * img3[..., 1]
            + 0.0722 * img3[..., 2])


def _box3(x):
    """3x3 box filter (edge-clamped): per-pixel half-difference sigma
    estimates are extremely noisy at production base budgets; MC noise
    is spatially correlated, so pooling neighbors cuts the estimator's
    own variance ~9x. Used for allocation only: the running per-pixel
    sigma bookkeeping stays unpooled."""
    p = np.pad(x, 1, mode="edge")
    return (p[:-2, :-2] + p[:-2, 1:-1] + p[:-2, 2:]
            + p[1:-1, :-2] + p[1:-1, 1:-1] + p[1:-1, 2:]
            + p[2:, :-2] + p[2:, 1:-1] + p[2:, 2:]) / 9.0


def render_adaptive(
    tables: SceneTables,
    cfg: RenderConfig,
    spp_base: Optional[int] = None,
    rounds: int = 16,
    sel_frac: float = 0.125,
    batch_samples: Optional[int] = None,
    relative: bool = False,
    progress: bool = False,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Render with cfg.samples_per_pixel * n_pixels TOTAL paths,
    adaptively allocated. Returns (pixel_sum [H,W,3], n [H,W]) — the
    image is pixel_sum / n[..., None] (adaptive_mean).

    spp_base (default spp//2, min 4, even) is the uniform exploration
    budget; the remaining (spp - spp_base) * n_pixels paths are spent
    over `rounds` greedy rounds on the top sel_frac of pixels by the
    marginal-variance-reduction score sigma/n (repeatedly topping up
    the argmax of sigma/n converges to the n_p-proportional-to-sigma_p
    allocation that minimizes total variance for a fixed path budget —
    NOT sigma/sqrt(n), which overconcentrates at n ~ sigma^2).
    Allocation scores pool sigma over a 3x3 neighborhood (_box3);
    relative=True divides by luminance for perceptually-even noise
    instead of minimal absolute RMSE. batch_samples, if given, caps the
    per-round top-up k. The renders run on `device` (CUDA unless the
    caller passes "cpu"); the per-pixel bookkeeping is NumPy on the
    host, as the reference's, so the allocation rule is its own."""
    dev = resolve_device(device)
    tables = tables.to(dev)
    w, h = cfg.width, cfg.height
    n_pix = w * h
    spp = cfg.samples_per_pixel
    if spp_base is None:
        spp_base = max(4, spp // 2)
    spp_base = min(spp, spp_base + (spp_base % 2))
    seed = int(cfg.seed)

    # ---- base pass: two half-budget renders -> error estimate ----
    # all path accounting below uses the ACTUALLY rendered base count
    # (2*half, or 1 in the degenerate spp_base==1 case) so the total
    # spend is exactly cfg.samples_per_pixel * n_pixels
    half = spp_base // 2
    c1 = cfg.replace(samples_per_pixel=max(half, 1))
    a1 = render(tables, c1, device=dev).cpu().numpy()
    if half:
        a2 = render(tables, c1, sample_offset=half, device=dev).cpu().numpy()
        acc = a1 + a2
        n_base = 2 * half
    else:
        a2 = a1
        acc = a1
        n_base = 1
    n = np.full((h, w), n_base, np.float32)
    # half-mean disagreement ~ 2 * stderr(spp_base); constants cancel in
    # the ranking, only the sqrt(n) decay matters
    sigma = _luminance(np.abs(a1 / max(half, 1)
                              - a2 / max(half, 1))) * np.sqrt(max(half, 1))

    budget = (spp - n_base) * n_pix
    if budget <= 0 or rounds <= 0:
        return acc, n

    per_round = budget // rounds
    # fixed selection size (the same lane count every round): the top
    # sel_frac of the frame, padded to a lane multiple; per-round top-up
    # k spends the round's share across it. If batch_samples caps k, the
    # selection widens so each round still spends its full share.
    def _pad128(x):
        return -(-max(x, 1) // 128) * 128

    b_sel = min(_pad128(int(n_pix * sel_frac)), n_pix)
    if per_round < b_sel:
        # a round's share is below the selection width: shrink the
        # selection (lane-padded) instead of overspending ~b_sel per
        # round — e.g. spp=5 (budget 1*n_pix over 16 rounds) used to
        # spend ~2*n_pix
        b_sel = min(_pad128(per_round), n_pix)
    k = max(1, per_round // b_sel)
    if batch_samples is not None and k > batch_samples:
        k = batch_samples
        b_sel = min(_pad128(per_round // k), n_pix)
    if b_sel >= n_pix:
        b_sel = n_pix
        k = max(1, per_round // n_pix)

    pix_flat = np.arange(n_pix, dtype=np.int32)
    px_all = (pix_flat % w).astype(np.int32)
    py_all = (pix_flat // w).astype(np.int32)

    spent = 0
    for r in range(rounds):
        if spent + k * b_sel > budget + b_sel - 1:
            break  # lane-padding slack only; never a whole extra round
        spent += k * b_sel
        score = _box3(sigma) / n
        if relative:
            score = score / (_luminance(acc / n[..., None]) + 1e-2)
        score = score.reshape(-1)
        if b_sel < n_pix:
            sel = np.argpartition(score, n_pix - b_sel)[n_pix - b_sel:]
        else:
            sel = pix_flat
        ys, xs = py_all[sel], px_all[sel]
        # per-pixel continuation on every engine: each pixel extends its
        # own sample stream at n_p (per-lane sample indices ride the
        # kernels too): contiguous scrambled-Sobol' prefixes under
        # sampler="qmc"
        starts = n[ys, xs].astype(np.int64)
        part = render_pixels(tables, cfg, xs, ys, starts, int(k), seed, w,
                             h, device=dev).cpu().numpy()
        mean_before = _luminance(acc[ys, xs]) / n[ys, xs]
        acc[ys, xs] += part
        n[ys, xs] += k
        # sigma refresh: round-mean vs prior running-mean disagreement is
        # a (noisy, sqrt(k)-scaled) observation of the same sigma; EMA
        # both ways so estimates converge, while late fireflies still
        # raise sigma enough for the pooled score to re-select them
        obs = np.abs(_luminance(part) / k - mean_before) * np.sqrt(k)
        sigma[ys, xs] = 0.5 * sigma[ys, xs] + 0.5 * obs
        if progress:
            print(f"\radaptive round {r + 1}/{rounds} "
                  f"(+{k} spp x {len(sel)} px)", end="", flush=True)
    if progress:
        print()
    return acc, n


def adaptive_mean(acc: np.ndarray, n: np.ndarray) -> np.ndarray:
    """Per-pixel mean radiance [H,W,3] from (pixel_sum, n)."""
    return acc / np.maximum(n, 1.0)[..., None]
