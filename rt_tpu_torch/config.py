"""Render configuration and device selection.

`RenderConfig` is a copy of `rt_tpu.config.RenderConfig`: the same field
names and defaults, so a configuration carries across field by field
(`RenderConfig(**dataclasses.asdict(jax_cfg))`). The engines have the
reference's names:

  "plain"  — pure PyTorch wavefront (the twin of rt_tpu's "xla")
  "pallas" — the hybrid wavefront: the sphere pass of every bounce runs
             the hand-written CUDA closest-hit kernel
             (ops/cuda_intersect.py, the twin of rt_tpu's "pallas")
  "mega"   — the forward megakernel (ops/cuda_mega.py, csrc/mega.cu):
             a segment of whole paths per launch, live lanes grouped
             between segments by compact_every / compact_schedule /
             compact_group / compact_shrink
  "queue"  — the persistent ray queue (ops/cuda_queue.py,
             csrc/queue.cu), the CLI's default as in the reference;
             queue_steps is its budget of bounce steps per launch

This slice reads cull_chunks and mxu_intersect as off: the sphere table
is in scene order and nothing is culled, so on exact-t ties it may pick
another sphere than rt_tpu's Morton-sorted table (ROADMAP C-3). What it
lacks raises NotImplementedError (check_supported).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

ENGINES = ("plain", "pallas", "mega", "queue")


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render settings (see rt_tpu/config.py for each field)."""

    width: int = 400
    height: int = 225
    samples_per_pixel: int = 16
    max_depth: int = 8

    background_mode: str = "constant"   # "constant" | "gradient"
    exhaust_mode: str = "black"         # "black" | "background"
    enable_defocus: bool = False
    p_rr: float = 0.0
    seed: int = 0
    sampler: str = "rng"                # "rng" ("qmc" not ported yet)
    nee: bool = False
    mis: bool = False
    nee_glossy: bool = False

    engine: str = "plain"               # "plain" | "pallas" | "mega" | "queue"
    loop: str = "while"
    traversal: str = "linear"
    rays_per_batch: int = 1 << 17
    compact_every: int = 0
    compact_group: int = 128
    compact_schedule: Tuple[int, ...] = ()
    cull_chunks: bool = True
    mxu_intersect: bool = False
    compact_shrink: bool = True
    compact_sort: str = "dead"
    regen: bool = False
    regen_compact: int = 0
    regen_shrink: bool = True
    queue_steps: int = 0

    @property
    def aspect_ratio(self) -> float:
        return self.width / self.height

    @property
    def num_pixels(self) -> int:
        return self.width * self.height

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


def check_supported(cfg: RenderConfig) -> None:
    """Raise for a configuration this slice of the port cannot render."""
    if cfg.engine not in ENGINES:
        raise ValueError(f"unknown engine {cfg.engine!r} (want {ENGINES})")
    if cfg.nee or cfg.mis or cfg.nee_glossy:
        raise NotImplementedError(
            "nee / mis / nee_glossy are not ported yet (ROADMAP Queue A-5)")
    if cfg.sampler != "rng":
        raise NotImplementedError(
            f"sampler={cfg.sampler!r}: QMC is not ported yet "
            "(ROADMAP Queue A-6)")
    if cfg.traversal != "linear":
        raise NotImplementedError("BVH traversal is not ported yet "
                                  "(ROADMAP Queue A-8)")
    if cfg.compact_sort != "dead":
        raise NotImplementedError(
            f"compact_sort={cfg.compact_sort!r}: only 'dead' is ported yet "
            "(ROADMAP Queue B2)")
    if cfg.regen:
        raise NotImplementedError("regen=True: the regeneration kernel is "
                                  "not ported yet (ROADMAP Queue B7)")
    if cfg.loop != "while":
        raise NotImplementedError(
            f"loop={cfg.loop!r}: the port runs the 'while' loop only; its "
            "gradients need no fixed-trip loop (autograd records the "
            "'while' loop, diff/inverse.py method='ad'; the path replay "
            "runs any engine, diff/replay.py)")


def resolve_device(device: Optional[str] = "cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. A missing GPU raises; it never silently means the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' "
            "(--device cpu) to run on the CPU")
    return dev
