"""The path-tracing integrator: a wavefront bounce loop over a ray batch
(rt_tpu/render/integrator.py).

Radiometric semantics are the CUDA reference's iterative ray_color
(gpu-version/main.cu:17-70):

  while depth > 0:
      if hit and scatter:   color += emitted * T ; T *= attenuation
      elif hit (no scatter): color += T * emitted ; stop
      else (miss):           color += T * background ; stop
  depth exhausted -> contributes what it accumulated (no background)

with the gradient sky, background credit on depth exhaustion and
Russian roulette as RenderConfig options. engine="plain" / "pallas":
the whole batch advances one bounce per iteration with masked (dead)
lanes; the loop ends at max_depth or when no lane is alive, which costs
one host sync per bounce. engine="queue" / "mega": the persistent ray
queue (ops/cuda_queue.py) or the segmented megakernel
(ops/cuda_mega.py) trace whole paths per launch; as in the reference,
only an empty scene falls back to "pallas".
NEE / MIS / glossy light sampling are not ported yet (ROADMAP Queue A-5).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from rt_tpu_torch.config import RenderConfig, check_supported
from rt_tpu_torch.ops import geometry as geom
from rt_tpu_torch.ops import materials, rng
from rt_tpu_torch.ops.intersect import intersect
from rt_tpu_torch.scene.types import SceneTables


class RayState(NamedTuple):
    o: torch.Tensor           # [B,3]
    d: torch.Tensor           # [B,3]
    throughput: torch.Tensor  # [B,3]
    rgb: torch.Tensor         # [B,3]
    alive: torch.Tensor       # [B] bool


def background_color(tables: SceneTables, cfg: RenderConfig, d):
    if cfg.background_mode == "gradient":
        unit = geom.unit(d)
        t = 0.5 * (unit[:, 1] + 1.0)
        white = torch.ones(3, dtype=torch.float32, device=d.device)
        blue = torch.tensor([0.5, 0.7, 1.0], dtype=torch.float32,
                            device=d.device)
        return (1.0 - t)[:, None] * white + t[:, None] * blue
    return tables.background.expand(d.shape)


def _bounce(tables: SceneTables, cfg: RenderConfig, state: RayState,
            pixel, sample_idx, seed, bounce_idx) -> RayState:
    """Advance every live lane one bounce."""
    o, d, tp, rgb, alive = state

    survive = torch.ones_like(alive)
    if cfg.p_rr > 0.0:
        # RR check precedes the hit test (4_0_path_tracing.py:45-46)
        u_rr = rng.uniform(seed, pixel, sample_idx, bounce_idx, rng.RR)
        survive = u_rr <= cfg.p_rr

    hit = intersect(tables, o, d, engine=cfg.engine)

    ball = rng.in_unit_ball(seed, pixel, sample_idx, bounce_idx)
    refl_u = rng.uniform(seed, pixel, sample_idx, bounce_idx, rng.DIEL_REFL)
    sc, em = materials.shade(tables, hit.mat, d, hit.normal, hit.front_face,
                             hit.u, hit.v, hit.p, ball, refl_u)

    bg = background_color(tables, cfg, d)

    live = alive & survive
    scattered = live & hit.hit & sc.ok
    emitter = live & hit.hit & ~sc.ok
    missed = live & ~hit.hit

    # color += emitted * T on every hit; += T * background on miss
    contrib = (torch.where((scattered | emitter)[:, None], em, 0.0)
               + torch.where(missed[:, None], bg, 0.0))
    rgb = rgb + tp * contrib

    rr_comp = 1.0 / cfg.p_rr if cfg.p_rr > 0.0 else 1.0
    tp = torch.where(scattered[:, None], tp * sc.attenuation * rr_comp, tp)
    o = torch.where(scattered[:, None], hit.p, o)
    d = torch.where(scattered[:, None], sc.direction, d)
    return RayState(o, d, tp, rgb, scattered)


def trace(tables: SceneTables, cfg: RenderConfig, ro, rd, pixel, sample_idx,
          seed, stats: Optional[dict] = None) -> torch.Tensor:
    """Trace a batch of primary rays to radiance [B,3].

    stats, when given: with engine="plain" / "pallas", stats["bounces"]
    gains the number of wavefront bounces this call ran (with "pallas",
    one kernel launch each); with "queue" / "mega", stats["launches"]
    gains the kernel launches (on the CPU: the plain versions' calls)
    and stats["ray_bounces"] the bounces of all lanes."""
    check_supported(cfg)
    if cfg.engine in ("queue", "mega"):
        from rt_tpu_torch.ops import cuda_mega, cuda_queue
        from rt_tpu_torch.ops.mega_tables import mega_supported

        if mega_supported(tables):
            fn = (cuda_queue.queue_trace if cfg.engine == "queue"
                  else cuda_mega.mega_trace)
            return fn(tables, cfg, ro, rd, pixel, sample_idx, seed,
                      stats=stats)
        cfg = cfg.replace(engine="pallas")  # empty scene only
    b = ro.shape[0]
    state = RayState(
        o=ro, d=rd,
        throughput=torch.ones((b, 3), dtype=torch.float32, device=ro.device),
        rgb=torch.zeros((b, 3), dtype=torch.float32, device=ro.device),
        alive=torch.ones((b,), dtype=torch.bool, device=ro.device),
    )
    i = 0
    while i < cfg.max_depth and bool(state.alive.any()):
        state = _bounce(tables, cfg, state, pixel, sample_idx, seed, i)
        i += 1
    if stats is not None:
        stats["bounces"] = stats.get("bounces", 0) + i

    rgb = state.rgb
    if cfg.exhaust_mode == "background":
        # depth-exhausted rays credit the sky (taichi main.py:194-196)
        bg = background_color(tables, cfg, state.d)
        rgb = rgb + torch.where(state.alive[:, None],
                                state.throughput * bg, 0.0)
    return rgb
