"""Render configuration and device selection.

`RenderConfig` is a copy of `rt_tpu.config.RenderConfig`: the same field
names and defaults, so a configuration carries across field by field
(`RenderConfig(**dataclasses.asdict(jax_cfg))`). The engines have the
reference's names:

  "plain"  — pure PyTorch wavefront (the twin of rt_tpu's "xla"; "xla"
             names it too, and `engine_name` resolves the alias)
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

regen=True with engine "mega" renders each tile's whole spp loop on the
regeneration kernel (ops/cuda_mega.mega_trace_regen, csrc/regen.cu),
segmented by regen_compact (with compact_group and regen_shrink); other
engines ignore it, as the reference's do.

cull_chunks (the default, as the reference's) Morton-sorts the sphere
and triangle rows the megakernels read into chunks of 32 with per-chunk
boxes, where the reference does (ops/mega_tables.MegaScene.of), and each
lane of B2-B7 skips a chunk whose box its ray misses or lies beyond its
closest hit so far; cull_chunks=False keeps the rows in scene order and
tests every one. The reference culls a chunk for a tile of 2048 lanes at
once, so the two differ only on lanes whose own slab test and their
tile's part on a grazing hit. sampler "qmc" draws every path dimension
from the Owen-scrambled Sobol' sequence (ops/qmc.py) on every engine;
compact_sort "spatial" orders the groups of the segmented traces by
direction octant and Morton cell (ops/cuda_mega._segmented).
mxu_intersect is a TPU mechanism and is read as off. check_supported
raises ValueError for a name no option has.

loop "while" (the default) ends the wavefront engines' bounce loop when
no lane is alive, one host read a bounce; "scan" runs a fixed trip of
max_depth bounces with no such read, dead lanes passing through
unchanged, so both render the same bits (rt_tpu's lax.scan,
render/integrator.py:444-452). The kernel engines trace whole paths and
ignore it, as the reference's do.

traversal "bvh" walks the threaded BVHs of the tables' families
(build_tables(..., bvh_types=...), accel/bvh.py) in the intersector of
the wavefront engines ("plain", "pallas"), the replays and the
wavefront capture. The kernels of "mega", "queue" and regen read no
BVH, as the reference's do: there it changes nothing.

nee, mis and nee_glossy follow the reference's rule (`nee_on`): light
sampling runs only when cfg.nee is set and the scene has an emitter;
mis and nee_glossy take effect only with it, so a scene without lights
renders bit for bit as without nee.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

ENGINES = ("plain", "xla", "pallas", "mega", "queue")
LOOPS = ("while", "scan")
SAMPLERS = ("rng", "qmc")
TRAVERSALS = ("linear", "bvh")
COMPACT_SORTS = ("dead", "spatial")


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
    sampler: str = "rng"                # "rng" | "qmc"
    nee: bool = False
    mis: bool = False
    nee_glossy: bool = False

    engine: str = "plain"               # "plain" ("xla") | "pallas" | "mega"
                                        # | "queue"
    loop: str = "while"                 # "while" | "scan"
    traversal: str = "linear"
    rays_per_batch: int = 1 << 17
    compact_every: int = 0
    compact_group: int = 128
    compact_schedule: Tuple[int, ...] = ()
    cull_chunks: bool = True
    mxu_intersect: bool = False
    compact_shrink: bool = True
    compact_sort: str = "dead"          # "dead" | "spatial"
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

    def background_tuple(self, scene_background: Tuple[float, float, float]):
        return tuple(float(c) for c in scene_background)


def engine_name(engine: str) -> str:
    """The port's name of an engine: "plain" for rt_tpu's "xla" (the same
    pure wavefront engine), any other name as it is. Every switch on an
    engine reads its name through this."""
    return "plain" if engine == "xla" else engine


def check_supported(cfg: RenderConfig) -> None:
    """Raise ValueError for a name that no option of cfg has."""
    if cfg.engine not in ENGINES:
        raise ValueError(f"unknown engine {cfg.engine!r} (want {ENGINES})")
    if cfg.sampler not in SAMPLERS:
        raise ValueError(f"unknown sampler {cfg.sampler!r} (want "
                         f"{SAMPLERS})")
    if cfg.traversal not in TRAVERSALS:
        raise ValueError(f"unknown traversal {cfg.traversal!r} (want "
                         f"{TRAVERSALS})")
    if cfg.compact_sort not in COMPACT_SORTS:
        raise ValueError(f"unknown compact_sort {cfg.compact_sort!r} (want "
                         f"{COMPACT_SORTS})")
    if cfg.loop not in LOOPS:
        raise ValueError(f"unknown loop {cfg.loop!r} (want {LOOPS})")


def nee_on(cfg: RenderConfig, tables) -> bool:
    """Whether a trace samples lights (rt_tpu/render/integrator.py:410):
    cfg.nee and at least one emitter in the scene."""
    return bool(cfg.nee) and tables.n_lights > 0


def resolve_device(device: Optional[str] = "cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. A missing GPU raises; it never silently means the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' "
            "(--device cpu) to run on the CPU")
    return dev
