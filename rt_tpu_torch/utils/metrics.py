"""Metrics, timing spans and profiling (rt_tpu/utils/metrics.py).

  - Phase / Metrics: named spans with wall time, optionally waiting for
    the device at the end of each span, and counters.
  - RenderStats: one frame's throughput record; `log_line` is the
    reference's append-only .log line under the tag "rt_tpu_torch".
  - profile(logdir): torch.profiler around a block, written to logdir
    as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Dict, Optional

import torch

TAG = "rt_tpu_torch"


def device_sync(x=None) -> None:
    """Wait for the device work queued on x's device (a tensor, or a
    list / tuple / dict holding one): torch.cuda.synchronize there, and
    nothing on the CPU. With x None, the current CUDA device if there is
    one."""
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        x = next((v for v in x if isinstance(v, torch.Tensor)), None)
    if isinstance(x, torch.Tensor):
        if x.device.type == "cuda":
            torch.cuda.synchronize(x.device)
    elif x is None and torch.cuda.is_available():
        torch.cuda.synchronize()


@dataclasses.dataclass
class Phase:
    """One named span. Use via Metrics.phase("name")."""

    name: str
    start: float = 0.0
    seconds: float = 0.0
    count: int = 0


class Metrics:
    """Collects phase timings and counters for one render job."""

    def __init__(self, sync: bool = False):
        self.phases: Dict[str, Phase] = {}
        self.counters: Dict[str, float] = {}
        self.sync = sync

    @contextlib.contextmanager
    def phase(self, name: str, result=None):
        ph = self.phases.setdefault(name, Phase(name))
        t0 = time.perf_counter()
        try:
            yield ph
        finally:
            if self.sync:
                device_sync(result)
            ph.seconds += time.perf_counter() - t0
            ph.count += 1

    def add(self, name: str, value: float = 1.0):
        self.counters[name] = self.counters.get(name, 0.0) + value

    def summary(self) -> dict:
        out = {f"phase.{p.name}.s": round(p.seconds, 4)
               for p in self.phases.values()}
        out.update({f"count.{k}": v for k, v in self.counters.items()})
        return out

    def __repr__(self):
        return f"Metrics({json.dumps(self.summary())})"


@dataclasses.dataclass
class RenderStats:
    """Throughput record for one frame (the .log regression line)."""

    width: int
    height: int
    spp: int
    max_depth: int
    seconds: float
    engine: str = "plain"
    n_devices: int = 1

    @property
    def paths(self) -> int:
        return self.width * self.height * self.spp

    @property
    def paths_per_s(self) -> float:
        return self.paths / self.seconds if self.seconds > 0 else 0.0

    def log_line(self, tag: str = TAG) -> str:
        return (f"{tag}, width {self.width} height {self.height} "
                f"spp {self.spp} depth {self.max_depth} engine {self.engine} "
                f"devices {self.n_devices} "
                f"paths/s {self.paths_per_s:.0f} time: {self.seconds:.6f} s")

    def append_to(self, path: str, tag: str = TAG) -> None:
        with open(path, "a") as f:
            f.write(self.log_line(tag) + "\n")

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self)
                          | {"paths_per_s": self.paths_per_s})


@contextlib.contextmanager
def profile(logdir: Optional[str] = None):
    """torch.profiler around a block (CPU activity, and CUDA where a GPU
    is present), its Chrome trace written to logdir/trace.json when the
    block ends; a no-op when logdir is None. Yields the profiler."""
    if logdir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch_profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
