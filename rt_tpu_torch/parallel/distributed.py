"""Multi-process runtime glue (rt_tpu/parallel/distributed.py).

The reference joins the hosts of a pod into one JAX runtime
(`jax.distributed.initialize`), after which its (tile, sample) mesh
spans every device. The port uses PyTorch's form of the same thing: one
process per device, started by torchrun (`python -m
torch.distributed.run`) or spawned by a caller, joined by a process
group. `init_distributed` joins the group that torchrun's environment
describes (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and
picks this rank's device; parallel/mesh.py lays the (tile, sample) grid
over the ranks. A process that joins no group is a world of one.

Frame-level farming (animation) stays embarrassingly parallel: each
host takes its contiguous slice of the frames with `frame_range`, the
analogue of the reference's per-GPU process split
(gpu-version/blue.py:23-35).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from rt_tpu_torch.config import resolve_device

# this process's device once init_distributed has run, and whether it
# made the process group (shutdown_distributed destroys only that one)
_STATE = {"device": None, "created": False}


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def init_distributed(device="cuda", backend: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     init_method: Optional[str] = None,
                     timeout_s: float = 600.0) -> torch.device:
    """Join the process group that torchrun's environment describes, or
    the one the arguments name (they override the environment), and
    return this rank's device.

    A single process with no such environment (no WORLD_SIZE, no
    world_size, no init_method) joins nothing: it is a world of one on
    `device`. Calling again once a group is up changes nothing.

    backend None means "nccl" for a CUDA device and "gloo" for the CPU.
    A CUDA rank runs on cuda:{LOCAL_RANK % device_count}, set with
    torch.cuda.set_device before the group is made. NCCL needs a card
    per rank: where two ranks of one host would share a card it raises
    and names gloo, which may share one. No failure switches the
    backend or the device, and a missing GPU raises as resolve_device
    does. timeout_s bounds every collective, so a lost rank fails the
    run instead of hanging it."""
    if dist.is_initialized():
        return rank_device()
    if rank is None:
        rank = _env_int("RANK")
    if world_size is None:
        world_size = _env_int("WORLD_SIZE")
    dev = resolve_device(device)
    if world_size is None and init_method is None:
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        _STATE["device"] = dev
        return dev
    if world_size is None or rank is None:
        raise ValueError("init_distributed: a process group needs both its "
                         "rank and its world size (RANK / WORLD_SIZE, or "
                         "the arguments)")
    local_rank = _env_int("LOCAL_RANK")
    local_rank = rank if local_rank is None else local_rank
    local_world = _env_int("LOCAL_WORLD_SIZE") or world_size
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("init_distributed: backend 'nccl' needs CUDA "
                         "devices; the CPU takes 'gloo'")
    if dev.type == "cuda":
        n_cards = torch.cuda.device_count()
        if backend == "nccl" and local_world > n_cards:
            raise ValueError(
                f"init_distributed: {local_world} ranks on this host share "
                f"{n_cards} CUDA device(s), and NCCL needs a card per rank; "
                "pass backend='gloo' to put several ranks on one card")
        dev = torch.device("cuda", local_rank % n_cards)
        torch.cuda.set_device(dev)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s), **kw)
    _STATE["device"], _STATE["created"] = dev, True
    return dev


def rank_device() -> torch.device:
    """This rank's device: the one init_distributed picked, or with no
    call of it, the current CUDA device (a missing GPU raises)."""
    if _STATE["device"] is not None:
        return _STATE["device"]
    resolve_device("cuda")  # raises without a GPU
    return torch.device("cuda", torch.cuda.current_device())


def world() -> Tuple[int, int]:
    """(rank, world size) of this process: (0, 1) without a group."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shutdown_distributed() -> None:
    """Destroy the process group if init_distributed made it."""
    if _STATE["created"] and dist.is_initialized():
        dist.destroy_process_group()
    _STATE["device"], _STATE["created"] = None, False


def frame_range(total_frames: int, num_hosts: int, host_index: int,
                start: int = 0) -> Tuple[int, int]:
    """Contiguous [lo, hi) frame slice for one host of a farm: the
    frames split in blocks of ceil(total / hosts), the last one short.
    Each frame's output is idempotent, so a crashed host's slice can be
    rerun on its own."""
    if not (0 <= host_index < num_hosts):
        raise ValueError(f"host_index {host_index} not in [0, {num_hosts})")
    per = -(-total_frames // num_hosts)
    lo = start + host_index * per
    hi = min(start + total_frames, lo + per)
    return lo, max(lo, hi)
