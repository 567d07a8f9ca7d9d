"""The (tile, sample) mesh over the ranks of a process group
(rt_tpu/parallel/mesh.py).

The reference's mesh is a jax.sharding.Mesh over the devices of one
program, with two named axes:

  "tile"   — pixel tiles, the data-parallel axis (each device owns a
             contiguous slab of the flat pixel list)
  "sample" — sample batches (each device renders a disjoint block of
             every pixel's sample indices; the image is the sum over
             this axis)

The port runs one process per device (parallel/distributed.py), so its
mesh is a grid over the ranks of the process group: rank r sits at
(tile, sample) = (r // n_sample, r % n_sample). Scene tables are small
and every rank holds them whole; the one collective is the sum of the
ranks' partial frames, or of their gradients in training
(`Mesh.all_reduce_sum`). What the reference does in its one process
while the others have nothing to do, rank 0 does alone
(`Mesh.run_on_root`). A process that joined no group is a world of
one: a (1, 1) mesh on its device.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from rt_tpu_torch.parallel.distributed import rank_device, world

TILE_AXIS = "tile"
SAMPLE_AXIS = "sample"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (tile, sample) grid over the ranks: `shape` {"tile": n_tile,
    "sample": n_sample}, this process's `rank` and `device`, and the
    process group (None for a world of one with no group)."""

    shape: Dict[str, int]
    rank: int
    device: torch.device
    group: Optional[object] = None

    @property
    def size(self) -> int:
        return self.shape[TILE_AXIS] * self.shape[SAMPLE_AXIS]

    @property
    def coords(self) -> Tuple[int, int]:
        """This rank's (tile, sample) coordinate."""
        return divmod(self.rank, self.shape[SAMPLE_AXIS])

    def all_reduce_sum(self, tensors: Sequence[torch.Tensor]
                       ) -> List[torch.Tensor]:
        """Each tensor summed over the ranks, every rank given the same
        bits, by one collective over a flat float32 buffer (staged on
        the CPU for gloo, on the card for NCCL). Without a group the
        tensors come back as they are."""
        tensors = list(tensors)
        if self.group is None:
            return tensors
        flat = torch.cat([t.detach().reshape(-1).to(torch.float32)
                          for t in tensors])
        if dist.get_backend(self.group) == "gloo":
            flat = flat.cpu()
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
        out, i = [], 0
        for t in tensors:
            n = t.numel()
            out.append(flat[i:i + n].reshape(t.shape).to(
                device=t.device, dtype=t.dtype))
            i += n
        return out

    def run_on_root(self, fn: Callable[[], int]) -> int:
        """fn() -> exit code on rank 0 alone, the other ranks waiting
        for it to end; every rank returns rank 0's code. Without a group
        it is fn().

        The wait is no collective, whose timeout (the group's) a long
        fn would outlast: rank 0 posts its code to the group's store in
        a finally, and the others poll the store for it. If fn raises on
        rank 0, the others raise RuntimeError."""
        if self.group is None:
            return fn()
        store = dist.distributed_c10d._get_default_store()
        key = f"rt_tpu_torch/run_on_root/{next(_ROOT_CALLS)}"
        if self.rank == 0:
            code = None
            try:
                code = int(fn())
                return code
            finally:
                store.set(key, "raised" if code is None else str(code))
        delay = 0.01
        while not store.check([key]):
            time.sleep(delay)
            delay = min(2 * delay, 0.5)
        code = store.get(key).decode()
        if code == "raised":
            raise RuntimeError("rank 0 raised in run_on_root; see its "
                               "traceback")
        return int(code)


# run_on_root's calls in this process: every rank of a group makes the
# same calls in the same order, so the n-th call's store key is the same
# on each
_ROOT_CALLS = itertools.count()


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              device=None) -> Mesh:
    """Mesh with ("tile", "sample") axes over the ranks of the process
    group (a world of one without a group).

    shape defaults to (world size, 1): every rank a slab of pixels,
    which needs no communication until the frame is gathered; (n // k,
    k) also splits every pixel's samples over k ranks. device: this
    rank's device (default: the one init_distributed picked, else the
    current CUDA device)."""
    rank, n = world()
    if shape is None:
        shape = (n, 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != 2 or shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != {n} ranks")
    dev = rank_device() if device is None else torch.device(device)
    group = dist.group.WORLD if dist.is_initialized() else None
    return Mesh({TILE_AXIS: shape[0], SAMPLE_AXIS: shape[1]}, rank, dev,
                group)


def default_mesh() -> Mesh:
    return make_mesh()
