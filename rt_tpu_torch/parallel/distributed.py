"""The frame farm's split (rt_tpu/parallel/distributed.py
`frame_range`).

The reference farms an animation's frames over independent processes,
one per GPU (gpu-version/blue.py:23-35); `frame_range` gives each
process its contiguous slice. Joining processes into one multi-device
render (`init_distributed`, the sharded renderer) is not ported yet
(ROADMAP Queue A-9).
"""

from __future__ import annotations

from typing import Tuple


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
