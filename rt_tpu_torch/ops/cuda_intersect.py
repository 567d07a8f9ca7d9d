"""Closest sphere hit per ray: the hand-written CUDA kernel B1 and its
plain PyTorch version (the counterpart of rt_tpu/ops/pallas_intersect.py).

`sphere_closest_hit` launches csrc/sphere_hit.cu (built by nvcc at first
use, ops/cuda_build.py) for CUDA tensors and raises if it cannot; for
CPU tensors it returns `sphere_closest_hit_plain`, the [B,N] version of
ops/intersect._sphere_t + _last_argmin. `sphere_closest_hit.launches`
counts kernel launches, and nothing else.

Contract (both versions, and the TPU kernel they replace):
centers [N,3] f32, radii [N] f32, live_mask [N] bool (False for pad rows),
ro / rd [B,3] f32 -> (t [B] f32, inf on a miss; pid [B] i32). Equal t
goes to the larger index; a ray that hits nothing reports pid N-1.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from rt_tpu_torch.ops import cuda_build
from rt_tpu_torch.ops.intersect import _last_argmin, _sphere_t

# rays per [B,N] block of the plain version: bounds its temporaries to
# a few hundred MB at N=512 whatever the batch
PLAIN_RAY_CHUNK = 1 << 16


def sphere_closest_hit_plain(centers, radii, live_mask, ro, rd,
                             t_min=1e-3):
    t_parts, pid_parts = [], []
    for s in range(0, ro.shape[0], PLAIN_RAY_CHUNK):
        cand = _sphere_t(centers, radii, live_mask,
                         ro[s:s + PLAIN_RAY_CHUNK],
                         rd[s:s + PLAIN_RAY_CHUNK], t_min)
        pid = _last_argmin(cand)
        t_parts.append(torch.gather(cand, 1, pid[:, None])[:, 0])
        pid_parts.append(pid.to(torch.int32))
    if not t_parts:
        return (torch.empty(0, dtype=torch.float32, device=ro.device),
                torch.empty(0, dtype=torch.int32, device=ro.device))
    return torch.cat(t_parts), torch.cat(pid_parts)


def pack_table(centers, radii, live):
    """The kernel's [N,4] rows: cx, cy, cz, |c|^2 - r^2 (the c2r of
    pallas_intersect.py:114 and of the plain version), with c2r = +inf
    for a pad row (live False), whose discriminant then fails as a miss's
    does (csrc/sphere_hit.cu)."""
    c2r = (centers * centers).sum(-1) - radii * radii
    c2r = torch.where(live, c2r, torch.full_like(c2r, float("inf")))
    return torch.cat([centers, c2r[:, None]], dim=1).contiguous()


@functools.lru_cache(maxsize=None)
def _library():
    lib = cuda_build.load("sphere_hit")
    vp = ctypes.c_void_p
    lib.sphere_closest_hit_launch.argtypes = [
        vp, ctypes.c_int, vp, vp, ctypes.c_int, ctypes.c_float, vp, vp, vp]
    lib.sphere_closest_hit_launch.restype = ctypes.c_int
    lib.sphere_hit_error_string.argtypes = [ctypes.c_int]
    lib.sphere_hit_error_string.restype = ctypes.c_char_p
    return lib


def sphere_closest_hit(centers, radii, live_mask, ro, rd, t_min=1e-3):
    """Closest sphere hit per ray (see the module docstring)."""
    tensors = (centers, radii, live_mask, ro, rd)
    devices = {x.device for x in tensors}
    if len(devices) != 1:
        raise ValueError(f"sphere_closest_hit: tensors on {sorted(map(str, devices))}")
    dev = ro.device
    if dev.type == "cpu":
        return sphere_closest_hit_plain(centers, radii, live_mask, ro, rd,
                                        t_min)
    if dev.type != "cuda":
        raise ValueError(f"sphere_closest_hit: unsupported device {dev}")
    n, b = centers.shape[0], ro.shape[0]
    check = cuda_build.check_tensor
    check("centers", centers, torch.float32, (n, 3), dev)
    check("radii", radii, torch.float32, (n,), dev)
    check("live_mask", live_mask, torch.bool, (n,), dev)
    check("ro", ro, torch.float32, (b, 3), dev)
    check("rd", rd, torch.float32, (b, 3), dev)

    table = pack_table(centers, radii, live_mask)
    t = torch.empty(b, dtype=torch.float32, device=dev)
    pid = torch.empty(b, dtype=torch.int32, device=dev)
    if b == 0:
        return t, pid
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sphere_closest_hit_launch(
            table.data_ptr(), n, ro.data_ptr(), rd.data_ptr(), b,
            float(t_min), t.data_ptr(), pid.data_ptr(), stream)
    if rc != 0:
        msg = lib.sphere_hit_error_string(rc).decode()
        raise RuntimeError(f"sphere_closest_hit launch failed: {msg} ({rc})")
    sphere_closest_hit.launches += 1
    return t, pid


sphere_closest_hit.launches = 0
