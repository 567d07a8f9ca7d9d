"""Camera ray generation (rt_tpu/ops/camera.py:54-82,
gpu-version/camera.cuh:31-39), with the thin-lens defocus of the
CPU/Taichi versions (cmake-cpu-version/camera.h:33-37).

`make_camera` builds the frame from a raw pose, differentiably.
`generate_rays` is the plain form of every engine's camera rays and of
the regeneration kernel's in-kernel `camera_ray` (csrc/camera.cuh),
which repeats its expressions in its order, so the two agree bit for bit
on the card. `camera_vec` flattens the camera to the 19 floats that
kernel takes."""

from __future__ import annotations

import math
from typing import Tuple

import torch

from rt_tpu_torch.ops import rng
from rt_tpu_torch.scene.types import CameraDef

# the fields of camera_vec, in order (pallas_mega.camera_vec :3205)
CAMERA_FIELDS = ("origin", "lower_left", "horizontal", "vertical", "u", "v",
                 "lens_radius")


def make_camera(lookfrom, lookat, vup, vfov_deg, aspect_ratio, aperture,
                focus_dist=None) -> CameraDef:
    """The thin-lens frame from a raw pose (rt_tpu/ops/camera.py
    `make_camera_jnp` :18, gpu-version/camera.cuh:9-28) in float32 torch
    arithmetic, differentiable in every tensor argument, so a camera
    POSE can be optimized (diff/inverse.fit_camera); the host builder
    scene/types.make_camera stays NumPy. Arguments are tensors, arrays
    or numbers; the frame lands on lookfrom's device (the CPU for
    non-tensors)."""
    dev = lookfrom.device if isinstance(lookfrom, torch.Tensor) else "cpu"

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    lookfrom, lookat, vup = f32(lookfrom), f32(lookat), f32(vup)
    if focus_dist is None:
        focus_dist = torch.linalg.vector_norm(lookfrom - lookat)
    focus_dist = f32(focus_dist)
    theta = f32(vfov_deg) * (math.pi / 180.0)
    h = torch.tan(theta / 2.0)
    viewport_height = 2.0 * h
    viewport_width = aspect_ratio * viewport_height

    w = lookfrom - lookat
    w = w / torch.linalg.vector_norm(w)
    u = torch.linalg.cross(vup, w)
    u = u / torch.linalg.vector_norm(u)
    v = torch.linalg.cross(w, u)

    origin = lookfrom
    horizontal = focus_dist * viewport_width * u
    vertical = focus_dist * viewport_height * v
    lower_left = origin - horizontal / 2 - vertical / 2 - focus_dist * w
    return CameraDef(origin=origin, lower_left=lower_left,
                     horizontal=horizontal, vertical=vertical, u=u, v=v,
                     lens_radius=f32(aperture) / 2.0)


def camera_vec(cam: CameraDef) -> Tuple[float, ...]:
    """The camera frame as 19 host floats: origin, lower_left,
    horizontal, vertical, u, v (3 each) and lens_radius. Each is a
    float32 value exactly."""
    out = []
    for name in CAMERA_FIELDS:
        out += getattr(cam, name).detach().to("cpu", torch.float32) \
            .reshape(-1).tolist()
    return tuple(float(v) for v in out)


def camera_of_vec(vec, device) -> CameraDef:
    """The CameraDef of camera_vec's 19 floats, on `device`."""
    t = torch.tensor(vec, dtype=torch.float32, device=device)
    return CameraDef(origin=t[0:3], lower_left=t[3:6], horizontal=t[6:9],
                     vertical=t[9:12], u=t[12:15], v=t[15:18],
                     lens_radius=t[18])


def _divisor(n: int, device) -> torch.Tensor:
    """float((n - 1) or 1) as a 0-d float32 tensor on device."""
    return torch.full((), float((n - 1) or 1), dtype=torch.float32,
                      device=device)


def generate_rays(cam: CameraDef, width, height, px, py, sample_idx, seed,
                  enable_defocus: bool, sampler: str = "rng"):
    """px, py: [B] integer pixel coords (x right, y up from bottom);
    sample_idx: one sample index, or one per lane ([B] integer tensor).
    sampler: "rng" or "qmc" (rng.resolve). Returns (ro [B,3], rd [B,3])
    on px's device."""
    smp = rng.resolve(sampler)
    pixel = py.to(torch.int64) * width + px.to(torch.int64)
    ru = smp.uniform(seed, pixel, sample_idx, 0, rng.PIXEL_U)
    rv = smp.uniform(seed, pixel, sample_idx, 0, rng.PIXEL_V)
    # ((w-1) or 1): a 1-pixel-wide/tall frame would divide by zero. The
    # divisors are device tensors: torch divides a CUDA tensor by a
    # Python number as a product with its float32 reciprocal, which
    # rounds otherwise than the division the CPU and the kernels do.
    s = (px.to(torch.float32) + ru) / _divisor(width, px.device)
    t = (py.to(torch.float32) + rv) / _divisor(height, px.device)

    if enable_defocus:
        disk = smp.in_unit_disk(seed, pixel, sample_idx, 0)
        rd_lens = cam.lens_radius * disk
        offset = (cam.u[None, :] * rd_lens[:, :1]
                  + cam.v[None, :] * rd_lens[:, 1:2])
    else:
        offset = torch.zeros((px.shape[0], 3), dtype=torch.float32,
                             device=px.device)

    origin = cam.origin[None, :] + offset
    direction = (cam.lower_left[None, :]
                 + s[:, None] * cam.horizontal[None, :]
                 + t[:, None] * cam.vertical[None, :]
                 - cam.origin[None, :] - offset)
    return origin, direction
