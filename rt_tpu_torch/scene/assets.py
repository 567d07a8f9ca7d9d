"""Asset loaders: OBJ meshes, per-frame point clouds and image textures
(rt_tpu/scene/assets.py `readobj` / `readdynamic`, the equivalents of
taichi-version/main.py:23-54, and `load_image_texture`, the cv2 texture
load of taichi-version/hittable.py:165-172, converted to RGB floats
once)."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def readobj(path: str) -> Tuple[np.ndarray, List[List[int]], np.ndarray]:
    """Minimal OBJ reader: `v x y z`, `f i j k` (1-based; a `/` suffix is
    dropped), `vt u v`. Returns (vertices [V,3] f32, faces as lists of
    three 0-based indices, texture coordinates [T,2] f32)."""
    verts, faces, texids = [], [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(parts[1]), float(parts[2]),
                              float(parts[3])])
            elif parts[0] == "f":
                faces.append([int(p.split("/")[0]) - 1 for p in parts[1:4]])
            elif parts[0] == "vt":
                texids.append([float(parts[1]), float(parts[2])])
    return (np.asarray(verts, np.float32), faces,
            np.asarray(texids, np.float32) if texids else
            np.zeros((0, 2), np.float32))


def readdynamic(path: str) -> np.ndarray:
    """Per-frame point cloud: one `x y z` per line
    (taichi-version/main.py:43-54)."""
    pts = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 3:
                pts.append([float(parts[0]), float(parts[1]),
                            float(parts[2])])
    return np.asarray(pts, np.float32)


def load_image_texture(path: str) -> np.ndarray:
    """An image as [H,W,3] float32 RGB in [0,1] (u8 / 255), bit-equal to
    rt_tpu's. A PNG (by its magic bytes) goes through io/image.read_png;
    any other format (the reference's bricks2.png is a JPEG whatever its
    extension says) through Pillow, imported only then."""
    with open(path, "rb") as f:
        magic = f.read(8)
    if magic == b"\x89PNG\r\n\x1a\n":
        from rt_tpu_torch.io.image import read_png
        return read_png(path).astype(np.float32) / 255.0
    from PIL import Image  # JPEG et al.
    img = np.asarray(Image.open(path).convert("RGB"))
    return img.astype(np.float32) / 255.0
