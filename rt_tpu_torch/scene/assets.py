"""Asset loaders: OBJ meshes and per-frame point clouds
(rt_tpu/scene/assets.py `readobj` / `readdynamic`, the equivalents of
taichi-version/main.py:23-54). Image loading comes with image textures
(ROADMAP Queue B2(c))."""

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
