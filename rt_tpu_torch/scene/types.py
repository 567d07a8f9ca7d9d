"""Scene representation: host-side builder + the device tables.

The port of rt_tpu/scene/types.py for the sphere slice. `SceneDef` is
the same host-side builder; `build_tables` freezes it into a
`SceneTables`, a dataclass of tensors with `.to(device)`. Field names,
dtypes and padding (`_pad_size`) are the reference's, so the two
packages' tables compare leaf by leaf (tests/test_torch_scene.py).

This slice carries the sphere, material and texture (solid, checker)
tables. Rects, cylinders, triangles, image textures and BVHs raise
NotImplementedError until their slices (ROADMAP Queue A-3, A-4, B2(b,c)).

Material type ids: 0=lambertian, 1=metal, 2=dielectric, 3=diffuse_light.
Texture type ids: 0=solid_color, 1=checker, 2=image.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rt_tpu_torch.ops import geometry as geom

MAT_LAMBERTIAN = 0
MAT_METAL = 1
MAT_DIELECTRIC = 2
MAT_DIFFUSE_LIGHT = 3

TEX_SOLID = 0
TEX_CHECKER = 1
TEX_IMAGE = 2


def _pad_size(n: int, minimum: int = 4) -> int:
    """Next power of two >= max(n, minimum) (rt_tpu/scene/types.py:48)."""
    m = max(n, minimum)
    return 1 << (m - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class CameraDef:
    """Precomputed thin-lens camera frame (gpu-version/camera.cuh:7-48)."""

    origin: torch.Tensor        # [3]
    lower_left: torch.Tensor    # [3]
    horizontal: torch.Tensor    # [3]
    vertical: torch.Tensor      # [3]
    u: torch.Tensor             # [3]
    v: torch.Tensor             # [3]
    lens_radius: torch.Tensor   # []

    def to(self, device) -> "CameraDef":
        return CameraDef(**{f.name: getattr(self, f.name).to(device)
                            for f in dataclasses.fields(self)})


def make_camera(
    lookfrom: Sequence[float],
    lookat: Sequence[float],
    vup: Sequence[float],
    vfov_deg: float,
    aspect_ratio: float,
    aperture: float,
    focus_dist: Optional[float] = None,
) -> CameraDef:
    """Camera constructor per gpu-version/camera.cuh:9-28, in the same
    NumPy float32 arithmetic as the reference, on the CPU."""
    lookfrom = np.asarray(lookfrom, dtype=np.float32)
    lookat = np.asarray(lookat, dtype=np.float32)
    vup = np.asarray(vup, dtype=np.float32)
    if focus_dist is None:
        focus_dist = float(np.linalg.norm(lookfrom - lookat))
    theta = geom.degrees_to_radians(float(vfov_deg))
    h = np.tan(theta / 2.0)
    viewport_height = 2.0 * h
    viewport_width = aspect_ratio * viewport_height

    w = lookfrom - lookat
    w = w / np.linalg.norm(w)
    u = np.cross(vup, w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)

    origin = lookfrom
    horizontal = np.float32(focus_dist * viewport_width) * u
    vertical = np.float32(focus_dist * viewport_height) * v
    lower_left = origin - horizontal / 2 - vertical / 2 - np.float32(focus_dist) * w

    def t(x):
        return torch.from_numpy(np.array(x, np.float32))

    return CameraDef(origin=t(origin), lower_left=t(lower_left),
                     horizontal=t(horizontal), vertical=t(vertical),
                     u=t(u), v=t(v), lens_radius=t(aperture / 2.0))


@dataclasses.dataclass(frozen=True)
class SceneTables:
    """Device-ready SoA scene. Every table is padded to a power-of-two
    length; pad sphere rows have obj index -1 and never produce hits.
    `n_spheres` (the live sphere count) is host metadata, not a leaf."""

    sph_center: torch.Tensor   # [Ns,3] f32
    sph_radius: torch.Tensor   # [Ns] f32
    sph_mat: torch.Tensor      # [Ns] i32
    sph_obj: torch.Tensor      # [Ns] i32, -1 = pad

    mat_type: torch.Tensor     # [Nm] i32
    mat_albedo: torch.Tensor   # [Nm,3] f32
    mat_fuzz: torch.Tensor     # [Nm] f32
    mat_ior: torch.Tensor      # [Nm] f32
    mat_tex: torch.Tensor      # [Nm] i32 texture id; -1 -> use mat_albedo

    tex_type: torch.Tensor     # [Nx] i32
    tex_color: torch.Tensor    # [Nx,3] f32 solid value / checker even
    tex_color2: torch.Tensor   # [Nx,3] f32 checker odd

    camera: CameraDef
    background: torch.Tensor   # [3] f32

    n_spheres: int = 0

    def to(self, device) -> "SceneTables":
        kw = {}
        for f in dataclasses.fields(self):
            val = getattr(self, f.name)
            kw[f.name] = (val.to(device) if isinstance(val, (torch.Tensor,
                                                            CameraDef))
                          else val)
        return SceneTables(**kw)

    @functools.cached_property
    def mega(self):
        """The packed form the megakernels read (ops/mega_tables
        MegaScene), built at first use and kept with these tables."""
        from rt_tpu_torch.ops.mega_tables import MegaScene

        return MegaScene.of(self)

    def leaves(self) -> Dict[str, torch.Tensor]:
        """Every tensor by name; camera fields as 'camera.<field>'."""
        out = {}
        for f in dataclasses.fields(self):
            val = getattr(self, f.name)
            if isinstance(val, CameraDef):
                for cf in dataclasses.fields(val):
                    out[f"camera.{cf.name}"] = getattr(val, cf.name)
            elif isinstance(val, torch.Tensor):
                out[f.name] = val
        return out


@dataclasses.dataclass
class SceneDef:
    """Host-side mutable scene under construction (rt_tpu/scene/types.py
    SceneDef, with the builders this slice's scenes use). Call
    build_tables() to freeze."""

    width: int = 400
    height: int = 225
    samples_per_pixel: int = 16
    max_depth: int = 8
    background: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    output_file: str = "main.png"
    camera: Optional[CameraDef] = None

    objects: List[dict] = dataclasses.field(default_factory=list)
    materials: List[dict] = dataclasses.field(default_factory=list)
    textures: List[dict] = dataclasses.field(default_factory=list)
    camera_params: Optional[dict] = None

    def add_sphere(self, center, radius, material: int) -> int:
        self.objects.append(
            {"type": "sphere", "center": list(map(float, center)),
             "radius": float(radius), "material": int(material)})
        return len(self.objects) - 1

    def add_lambertian(self, texture: int) -> int:
        self.materials.append({"type": "lambertian", "texture": int(texture)})
        return len(self.materials) - 1

    def add_lambertian_color(self, color) -> int:
        return self.add_lambertian(self.add_solid_color(color))

    def add_metal(self, albedo, fuzz: float) -> int:
        self.materials.append(
            {"type": "metal", "albedo": list(map(float, albedo)),
             "fuzz": float(fuzz)})
        return len(self.materials) - 1

    def add_dielectric(self, ior: float) -> int:
        self.materials.append(
            {"type": "dielectric", "index_of_refraction": float(ior)})
        return len(self.materials) - 1

    def add_diffuse_light(self, texture: int) -> int:
        self.materials.append({"type": "diffuse_light",
                               "texture": int(texture)})
        return len(self.materials) - 1

    def add_diffuse_light_color(self, color) -> int:
        return self.add_diffuse_light(self.add_solid_color(color))

    def add_solid_color(self, color) -> int:
        self.textures.append(
            {"type": "solid_color", "color": list(map(float, color))})
        return len(self.textures) - 1

    def add_checker(self, even, odd) -> int:
        self.textures.append(
            {"type": "checker", "even": list(map(float, even)),
             "odd": list(map(float, odd))})
        return len(self.textures) - 1

    def set_camera(self, lookfrom, lookat, vup, vfov_deg, aperture,
                   focus_dist=None):
        self.camera_params = {
            "lookfrom": list(map(float, lookfrom)),
            "lookat": list(map(float, lookat)),
            "vup": list(map(float, vup)),
            "vfov": float(vfov_deg),
            "aperture": float(aperture),
        }
        if focus_dist is not None:
            self.camera_params["focus_dist"] = float(focus_dist)
        self.camera = make_camera(
            lookfrom, lookat, vup, vfov_deg,
            self.width / self.height, aperture, focus_dist)

    def resize(self, width=None, height=None):
        """Change image dimensions and re-derive the camera frame for the
        new aspect ratio (rt_tpu SceneDef.resize)."""
        if width:
            self.width = int(width)
        if height:
            self.height = int(height)
        if self.camera_params is not None:
            p = self.camera_params
            self.set_camera(p["lookfrom"], p["lookat"], p["vup"],
                            p["vfov"], p["aperture"], p.get("focus_dist"))


def build_tables(s: SceneDef, device="cpu") -> SceneTables:
    """Freeze a SceneDef into padded tables on `device`."""
    if s.camera is None:
        raise ValueError("scene has no camera")

    sph = []
    for idx, obj in enumerate(s.objects):
        if obj["type"] != "sphere":
            raise NotImplementedError(
                f"object type {obj['type']!r}: only spheres are ported yet "
                "(ROADMAP Queue A-3)")
        sph.append((obj["center"], obj["radius"], obj["material"], idx))

    f32, i32 = np.float32, np.int32
    ns = _pad_size(len(sph))
    sph_center = np.zeros((ns, 3), f32)
    sph_radius = np.zeros(ns, f32)
    sph_mat = np.zeros(ns, i32)
    sph_obj = np.full(ns, -1, i32)
    for i, (center, radius, mat, idx) in enumerate(sph):
        sph_center[i] = np.asarray(center, f32)
        sph_radius[i] = radius
        sph_mat[i] = mat
        sph_obj[i] = idx

    nm = _pad_size(len(s.materials))
    mat_type = np.zeros(nm, i32)
    mat_albedo = np.zeros((nm, 3), f32)
    mat_fuzz = np.zeros(nm, f32)
    mat_ior = np.ones(nm, f32)
    mat_tex = np.full(nm, -1, i32)
    for i, m in enumerate(s.materials):
        kind = m["type"]
        if kind == "lambertian":
            mat_type[i] = MAT_LAMBERTIAN
            mat_tex[i] = m["texture"]
        elif kind == "metal":
            mat_type[i] = MAT_METAL
            mat_albedo[i] = m["albedo"]
            # fuzz clamped to <=1 at construction (material.cuh:60-61)
            mat_fuzz[i] = min(m["fuzz"], 1.0)
        elif kind == "dielectric":
            mat_type[i] = MAT_DIELECTRIC
            mat_ior[i] = m["index_of_refraction"]
            mat_albedo[i] = (1.0, 1.0, 1.0)
        elif kind == "diffuse_light":
            mat_type[i] = MAT_DIFFUSE_LIGHT
            mat_tex[i] = m["texture"]
        else:
            raise ValueError(f"unknown material type: {kind}")

    nx = _pad_size(len(s.textures))
    tex_type = np.zeros(nx, i32)
    tex_color = np.zeros((nx, 3), f32)
    tex_color2 = np.zeros((nx, 3), f32)
    for i, t in enumerate(s.textures):
        kind = t["type"]
        if kind == "solid_color":
            tex_type[i] = TEX_SOLID
            tex_color[i] = t["color"]
        elif kind == "checker":
            tex_type[i] = TEX_CHECKER
            tex_color[i] = t["even"]
            tex_color2[i] = t["odd"]
        elif kind == "image":
            raise NotImplementedError(
                "image textures are not ported yet (ROADMAP Queue A-4, B2(c))")
        else:
            raise ValueError(f"unknown texture type: {kind}")

    def t(x):
        return torch.from_numpy(x).to(device)

    return SceneTables(
        sph_center=t(sph_center), sph_radius=t(sph_radius),
        sph_mat=t(sph_mat), sph_obj=t(sph_obj),
        mat_type=t(mat_type), mat_albedo=t(mat_albedo),
        mat_fuzz=t(mat_fuzz), mat_ior=t(mat_ior), mat_tex=t(mat_tex),
        tex_type=t(tex_type), tex_color=t(tex_color),
        tex_color2=t(tex_color2),
        camera=s.camera.to(device),
        background=t(np.asarray(s.background, f32)),
        n_spheres=len(sph),
    )
