"""Scene representation: host-side builder + the device tables.

The port of rt_tpu/scene/types.py. `SceneDef` is the same host-side
builder; `build_tables` freezes it into a `SceneTables`, a dataclass of
tensors with `.to(device)`. Field names, dtypes and padding (`_pad_size`)
are the reference's, so the two packages' tables compare leaf by leaf
(tests/test_torch_scene.py, tests/test_torch_parser.py).

The tables carry the four primitive families (spheres, axis-aligned
rects, cylinders, triangles), the materials, the solid, checker and
image textures (the image atlas: every image of a scene shares one
size), the emissive-primitive index and the threaded BVHs of the
families that ask for one (`build_tables(..., bvh_types=...)`, walked
under RenderConfig(traversal="bvh"); accel/bvh.py).

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

# rect axis convention: the constant coordinate's axis index.
# yz_rect -> 0 (x=k), xz_rect -> 1 (y=k), xy_rect -> 2 (z=k)
RECT_YZ = 0
RECT_XZ = 1
RECT_XY = 2

# the families' names, in family order (rt_tpu's img_on names)
FAMILY_NAMES = ("sphere", "rect", "cylinder", "triangle")


# the families that may carry a BVH: (name, field prefix), in the order
# rt_tpu's build_tables builds them (its bvh_for order)
BVH_FAMILIES = (("sphere", "sph"), ("triangle", "tri"), ("rect", "rect"),
                ("cylinder", "cyl"))
# the suffixes of a family's five BVH fields, in accel/bvh.BVH's order
BVH_KEYS = ("obj", "left", "next", "min", "max")


def _dummy_bvh():
    """The one-node arrays of an absent BVH (obj, left, next, min, max),
    rt_tpu's dummies."""
    return (torch.zeros(1, dtype=torch.int32),
            torch.full((1,), -1, dtype=torch.int32),
            torch.full((1,), -1, dtype=torch.int32),
            torch.zeros((1, 3), dtype=torch.float32),
            torch.zeros((1, 3), dtype=torch.float32))


def _bvh_field(i: int):
    """A SceneTables BVH field whose default is the dummy's array i."""
    return dataclasses.field(default_factory=lambda: _dummy_bvh()[i])


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
        """The camera on device; self when every field is there already."""
        kw = {f.name: getattr(self, f.name).to(device)
              for f in dataclasses.fields(self)}
        if all(v is getattr(self, k) for k, v in kw.items()):
            return self
        return CameraDef(**kw)


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
    length; pad rows have obj index -1 and never produce hits.
    `counts` (the live rows of each family) and `n_lights` are host
    metadata, not leaves."""

    # spheres (object.cuh:40-94)
    sph_center: torch.Tensor   # [Ns,3] f32
    sph_radius: torch.Tensor   # [Ns] f32
    sph_mat: torch.Tensor      # [Ns] i32
    sph_obj: torch.Tensor      # [Ns] i32, -1 = pad

    # axis-aligned rects (object.cuh:96-197), unified across xy/xz/yz
    rect_axis: torch.Tensor    # [Nr] i32 (constant axis)
    rect_lo: torch.Tensor      # [Nr,2] (a0,b0) in free-axis order
    rect_hi: torch.Tensor      # [Nr,2] (a1,b1)
    rect_k: torch.Tensor       # [Nr] f32
    rect_mat: torch.Tensor     # [Nr] i32
    rect_obj: torch.Tensor     # [Nr] i32

    # cylinders (object.cuh:216-297)
    cyl_radius: torch.Tensor   # [Nc] f32
    cyl_zmin: torch.Tensor     # [Nc] f32
    cyl_zmax: torch.Tensor     # [Nc] f32
    cyl_o2w: torch.Tensor      # [Nc,4,4] f32
    cyl_w2o: torch.Tensor      # [Nc,4,4] f32, the cached inverse
    cyl_mat: torch.Tensor      # [Nc] i32
    cyl_obj: torch.Tensor      # [Nc] i32

    # triangles (taichi-version/hittable.py:38-71,92-114)
    tri_v1: torch.Tensor       # [Nt,3] f32
    tri_v2: torch.Tensor       # [Nt,3] f32
    tri_v3: torch.Tensor       # [Nt,3] f32
    tri_uv1: torch.Tensor      # [Nt,2] f32
    tri_uv2: torch.Tensor      # [Nt,2] f32
    tri_uv3: torch.Tensor      # [Nt,2] f32
    tri_n: torch.Tensor        # [Nt,3] f32 unit geometric normal
    tri_mat: torch.Tensor      # [Nt] i32
    tri_obj: torch.Tensor      # [Nt] i32

    mat_type: torch.Tensor     # [Nm] i32
    mat_albedo: torch.Tensor   # [Nm,3] f32
    mat_fuzz: torch.Tensor     # [Nm] f32
    mat_ior: torch.Tensor      # [Nm] f32
    mat_tex: torch.Tensor      # [Nm] i32 texture id; -1 -> use mat_albedo

    tex_type: torch.Tensor     # [Nx] i32
    tex_color: torch.Tensor    # [Nx,3] f32 solid value / checker even
    tex_color2: torch.Tensor   # [Nx,3] f32 checker odd
    tex_image: torch.Tensor    # [Nx] i32 index into images, -1 if none
    images: torch.Tensor       # [Ni,TH,TW,3] f32 RGB in [0,1]; one
                               # [1,1,1,3] zero image when none

    camera: CameraDef
    background: torch.Tensor   # [3] f32

    # emissive-primitive index (rt_tpu's): family code (ops/intersect
    # PTYPE_*) and row of every live emissive primitive, the lights NEE
    # samples (render/integrator._nee_direct, ops/mega_tables
    # light_table); one dummy entry when none
    light_fam: torch.Tensor    # [max(n_lights, 1)] i32
    light_pid: torch.Tensor    # [max(n_lights, 1)] i32

    # threaded BVHs over the live rows of each family (accel/bvh.py,
    # rt_tpu/scene/types.py:176-216): dummy one-node arrays when absent;
    # `bvh_for` says which are real
    sph_bvh_obj: torch.Tensor = _bvh_field(0)
    sph_bvh_left: torch.Tensor = _bvh_field(1)
    sph_bvh_next: torch.Tensor = _bvh_field(2)
    sph_bvh_min: torch.Tensor = _bvh_field(3)
    sph_bvh_max: torch.Tensor = _bvh_field(4)
    tri_bvh_obj: torch.Tensor = _bvh_field(0)
    tri_bvh_left: torch.Tensor = _bvh_field(1)
    tri_bvh_next: torch.Tensor = _bvh_field(2)
    tri_bvh_min: torch.Tensor = _bvh_field(3)
    tri_bvh_max: torch.Tensor = _bvh_field(4)
    rect_bvh_obj: torch.Tensor = _bvh_field(0)
    rect_bvh_left: torch.Tensor = _bvh_field(1)
    rect_bvh_next: torch.Tensor = _bvh_field(2)
    rect_bvh_min: torch.Tensor = _bvh_field(3)
    rect_bvh_max: torch.Tensor = _bvh_field(4)
    cyl_bvh_obj: torch.Tensor = _bvh_field(0)
    cyl_bvh_left: torch.Tensor = _bvh_field(1)
    cyl_bvh_next: torch.Tensor = _bvh_field(2)
    cyl_bvh_min: torch.Tensor = _bvh_field(3)
    cyl_bvh_max: torch.Tensor = _bvh_field(4)

    # (n_spheres, n_rects, n_cylinders, n_triangles)
    counts: Tuple[int, int, int, int] = (0, 0, 0, 0)
    n_lights: int = 0
    # the families whose live rows' materials sample an image texture
    # (names of FAMILY_NAMES, sorted), and whether a light's emission is
    # one (rt_tpu's static img_on / nee_img; image_usage)
    img_on: Tuple[str, ...] = ()
    nee_img: bool = False
    # the families that carry a real BVH, in rt_tpu's build order
    # (BVH_FAMILIES), e.g. ("triangle",)
    bvh_for: Tuple[str, ...] = ()

    @property
    def n_spheres(self) -> int:
        return self.counts[0]

    @property
    def has_families(self) -> bool:
        """A live rect, cylinder or triangle row."""
        return any(self.counts[1:])

    @property
    def has_images(self) -> bool:
        """A live primitive samples an image texture."""
        return bool(self.img_on)

    def to(self, device) -> "SceneTables":
        """The tables on device. When every tensor is there already this
        is self, so the packs cached on it (`mega`, `mega_culled`) serve
        every render of the same tables."""
        kw = {}
        for f in dataclasses.fields(self):
            val = getattr(self, f.name)
            kw[f.name] = (val.to(device) if isinstance(val, (torch.Tensor,
                                                            CameraDef))
                          else val)
        if all(v is getattr(self, k) for k, v in kw.items()):
            return self
        return SceneTables(**kw)

    @functools.cached_property
    def mega(self):
        """The packed form the megakernels read (ops/mega_tables
        MegaScene), built at first use and kept with these tables."""
        from rt_tpu_torch.ops.mega_tables import MegaScene

        return MegaScene.of(self)

    @functools.cached_property
    def mega_culled(self):
        """The megakernels' tables with chunk culling (MegaScene.of with
        cull=True: the Morton-sorted rows and their chunk boxes), built
        at first use and kept with these tables."""
        from rt_tpu_torch.ops.mega_tables import MegaScene

        return MegaScene.of(self, cull=True)

    def family_boxes(self, name: str):
        """(bmin, bmax) [n,3] NumPy float32: the boxes of the n live rows
        of family `name` (FAMILY_NAMES), what its BVH is built over
        (rt_tpu's per-family aabbs; a rect padded by 1e-4 on its axis)."""
        from rt_tpu_torch.accel import bvh

        n = self.counts[FAMILY_NAMES.index(name)]

        def rows(field):
            return getattr(self, field)[:n].cpu().numpy()

        if name == "sphere":
            return bvh.sphere_aabbs(rows("sph_center"), rows("sph_radius"))
        if name == "triangle":
            return bvh.triangle_aabbs(rows("tri_v1"), rows("tri_v2"),
                                      rows("tri_v3"))
        if name == "rect":
            return bvh.rect_aabbs(rows("rect_axis"), rows("rect_lo"),
                                  rows("rect_hi"), rows("rect_k"))
        return bvh.cylinder_aabbs(rows("cyl_radius"), rows("cyl_zmin"),
                                  rows("cyl_zmax"), rows("cyl_o2w"))

    def bvh_arrays(self, prefix: str) -> Dict[str, torch.Tensor]:
        """The BVH of family `prefix` (sph, tri, rect, cyl) as the dict
        accel/bvh.traverse walks."""
        return {k: getattr(self, f"{prefix}_bvh_{n}") for k, n in zip(
            ("obj_id", "left_id", "next_id", "bmin", "bmax"), BVH_KEYS)}

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
    SceneDef). Call build_tables() to freeze."""

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
    images: List[np.ndarray] = dataclasses.field(default_factory=list)
    camera_params: Optional[dict] = None

    # the Taichi reference's swapped triangle-UV weights
    # (taichi-version/hittable.py:57-60, 233), opt-in: build_tables
    # swaps the uv1 / uv3 columns (see rt_tpu's SceneDef.taichi_tri_uv)
    taichi_tri_uv: bool = False

    def add_sphere(self, center, radius, material: int) -> int:
        self.objects.append(
            {"type": "sphere", "center": list(map(float, center)),
             "radius": float(radius), "material": int(material)})
        return len(self.objects) - 1

    def add_rect(self, kind: str, a0, a1, b0, b1, k, material: int) -> int:
        assert kind in ("xy_rect", "xz_rect", "yz_rect")
        names = {"xy_rect": ("x0", "x1", "y0", "y1"),
                 "xz_rect": ("x0", "x1", "z0", "z1"),
                 "yz_rect": ("y0", "y1", "z0", "z1")}[kind]
        self.objects.append(
            {"type": kind, names[0]: float(a0), names[1]: float(a1),
             names[2]: float(b0), names[3]: float(b1), "k": float(k),
             "material": int(material)})
        return len(self.objects) - 1

    def add_cylinder(self, radius, zmin, zmax, material: int,
                     rotate=None, translate=None) -> int:
        obj = {"type": "cylinder", "radius": float(radius),
               "zmin": float(zmin), "zmax": float(zmax),
               "material": int(material)}
        if rotate is not None:
            axis, angle_deg = rotate
            obj["rotate"] = {"axis": list(map(float, axis)),
                             "angle": float(angle_deg)}
        if translate is not None:
            obj["translate"] = list(map(float, translate))
        self.objects.append(obj)
        return len(self.objects) - 1

    def add_triangle(self, v1, v2, v3, material: int,
                     uv1=(0.0, 0.0), uv2=(0.0, 0.0), uv3=(0.0, 0.0)) -> int:
        self.objects.append(
            {"type": "triangle",
             "v1": list(map(float, v1)), "v2": list(map(float, v2)),
             "v3": list(map(float, v3)),
             "uv1": list(map(float, uv1)), "uv2": list(map(float, uv2)),
             "uv3": list(map(float, uv3)), "material": int(material)})
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

    def add_image_texture(self, image_rgb) -> int:
        """image_rgb: [H,W,3] float RGB in [0,1] (scene/assets.
        load_image_texture); u indexes its first axis, v its second."""
        self.images.append(np.asarray(image_rgb, dtype=np.float32))
        self.textures.append({"type": "image",
                              "image": len(self.images) - 1})
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


def _cylinder_o2w(obj: dict) -> Tuple[np.ndarray, np.ndarray]:
    """o2w = translate * rotate * identity: the parser applies rotate
    first, then translate (parser.hpp:423-440), each left-multiplied
    (object.cuh:225-231)."""
    t = geom.identity_transform()
    if "rotate" in obj:
        axis = obj["rotate"]["axis"]
        rad = geom.degrees_to_radians(obj["rotate"]["angle"])
        t = geom.compose(geom.rotate(axis, rad), t)
    if "translate" in obj:
        t = geom.compose(geom.translate(obj["translate"]), t)
    return t


def _padded(rows, columns):
    """One [pad, ...] array per column spec (build, shape, dtype, fill)
    over the rows, padded with fill to _pad_size rows."""
    n = _pad_size(len(rows))
    outs = []
    for build, shape, dtype, fill in columns:
        arr = np.full((n,) + shape, fill, dtype=dtype)
        for i, row in enumerate(rows):
            arr[i] = build(row)
        outs.append(arr)
    return outs


def build_tables(s: SceneDef, device="cpu", *,
                 bvh_types: Sequence[str] = ()) -> SceneTables:
    """Freeze a SceneDef into padded tables on `device`. bvh_types names
    the families (sphere, triangle, rect, cylinder) whose live rows get a
    threaded BVH, built on the host (accel/bvh.build_bvh), as rt_tpu's
    build_tables does (types.py:584-626); a family without rows gets
    none."""
    unknown = set(bvh_types) - {name for name, _ in BVH_FAMILIES}
    if unknown:
        raise ValueError(f"unknown bvh_types {sorted(unknown)} (want among "
                         f"{[name for name, _ in BVH_FAMILIES]})")
    if s.camera is None:
        raise ValueError("scene has no camera")

    sph, rect, cyl, tri = [], [], [], []
    for idx, obj in enumerate(s.objects):
        kind = obj["type"]
        if kind == "sphere":
            sph.append((obj["center"], obj["radius"], obj["material"], idx))
        elif kind in ("xy_rect", "xz_rect", "yz_rect"):
            if kind == "xy_rect":
                axis, lo, hi = (RECT_XY, (obj["x0"], obj["y0"]),
                                (obj["x1"], obj["y1"]))
            elif kind == "xz_rect":
                axis, lo, hi = (RECT_XZ, (obj["x0"], obj["z0"]),
                                (obj["x1"], obj["z1"]))
            else:
                axis, lo, hi = (RECT_YZ, (obj["y0"], obj["z0"]),
                                (obj["y1"], obj["z1"]))
            rect.append((axis, lo, hi, obj["k"], obj["material"], idx))
        elif kind == "cylinder":
            m, minv = _cylinder_o2w(obj)
            cyl.append((obj["radius"], obj["zmin"], obj["zmax"], m, minv,
                        obj["material"], idx))
        elif kind == "triangle":
            v1 = np.asarray(obj["v1"], np.float32)
            v2 = np.asarray(obj["v2"], np.float32)
            v3 = np.asarray(obj["v3"], np.float32)
            n = np.cross(v2 - v1, v3 - v1)
            n = (n / np.linalg.norm(n)).astype(np.float32)
            uv1, uv3 = obj["uv1"], obj["uv3"]
            if s.taichi_tri_uv:  # the reference's w1 / w3 quirk
                uv1, uv3 = uv3, uv1
            tri.append((v1, v2, v3, uv1, obj["uv2"], uv3, n,
                        obj["material"], idx))
        else:
            raise ValueError(f"unknown object type: {kind}")

    f32, i32 = np.float32, np.int32
    sph_center, sph_radius, sph_mat, sph_obj = _padded(sph, [
        (lambda r: np.asarray(r[0], f32), (3,), f32, 0.0),
        (lambda r: r[1], (), f32, 0.0),
        (lambda r: r[2], (), i32, 0),
        (lambda r: r[3], (), i32, -1),
    ])
    rect_axis, rect_lo, rect_hi, rect_k, rect_mat, rect_obj = _padded(rect, [
        (lambda r: r[0], (), i32, 0),
        (lambda r: np.asarray(r[1], f32), (2,), f32, 0.0),
        (lambda r: np.asarray(r[2], f32), (2,), f32, 0.0),
        (lambda r: r[3], (), f32, 0.0),
        (lambda r: r[4], (), i32, 0),
        (lambda r: r[5], (), i32, -1),
    ])
    (cyl_radius, cyl_zmin, cyl_zmax, cyl_o2w, cyl_w2o, cyl_mat,
     cyl_obj) = _padded(cyl, [
        (lambda r: r[0], (), f32, 0.0),
        (lambda r: r[1], (), f32, 0.0),
        (lambda r: r[2], (), f32, 0.0),
        (lambda r: r[3], (4, 4), f32, np.eye(4, dtype=f32)),
        (lambda r: r[4], (4, 4), f32, np.eye(4, dtype=f32)),
        (lambda r: r[5], (), i32, 0),
        (lambda r: r[6], (), i32, -1),
    ])
    (tri_v1, tri_v2, tri_v3, tri_uv1, tri_uv2, tri_uv3, tri_n, tri_mat,
     tri_obj) = _padded(tri, [
        (lambda r: r[0], (3,), f32, 0.0),
        (lambda r: r[1], (3,), f32, 0.0),
        (lambda r: r[2], (3,), f32, 0.0),
        (lambda r: np.asarray(r[3], f32), (2,), f32, 0.0),
        (lambda r: np.asarray(r[4], f32), (2,), f32, 0.0),
        (lambda r: np.asarray(r[5], f32), (2,), f32, 0.0),
        (lambda r: r[6], (3,), f32, np.array([0, 0, 1], f32)),
        (lambda r: r[7], (), i32, 0),
        (lambda r: r[8], (), i32, -1),
    ])

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
    tex_image = np.full(nx, -1, i32)
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
            tex_type[i] = TEX_IMAGE
            tex_image[i] = t["image"]
        else:
            raise ValueError(f"unknown texture type: {kind}")

    if s.images:
        th, tw = s.images[0].shape[:2]
        for img in s.images:
            if img.shape[:2] != (th, tw):
                raise ValueError("all image textures must share one size")
        images = np.stack(s.images).astype(f32)
    else:
        images = np.zeros((1, 1, 1, 3), f32)

    # the emissive-primitive index (rt_tpu/scene/types.py:639-672): the
    # live emissive rows of the four families, in family order
    l_fam, l_pid = [], []
    for fam, (mids, oids) in enumerate(
            ((sph_mat, sph_obj), (rect_mat, rect_obj),
             (cyl_mat, cyl_obj), (tri_mat, tri_obj))):
        emits = (oids >= 0) & (mat_type[mids] == MAT_DIFFUSE_LIGHT)
        for r in np.nonzero(emits)[0]:
            l_fam.append(fam)
            l_pid.append(int(r))
    n_lights = len(l_fam)
    light_fam = np.asarray(l_fam if n_lights else [0], i32)
    light_pid = np.asarray(l_pid if n_lights else [0], i32)
    img_on, nee_img = image_usage(
        tex_type, mat_tex, ((sph_mat, sph_obj), (rect_mat, rect_obj),
                            (cyl_mat, cyl_obj), (tri_mat, tri_obj)),
        light_fam[:n_lights], light_pid[:n_lights])

    def t(x):
        return torch.from_numpy(x).to(device)

    tables = SceneTables(
        sph_center=t(sph_center), sph_radius=t(sph_radius),
        sph_mat=t(sph_mat), sph_obj=t(sph_obj),
        rect_axis=t(rect_axis), rect_lo=t(rect_lo), rect_hi=t(rect_hi),
        rect_k=t(rect_k), rect_mat=t(rect_mat), rect_obj=t(rect_obj),
        cyl_radius=t(cyl_radius), cyl_zmin=t(cyl_zmin),
        cyl_zmax=t(cyl_zmax), cyl_o2w=t(cyl_o2w), cyl_w2o=t(cyl_w2o),
        cyl_mat=t(cyl_mat), cyl_obj=t(cyl_obj),
        tri_v1=t(tri_v1), tri_v2=t(tri_v2), tri_v3=t(tri_v3),
        tri_uv1=t(tri_uv1), tri_uv2=t(tri_uv2), tri_uv3=t(tri_uv3),
        tri_n=t(tri_n), tri_mat=t(tri_mat), tri_obj=t(tri_obj),
        mat_type=t(mat_type), mat_albedo=t(mat_albedo),
        mat_fuzz=t(mat_fuzz), mat_ior=t(mat_ior), mat_tex=t(mat_tex),
        tex_type=t(tex_type), tex_color=t(tex_color),
        tex_color2=t(tex_color2), tex_image=t(tex_image), images=t(images),
        camera=s.camera.to(device),
        background=t(np.asarray(s.background, f32)),
        light_fam=t(light_fam), light_pid=t(light_pid),
        counts=(len(sph), len(rect), len(cyl), len(tri)),
        n_lights=n_lights, img_on=img_on, nee_img=nee_img,
        **{f"{prefix}_bvh_{k}": a.to(device) for _, prefix in BVH_FAMILIES
           for k, a in zip(BVH_KEYS, _dummy_bvh())},
    )
    # each asked-for family's BVH over its live rows (types.py:584-626)
    built = [name for name, _ in BVH_FAMILIES
             if name in bvh_types and tables.counts[FAMILY_NAMES.index(name)]]
    if not built:
        return tables
    from rt_tpu_torch.accel.bvh import build_bvh

    fields = {}
    for name, prefix in BVH_FAMILIES:
        if name in built:
            bv = build_bvh(*tables.family_boxes(name))
            fields.update({f"{prefix}_bvh_{k}": t(a)
                           for k, a in zip(BVH_KEYS, bv)})
    return dataclasses.replace(tables, bvh_for=tuple(built), **fields)


def image_usage(tex_type, mat_tex, families, light_fam, light_pid):
    """(img_on, nee_img) of a scene's tables (rt_tpu/scene/types.py
    :628-672): the names of the families (FAMILY_NAMES, sorted) with a
    live row whose material samples an image texture, and whether a
    light's does. families: (mat, obj) row arrays of each family in
    family order; light_fam, light_pid: the lights' (family, row)."""
    tex_type, mat_tex = np.asarray(tex_type), np.asarray(mat_tex)
    mat_img = (mat_tex >= 0) & (tex_type[np.maximum(mat_tex, 0)]
                                == TEX_IMAGE)
    img_on = tuple(sorted(
        name for name, (mat, obj) in zip(FAMILY_NAMES, families)
        if (mat_img[np.asarray(mat)] & (np.asarray(obj) >= 0)).any()))
    nee_img = any(bool(mat_img[int(np.asarray(families[f][0])[p])])
                  for f, p in zip(np.asarray(light_fam).tolist(),
                                  np.asarray(light_pid).tolist()))
    return img_on, nee_img
