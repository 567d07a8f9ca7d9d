"""JSON scene parser (rt_tpu/scene/parser.py), for the reference's
schema (gpu-version/parser.hpp:34-112) and rt_tpu's extensions:

  top level : output_file (default "main.png"), background[3],
              max_depth, samples_per_pixel, width, height,
              taichi_tri_uv (extension)
  camera    : lookfrom[3], lookat[3], vup[3], vfov (deg), aperture,
              focus_dist (extension; else |lookfrom - lookat|)
  object    : {"data": [...]} or a list: sphere{center,radius,material},
              xy_rect/xz_rect/yz_rect{x0,x1,y0/z0,y1/z1,k,material},
              cylinder{radius,zmin,zmax,material,rotate{axis,angle}?,
              translate[3]?}, triangle{v1,v2,v3,uv1?,uv2?,uv3?,material}
  material  : lambertian{texture}, metal{albedo,fuzz},
              dielectric{index_of_refraction}, diffuse_light{texture}
  texture   : solid_color{color[3]}, checker{even[3],odd[3]},
              image{file} (relative to the scene's directory; every image
              of a scene must share one size)
"""

from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np

from rt_tpu_torch.config import RenderConfig
from rt_tpu_torch.scene.assets import load_image_texture
from rt_tpu_torch.scene.types import (
    SceneDef,
    SceneTables,
    build_tables,
)


def _data_list(section) -> list:
    if section is None:
        return []
    if isinstance(section, dict):
        return section.get("data", [])
    return list(section)


def parse_scene_dict(data: dict, base_dir: str = "."
                     ) -> Tuple[SceneDef, RenderConfig]:
    """A scene dict of the schema above -> (SceneDef, RenderConfig).
    base_dir resolves the files of image textures."""
    s = SceneDef(
        width=int(data["width"]),
        height=int(data["height"]),
        samples_per_pixel=int(data["samples_per_pixel"]),
        max_depth=int(data["max_depth"]),
        background=tuple(float(c) for c in data["background"]),
        output_file=str(data.get("output_file", "main.png")),
        taichi_tri_uv=bool(data.get("taichi_tri_uv", False)),
    )

    cam = data["camera"]
    fd = cam.get("focus_dist")
    s.set_camera(cam["lookfrom"], cam["lookat"], cam["vup"],
                 float(cam["vfov"]), float(cam["aperture"]),
                 focus_dist=None if fd is None else float(fd))

    for t in _data_list(data.get("texture")):
        kind = t["type"]
        if kind == "solid_color":
            s.add_solid_color(t["color"])
        elif kind == "checker":
            s.add_checker(t["even"], t["odd"])
        elif kind == "image":
            s.add_image_texture(
                load_image_texture(os.path.join(base_dir, t["file"])))
        else:
            raise ValueError(f"unknown texture type: {kind}")

    for m in _data_list(data.get("material")):
        kind = m["type"]
        if kind == "lambertian":
            s.add_lambertian(int(m["texture"]))
        elif kind == "metal":
            s.add_metal(m["albedo"], float(m["fuzz"]))
        elif kind == "dielectric":
            s.add_dielectric(float(m["index_of_refraction"]))
        elif kind == "diffuse_light":
            s.add_diffuse_light(int(m["texture"]))
        else:
            raise ValueError(f"unknown material type: {kind}")

    rect_keys = {"xy_rect": ("x0", "x1", "y0", "y1"),
                 "xz_rect": ("x0", "x1", "z0", "z1"),
                 "yz_rect": ("y0", "y1", "z0", "z1")}
    for o in _data_list(data.get("object")):
        kind = o["type"]
        if kind == "sphere":
            s.add_sphere(o["center"], o["radius"], o["material"])
        elif kind in rect_keys:
            s.add_rect(kind, *(o[k] for k in rect_keys[kind]), o["k"],
                       o["material"])
        elif kind == "cylinder":
            rot = None
            if "rotate" in o:
                rot = (o["rotate"]["axis"], o["rotate"]["angle"])
            s.add_cylinder(o["radius"], o["zmin"], o["zmax"], o["material"],
                           rotate=rot, translate=o.get("translate"))
        elif kind == "triangle":
            s.add_triangle(o["v1"], o["v2"], o["v3"], o["material"],
                           uv1=o.get("uv1", (0.0, 0.0)),
                           uv2=o.get("uv2", (0.0, 0.0)),
                           uv3=o.get("uv3", (0.0, 0.0)))
        else:
            raise ValueError(f"unknown object type: {kind}")

    cfg = RenderConfig(width=s.width, height=s.height,
                       samples_per_pixel=s.samples_per_pixel,
                       max_depth=s.max_depth)
    return s, cfg


def parse_scene(path: str) -> Tuple[SceneDef, RenderConfig]:
    """Parse a scene JSON file (the `-f <scene.json>` surface of
    gpu-version/main.cu:454-460)."""
    with open(path) as f:
        data = json.load(f)
    return parse_scene_dict(data, base_dir=os.path.dirname(path) or ".")


def scene_to_dict(s: SceneDef) -> dict:
    """A SceneDef back to the JSON schema."""
    out = {
        "output_file": s.output_file,
        "background": list(s.background),
        "max_depth": s.max_depth,
        "samples_per_pixel": s.samples_per_pixel,
        "width": s.width,
        "height": s.height,
        "camera": _camera_to_dict(s),
        "object": {"data": [dict(o) for o in s.objects]},
        "material": {"data": [dict(m) for m in s.materials]},
        "texture": {"data": [dict(t) for t in s.textures]},
    }
    if s.taichi_tri_uv:  # schema extension; omitted when default
        out["taichi_tri_uv"] = True
    return out


def _camera_to_dict(s: SceneDef) -> dict:
    if s.camera_params is not None:
        return dict(s.camera_params)
    if s.camera is None:
        raise ValueError("scene has no camera")
    # cameras constructed without set_camera: the reference's fallback
    c = s.camera
    return {"lookfrom": np.asarray(c.origin).tolist(), "lookat": [0, 0, 0],
            "vup": [0, 1, 0], "vfov": 20,
            "aperture": float(c.lens_radius) * 2.0}


def tables_from_file(path: str, device="cpu"
                     ) -> Tuple[SceneTables, RenderConfig, str]:
    """(tables on `device`, config, the scene's output_file)."""
    sdef, cfg = parse_scene(path)
    return build_tables(sdef, device=device), cfg, sdef.output_file
