"""Programmatic scene builders (rt_tpu/scene/builders.py), for the scenes
of the sphere slice. Python's random.Random(seed) gives the reference's
layout exactly; no JAX is involved on either side.

Each builder returns (SceneDef, RenderConfig) ready for build_tables().
"""

from __future__ import annotations

import random
from typing import Tuple

import numpy as np

from rt_tpu_torch.config import RenderConfig
from rt_tpu_torch.scene.types import SceneDef


def three_sphere_scene(width=800, height=450, spp=500, max_depth=50
                       ) -> Tuple[SceneDef, RenderConfig]:
    """The 5-object fixed test scene of gpu-version/main.cu:133-157:
    hollow-glass / diffuse / metal spheres over a yellow ground, constant
    background (0.3,0.7,1.0)."""
    s = SceneDef(width=width, height=height, samples_per_pixel=spp,
                 max_depth=max_depth, background=(0.3, 0.7, 1.0))
    m_center = s.add_lambertian_color((0.1, 0.2, 0.5))
    m_ground = s.add_lambertian_color((0.8, 0.8, 0.0))
    m_metal = s.add_metal((0.8, 0.6, 0.2), 0.0)
    m_glass = s.add_dielectric(1.5)
    s.add_sphere((0, 0, -1), 0.5, m_center)
    s.add_sphere((0, -100.5, -1), 100, m_ground)
    s.add_sphere((1, 0, -1), 0.5, m_metal)
    s.add_sphere((-1, 0, -1), 0.5, m_glass)
    s.add_sphere((-1, 0, -1), -0.45, m_glass)
    s.set_camera(lookfrom=(-2, 2, 1), lookat=(0, 0, -1), vup=(0, 1, 0),
                 vfov_deg=20.0, aperture=0.0,
                 focus_dist=float(np.linalg.norm(np.array([13.0, 2, 3]))))
    cfg = RenderConfig(width=width, height=height, samples_per_pixel=spp,
                       max_depth=max_depth)
    return s, cfg


def cover_scene(width=400, height=225, spp=50, max_depth=50, seed=7,
                grid=11) -> Tuple[SceneDef, RenderConfig]:
    """The RTiOW random-cover scene (cmake-cpu-version/main.cpp:125-172):
    checker ground, (2*grid)^2 random spheres, glass/diffuse/metal
    heroes, gradient sky, defocus on. At grid=11 that is 488 spheres,
    padded to 512. The variant with lights (rt_tpu's lights=True) needs
    rects and cylinders and comes with their slice."""
    rnd = random.Random(seed)
    s = SceneDef(width=width, height=height, samples_per_pixel=spp,
                 max_depth=max_depth, background=(0, 0, 0))
    checker = s.add_checker((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
    m_ground = s.add_lambertian(checker)
    s.add_sphere((0, -1000, 0), 1000, m_ground)

    for a in range(-grid, grid):
        for b in range(-grid, grid):
            choose = rnd.random()
            center = (a + 0.9 * rnd.random(), 0.2, b + 0.9 * rnd.random())
            if choose < 0.8:
                albedo = tuple(rnd.random() * rnd.random() for _ in range(3))
                m = s.add_lambertian_color(albedo)
            elif choose < 0.95:
                albedo = tuple(0.5 * (1 + rnd.random()) for _ in range(3))
                m = s.add_metal(albedo, 0.5 * rnd.random())
            else:
                m = s.add_dielectric(1.5)
            s.add_sphere(center, 0.2, m)

    m_glass = s.add_dielectric(1.5)
    m_diff = s.add_lambertian_color((0.4, 0.2, 0.1))
    m_metal = s.add_metal((0.7, 0.6, 0.5), 0.0)
    s.add_sphere((0, 1, 0), 1.0, m_glass)
    s.add_sphere((-4, 1, 0), 1.0, m_diff)
    s.add_sphere((4, 1, 0), 1.0, m_metal)
    s.set_camera(lookfrom=(13, 2, 3), lookat=(0, 0, 0), vup=(0, 1, 0),
                 vfov_deg=20.0, aperture=0.1, focus_dist=10.0)
    cfg = RenderConfig(width=width, height=height, samples_per_pixel=spp,
                       max_depth=max_depth, background_mode="gradient",
                       enable_defocus=True)
    return s, cfg


def cornell_spheres_scene(width=400, height=400, spp=8, max_depth=8
                          ) -> Tuple[SceneDef, RenderConfig]:
    """The naive tracer's 17-sphere emissive Cornell-like box
    (rt_tpu's builder, 4_0_path_tracing.py:93-132): black background,
    emissive spheres inside glass shells, Russian roulette p_rr = 0.9."""
    s = SceneDef(width=width, height=height, samples_per_pixel=spp,
                 max_depth=max_depth, background=(0, 0, 0))

    def lam(color):
        return s.add_lambertian_color(color)

    def light(color):
        return s.add_diffuse_light_color(color)

    def metal(color, fuzz):
        return s.add_metal(color, fuzz)

    glass = s.add_dielectric(1.5)
    s.add_sphere((0, -100.5, -1), 100.0, lam((0.8, 0.8, 0.8)))
    s.add_sphere((0, 110.5, -1), 100.0, lam((0.8, 0.8, 0.8)))
    s.add_sphere((0, 1, 110), 100.0, lam((0.8, 0.8, 0.8)))
    s.add_sphere((-105.5, 0, -1), 100.0, lam((0.6, 0.0, 0.0)))
    s.add_sphere((105.5, 0, -1), 100.0, lam((0.0, 0.6, 0.0)))
    s.add_sphere((-0.8, 0.2, 2), 0.7, metal((0.6, 0.8, 0.8), 0.0))
    s.add_sphere((0.0, 0, -0.5), 0.5, glass)
    s.add_sphere((0.0, 0, -0.5), 0.2, light((2, 3, 5)))
    s.add_sphere((1.0, -0.15, 1.6), 0.4, metal((0.8, 0.6, 0.2), 0.4))
    s.add_sphere((0.8, 0.5, 3.0), 0.8, glass)
    s.add_sphere((0.8, 0.5, 3.0), 0.4, light((4, 8, 5)))
    s.add_sphere((1.0, 0.1, -2.0), 0.6, glass)
    s.add_sphere((1.0, 0.1, -2.0), 0.3, light((5, 3, 8)))
    s.add_sphere((-0.7, -0.1, -2.0), 0.4, lam((0.4, 0.8, 0.6)))
    s.add_sphere((-1.5, -0.23, -0.5), 0.3, lam((0.6, 0.4, 0.3)))
    s.add_sphere((1.9, -0.2, 0.8), 0.4, glass)
    s.add_sphere((-2.4, -0.0, 1.5), 0.6, glass)
    s.add_sphere((-2.4, -0.0, 1.5), 0.3, light((2, 3, 8)))
    s.set_camera(lookfrom=(0, 1, -5), lookat=(0, 0.6, 0), vup=(0, 1, 0),
                 vfov_deg=60.0, aperture=0.0)
    cfg = RenderConfig(width=width, height=height, samples_per_pixel=spp,
                       max_depth=max_depth, p_rr=0.9)
    return s, cfg


def random_spheres_scene(n_spheres=3000, n_materials=0, width=64,
                         height=48, spp=1, max_depth=8, seed=3
                         ) -> Tuple[SceneDef, RenderConfig]:
    """n_spheres small random spheres over a checker ground, lit by a
    light sphere and a constant sky: a table of any size for the
    kernels' large-table path (bounce.cuh stages the first rows in
    shared memory and reads the rest from global memory, ROADMAP C-7).
    Materials (lambertian 70%, metal 20%, dielectric 10%) are one per
    sphere, or n_materials shared at random. No counterpart in rt_tpu."""
    rs = np.random.RandomState(seed)
    s = SceneDef(width=width, height=height, samples_per_pixel=spp,
                 max_depth=max_depth, background=(0.5, 0.6, 0.7))
    s.add_sphere((0, -1000, 0), 1000,
                 s.add_lambertian(s.add_checker((0.2, 0.3, 0.1),
                                                (0.9, 0.9, 0.9))))
    s.add_sphere((0, 6, -2), 2.0,
                 s.add_diffuse_light_color((4.0, 3.6, 3.2)))

    def material():
        u = rs.rand()
        if u < 0.7:
            return s.add_lambertian_color(rs.uniform(0.1, 0.9, 3))
        if u < 0.9:
            return s.add_metal(rs.uniform(0.5, 1.0, 3), 0.5 * rs.rand())
        return s.add_dielectric(1.5)

    mats = [material() for _ in range(n_materials)]
    side = max(1.0, np.sqrt(n_spheres) * 0.25)
    for _ in range(n_spheres - 2):
        center = (rs.uniform(-side, side), rs.uniform(0.05, 0.6),
                  rs.uniform(-side, side))
        m = mats[rs.randint(n_materials)] if mats else material()
        s.add_sphere(center, rs.uniform(0.03, 0.12), m)
    s.set_camera(lookfrom=(0.6 * side + 2, 2.5, 0.6 * side + 2),
                 lookat=(0, 0, 0), vup=(0, 1, 0), vfov_deg=40.0,
                 aperture=0.0)
    cfg = RenderConfig(width=width, height=height, samples_per_pixel=spp,
                       max_depth=max_depth)
    return s, cfg
