"""The path-tracing integrator: a wavefront bounce loop over a ray batch
(rt_tpu/render/integrator.py).

Radiometric semantics are the CUDA reference's iterative ray_color
(gpu-version/main.cu:17-70):

  while depth > 0:
      if hit and scatter:   color += emitted * T ; T *= attenuation
      elif hit (no scatter): color += T * emitted ; stop
      else (miss):           color += T * background ; stop
  depth exhausted -> contributes what it accumulated (no background)

with the gradient sky, background credit on depth exhaustion and
Russian roulette as RenderConfig options. engine="plain" ("xla") /
"pallas": the whole batch advances one bounce per iteration with masked
(dead) lanes; under loop "while" the loop ends at max_depth or when no
lane is alive, which costs one host sync per bounce, under "scan" it
runs max_depth bounces with no sync (rt_tpu's lax.scan), dead lanes
passing through unchanged. engine="queue" / "mega": the persistent ray
queue (ops/cuda_queue.py) or the segmented megakernel
(ops/cuda_mega.py) trace whole paths per launch; as in the reference,
only an empty scene falls back to "pallas".

With cfg.nee on a scene with lights (config.nee_on), every lambertian
bounce adds a direct-light sample (`_nee_direct`: one light picked
uniformly, a point on it area-sampled, a shadow ray through
ops/intersect.occluded) and emission reached through such a bounce is
suppressed; cfg.mis weights both techniques by the balance heuristic
(the previous bounce's density carried in `prev_diff`, 0 meaning "not
light-sampled", ROADMAP C-2) and cfg.nee_glossy adds fuzzy-metal bounces
with their fuzz-ball density (`_glossy_pdf`). The kernel engines run
the same estimator in the kernels' own arithmetic (ops/mega_plain.py).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from rt_tpu_torch.config import (
    RenderConfig,
    check_supported,
    engine_name,
    nee_on,
)
from rt_tpu_torch.ops import geometry as geom
from rt_tpu_torch.ops import materials, rng
from rt_tpu_torch.ops.intersect import intersect, occluded
from rt_tpu_torch.scene.types import MAT_LAMBERTIAN, MAT_METAL, SceneTables


class RayState(NamedTuple):
    o: torch.Tensor           # [B,3]
    d: torch.Tensor           # [B,3]
    throughput: torch.Tensor  # [B,3]
    rgb: torch.Tensor         # [B,3]
    alive: torch.Tensor       # [B] bool


def background_color(tables: SceneTables, cfg: RenderConfig, d):
    if cfg.background_mode == "gradient":
        unit = geom.unit(d)
        t = 0.5 * (unit[:, 1] + 1.0)
        white = torch.ones(3, dtype=torch.float32, device=d.device)
        blue = torch.tensor([0.5, 0.7, 1.0], dtype=torch.float32,
                            device=d.device)
        return (1.0 - t)[:, None] * white + t[:, None] * blue
    return tables.background.expand(d.shape)


def _glossy_pdf(cosr, fz):
    """Solid-angle density of the metal's reflect + fuzz * ball draw
    about the mirror direction (rt_tpu integrator.py `_glossy_pdf` :58):
    p = s (3 cos^2 + s^2) / (2 pi fz^3), s = sqrt(fz^2 - sin^2), inside
    the cone sin < fz, zero outside. fz = 1 about the normal is the
    lambertian (2/pi) cos^3 law."""
    s2 = fz * fz - (1.0 - cosr * cosr)
    inside = (cosr > 0.0) & (s2 > 0.0) & (fz > 0.0)
    # the same values as the reference's sqrt(max(s2, 0)); outside the
    # cone the root's argument is 1, so its gradient there is finite
    # (the reference's is NaN: ROADMAP C-12)
    s = torch.sqrt(torch.where(inside, s2, 1.0))
    denom = (2.0 * math.pi) * torch.clamp(fz, min=1e-8) ** 3
    return torch.where(inside, s * (3.0 * cosr * cosr + s2) / denom, 0.0)


def _nee_direct(tables: SceneTables, cfg: RenderConfig, hit, albedo,
                pixel, sample_idx, seed, bounce_idx, rd=None):
    """The direct-light term [B,3] of one bounce (rt_tpu integrator.py
    `_nee_direct` :72-252): pick one light uniformly, area-sample a point
    on it (a sphere's surface, a rect's face, a cylinder's lateral
    surface, a triangle by the sqrt barycentric warp), cast a shadow ray
    and return albedo * Le * w, zero where the sample is occluded or
    below the horizon. The scatter rule n + unit ball has the density
    (2/pi) cos^3; lights emit from both faces (|cos_l|). With cfg.mis
    the weight is the balance heuristic p_b / (p_n + p_b); with
    cfg.nee_glossy (and rd, the incoming direction, given) a metal lane
    takes its fuzz-ball density for p_b. Le is materials.emitted at the
    sampled point and its UV, in each family's hit-UV convention."""
    L = tables.n_lights
    smp = rng.resolve(cfg.sampler)
    u_pick = smp.uniform(seed, pixel, sample_idx, bounce_idx, rng.NEE_PICK)
    li = torch.clamp((u_pick * L).to(torch.int32), max=L - 1).long()
    fam = tables.light_fam[li]
    pid = tables.light_pid[li].long()
    u1 = smp.uniform(seed, pixel, sample_idx, bounce_idx, rng.NEE_U1)
    u2 = smp.uniform(seed, pixel, sample_idx, bounce_idx, rng.NEE_U2)

    b = u1.shape[0]
    dev = u1.device
    point = torch.zeros((b, 3), dtype=torch.float32, device=dev)
    n_l = torch.zeros_like(point)
    area = torch.zeros((b,), dtype=torch.float32, device=dev)
    mat_l = torch.zeros((b,), dtype=torch.int32, device=dev)
    u_l = torch.zeros_like(area)
    v_l = torch.zeros_like(area)
    n_sph, n_rect, n_cyl, n_tri = tables.counts

    def sel(cond, a, bv):
        return torch.where(cond[:, None] if a.dim() == 2 else cond, a, bv)

    if n_sph:
        ps = torch.clamp(pid, 0, tables.sph_center.shape[0] - 1)
        c = geom.take_rows(tables.sph_center, ps)
        r = torch.abs(geom.take_rows(tables.sph_radius, ps))
        z = 1.0 - 2.0 * u1
        st = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
        phi = (2.0 * math.pi) * u2
        ns = torch.stack([st * torch.cos(phi), st * torch.sin(phi), z], -1)
        is_s = fam == 0
        point = sel(is_s, c + r[:, None] * ns, point)
        n_l = sel(is_s, ns, n_l)
        area = torch.where(is_s, 4.0 * math.pi * r * r, area)
        mat_l = torch.where(is_s, tables.sph_mat[ps], mat_l)
        az_deg = (ns[:, 2] == 0.0) & (ns[:, 0] == 0.0)
        s_phi = torch.atan2(-ns[:, 2],
                            torch.where(az_deg, 1.0, ns[:, 0])) + math.pi
        u_l = torch.where(is_s, s_phi / (2 * math.pi), u_l)
        v_l = torch.where(is_s, torch.acos(torch.clamp(-ns[:, 1], -1.0, 1.0))
                          / math.pi, v_l)
    if n_rect:
        pr = torch.clamp(pid, 0, tables.rect_axis.shape[0] - 1)
        ax = tables.rect_axis[pr].long()
        lo = geom.take_rows(tables.rect_lo, pr)
        hi = geom.take_rows(tables.rect_hi, pr)
        k = geom.take_rows(tables.rect_k, pr)
        f1 = torch.where(ax == 0, 1, 0)
        f2 = torch.where(ax == 2, 1, 2)
        a_c = lo[:, 0] + u1 * (hi[:, 0] - lo[:, 0])
        b_c = lo[:, 1] + u2 * (hi[:, 1] - lo[:, 1])
        axes = torch.arange(3, device=dev)[None, :]
        pt = (torch.where(axes == ax[:, None], k[:, None], 0.0)
              + torch.where(axes == f1[:, None], a_c[:, None], 0.0)
              + torch.where(axes == f2[:, None], b_c[:, None], 0.0))
        is_r = fam == 1
        point = sel(is_r, pt, point)
        n_l = sel(is_r, (axes == ax[:, None]).to(torch.float32), n_l)
        area = torch.where(
            is_r, (hi[:, 0] - lo[:, 0]) * (hi[:, 1] - lo[:, 1]), area)
        mat_l = torch.where(is_r, tables.rect_mat[pr], mat_l)
        u_l = torch.where(is_r, u1, u_l)
        v_l = torch.where(is_r, u2, v_l)
    if n_cyl:
        pc = torch.clamp(pid, 0, tables.cyl_radius.shape[0] - 1)
        r = torch.abs(geom.take_rows(tables.cyl_radius, pc))
        zmin = geom.take_rows(tables.cyl_zmin, pc)
        zmax = geom.take_rows(tables.cyl_zmax, pc)
        o2w = tables.cyl_o2w[pc]
        phi = (2.0 * math.pi) * u2
        zc = zmin + u1 * (zmax - zmin)
        po = torch.stack([r * torch.cos(phi), r * torch.sin(phi), zc], -1)
        no = torch.stack([torch.cos(phi), torch.sin(phi),
                          torch.zeros_like(phi)], -1)
        is_c = fam == 2
        point = sel(is_c, geom.apply_point(o2w, po), point)
        # rotation-only transforms: the lateral normal turns with the
        # rotation block
        n_l = sel(is_c, geom.apply_vec(o2w, no), n_l)
        area = torch.where(is_c, 2.0 * math.pi * r * (zmax - zmin), area)
        mat_l = torch.where(is_c, tables.cyl_mat[pc], mat_l)
        c_phi2 = torch.atan2(torch.sin(phi), torch.cos(phi)) + 2 * math.pi
        u_l = torch.where(is_c, c_phi2 / (4 * math.pi), u_l)
        v_l = torch.where(is_c, u1, v_l)
    if n_tri:
        pt_ = torch.clamp(pid, 0, tables.tri_v1.shape[0] - 1)
        v1 = geom.take_rows(tables.tri_v1, pt_)
        e1 = geom.take_rows(tables.tri_v2, pt_) - v1
        e2 = geom.take_rows(tables.tri_v3, pt_) - v1
        sq = torch.sqrt(u1)
        b2 = sq * (1.0 - u2)
        b3 = sq * u2
        pt3 = v1 + b2[:, None] * e1 + b3[:, None] * e2
        crl = geom.safe_length(geom.cross(e1, e2))
        is_t = fam == 3
        point = sel(is_t, pt3, point)
        n_l = sel(is_t, tables.tri_n[pt_], n_l)
        area = torch.where(is_t, 0.5 * crl, area)
        mat_l = torch.where(is_t, tables.tri_mat[pt_], mat_l)
        b1 = 1.0 - sq
        uvt = (tables.tri_uv1[pt_] * b1[:, None]
               + tables.tri_uv2[pt_] * b2[:, None]
               + tables.tri_uv3[pt_] * b3[:, None])
        u_l = torch.where(is_t, uvt[:, 0], u_l)
        v_l = torch.where(is_t, uvt[:, 1], v_l)

    wi = point - hit.p
    d2 = torch.clamp(geom.length_squared(wi), min=1e-8)
    dist = torch.sqrt(d2)
    cos_s = geom.dot(hit.normal, wi) / dist
    cos_l = torch.abs(geom.dot(n_l, wi)) / dist
    Le = materials.emitted(tables, mat_l, u_l, v_l, point)
    with torch.no_grad():  # visibility is piecewise constant
        occ = occluded(tables, hit.p.detach(), wi.detach(),
                       t_max=1.0 - 1e-3,
                       engine="pallas" if cfg.engine == "pallas"
                       else "plain")
    cs = torch.clamp(cos_s, min=0.0)
    ok = (cos_s > 0.0) & ~occ
    mis = bool(cfg.mis)
    glossy = bool(cfg.nee_glossy) and rd is not None
    if mis or glossy:
        p_b = (2.0 / math.pi) * cs * cs * cs
        if glossy:
            mc = torch.clamp(hit.mat.long(), 0, tables.mat_type.shape[0] - 1)
            fz = geom.take_rows(tables.mat_fuzz, mc)
            R = geom.reflect(geom.unit(rd), hit.normal)
            cosr = geom.dot(R, wi) / dist
            p_b = torch.where(tables.mat_type[mc] == MAT_METAL,
                              _glossy_pdf(cosr, fz), p_b)
        p_n = d2 / (torch.clamp(area * float(L), min=1e-8)
                    * torch.clamp(cos_l, min=1e-6))
        if mis:
            # balance heuristic; p_n -> inf as cos_l -> 0 (a grazing
            # light), so the term -> 0
            w = p_b / (p_n + p_b + 1e-20)
        else:
            w = p_b / torch.clamp(p_n, min=1e-20)
    else:
        w = (cs * cs * cs * cos_l / d2) * area * (2.0 * L / math.pi)
    return torch.where(ok[:, None], albedo * Le * w[:, None], 0.0)


def _prim_area(tables: SceneTables, ptype, pid):
    """Surface area of the hit primitive, per family (rt_tpu
    integrator.py `_prim_area` :255; the NEE sampler's formulas): the
    BSDF-side MIS weight needs p_nee of the direction that hit an
    emitter."""
    b = ptype.shape[0]
    area = torch.zeros((b,), dtype=torch.float32, device=ptype.device)
    n_sph, n_rect, n_cyl, n_tri = tables.counts
    pid = pid.long()
    if n_sph:
        ps = torch.clamp(pid, 0, tables.sph_center.shape[0] - 1)
        r = torch.abs(geom.take_rows(tables.sph_radius, ps))
        area = torch.where(ptype == 0, 4.0 * math.pi * r * r, area)
    if n_rect:
        pr = torch.clamp(pid, 0, tables.rect_axis.shape[0] - 1)
        lo = geom.take_rows(tables.rect_lo, pr)
        hi = geom.take_rows(tables.rect_hi, pr)
        area = torch.where(ptype == 1,
                           (hi[:, 0] - lo[:, 0]) * (hi[:, 1] - lo[:, 1]),
                           area)
    if n_cyl:
        pc = torch.clamp(pid, 0, tables.cyl_radius.shape[0] - 1)
        r = torch.abs(geom.take_rows(tables.cyl_radius, pc))
        area = torch.where(
            ptype == 2,
            2.0 * math.pi * r * (geom.take_rows(tables.cyl_zmax, pc)
                                 - geom.take_rows(tables.cyl_zmin, pc)),
            area)
    if n_tri:
        pt_ = torch.clamp(pid, 0, tables.tri_v1.shape[0] - 1)
        v1 = geom.take_rows(tables.tri_v1, pt_)
        e1 = geom.take_rows(tables.tri_v2, pt_) - v1
        e2 = geom.take_rows(tables.tri_v3, pt_) - v1
        crl = geom.safe_length(geom.cross(e1, e2))
        area = torch.where(ptype == 3, 0.5 * crl, area)
    return area


def nee_emission(tables: SceneTables, cfg: RenderConfig, hit, o, em,
                 prev_diff):
    """The emission a bounce adds under NEE (rt_tpu integrator.py
    `_bounce` :325-349): with cfg.mis weighted by the balance heuristic
    against the previous bounce's density prev_diff (0: that bounce was
    not light-sampled, weight 1); without it zero where the previous
    bounce was light-sampled (prev_diff a bool), its light sample having
    counted it. Every emitter is in the light list."""
    if cfg.mis:
        vec = hit.p - o
        d2h = torch.clamp(geom.length_squared(vec), min=1e-8)
        cos_lh = torch.abs(geom.dot(hit.normal, vec)) / torch.sqrt(d2h)
        a_hit = _prim_area(tables, hit.ptype, hit.pid)
        p_n = d2h / (torch.clamp(a_hit * float(tables.n_lights), min=1e-8)
                     * torch.clamp(cos_lh, min=1e-6))
        w_b = torch.where(prev_diff > 0.0,
                          prev_diff / (prev_diff + p_n + 1e-20), 1.0)
        return em * w_b[:, None]
    return torch.where(prev_diff[:, None], torch.zeros_like(em), em)


def nee_bounce(tables: SceneTables, cfg: RenderConfig, hit, sc, d,
               scattered, pixel, sample_idx, seed, bounce_idx):
    """The light-sampled part of a bounce under NEE (rt_tpu
    integrator.py `_bounce` :355-392): (direct [B,3] to add times the
    throughput, the next prev_diff). The lanes that sample lights are
    the scattered lambertian ones, and with cfg.nee_glossy the scattered
    metal ones of fuzz > 0; prev_diff is then their bool mask, or under
    cfg.mis the density of the direction just drawn (0 elsewhere)."""
    mc = torch.clamp(hit.mat.long(), 0, tables.mat_type.shape[0] - 1)
    mt = tables.mat_type[mc]
    sel = scattered & (mt == MAT_LAMBERTIAN)
    glossy_on = bool(cfg.nee_glossy)
    if glossy_on:
        fz_l = geom.take_rows(tables.mat_fuzz, mc)
        glo = scattered & (mt == MAT_METAL) & (fz_l > 0.0)
        sel = sel | glo
    ld = _nee_direct(tables, cfg, hit, sc.attenuation, pixel, sample_idx,
                     seed, bounce_idx, rd=d if glossy_on else None)
    ld = torch.where(sel[:, None], ld, 0.0)
    if not cfg.mis:
        return ld, sel
    udir = geom.unit(sc.direction)
    csn = torch.clamp(geom.dot(udir, hit.normal), min=0.0)
    p_new = (2.0 / math.pi) * csn * csn * csn
    if glossy_on:
        Rn = geom.reflect(geom.unit(d), hit.normal)
        p_new = torch.where(glo, _glossy_pdf(geom.dot(udir, Rn), fz_l),
                            p_new)
    return ld, torch.where(sel, p_new, 0.0)


def _bounce(tables: SceneTables, cfg: RenderConfig, state: RayState,
            pixel, sample_idx, seed, bounce_idx, prev_diff=None):
    """Advance every live lane one bounce. Under NEE (prev_diff given:
    a [B] bool, or a float32 density under cfg.mis) returns (RayState,
    the next prev_diff), see nee_emission and nee_bounce."""
    o, d, tp, rgb, alive = state
    nee = prev_diff is not None
    smp = rng.resolve(cfg.sampler)

    survive = torch.ones_like(alive)
    if cfg.p_rr > 0.0:
        # RR check precedes the hit test (4_0_path_tracing.py:45-46)
        u_rr = smp.uniform(seed, pixel, sample_idx, bounce_idx, rng.RR)
        survive = u_rr <= cfg.p_rr

    hit = intersect(tables, o, d, engine=cfg.engine,
                    traversal=cfg.traversal)

    ball = smp.in_unit_ball(seed, pixel, sample_idx, bounce_idx)
    refl_u = smp.uniform(seed, pixel, sample_idx, bounce_idx, rng.DIEL_REFL)
    sc, em = materials.shade(tables, hit.mat, d, hit.normal, hit.front_face,
                             hit.u, hit.v, hit.p, ball, refl_u)

    bg = background_color(tables, cfg, d)

    live = alive & survive
    scattered = live & hit.hit & sc.ok
    emitter = live & hit.hit & ~sc.ok
    missed = live & ~hit.hit

    if nee:
        em = nee_emission(tables, cfg, hit, o, em, prev_diff)
    # color += emitted * T on every hit; += T * background on miss
    contrib = (torch.where((scattered | emitter)[:, None], em, 0.0)
               + torch.where(missed[:, None], bg, 0.0))
    rgb = rgb + tp * contrib
    if nee:
        ld, prev_diff = nee_bounce(tables, cfg, hit, sc, d, scattered,
                                   pixel, sample_idx, seed, bounce_idx)
        rgb = rgb + tp * ld

    rr_comp = 1.0 / cfg.p_rr if cfg.p_rr > 0.0 else 1.0
    tp = torch.where(scattered[:, None], tp * sc.attenuation * rr_comp, tp)
    o = torch.where(scattered[:, None], hit.p, o)
    d = torch.where(scattered[:, None], sc.direction, d)
    st = RayState(o, d, tp, rgb, scattered)
    return (st, prev_diff) if nee else st


def initial_prev_diff(cfg: RenderConfig, b: int, device):
    """The prev_diff carry of fresh lanes under NEE: zeros, float32
    under cfg.mis, else bool."""
    return torch.zeros((b,), dtype=torch.float32 if cfg.mis else torch.bool,
                       device=device)


def trace(tables: SceneTables, cfg: RenderConfig, ro, rd, pixel, sample_idx,
          seed, stats: Optional[dict] = None) -> torch.Tensor:
    """Trace a batch of primary rays to radiance [B,3].

    stats, when given: with engine="plain" / "pallas", stats["bounces"]
    gains the number of wavefront bounces this call ran (max_depth under
    loop "scan"; with "pallas", one kernel launch each); with "queue" /
    "mega", stats["launches"]
    gains the kernel launches (on the CPU: the plain versions' calls)
    and stats["ray_bounces"] the bounces of all lanes."""
    check_supported(cfg)
    cfg = cfg.replace(engine=engine_name(cfg.engine))
    if cfg.engine in ("queue", "mega"):
        from rt_tpu_torch.ops import cuda_mega, cuda_queue
        from rt_tpu_torch.ops.mega_tables import mega_supported

        if mega_supported(tables):
            fn = (cuda_queue.queue_trace if cfg.engine == "queue"
                  else cuda_mega.mega_trace)
            return fn(tables, cfg, ro, rd, pixel, sample_idx, seed,
                      stats=stats)
        cfg = cfg.replace(engine="pallas")  # empty scene only
    b = ro.shape[0]
    state = RayState(
        o=ro, d=rd,
        throughput=torch.ones((b, 3), dtype=torch.float32, device=ro.device),
        rgb=torch.zeros((b, 3), dtype=torch.float32, device=ro.device),
        alive=torch.ones((b,), dtype=torch.bool, device=ro.device),
    )
    nee = nee_on(cfg, tables)
    pd = initial_prev_diff(cfg, b, ro.device) if nee else None
    scan = cfg.loop == "scan"  # a fixed trip: no host read a bounce
    i = 0
    while i < cfg.max_depth and (scan or bool(state.alive.any())):
        if nee:
            state, pd = _bounce(tables, cfg, state, pixel, sample_idx, seed,
                                i, prev_diff=pd)
        else:
            state = _bounce(tables, cfg, state, pixel, sample_idx, seed, i)
        i += 1
    if stats is not None:
        stats["bounces"] = stats.get("bounces", 0) + i

    rgb = state.rgb
    if cfg.exhaust_mode == "background":
        # depth-exhausted rays credit the sky (taichi main.py:194-196)
        bg = background_color(tables, cfg, state.d)
        rgb = rgb + torch.where(state.alive[:, None],
                                state.throughput * bg, 0.0)
    return rgb
