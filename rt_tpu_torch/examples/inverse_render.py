"""Inverse rendering demo: recover material + geometry from a target (the
port of examples/inverse_render.py).

Render a target image with known scene parameters, perturb them, then
recover them with Adam through the differentiable renderer. Prints the
loss curve and parameter errors and writes before/after/target PNGs.

Run:  python -m rt_tpu_torch.examples.inverse_render [--steps 80] [--spp 4]
      and one of --replay, --position, --grad-1080p, --camera,
      --tape-1080p, --cover-albedo, --texture, --joint-1080p,
      --material-geom (see --help)

The demos run on CUDA (RT_TPU_FORCE_CPU=1 runs them on the CPU, as the
reference's variable of that name does). Where the reference picks the
megakernel on the TPU and "xla" elsewhere, the port picks "mega" on CUDA
and "plain" on the CPU. The albedo demo reverse-differentiates the
fixed-trip "scan" loop (method "ad"), as the reference's does. Each demo function takes its frame size as keywords whose
defaults are the reference's, and a device (None: as above), and returns
(exit code, loss history); main returns the exit code. With --sharded
the joint demo's fit_hybrid trains over the mesh of the process group
(parallel/: torchrun's ranks, or a world of one), as the reference's
does; the other demos ignore it, as there.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from rt_tpu_torch.config import RenderConfig, resolve_device
from rt_tpu_torch.diff.inverse import fit
from rt_tpu_torch.io.image import write_png
from rt_tpu_torch.render import film
from rt_tpu_torch.render.renderer import render
from rt_tpu_torch.scene.builders import cover_scene
from rt_tpu_torch.scene.types import SceneDef, build_tables

# the reference demo's bricks texture, read from the reference checkout
# that RT_REFERENCE_DIR names; without it the texture demo skips
REFERENCE_DIR = os.environ.get("RT_REFERENCE_DIR")
BRICKS = (os.path.join(REFERENCE_DIR, "taichi-version", "asset", "tex",
                       "bricks2.png") if REFERENCE_DIR else None)


def _device(device=None) -> torch.device:
    if device is None:
        device = "cpu" if os.environ.get("RT_TPU_FORCE_CPU") else "cuda"
    return resolve_device(device)


def _engine(dev: torch.device) -> str:
    """The reference's `"mega" if tpu else "xla"`."""
    return "mega" if dev.type == "cuda" else "plain"


def _mean(tables, cfg, dev, spp=None) -> torch.Tensor:
    """The mean radiance [H,W,3] of a render at spp samples (default
    cfg's), on dev."""
    spp = spp or cfg.samples_per_pixel
    return render(tables, cfg.replace(samples_per_pixel=spp),
                  device=dev) / float(spp)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _png(path, mean):
    write_png(path, film.finalize(mean, 1, gamma=True))


def make_scene(albedo, center_x, width=64, height=36):
    """A lambertian sphere of `albedo` at x = center_x on a grey ground
    under a gradient sky (the reference's make_scene)."""
    s = SceneDef(width=width, height=height, samples_per_pixel=4,
                 max_depth=4, background=(0.7, 0.8, 1.0))
    m = s.add_lambertian_color(albedo)
    s.add_sphere((center_x, 0, -1), 0.5, m)
    s.add_sphere((0, -100.5, -1), 100,
                 s.add_lambertian_color((0.6, 0.6, 0.6)))
    s.set_camera(lookfrom=(0, 0, 1), lookat=(0, 0, -1), vup=(0, 1, 0),
                 vfov_deg=45.0, aperture=0.0)
    cfg = RenderConfig(width=width, height=height, samples_per_pixel=4,
                       max_depth=4, loop="scan", background_mode="gradient")
    return s, cfg


def material_geom_scene(spp, width=96, height=54, true_fuzz=0.15,
                        true_ior=1.5):
    """A glass ball and a brushed-metal ball under a gradient sky (the
    reference's material_geom_demo scene)."""
    s = SceneDef(width=width, height=height, samples_per_pixel=spp,
                 max_depth=8, background=(0.7, 0.8, 1.0))
    s.add_sphere((-0.9, 0, -2), 0.8, s.add_dielectric(true_ior))
    s.add_sphere((0.9, 0, -2), 0.8, s.add_metal((0.8, 0.7, 0.6), true_fuzz))
    s.set_camera(lookfrom=(0, 0, 1), lookat=(0, 0, -2), vup=(0, 1, 0),
                 vfov_deg=50.0, aperture=0.0)
    cfg = RenderConfig(width=width, height=height, samples_per_pixel=spp,
                       max_depth=8, background_mode="gradient")
    return s, cfg


def joint_scene(cx, cy, albedo, width=1920, height=1080):
    """A lambertian sphere at (cx, cy), a metal one and the ground (the
    reference's joint_1080p_demo scene)."""
    s = SceneDef(width=width, height=height, samples_per_pixel=4,
                 max_depth=8, background=(0.7, 0.8, 1.0))
    s.add_sphere((cx, cy, -1.2), 0.5, s.add_lambertian_color(albedo))
    s.add_sphere((-1.1, 0, -1.6), 0.5, s.add_metal((0.8, 0.75, 0.7), 0.05))
    s.add_sphere((0, -100.5, -1), 100,
                 s.add_lambertian_color((0.55, 0.6, 0.5)))
    s.set_camera((0, 0.35, 1), (0, 0, -1.2), (0, 1, 0), 50, 0.0)
    cfg = RenderConfig(width=width, height=height, samples_per_pixel=4,
                       max_depth=8, background_mode="gradient",
                       loop="while")
    return s, cfg


def texture_scene(img, width=640, height=360):
    """A quad textured with img (the reference's texture_demo scene)."""
    s = SceneDef(width=width, height=height, samples_per_pixel=4,
                 max_depth=4, background=(0.85, 0.85, 0.9))
    m = s.add_lambertian(s.add_image_texture(img))
    s.add_rect("xy_rect", -1.5, 1.5, -0.9, 0.9, -1.0, m)
    s.set_camera((0, 0, 1.4), (0, 0, -1), (0, 1, 0), 60, 0.0)
    cfg = RenderConfig(width=width, height=height, samples_per_pixel=4,
                       max_depth=4, loop="while")
    return s, cfg


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m rt_tpu_torch.examples.inverse_render",
        description="inverse rendering demos of the PyTorch/CUDA port")
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--outdir", default="inverse_out")
    ap.add_argument("--sharded", action="store_true",
                    help="run the joint demo's fit over the (tile, sample) "
                         "mesh of the process group's ranks (torchrun; a "
                         "world of one without it)")
    ap.add_argument("--position", action="store_true",
                    help="run the FD position-recovery demo instead")
    ap.add_argument("--replay", action="store_true",
                    help="use the O(B)-memory path-replay backward with a "
                         "megakernel forward instead of autograd")
    ap.add_argument("--grad-1080p", action="store_true",
                    help="one full-HD gradient step via path replay")
    ap.add_argument("--camera", action="store_true",
                    help="CAMERA POSE recovery: find the lookfrom that "
                         "produced a target image via CRN finite "
                         "differences (forward-only, megakernel on CUDA)")
    ap.add_argument("--tape-1080p", action="store_true",
                    help="winner-tape reverse mode at full HD: gradient of "
                         "a 1920x1080 depth-50 cover render w.r.t. EVERY "
                         "sphere center+radius and every albedo in ONE "
                         "backward pass")
    ap.add_argument("--cover-albedo", action="store_true",
                    help="MASS recovery: all ~480 cover-scene sphere "
                         "albedos jointly from ONE 1080p depth-50 target, "
                         "via the adjoint-megakernel backward")
    ap.add_argument("--texture", action="store_true",
                    help="TEXTURE RECOVERY: reconstruct the reference's "
                         "100x100 bricks image texture from a render of a "
                         "textured quad")
    ap.add_argument("--joint-1080p", action="store_true",
                    help="jointly recover a sphere's albedo (path replay) "
                         "AND its position (batched CRN finite "
                         "differences) from a 1920x1080 target")
    ap.add_argument("--material-geom", action="store_true",
                    help="recover metal fuzz + dielectric IOR via the "
                         "forward-mode tangent replay (O(B) memory)")
    return ap


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    for flag, demo in (("position", position_demo),
                       ("joint_1080p", joint_1080p_demo),
                       ("texture", texture_demo),
                       ("cover_albedo", cover_albedo_demo),
                       ("tape_1080p", tape_1080p_demo),
                       ("camera", camera_demo),
                       ("grad_1080p", grad_1080p_demo),
                       ("material_geom", material_geom_demo)):
        if getattr(args, flag):
            code, _ = demo() if flag == "position" else demo(args)
            return code
    code, _ = albedo_demo(args)
    return code


def albedo_demo(args, width=64, height=36, device=None):
    """Recover a sphere's albedo (its texture colour) from a target: by
    autograd through the plain engine, or with --replay by the path
    replay on the megakernel (B2 forward, B5 backward on CUDA)."""
    dev = _device(device)
    os.makedirs(args.outdir, exist_ok=True)
    true_albedo = (0.7, 0.2, 0.4)
    sdef_true, cfg = make_scene(true_albedo, 0.0, width, height)
    target = _mean(build_tables(sdef_true), cfg, dev)
    _png(os.path.join(args.outdir, "target.png"), target)

    sdef_wrong, _ = make_scene((0.3, 0.5, 0.1), 0.0, width, height)
    tables_wrong = build_tables(sdef_wrong)
    _png(os.path.join(args.outdir, "before.png"),
         _mean(tables_wrong, cfg, dev))

    fit_cfg = cfg.replace(engine=_engine(dev)) if args.replay else cfg
    recovered, history = fit(tables_wrong, fit_cfg, _host(target),
                             fields=("tex_color",), spp=args.spp,
                             steps=args.steps, learning_rate=5e-2,
                             method="replay" if args.replay else "ad",
                             device=dev)
    print(f"loss: {history[0]:.5f} -> {history[-1]:.6f}")
    got = recovered["tex_color"][0]
    print(f"albedo recovered: {np.round(got, 3)} (true {true_albedo})")

    tables_after = dataclasses.replace(
        build_tables(sdef_wrong),
        tex_color=torch.from_numpy(recovered["tex_color"].astype(np.float32)))
    _png(os.path.join(args.outdir, "after.png"),
         _mean(tables_after, cfg, dev))
    err = np.abs(np.asarray(got) - np.asarray(true_albedo)).max()
    print(f"max albedo error: {err:.4f}")
    print(f"wrote {args.outdir}/{{target,before,after}}.png")
    return (0 if err < 0.1 else 1), history


def grad_1080p_demo(args, width=1920, height=1080, device=None):
    """One gradient of the render loss at 1920x1080 depth 50 through the
    path replay: the forward runs the megakernel, the backward replays
    the bounces from the counter RNG, and the live state is O(B). Then
    the geometry tangent replay on a 131,072-pixel minibatch (the counter
    RNG keys on absolute pixel ids, so a minibatch renders exactly the
    samples those pixels get in the full frame). The target is black,
    so a step of the colours against their gradient must lower the loss
    on the same samples: the history is (loss, loss after that step)."""
    from rt_tpu_torch.diff.replay import make_replay_loss_fn

    dev = _device(device)
    sdef, cfg = cover_scene(width=width, height=height, spp=1, max_depth=50)
    cfg = cfg.replace(engine="mega", compact_every=4)
    tables = build_tables(sdef, device=dev)
    n_pix = width * height
    pix = torch.arange(n_pix, device=dev)
    px, py = pix % width, pix // width
    target = torch.zeros((n_pix, 3), device=dev)
    # the early exit: the same gradients, no bounce of the depth-50
    # replays over no lane
    loss_fn = make_replay_loss_fn(tables, cfg, 1, px, py, target,
                                  bwd_early_exit=True)
    params = {"tex_color": tables.tex_color.clone().requires_grad_(True)}
    t0 = time.time()
    loss = loss_fn(params)
    loss.backward()
    g = params["tex_color"].grad
    _sync(dev)
    dt = time.time() - t0
    loss = loss.detach()
    print(f"{width}x{height} depth-50 grad step: loss={float(loss):.5f}, "
          f"|grad|_max={float(g.abs().max()):.3e}, {dt:.1f}s")
    ok = bool(torch.isfinite(g).all())
    eta = 0.05 / max(float(g.abs().max()), 1e-12)
    with torch.no_grad():
        stepped = float(loss_fn({"tex_color": tables.tex_color - eta * g}))
    print(f"loss after a colour step of 0.05 against the gradient: "
          f"{stepped:.5f}")

    rng_np = np.random.default_rng(0)
    sub = np.sort(rng_np.choice(n_pix, size=min(1 << 17, n_pix),
                                replace=False))
    sub = torch.from_numpy(sub).to(dev)
    loss_geom = make_replay_loss_fn(
        tables, cfg, 1, px[sub], py[sub], target[sub],
        geom_spec={"sph_center": [(0, 0), (0, 1)], "sph_radius": [(0,)]},
        bwd_early_exit=True)
    gparams = {"sph_center": tables.sph_center.clone().requires_grad_(True),
               "sph_radius": tables.sph_radius.clone().requires_grad_(True)}
    t0 = time.time()
    loss_geom(gparams).backward()
    gc = gparams["sph_center"].grad
    _sync(dev)
    dt = time.time() - t0
    print(f"geometry tangent step ({sub.numel()}-pixel minibatch, 3 "
          f"components): |grad|_max={float(gc.abs().max()):.3e}, "
          f"{dt:.1f}s")
    ok = ok and bool(torch.isfinite(gc).all()) and stepped < float(loss)
    return (0 if ok else 1), [float(loss), stepped]


def material_geom_demo(args, width=96, height=54, device=None):
    """Recover a glass ball's IOR and a brushed-metal ball's fuzz from a
    target via the forward-mode tangent replay (diff/replay.py
    geom_spec): both act through the scattered direction, which the
    suffix adjoint cannot see; against the smooth gradient sky the
    interior term is the whole gradient."""
    dev = _device(device)
    true_fuzz, true_ior = 0.15, 1.5
    sdef, cfg = material_geom_scene(args.spp, width, height, true_fuzz,
                                    true_ior)
    tables = build_tables(sdef)
    die, met = 0, 1  # material rows in add order
    target = _mean(tables, cfg, dev)
    fuzz, ior = tables.mat_fuzz.clone(), tables.mat_ior.clone()
    fuzz[met], ior[die] = 0.4, 1.1
    wrong = dataclasses.replace(tables, mat_fuzz=fuzz, mat_ior=ior)
    rec, hist = fit(wrong, cfg.replace(engine=_engine(dev)), _host(target),
                    fields=("mat_fuzz", "mat_ior"), spp=args.spp,
                    steps=args.steps, learning_rate=3e-2, method="replay",
                    geom_spec={"mat_fuzz": [(met,)], "mat_ior": [(die,)]},
                    device=dev)
    got_f = float(rec["mat_fuzz"][met])
    got_i = float(rec["mat_ior"][die])
    print(f"loss: {hist[0]:.6f} -> {hist[-1]:.7f}")
    print(f"fuzz: {got_f:.4f} (true {true_fuzz}, init 0.4)")
    print(f"ior:  {got_i:.4f} (true {true_ior}, init 1.1)")
    ok = abs(got_f - true_fuzz) < 0.05 and abs(got_i - true_ior) < 0.1
    return (0 if ok else 1), hist


def joint_1080p_demo(args, width=1920, height=1080, device=None):
    """Recover a sphere's albedo and 2D position jointly from a 1920x1080
    target: the albedo gradient by the path replay (forward on the
    megakernel on CUDA), the position gradient by batched
    common-random-numbers central differences, which see the silhouette
    term, in one Adam loop (diff/inverse.fit_hybrid)."""
    from rt_tpu_torch.diff.inverse import fit_hybrid

    dev = _device(device)
    mesh = None
    if args.sharded:
        from rt_tpu_torch.parallel.distributed import init_distributed, world
        from rt_tpu_torch.parallel.mesh import make_mesh

        dev = init_distributed(device=dev)
        mesh = make_mesh((world()[1], 1), device=dev)
    true_x, true_y = 0.25, 0.05
    true_albedo = (0.7, 0.15, 0.35)
    outdir = args.outdir
    os.makedirs(outdir, exist_ok=True)
    sdef_t, cfg = joint_scene(true_x, true_y, true_albedo, width, height)
    cfg = cfg.replace(engine=_engine(dev))
    t0 = time.time()
    target = _mean(build_tables(sdef_t), cfg, dev, spp=32)
    _sync(dev)
    print(f"target {width}x{height} spp32: {time.time() - t0:.1f}s")
    _png(os.path.join(outdir, "joint_target.png"), target)

    sdef_w, _ = joint_scene(-0.35, -0.15, (0.25, 0.5, 0.45), width, height)
    tables_w = build_tables(sdef_w)
    _png(os.path.join(outdir, "joint_before.png"), _mean(tables_w, cfg, dev))

    t0 = time.time()
    if mesh is not None:
        print(f"sharded fit over {mesh.size} device(s)")
    rec, hist = fit_hybrid(tables_w, cfg, _host(target),
                           replay_fields=("tex_color",),
                           fd_params={"sph_center": [(0, 0), (0, 1)]},
                           spp=args.spp, fd_spp=2, steps=args.steps,
                           learning_rate=3e-2, device=dev, mesh=mesh)
    dt = time.time() - t0
    print(f"{args.steps} joint steps at {width}x{height}: {dt:.1f}s "
          f"({dt / args.steps:.2f}s/step)")
    print(f"loss: {hist[0]:.6f} -> {hist[-1]:.7f}")
    cx, cy = float(rec["sph_center"][0, 0]), float(rec["sph_center"][0, 1])
    alb = rec["tex_color"][0]
    print(f"center: ({cx:.4f}, {cy:.4f})  true ({true_x}, {true_y}), "
          f"init (-0.35, -0.15)")
    print(f"albedo: {np.round(alb, 3)}  true {true_albedo}")

    tables_rec = dataclasses.replace(
        tables_w, tex_color=torch.from_numpy(rec["tex_color"]),
        sph_center=torch.from_numpy(rec["sph_center"]))
    _png(os.path.join(outdir, "joint_after.png"),
         _mean(tables_rec, cfg, dev))
    print(f"wrote {outdir}/joint_{{target,before,after}}.png")
    pos_err = max(abs(cx - true_x), abs(cy - true_y))
    alb_err = float(np.abs(alb - np.asarray(true_albedo)).max())
    return (0 if (pos_err < 0.05 and alb_err < 0.08) else 1), hist


def cover_albedo_demo(args, width=1920, height=1080, device=None):
    """Recover every solid-textured lambertian sphere's albedo in the
    cover scene (~480 spheres, ~1440 parameters) jointly from ONE
    1920x1080 depth-50 target through the adjoint megakernel (B5 on
    CUDA): each albedo takes gradient only from the paths that touched
    it, and a step costs one forward and one replay whatever the
    parameter count."""
    from rt_tpu_torch.scene.types import MAT_LAMBERTIAN, TEX_SOLID

    dev = _device(device)
    sdef, cfg = cover_scene(width=width, height=height, spp=1, max_depth=50)
    cfg = cfg.replace(engine=_engine(dev), compact_schedule=(2, 3, 5, 10),
                      compact_group=16)
    tables = build_tables(sdef)
    outdir = args.outdir
    os.makedirs(outdir, exist_ok=True)
    t0 = time.time()
    target = _mean(tables, cfg, dev, spp=32)
    _sync(dev)
    print(f"target {width}x{height} d50 spp32: {time.time() - t0:.1f}s")

    # grey out every SOLID-textured lambertian (the ~480 small spheres +
    # the big center one); checker ground / metal / glass untouched
    mt, tex = tables.mat_type.numpy(), tables.mat_tex.numpy()
    ttype = tables.tex_type.numpy()
    lam_tex = np.unique(tex[(mt == MAT_LAMBERTIAN) & (tex >= 0)])
    lam_tex = lam_tex[ttype[lam_tex] == TEX_SOLID]
    true_colors = tables.tex_color.numpy()[lam_tex]
    init_tc = tables.tex_color.numpy().copy()
    init_tc[lam_tex] = 0.5
    wrong = dataclasses.replace(tables, tex_color=torch.from_numpy(init_tc))
    _png(os.path.join(outdir, "cover_before.png"),
         _mean(wrong, cfg, dev, spp=8))

    t0 = time.time()
    rec, hist = fit(wrong, cfg, _host(target), fields=("tex_color",),
                    spp=args.spp, steps=args.steps, learning_rate=5e-2,
                    method="replay", bwd_depth=12, resample=True,
                    device=dev)
    dt = time.time() - t0
    print(f"{args.steps} steps x {len(lam_tex)} spheres "
          f"({3 * len(lam_tex)} params): {dt:.1f}s "
          f"({dt / args.steps:.2f}s/step)")
    print(f"loss: {hist[0]:.6f} -> {hist[-1]:.7f}")
    got = np.clip(rec["tex_color"][lam_tex], 0.0, 1.0)
    err = np.abs(got - true_colors).max(axis=-1)
    # a single view cannot constrain spheres it barely/never sees:
    # report over spheres whose parameters actually received signal
    moved = np.abs(got - 0.5).max(axis=-1) > 0.05
    print(f"albedo error over ALL {len(lam_tex)} spheres: "
          f"median {np.median(err):.4f}, p90 {np.percentile(err, 90):.4f},"
          f" max {err.max():.4f}")
    if moved.any():
        print(f"over the {int(moved.sum())} observable (trained) spheres: "
              f"median {np.median(err[moved]):.4f}, "
              f"p90 {np.percentile(err[moved], 90):.4f}")

    after_t = dataclasses.replace(
        wrong, tex_color=torch.from_numpy(rec["tex_color"]))
    _png(os.path.join(outdir, "cover_after.png"),
         _mean(after_t, cfg, dev, spp=8))
    print(f"wrote {outdir}/cover_{{before,after}}.png")
    ok = bool(moved.any()) and float(np.median(err[moved])) < 0.08
    return (0 if ok else 1), hist


def camera_demo(args, width=480, height=270, device=None):
    """Recover the camera's lookfrom from one rendered view of the cover
    scene (pose estimation) by common-random-numbers central differences
    (diff/inverse.fit_camera): forward-only probe renders on the
    megakernel on CUDA, whose noise cancels in each difference because
    the +-eps probes draw the same counter-RNG streams."""
    from rt_tpu_torch.diff.inverse import fit_camera

    dev = _device(device)
    sdef, cfg = cover_scene(width=width, height=height, spp=8, max_depth=8)
    cfg = cfg.replace(engine=_engine(dev))
    tables = build_tables(sdef)
    true_lf = np.asarray(sdef.camera_params["lookfrom"], np.float32)

    t0 = time.time()
    target = _mean(tables, cfg, dev)
    _sync(dev)
    print(f"target {width}x{height}: {time.time() - t0:.1f}s; true "
          f"lookfrom {true_lf}")
    cp = sdef.camera_params
    off = np.asarray([0.25, -0.2, 0.3], np.float32)
    init = {"lookfrom": true_lf + off, "lookat": cp["lookat"],
            "vup": cp["vup"], "vfov_deg": cp["vfov"],
            "aperture": cp["aperture"]}
    if "focus_dist" in cp:
        init["focus_dist"] = cp["focus_dist"]
    print(f"init offset {off} (|err| {np.abs(off).max():.3f})")

    t0 = time.time()
    rec, hist = fit_camera(tables, cfg, _host(target), init,
                           recover=("lookfrom",), spp=8, steps=args.steps,
                           learning_rate=8e-3, device=dev)
    dt = time.time() - t0
    err = np.abs(np.asarray(rec["lookfrom"]) - true_lf).max()
    print(f"{args.steps} steps (7 probe renders each): {dt:.1f}s "
          f"({dt / args.steps:.2f}s/step)")
    print(f"loss {hist[0]:.6f} -> {hist[-1]:.8f}")
    print(f"recovered lookfrom {np.asarray(rec['lookfrom'])} "
          f"(|err| {err:.4f}, init {np.abs(off).max():.3f})")
    return (0 if err < 0.02 else 1), hist


def tape_1080p_demo(args, width=1920, height=1080, device=None):
    """One full-HD reverse-mode gradient over EVERY continuous cover-scene
    parameter at once (all ~490 sphere centers and radii, every material
    colour, fuzz and IOR) by the winner tape (diff/tape.make_tape_vg:
    the capture kernel B4 on CUDA, then the death-sorted replay), one
    backward pass whose cost does not grow with the parameter count.
    Timed cold and warm at the same parameters; then a step of the
    colour fields against their gradient, whose loss on the same samples
    must be lower: the history is (loss, loss after that step)."""
    from rt_tpu_torch.diff.tape import make_tape_vg

    dev = _device(device)
    sdef, cfg = cover_scene(width=width, height=height, spp=1, max_depth=50)
    cfg = cfg.replace(background_mode="gradient", engine=_engine(dev))
    tables = build_tables(sdef, device=dev)
    real = (tables.sph_obj >= 0).cpu().numpy()

    t0 = time.time()
    target = _mean(tables, cfg, dev, spp=8)
    _sync(dev)
    print(f"target {width}x{height} d50 spp8: {time.time() - t0:.1f}s")

    rs = np.random.RandomState(3)
    center = tables.sph_center.cpu().numpy()
    noise = np.where(real[:, None], rs.normal(0, 0.01, center.shape), 0.0)
    params = {
        "sph_center": torch.from_numpy(
            (center + noise).astype(np.float32)).to(dev),
        "sph_radius": tables.sph_radius.clone(),
        "tex_color": tables.tex_color.clone(),
        "mat_albedo": tables.mat_albedo.clone(),
        "mat_fuzz": tables.mat_fuzz.clone(),
        "mat_ior": tables.mat_ior.clone(),
    }
    n_par = sum(int(v.numel()) for v in params.values())
    print(f"d(loss)/d({n_par} params: all centers, radii, albedos, fuzz, "
          f"IOR) at {width}x{height} depth-50, ONE backward pass")

    pix = torch.arange(width * height, device=dev)
    vg = make_tape_vg(tables, cfg, pix % width, pix // width,
                      target.reshape(-1, 3), spp=1)
    t0 = time.time()
    loss, grads = vg(params)
    _sync(dev)
    print(f"first step (kernel builds included): {time.time() - t0:.1f}s")
    t0 = time.time()
    loss, grads = vg(params)
    _sync(dev)
    dt = time.time() - t0
    print(f"warm gradient step: {dt:.2f}s (capture + replay backward, loss "
          f"{float(loss):.6f})")
    ok = True
    for f, g in grads.items():
        fin = bool(torch.isfinite(g).all())
        gmax = float(g.abs().max())
        ok &= fin and (gmax > 0.0 or f == "mat_fuzz")
        print(f"  |grad {f}|_max = {gmax:.3e} finite={fin}")
    colours = ("tex_color", "mat_albedo")
    gmax = max(float(grads[f].abs().max()) for f in colours)
    eta = 0.01 / max(gmax, 1e-12)
    stepped = dict(params, **{f: params[f] - eta * grads[f]
                              for f in colours})
    loss2, _ = vg(stepped)
    print(f"loss after a colour step of 0.01 against the gradient: "
          f"{float(loss2):.6f}")
    ok = ok and float(loss2) < float(loss)
    print("all-fields reverse-mode gradient " + ("OK" if ok else "FAILED"))
    return (0 if ok else 1), [float(loss), float(loss2)]


def texture_demo(args, width=640, height=360, device=None, image=None):
    """Recover a whole image texture from a render: the target is a
    render of a quad textured with the reference's 100x100 bricks image
    (or `image`, [H,W,3] in [0,1]); the init is a flat grey atlas. The
    replay's adjoint adds each bounce's cotangent into exactly the
    texels the paths sampled (B5's atlas gradient on CUDA)."""
    from rt_tpu_torch.scene.assets import load_image_texture

    if image is None:
        if BRICKS is None or not os.path.exists(BRICKS):
            print("reference bricks texture not found; skipping")
            return 0, []
        image = load_image_texture(BRICKS)
    dev = _device(device)
    true_img = np.asarray(image, np.float32)
    th, tw = true_img.shape[:2]
    outdir = args.outdir
    os.makedirs(outdir, exist_ok=True)
    sdef_t, cfg = texture_scene(true_img, width, height)
    cfg = cfg.replace(engine=_engine(dev))
    target = _mean(build_tables(sdef_t), cfg, dev, spp=16)
    _png(os.path.join(outdir, "tex_target_render.png"), target)

    init = np.full_like(true_img, 0.5)
    sdef_w, _ = texture_scene(init, width, height)
    t0 = time.time()
    rec, hist = fit(build_tables(sdef_w), cfg, _host(target),
                    fields=("images",), spp=args.spp, steps=args.steps,
                    learning_rate=5e-2, method="replay", device=dev)
    dt = time.time() - t0
    got = np.clip(rec["images"][0, :th, :tw], 0.0, 1.0)
    moved = np.abs(got - init).max(axis=-1) > 1e-3
    err = np.abs(got - true_img).max(axis=-1)
    med = float(np.median(err[moved])) if moved.any() else float("inf")
    print(f"{args.steps} steps at {width}x{height}: {dt:.1f}s "
          f"({dt / args.steps:.2f}s/step)")
    print(f"loss: {hist[0]:.6f} -> {hist[-1]:.7f}")
    print(f"texels trained: {int(moved.sum())}/{th * tw}, median |err| on "
          f"trained texels: {med:.4f}")

    # side by side: true | init | recovered (nearest-upscaled 2x)
    strip = np.concatenate([true_img, init, got], axis=1)
    strip = np.repeat(np.repeat(strip, 2, axis=0), 2, axis=1)
    write_png(os.path.join(outdir, "tex_true_init_recovered.png"),
              (np.clip(strip, 0, 1) * 255).astype(np.uint8)[::-1])
    print(f"wrote {outdir}/tex_true_init_recovered.png and "
          f"{outdir}/tex_target_render.png")
    return (0 if med < 0.1 else 1), hist


def position_demo(width=64, height=36, device=None, steps=60):
    """Sphere-position recovery via common-random-numbers finite
    differences (diff/inverse.fit_fd), 60 steps (the reference's; the
    demo takes no --steps)."""
    from rt_tpu_torch.diff.inverse import fit_fd

    dev = _device(device)
    true_x = 0.15
    sdef_t, cfg = make_scene((0.7, 0.2, 0.2), true_x, width, height)
    cfg = cfg.replace(samples_per_pixel=8)
    target = _mean(build_tables(sdef_t), cfg, dev)
    sdef_w, _ = make_scene((0.7, 0.2, 0.2), -0.1, width, height)
    rec, hist = fit_fd(build_tables(sdef_w), cfg, _host(target),
                       fd_params={"sph_center": [(0, 0)]}, spp=8, steps=steps,
                       learning_rate=3e-2, device=dev)
    print(f"loss: {hist[0]:.5f} -> {hist[-1]:.7f}")
    print(f"center_x: {rec['sph_center'][0, 0]:.4f} (true {true_x}, init "
          f"-0.1)")
    return (0 if abs(rec["sph_center"][0, 0] - true_x) < 0.05 else 1), hist


if __name__ == "__main__":
    raise SystemExit(main())
