"""rt_tpu_torch/examples/inverse_render.py, the port of
examples/inverse_render.py, on the CPU.

Each demo's scene is the reference's: the reference module (imported by
its path) runs each demo until its first build_tables call, which is
captured, and rt_tpu's tables of that scene carried across by
tables_from_numpy equal the port's constructor's tables leaf for leaf,
bit for bit (make_scene directly). Each demo then runs at a tiny frame
(8x5; position at 16x9), 2 steps (the one-gradient demos: their gradient
and one step against it) on the CPU, and its loss falls. --sharded
raises NotImplementedError naming ROADMAP Queue A-9, and --texture
prints the reference's skip when the bricks image is absent."""

import argparse
import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from rt_tpu.scene import assets as jassets
from rt_tpu.scene import types as jtypes
from rt_tpu_torch.examples import inverse_render as ex
from rt_tpu_torch.scene import builders as tbuilders
from rt_tpu_torch.scene import types as ttypes
from rt_tpu_torch.scene.convert import tables_from_numpy

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's default of one thread per core in each of them
# oversubscribes the CPU many times over.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = np.random.default_rng(11).random((100, 100, 3)).astype(np.float32)


def _reference():
    spec = importlib.util.spec_from_file_location(
        "reference_inverse_render",
        os.path.join(ROOT, "examples", "inverse_render.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Built(Exception):
    pass


def _leaves(tables):
    out = {}
    for f in dataclasses.fields(tables):
        if f.metadata.get("static"):
            continue
        val = getattr(tables, f.name)
        if f.name == "camera":
            for cf in dataclasses.fields(val):
                out[f"camera.{cf.name}"] = np.asarray(getattr(val, cf.name))
        else:
            out[f.name] = np.asarray(val)
    return out


def _first_scene(ref, monkeypatch, demo, args):
    """The SceneDef of the reference demo's first build_tables call."""
    seen = []

    def capture(sdef, **kw):
        seen.append(sdef)
        raise _Built

    monkeypatch.setattr(ref, "build_tables", capture)
    with pytest.raises(_Built):
        demo(args) if args is not None else demo()
    return seen[0]


def _port_scene(name, spp):
    if name == "material_geom":
        return ex.material_geom_scene(spp)[0]
    if name == "joint_1080p":
        return ex.joint_scene(0.25, 0.05, (0.7, 0.15, 0.35))[0]
    if name == "texture":
        return ex.texture_scene(IMG)[0]
    if name == "position":
        return ex.make_scene((0.7, 0.2, 0.2), 0.15)[0]
    if name == "camera":
        return tbuilders.cover_scene(width=480, height=270, spp=8,
                                     max_depth=8)[0]
    return tbuilders.cover_scene(width=1920, height=1080, spp=1,
                                 max_depth=50)[0]


@pytest.mark.parametrize("name", ["position", "grad_1080p", "material_geom",
                                  "joint_1080p", "cover_albedo", "camera",
                                  "tape_1080p", "texture", "make_scene"])
def test_scenes_are_the_references(name, monkeypatch, tmp_path):
    ref = _reference()
    args = argparse.Namespace(steps=2, spp=4, outdir=str(tmp_path),
                              sharded=False)
    if name == "make_scene":
        pairs = [(ref.make_scene(a, x)[0], ex.make_scene(a, x)[0])
                 for a, x in (((0.7, 0.2, 0.4), 0.0),
                              ((0.3, 0.5, 0.1), 0.0))]
        assert ex.make_scene((0.7, 0.2, 0.4), 0.0)[1].max_depth == \
            ref.make_scene((0.7, 0.2, 0.4), 0.0)[1].max_depth
    else:
        if name == "texture":
            exists = os.path.exists
            monkeypatch.setattr(os.path, "exists", lambda p: str(p).endswith(
                "bricks2.png") or exists(p))
            monkeypatch.setattr(jassets, "load_image_texture",
                                lambda path: IMG)
        demo = getattr(ref, f"{name}_demo")
        sj = _first_scene(ref, monkeypatch, demo,
                          None if name == "position" else args)
        pairs = [(sj, _port_scene(name, args.spp))]
    for sj, st in pairs:
        carried = tables_from_numpy(_leaves(jtypes.build_tables(sj)))
        own = ttypes.build_tables(st)
        a, b = carried.leaves(), own.leaves()
        assert sorted(a) == sorted(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
        assert (st.width, st.height, st.samples_per_pixel, st.max_depth,
                st.background) == (sj.width, sj.height, sj.samples_per_pixel,
                                   sj.max_depth, sj.background)


@pytest.mark.parametrize("name", ["albedo", "albedo_replay", "position",
                                  "grad_1080p", "material_geom",
                                  "joint_1080p", "cover_albedo", "camera",
                                  "tape_1080p", "texture"])
def test_demo_runs_tiny_and_its_loss_falls(name, tmp_path):
    argv = ["--steps", "2", "--spp", "2", "--outdir", str(tmp_path)]
    if name == "albedo_replay":
        argv.append("--replay")
    args = ex.make_parser().parse_args(argv)
    if name == "position":
        code, hist = ex.position_demo(16, 9, device="cpu", steps=2)
    elif name.startswith("albedo"):
        code, hist = ex.albedo_demo(args, 8, 5, device="cpu")
    elif name == "texture":
        code, hist = ex.texture_demo(args, 8, 5, device="cpu", image=IMG)
    else:
        code, hist = getattr(ex, f"{name}_demo")(args, 8, 5, device="cpu")
    assert len(hist) == 2 and np.isfinite(hist).all(), hist
    assert hist[-1] < hist[0], hist
    assert code in (0, 1)
    if name in ("grad_1080p", "tape_1080p"):
        assert code == 0  # finite gradients, a descent step


def test_sharded_raises_naming_a9(tmp_path, capsys):
    """--sharded (ROADMAP item A-9, once refused): the joint demo's
    fit_hybrid over the mesh, here a world of one on the CPU at 8x5,
    prints the reference's line and follows the unsharded fit (its
    slab padded to 128-pixel lanes, the pad rows masked)."""
    runs = {}
    for extra in (["--sharded"], []):
        args = ex.make_parser().parse_args(
            ["--steps", "2", "--outdir", str(tmp_path / str(len(extra)))]
            + extra)
        runs[bool(extra)] = ex.joint_1080p_demo(args, 8, 5, device="cpu")
    out = capsys.readouterr().out
    assert out.count("sharded fit over 1 device(s)") == 1
    (code_s, hist_s), (code_u, hist_u) = runs[True], runs[False]
    assert code_s == code_u
    np.testing.assert_allclose(hist_s, hist_u, rtol=1e-5, atol=1e-7)
    assert hist_s[-1] < hist_s[0]


def test_texture_skips_without_the_bricks_file(monkeypatch, tmp_path,
                                               capsys):
    monkeypatch.setattr(ex, "BRICKS", str(tmp_path / "absent.png"))
    assert ex.main(["--texture", "--outdir", str(tmp_path / "o")]) == 0
    assert "reference bricks texture not found; skipping" in \
        capsys.readouterr().out
    assert not (tmp_path / "o").exists()
