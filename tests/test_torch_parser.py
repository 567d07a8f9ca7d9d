"""rt_tpu_torch's JSON parser, asset readers, host transforms and the
family tables against rt_tpu's on the same inputs, and the CLI on a JSON
scene.

Both packages build the tables in NumPy float32, so every leaf is held
equal exactly: integers and floats to 0 ulp. The scenes are the in-repo
demo_scene.json and the coded scenes that need rects, cylinders and
triangles: cover_scene(lights=True), dna_scene and mesh_scene on the
in-repo scenes/plane441.obj."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rt_tpu.ops import geometry as jgeom
from rt_tpu.scene import assets as jassets
from rt_tpu.scene import builders as jbuilders
from rt_tpu.scene import parser as jparser
from rt_tpu.scene import types as jtypes
from rt_tpu_torch.io.image import read_png
from rt_tpu_torch.ops import geometry as tgeom
from rt_tpu_torch.scene import assets as tassets
from rt_tpu_torch.scene import builders as tbuilders
from rt_tpu_torch.scene import parser as tparser
from rt_tpu_torch.scene import types as ttypes
from rt_tpu_torch.scene.convert import tables_from_numpy
from test_torch_scene import jax_leaves

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's default of one thread per core in each of them
# oversubscribes the CPU many times over.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(ROOT, "scenes", "demo_scene.json")
MESH = os.path.join(ROOT, "scenes", "plane441.obj")

SCENES = {
    "demo_json": lambda m: m[0].parse_scene(DEMO),
    "cover_lights": lambda m: m[1].cover_scene(lights=True),
    "cover_lights_grid2": lambda m: m[1].cover_scene(lights=True, grid=2,
                                                     seed=3),
    "dna": lambda m: m[1].dna_scene(angle_deg=17.0),
    "mesh": lambda m: m[1].mesh_scene(MESH),
}


def _both(name):
    sj, cj = SCENES[name]((jparser, jbuilders))
    st, ct = SCENES[name]((tparser, tbuilders))
    return sj, cj, st, ct


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_defs_and_configs_match_jax(name):
    sj, cj, st, ct = _both(name)
    assert st.objects == sj.objects
    assert st.materials == sj.materials
    assert st.textures == sj.textures
    assert st.camera_params == sj.camera_params
    assert (st.width, st.height, st.samples_per_pixel, st.max_depth,
            st.background, st.output_file, st.taichi_tri_uv) == (
        sj.width, sj.height, sj.samples_per_pixel, sj.max_depth,
        sj.background, sj.output_file, sj.taichi_tri_uv)
    assert dataclasses.asdict(ct) == dataclasses.asdict(
        cj.replace(engine="plain"))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_tables_match_jax_leaf_by_leaf(name):
    """Every leaf of the port's build_tables equals rt_tpu's carried
    across by tables_from_numpy, dtype, shape and bits; the family
    counts and the light index too."""
    sj, _, st, _ = _both(name)
    jt = jtypes.build_tables(sj)
    carried = tables_from_numpy(jax_leaves(jt))
    own = ttypes.build_tables(st)
    a, b = carried.leaves(), own.leaves()
    assert sorted(a) == sorted(b)
    for k in ("rect_k", "cyl_w2o", "tri_n", "light_fam", "light_pid"):
        assert k in a
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert a[k].shape == b[k].shape, k
        assert torch.equal(a[k], b[k]), k
    assert carried.counts == own.counts == tuple(jt.counts)
    assert carried.n_lights == own.n_lights == jt.n_lights
    assert own.has_families


def test_demo_scene_contents():
    st, ct = tparser.parse_scene(DEMO)
    tt = ttypes.build_tables(st)
    assert tt.counts == (5, 1, 1, 0) and tt.n_lights == 1
    assert (ct.width, ct.height, ct.samples_per_pixel, ct.max_depth) == (
        960, 540, 128, 40)
    assert st.output_file == "demo.png"
    assert tt.light_fam.tolist() == [1] and tt.light_pid.tolist() == [0]


def test_scene_to_dict_round_trip():
    """scene_to_dict is rt_tpu's, and parsing its output again gives the
    same scene and tables."""
    sj, _ = jparser.parse_scene(DEMO)
    st, _ = tparser.parse_scene(DEMO)
    d = tparser.scene_to_dict(st)
    assert d == jparser.scene_to_dict(sj)
    json.dumps(d)
    again, _ = tparser.parse_scene_dict(json.loads(json.dumps(d)))
    assert again.objects == st.objects
    assert again.camera_params == st.camera_params
    a = ttypes.build_tables(again).leaves()
    b = ttypes.build_tables(st).leaves()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    st.taichi_tri_uv = True
    assert tparser.scene_to_dict(st)["taichi_tri_uv"] is True


def test_taichi_tri_uv_swaps_uv_columns():
    sj, _ = jbuilders.mesh_scene(MESH)
    st, _ = tbuilders.mesh_scene(MESH)
    sj.taichi_tri_uv = st.taichi_tri_uv = True
    jt, tt = jtypes.build_tables(sj), ttypes.build_tables(st)
    for k in ("tri_uv1", "tri_uv3"):
        np.testing.assert_array_equal(getattr(tt, k).numpy(),
                                      np.asarray(getattr(jt, k)))
    plain = ttypes.build_tables(tbuilders.mesh_scene(MESH)[0])
    assert torch.equal(tt.tri_uv1, plain.tri_uv3)


def test_readobj_matches_jax():
    vj, fj, uj = jassets.readobj(MESH)
    vt, ft, ut = tassets.readobj(MESH)
    np.testing.assert_array_equal(vt, vj)
    assert ft == fj and len(ft) == 800
    np.testing.assert_array_equal(ut, uj)
    assert vt.dtype == np.float32 and vt.shape == (441, 3)


def test_readdynamic_matches_jax(tmp_path):
    p = tmp_path / "0.txt"
    rs = np.random.default_rng(2)
    pts = rs.normal(size=(50, 3))
    p.write_text("\n".join(" ".join(f"{v:.6f}" for v in r) for r in pts)
                 + "\n\n1 2\n")
    np.testing.assert_array_equal(tassets.readdynamic(str(p)),
                                  jassets.readdynamic(str(p)))
    # a frame of points replaces the mesh's vertices, as rt_tpu's
    verts = jassets.readobj(MESH)[0] * np.float32(1.5)
    sj, _ = jbuilders.mesh_scene(MESH, points=verts)
    st, _ = tbuilders.mesh_scene(MESH, points=verts)
    assert st.objects == sj.objects


def test_transforms_match_jax_bit_for_bit():
    rs = np.random.default_rng(4)
    for _ in range(5):
        axis = rs.normal(size=3)
        theta = float(rs.uniform(-3, 3))
        delta = rs.normal(size=3)
        for got, want in (
                (tgeom.rotate(axis, theta), jgeom.rotate(axis, theta)),
                (tgeom.translate(delta), jgeom.translate(delta)),
                (tgeom.compose(tgeom.translate(delta),
                               tgeom.rotate(axis, theta)),
                 jgeom.compose(jgeom.translate(delta),
                               jgeom.rotate(axis, theta)))):
            for g, w in zip(got, want):
                assert g.dtype == np.float32
                np.testing.assert_array_equal(g, w)
    m, minv = tgeom.identity_transform()
    np.testing.assert_array_equal(m, np.eye(4, dtype=np.float32))
    assert m is not minv


def test_apply_transforms_on_tensors():
    """apply_point / apply_vec / apply_normal against float64 NumPy,
    within 1e-5 (float32 sums of three products)."""
    rs = np.random.default_rng(6)
    m, minv = tgeom.compose(tgeom.translate(rs.normal(size=3)),
                            tgeom.rotate(rs.normal(size=3), 0.7))
    p = rs.normal(size=(64, 3)).astype(np.float32)
    mt, mit, pt = map(torch.from_numpy, (m, minv, p))
    m64, mi64, p64 = (x.astype(np.float64) for x in (m, minv, p))
    np.testing.assert_allclose(tgeom.apply_point(mt, pt).numpy(),
                               p64 @ m64[:3, :3].T + m64[:3, 3], atol=1e-5)
    np.testing.assert_allclose(tgeom.apply_vec(mt, pt).numpy(),
                               p64 @ m64[:3, :3].T, atol=1e-5)
    np.testing.assert_allclose(tgeom.apply_normal(mit, pt).numpy(),
                               p64 @ mi64[:3, :3], atol=1e-5)


def test_image_textures_raise(tmp_path):
    """Image textures raised here until they were ported; the parser's
    `"image" {file}` (relative to the scene's directory), the textured
    mesh and an image texture carried across by tables_from_numpy are
    taken now (tests/test_torch_images.py holds them against rt_tpu).
    BVHs, once refused too, build (tests/test_torch_bvh.py)."""
    from rt_tpu_torch.io.image import write_png

    u8 = np.random.default_rng(4).integers(0, 256, (6, 5, 3), np.uint8)
    write_png(str(tmp_path / "x.png"), u8)
    data = json.loads(open(DEMO).read())
    data["texture"]["data"].append({"type": "image", "file": "x.png"})
    sdef, _ = tparser.parse_scene_dict(data, base_dir=str(tmp_path))
    assert sdef.textures[-1] == {"type": "image", "image": 0}
    np.testing.assert_array_equal(sdef.images[0],
                                  u8.astype(np.float32) / 255.0)
    sdef, _ = tbuilders.mesh_scene(MESH, texture_path=str(tmp_path / "x.png"))
    assert ttypes.build_tables(sdef).img_on == ("triangle",)
    leaves = jax_leaves(jtypes.build_tables(jbuilders.cover_scene(grid=1)[0]))
    leaves["tex_type"] = leaves["tex_type"].copy()
    leaves["tex_type"][0] = ttypes.TEX_IMAGE
    assert int(tables_from_numpy(leaves).tex_type[0]) == ttypes.TEX_IMAGE
    # a sphere BVH builds, and bvh_for is rt_tpu's
    own = ttypes.build_tables(tparser.parse_scene(DEMO)[0],
                              bvh_types=("sphere",))
    ref = jtypes.build_tables(jparser.parse_scene(DEMO)[0],
                              bvh_types=("sphere",))
    assert own.bvh_for == ref.bvh_for == ("sphere",)
    assert torch.equal(own.sph_bvh_obj, torch.from_numpy(
        np.asarray(ref.sph_bvh_obj)))


def test_tables_from_file():
    tt, cfg, out = tparser.tables_from_file(DEMO)
    assert out == "demo.png" and cfg.max_depth == 40
    assert tt.counts == (5, 1, 1, 0)


def _cli(args, cwd):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-m", "rt_tpu_torch", "render",
                           *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_cli_renders_json_scene(tmp_path):
    """-f demo_scene.json on the CPU at 48x27, spp 2, depth 4 through the
    default engine (queue): a finite, non-black PNG at -o, and without
    -o the scene's output_file in the working directory."""
    out = tmp_path / "demo_small.png"
    res = _cli(["-f", DEMO, "-w", "48", "--height", "27", "-spp", "2", "-d",
                "4", "--device", "cpu", "-o", str(out)], ROOT)
    assert res.returncode == 0, res.stderr
    assert "engine queue" in res.stdout and "launches" in res.stdout
    img = read_png(str(out))
    assert img.shape == (27, 48, 3) and img.max() > 0
    assert np.isfinite(img).all()
    res = _cli(["-f", DEMO, "-w", "16", "--height", "9", "-spp", "1", "-d",
                "2", "--device", "cpu", "--engine", "mega"], str(tmp_path))
    assert res.returncode == 0, res.stderr
    assert read_png(str(tmp_path / "demo.png")).shape == (9, 16, 3)


def test_family_modules_import_without_jax():
    """The parser, assets, builders, tables and intersect import, and
    parse and build demo_scene.json, with JAX and rt_tpu blocked."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'rt_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import rt_tpu_torch.scene.assets, rt_tpu_torch.scene.builders\n"
        "import rt_tpu_torch.scene.convert, rt_tpu_torch.ops.intersect\n"
        "from rt_tpu_torch.scene import parser\n"
        f"tt, cfg, out = parser.tables_from_file({DEMO!r})\n"
        "assert tt.counts == (5, 1, 1, 0) and tt.mega.fam is not None\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'rt_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
