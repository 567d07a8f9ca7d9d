"""rt_tpu_torch's scene tables and config against rt_tpu's: the port's
build_tables equals the JAX package's tables carried across with
tables_from_numpy, leaf by leaf and exactly."""

import dataclasses

import numpy as np
import pytest
import torch

from rt_tpu import config as jconfig
from rt_tpu.scene import builders as jbuilders
from rt_tpu.scene import types as jtypes
from rt_tpu_torch import config as tconfig
from rt_tpu_torch.scene import builders as tbuilders
from rt_tpu_torch.scene import types as ttypes
from rt_tpu_torch.scene.convert import tables_from_numpy

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's default of one thread per core in each of them
# oversubscribes the CPU many times over.
torch.set_num_threads(1)

SCENES = {
    "cover_grid4": ("cover_scene", dict(grid=4)),
    "cover": ("cover_scene", {}),
    "cover_seed3_small": ("cover_scene", dict(seed=3, grid=2, width=64,
                                              height=48)),
    "three_sphere": ("three_sphere_scene", {}),
}


def jax_leaves(tables):
    """A JAX SceneTables' leaves as NumPy, camera under 'camera.<field>'."""
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


def _both(name):
    fn, kw = SCENES[name]
    sj, cj = getattr(jbuilders, fn)(**kw)
    st, ct = getattr(tbuilders, fn)(**kw)
    return sj, cj, st, ct


@pytest.mark.parametrize("name", sorted(SCENES))
def test_build_tables_matches_jax_leaf_by_leaf(name):
    sj, _, st, _ = _both(name)
    jt = jtypes.build_tables(sj)
    carried = tables_from_numpy(jax_leaves(jt))
    own = ttypes.build_tables(st)
    a, b = carried.leaves(), own.leaves()
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert a[k].shape == b[k].shape, k
        assert torch.equal(a[k], b[k]), k
    assert carried.n_spheres == own.n_spheres == jt.counts[0]


@pytest.mark.parametrize("name", sorted(SCENES))
def test_builders_match_jax_scene_defs(name):
    """Same objects, materials, textures and camera parameters."""
    sj, cj, st, ct = _both(name)
    assert st.objects == sj.objects
    assert st.materials == sj.materials
    assert st.textures == sj.textures
    assert st.camera_params == sj.camera_params
    assert (st.width, st.height, st.background) == (sj.width, sj.height,
                                                    sj.background)
    assert dataclasses.asdict(ct) == dataclasses.asdict(
        cj.replace(engine="plain"))


def test_cover_scene_size():
    st, _ = tbuilders.cover_scene()
    tables = ttypes.build_tables(st)
    assert tables.n_spheres == 488
    assert tables.sph_center.shape == (512, 3)


def test_pad_size_identical():
    for n in range(0, 2100):
        assert ttypes._pad_size(n) == jtypes._pad_size(n), n


def test_resize_rederives_camera_like_jax():
    sj, _, st, _ = _both("cover_grid4")
    sj.resize(320, 180)
    st.resize(320, 180)
    a = tables_from_numpy(jax_leaves(jtypes.build_tables(sj))).leaves()
    b = ttypes.build_tables(st).leaves()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_to_device_round_trip():
    st, _ = tbuilders.three_sphere_scene()
    tables = ttypes.build_tables(st)
    moved = tables.to("cpu")
    assert moved.sph_center.device == torch.device("cpu")
    assert moved.n_spheres == tables.n_spheres == 5
    for k, v in tables.leaves().items():
        assert torch.equal(v, moved.leaves()[k]), k


def test_tables_from_numpy_rejects_other_families():
    """Rects and cylinders carry across with their counts and light
    index (tests/test_torch_parser.py compares every leaf). Image
    textures, once refused, carry across too: a texture turned into an
    image keeps its type, image id and the atlas, and the static img_on
    follows the primitives that sample it (tests/test_torch_images.py
    compares scenes with images leaf by leaf)."""
    sj, _ = jbuilders.cover_scene(grid=2, lights=True)  # rect + cylinder
    leaves = jax_leaves(jtypes.build_tables(sj))
    tt = tables_from_numpy(leaves)
    assert tt.counts == (19, 1, 1, 0) and tt.n_lights == 2
    assert tt.img_on == () and not tt.nee_img
    leaves["tex_type"] = leaves["tex_type"].copy()
    leaves["tex_type"][0] = ttypes.TEX_IMAGE
    leaves["tex_image"] = leaves["tex_image"].copy()
    leaves["tex_image"][0] = 0
    carried = tables_from_numpy(leaves)
    assert int(carried.tex_type[0]) == ttypes.TEX_IMAGE
    assert int(carried.tex_image[0]) == 0
    assert torch.equal(carried.images, torch.from_numpy(leaves["images"]))
    # texture 0 is the ground sphere's checker; no light samples it
    assert carried.img_on == ("sphere",) and carried.nee_img is False


def test_build_tables_rejects_other_families():
    """A rect joins its own table; unknown object types are refused.
    Image textures, once refused, join the atlas; images of two sizes
    are refused, as rt_tpu refuses them."""
    st, _ = tbuilders.three_sphere_scene()
    st.objects.append({"type": "xy_rect", "x0": 0.0, "x1": 1.0, "y0": 0.0,
                       "y1": 1.0, "k": 0.0, "material": 0})
    tt = ttypes.build_tables(st)
    assert tt.counts == (5, 1, 0, 0) and int(tt.rect_obj[0]) == 5
    st.objects.append({"type": "torus", "material": 0})
    with pytest.raises(ValueError, match="torus"):
        ttypes.build_tables(st)
    st, _ = tbuilders.three_sphere_scene()
    img = np.linspace(0.0, 1.0, 4 * 5 * 3, dtype=np.float32).reshape(4, 5, 3)
    tex = st.add_image_texture(img)
    st.materials[0] = {"type": "lambertian", "texture": tex}
    tt = ttypes.build_tables(st)
    assert int(tt.tex_type[tex]) == ttypes.TEX_IMAGE
    assert int(tt.tex_image[tex]) == 0
    assert torch.equal(tt.images, torch.from_numpy(img)[None])
    assert tt.img_on == ("sphere",) and tt.has_images
    st.add_image_texture(np.zeros((5, 4, 3), np.float32))
    with pytest.raises(ValueError, match="one size"):
        ttypes.build_tables(st)


def test_config_fields_and_defaults_match_jax():
    j = {f.name: f.default for f in dataclasses.fields(jconfig.RenderConfig)}
    t = {f.name: f.default for f in dataclasses.fields(tconfig.RenderConfig)}
    assert list(j) == list(t)
    # engine's value names differ: "plain" is the twin of "xla"
    assert j.pop("engine") == "xla" and t.pop("engine") == "plain"
    assert j == t


@pytest.mark.parametrize("bad,exc", [
    # the spatial sort, QMC and the BVH run (tests/test_torch_cull.py,
    # test_torch_qmc.py, test_torch_bvh.py); they hide no refusal
    (dict(engine="mega", compact_sort="spatial", traversal="bvh"), None),
    # the fixed-trip loop and rt_tpu's engine name "xla" run
    # (tests/test_torch_scan.py)
    (dict(engine="mega", regen=True, compact_sort="spatial", loop="scan"),
     None),
    (dict(engine="xla"), None),
    # light sampling runs (tests/test_torch_nee.py); it hides no refusal
    (dict(nee=True, sampler="qmc", traversal="bvh"), None),
    (dict(nee=True, mis=True, traversal="bvh"), None),
    (dict(sampler="qmc", loop="scan"), None),
    (dict(traversal="bvh"), None),
    (dict(loop="scan"), None),
    (dict(traversal="kdtree"), ValueError),
    (dict(loop="fori"), ValueError),
    (dict(engine="cuda"), ValueError),
])
def test_config_unported_options_raise(bad, exc):
    """What the port refuses (exc), and the configurations it takes
    (None): traversal "bvh" and loop "scan" with any engine and option,
    and rt_tpu's engine name "xla", as rt_tpu's config takes them; an
    unknown traversal, loop or engine is a ValueError."""
    cfg = tconfig.RenderConfig(**bad)
    if exc is None:
        tconfig.check_supported(cfg)
    else:
        with pytest.raises(exc):
            tconfig.check_supported(cfg)


@pytest.mark.parametrize("opts,exc", [
    (dict(sampler="qmc"), None), (dict(compact_sort="spatial"), None),
    (dict(cull_chunks=False), None), (dict(sampler="sobol"), ValueError),
    (dict(compact_sort="octant"), ValueError),
])
def test_config_takes_qmc_spatial_and_cull(opts, exc):
    cfg = tconfig.RenderConfig(engine="mega", **opts)
    if exc is None:
        tconfig.check_supported(cfg)
    else:
        with pytest.raises(exc):
            tconfig.check_supported(cfg)


def test_resolve_device():
    assert tconfig.resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert tconfig.resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tconfig.resolve_device()
