"""rt_tpu_torch's BVH (accel/bvh.py, io/native.py, the BVH fields of
SceneTables, intersect(traversal="bvh")) against rt_tpu's on the CPU.

The builds are array-equal: the port's NumPy builder against rt_tpu's,
and the port's native (C++) builder against the port's NumPy one, on the
AABBs of tests/test_bvh.py; where centroids tie (cover, the mesh, dna)
the two differ, as rt_tpu's two do, and each equals its rt_tpu twin.
The walk takes the same steps: the port's
`traverse` against rt_tpu's on the single box and the zero-direction ray
on a node plane of tests/test_bvh.py:89-142, exactly. Per lane,
intersect(traversal="bvh") agrees with rt_tpu's on cover (grid 5), the
plane441 mesh and dna with every family's BVH: hits, families and rows
on >= 99.9% of rays (the leaf tests compute in the same order, but
XLA-CPU rounds a few expressions otherwise, e.g. the cylinder's 3x3
products), t within rtol 2e-4 / atol 1e-4 where both hit, as
tests/test_torch_families.py holds the scan. The port's walk agrees
with its own scan as tests/test_bvh.py:65-73 holds rt_tpu's: hits
equal, t within rtol 1e-3 / atol 5e-3, rows on > 99.5% of the lanes
that hit (an exact tie
goes to the first hit in traversal order, where the scan keeps the last
row). Frames of the plain engine with the BVH against rt_tpu's "xla"
with the BVH by images_close: dna at 48x27 and plane441 at 32x18, spp 2,
depth 4. rt_tpu's BVH leaves carried across by tables_from_numpy equal
the port's own, and the port's walk on them gives the same lanes bit
for bit."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt_tpu.accel import bvh as jbvh
from rt_tpu.ops import intersect as jintersect
from rt_tpu.render.renderer import render as jrender
from rt_tpu.scene import builders as jbuilders
from rt_tpu.scene import parser as jparser
from rt_tpu.scene import types as jtypes
from rt_tpu_torch.accel import bvh as tbvh
from rt_tpu_torch.config import RenderConfig
from rt_tpu_torch.io import native
from rt_tpu_torch.ops import intersect as tintersect
from rt_tpu_torch.render.renderer import render as trender
from rt_tpu_torch.scene import builders as tbuilders
from rt_tpu_torch.scene import parser as tparser
from rt_tpu_torch.scene import types as ttypes
from rt_tpu_torch.scene.convert import tables_from_numpy

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's default of one thread per core in each of them
# oversubscribes the CPU many times over.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(ROOT, "scenes", "demo_scene.json")
MESH = os.path.join(ROOT, "scenes", "plane441.obj")
ALL = ("sphere", "rect", "cylinder", "triangle")
KEYS = ("obj_id", "left_id", "next_id", "bmin", "bmax")


def _random_aabbs(n, seed=0):
    """tests/test_bvh.py's boxes."""
    rng = np.random.default_rng(seed)
    c = rng.normal(0, 5, (n, 3)).astype(np.float32)
    r = (0.1 + rng.random(n)).astype(np.float32)[:, None]
    return c - r, c + r


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


@pytest.mark.parametrize("n", [1, 2, 3, 7, 33, 100])
def test_builders_match_rt_tpu_and_native(n):
    lo, hi = _random_aabbs(n, seed=n)
    port_py = tbvh._python_build(lo, hi)
    ref_py = jbvh._python_build(lo, hi)
    nat = native.native_build_bvh(lo, hi)
    assert native.available() and nat is not None
    for got in (ref_py, nat):
        for k in ("obj_id", "left_id", "right_id", "next_id", "bmin",
                  "bmax"):
            np.testing.assert_array_equal(got[k], port_py[k], err_msg=k)
            assert got[k].dtype == port_py[k].dtype, k
    built = tbvh.build_bvh(lo, hi)
    for k in KEYS:
        np.testing.assert_array_equal(getattr(built, k), port_py[k])


@pytest.mark.parametrize("name,family", [("cover", "sphere"),
                                         ("plane441", "triangle"),
                                         ("dna", "cylinder")])
def test_builders_match_rt_tpu_where_centroids_tie(name, family):
    """Where centroids tie (cover's small spheres share y = 0.2, the mesh
    is a grid, dna's rows share y) the native builder (nth_element) and
    the NumPy one (argpartition) order the tied primitives otherwise, in
    rt_tpu as in the port: each port builder equals its rt_tpu twin, and
    the two trees' walks find the same t on every lane."""
    from rt_tpu.io import native as jnative

    _, st = _scene(name)
    tt = ttypes.build_tables(st)
    n = tt.counts[("sphere", "rect", "cylinder", "triangle").index(family)]
    lo, hi = tt.family_boxes(family)
    assert len(lo) == n
    nat, py = native.native_build_bvh(lo, hi), tbvh._python_build(lo, hi)
    ref_nat, ref_py = jnative.native_build_bvh(lo, hi), \
        jbvh._python_build(lo, hi)
    assert ref_nat is not None
    for k in py:
        np.testing.assert_array_equal(nat[k], ref_nat[k], err_msg=k)
        np.testing.assert_array_equal(py[k], ref_py[k], err_msg=k)
    assert not np.array_equal(nat["obj_id"], py["obj_id"])
    prefix = {"sphere": "sph", "triangle": "tri", "cylinder": "cyl"}[family]
    trees = [ttypes.build_tables(st, bvh_types=(family,))]
    trees.append(dataclasses.replace(trees[0], **{
        f"{prefix}_bvh_{k}": torch.from_numpy(py[v]) for k, v in (
            ("obj", "obj_id"), ("left", "left_id"), ("next", "next_id"),
            ("min", "bmin"), ("max", "bmax"))}))
    ro, rd = (torch.from_numpy(x) for x in _rays(
        jbuilders.cover_scene(spp=1, grid=5)[0] if name == "cover" else
        _scene(name)[0]))
    h = [tintersect.intersect(t, ro, rd, traversal="bvh") for t in trees]
    assert h[0].hit.float().mean() > 0.1
    assert torch.equal(torch.where(h[0].hit, h[0].t, 0.0),
                       torch.where(h[1].hit, h[1].t, 0.0))


@pytest.mark.parametrize("n", [1, 2, 3, 7, 64, 100])
def test_bvh_structure(n):
    """tests/test_bvh.py:26-39 on the port's builder."""
    lo, hi = _random_aabbs(n)
    bvh = tbvh.build_bvh(lo, hi)
    m = 2 * n - 1
    assert bvh.obj_id.shape == (m,)
    leaves = bvh.obj_id[bvh.obj_id >= 0]
    assert sorted(leaves.tolist()) == list(range(n))
    assert (bvh.bmin[0] <= lo.min(0) + 1e-6).all()
    assert (bvh.bmax[0] >= hi.max(0) - 1e-6).all()
    assert bvh.next_id[0] == -1
    # every inner node's first child follows it, and every node's box
    # holds its children's
    inner = np.nonzero(bvh.obj_id < 0)[0]
    assert (bvh.left_id[inner] == inner + 1).all()
    for i in inner:
        for c in (bvh.left_id[i], bvh.next_id[bvh.left_id[i]]):
            assert (bvh.bmin[i] <= bvh.bmin[c]).all()
            assert (bvh.bmax[i] >= bvh.bmax[c]).all()


def _walk_both(arrays, ro, rd, leaf_np):
    """rt_tpu's traverse and the port's on the same arrays and rays, with
    the same leaf test written once for each."""
    jt, jp = jbvh.traverse({k: jnp.asarray(v) for k, v in arrays.items()},
                           jnp.asarray(ro), jnp.asarray(rd), 1e-3,
                           lambda p, o, d, tm: leaf_np(jnp, p, o, d, tm))
    tt, tp = tbvh.traverse({k: torch.from_numpy(np.asarray(v))
                            for k, v in arrays.items()},
                           torch.from_numpy(ro), torch.from_numpy(rd), 1e-3,
                           lambda p, o, d, tm: leaf_np(torch, p, o, d, tm))
    return (np.asarray(jt), np.asarray(jp)), (tt.numpy(), tp.numpy())


def test_traverse_single_box_matches_rt_tpu():
    """tests/test_bvh.py:89-109: through the box, and beside it."""
    lo, hi = _random_aabbs(1)
    bvh = tbvh.build_bvh(lo, hi)
    center = (lo[0] + hi[0]) / 2.0
    ro = np.stack([center + [0.0, 0.0, 10.0],
                   center + [100.0, 0.0, 10.0]]).astype(np.float32)
    rd = np.broadcast_to(np.float32([0.0, 0.0, -1.0]), (2, 3)).copy()

    def leaf(xp, pid, o, d, t_min):
        t = (float(center[2]) - o[:, 2]) / d[:, 2]
        return xp.where(t >= t_min, t, np.float32(np.inf))

    (jt, jp), (tt, tp) = _walk_both(bvh._asdict(), ro, rd, leaf)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tp, jp)
    assert np.isfinite(tt[0]) and not np.isfinite(tt[1])


def test_zero_direction_on_node_plane_matches_rt_tpu():
    """tests/test_bvh.py:112-142: a zero direction component whose
    origin lies on the node's plane still enters the box."""
    arrays = {"obj_id": np.int32([0]), "left_id": np.int32([-1]),
              "next_id": np.int32([-1]),
              "bmin": np.float32([[0.0, -2.0, 0.0]]),
              "bmax": np.float32([[4.0, 2.0, 10.0]])}
    ro = np.float32([[0.0, 0.0, 0.0]])
    rd = np.float32([[0.0, 0.0, 1.0]])

    def leaf(xp, pid, o, d, t_min):
        oc = o - xp.asarray(np.float32([0.0, 0.0, 5.0]))
        b_half = (oc * d).sum(-1)
        c = (oc * oc).sum(-1) - 1.0
        disc = b_half * b_half - c
        t = -b_half - xp.sqrt(xp.maximum(disc, xp.zeros_like(disc)))
        return xp.where((disc >= 0) & (t >= t_min), t, np.float32(np.inf))

    (jt, jp), (tt, tp) = _walk_both(arrays, ro, rd, leaf)
    np.testing.assert_array_equal(tt, jt)
    assert tt[0] == pytest.approx(4.0, rel=1e-5)


def test_traverse_random_boxes_matches_rt_tpu():
    """Many boxes, seeded rays, the sphere leaf test of each box's
    inscribed sphere: the same rows on every lane, t within rtol 2e-5
    (XLA-CPU fuses the leaf test's sums and rounds them otherwise); the
    walk reads its condition on the host once a step, and a second walk
    gives the same bits."""
    lo, hi = _random_aabbs(100, seed=4)
    c, r = (lo + hi) / 2, (hi[:, 0] - lo[:, 0]) / 2
    bvh = tbvh.build_bvh(lo, hi)
    rng = np.random.default_rng(5)
    ro = rng.normal(0, 8, (256, 3)).astype(np.float32)
    rd = rng.normal(0, 1, (256, 3)).astype(np.float32)

    def leaf(xp, pid, o, d, t_min):
        cc, rr = xp.asarray(c)[pid], xp.asarray(r)[pid]
        oc = o - cc
        a = (d * d).sum(-1)
        hb = (oc * d).sum(-1)
        disc = hb * hb - a * ((oc * oc).sum(-1) - rr * rr)
        root = (-hb - xp.sqrt(xp.maximum(disc, xp.zeros_like(disc)))) / a
        return xp.where((disc >= 0) & (root >= t_min), root,
                        np.float32(np.inf))

    (jt, jp), (tt, tp) = _walk_both(bvh._asdict(), ro, rd, leaf)
    assert np.isfinite(tt).sum() > 20
    for k in tbvh.COUNTS:
        tbvh.COUNTS[k] = 0
    t1, p1 = tbvh.traverse({k: torch.from_numpy(np.asarray(v))
                            for k, v in bvh._asdict().items()},
                           torch.from_numpy(ro), torch.from_numpy(rd), 1e-3,
                           lambda p, o, d, tm: leaf(torch, p, o, d, tm))
    # one read per phase-A step and per phase-B test, and the last one
    counts = dict(tbvh.COUNTS)
    assert counts["host_reads"] == (counts["advance_steps"]
                                    + counts["leaf_steps"] + 1)
    np.testing.assert_array_equal(t1.numpy(), tt)
    np.testing.assert_array_equal(p1.numpy(), tp)
    np.testing.assert_array_equal(np.isfinite(tt), np.isfinite(jt))
    np.testing.assert_allclose(tt[np.isfinite(tt)], jt[np.isfinite(jt)],
                               rtol=2e-5)
    np.testing.assert_array_equal(tp, jp)


def _scene(name):
    """(rt_tpu's SceneDef, the port's) of a scene of this file."""
    if name == "cover":
        return (jbuilders.cover_scene(spp=1, grid=5)[0],
                tbuilders.cover_scene(spp=1, grid=5)[0])
    if name == "plane441":
        return (jbuilders.mesh_scene(MESH, width=32, height=18)[0],
                tbuilders.mesh_scene(MESH, width=32, height=18)[0])
    if name == "dna":
        return (jbuilders.dna_scene(width=48, height=27)[0],
                tbuilders.dna_scene(width=48, height=27)[0])
    return jparser.parse_scene(DEMO)[0], tparser.parse_scene(DEMO)[0]


def _rays(sdef, n=768, seed=2):
    """Seeded rays around the scene's camera: a third from the camera
    origin toward its view, the rest from random origins."""
    rng = np.random.default_rng(seed)
    cam = np.asarray(sdef.camera_params["lookfrom"], np.float32)
    at = np.asarray(sdef.camera_params["lookat"], np.float32)
    k = n // 3
    ro = np.concatenate([np.broadcast_to(cam, (k, 3)),
                         rng.normal(0, 4, (n - k, 3)) + at])
    rd = np.concatenate([(at - cam) / np.linalg.norm(at - cam)
                         + rng.normal(0, 0.15, (k, 3)),
                         rng.normal(0, 1, (n - k, 3))])
    return ro.astype(np.float32), rd.astype(np.float32)


@pytest.mark.parametrize("name", ["cover", "plane441", "dna"])
def test_intersect_bvh_matches_rt_tpu_per_lane(name):
    sj, st = _scene(name)
    jt = jtypes.build_tables(sj, bvh_types=ALL)
    tt = ttypes.build_tables(st, bvh_types=ALL)
    assert tt.bvh_for == jt.bvh_for and tt.bvh_for
    ro, rd = _rays(sj)
    jh = jintersect.intersect(jt, jnp.asarray(ro), jnp.asarray(rd),
                              traversal="bvh")
    th = tintersect.intersect(tt, torch.from_numpy(ro), torch.from_numpy(rd),
                              traversal="bvh")
    lin = tintersect.intersect(tt, torch.from_numpy(ro),
                               torch.from_numpy(rd))
    hj, ht = np.asarray(jh.hit), th.hit.numpy()
    assert ht.mean() > 0.1, ht.mean()
    same = ((hj == ht) & (np.asarray(jh.ptype) == th.ptype.numpy())
            & (np.asarray(jh.pid) == th.pid.numpy()))
    assert same.mean() >= 0.999, same.mean()
    both = same & ht
    np.testing.assert_allclose(th.t.numpy()[both], np.asarray(jh.t)[both],
                               rtol=2e-4, atol=1e-4)
    np.testing.assert_array_equal(th.obj.numpy()[both],
                                  np.asarray(jh.obj)[both])
    # the walk against the port's own scan (tests/test_bvh.py:65-73)
    np.testing.assert_array_equal(ht, lin.hit.numpy())
    np.testing.assert_allclose(torch.where(th.hit, th.t, 0.0).numpy(),
                               torch.where(lin.hit, lin.t, 0.0).numpy(),
                               rtol=1e-3, atol=5e-3)
    # rows where a lane hits (a missing lane's row means nothing)
    assert (th.pid == lin.pid)[lin.hit].float().mean() > 0.995


def test_bvh_leaves_carried_across_walk_as_the_ports():
    """rt_tpu's tables with every family's BVH, carried across by
    tables_from_numpy: the same leaves and bvh_for as the port's own
    build_tables, and intersect(traversal="bvh") on them equals the one
    on the port's tables lane for lane, bit for bit."""
    for name, fams in (("demo", (("sphere", "cylinder"), ALL)),
                       ("plane441", (("triangle",), ALL))):
        sj, st = _scene(name)
        for types in fams:
            jt = jtypes.build_tables(sj, bvh_types=types)
            carried = tables_from_numpy(jax_leaves(jt))
            own = ttypes.build_tables(st, bvh_types=types)
            assert carried.bvh_for == own.bvh_for == jt.bvh_for
            a, b = carried.leaves(), own.leaves()
            assert sorted(a) == sorted(b)
            for k in a:
                assert torch.equal(a[k], b[k]), k
        ro, rd = (torch.from_numpy(x) for x in _rays(sj, seed=7))
        hc = tintersect.intersect(carried, ro, rd, traversal="bvh")
        ho = tintersect.intersect(own, ro, rd, traversal="bvh")
        assert hc.hit.float().mean() > 0.1
        for f in hc._fields:
            assert torch.equal(getattr(hc, f), getattr(ho, f)), f


@pytest.mark.parametrize("name,w,h", [("dna", 48, 27), ("plane441", 32, 18)])
def test_render_plain_bvh_matches_rt_tpu(name, w, h, images_close):
    """The plain engine with every family's BVH against rt_tpu's "xla"
    with its BVHs, and against the port's own linear frame."""
    sj, st = _scene(name)
    if name == "plane441":
        _, cj = jbuilders.mesh_scene(MESH, width=w, height=h, spp=2,
                                     max_depth=4)
    else:
        _, cj = jbuilders.dna_scene(width=w, height=h, spp=2, max_depth=4)
    jcfg = cj.replace(engine="xla", loop="while", traversal="bvh")
    cfg = RenderConfig(**{**jcfg.__dict__, "engine": "plain"})
    want = np.asarray(jrender(jtypes.build_tables(sj, bvh_types=ALL), jcfg))
    tt = ttypes.build_tables(st, bvh_types=ALL)
    got = trender(tt, cfg, device="cpu").numpy()
    lin = trender(tt, cfg.replace(traversal="linear"), device="cpu").numpy()
    assert got.size == want.size == h * w * 3
    images_close(got.reshape(want.shape), want, 2)
    images_close(got, lin, 2)
