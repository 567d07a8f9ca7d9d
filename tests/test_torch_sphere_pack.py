"""Kernel B1's table packing and row rule (csrc/sphere_hit.cu), on the CPU.

The wrapper `cuda_intersect.sphere_closest_hit` hands the kernel one
16-byte row a sphere, `pack_table`: cx, cy, cz, c2r = |c|^2 - r^2, with
c2r = +inf for a pad row. The kernel then tests the discriminant first:
the roots only where disc >= 0 (a pad row's disc is -inf), rows in
ascending order with `if (t <= t_best)`, and pid = N-1 for a ray whose
t_best stays inf. `kernel_rule` below is that loop in plain torch, one
row at a time over all rays, on the packed rows. It must give
`sphere_closest_hit_plain`'s t and pid bit for bit (pad rows, rays that
hit nothing, equal spheres), so the packing and the skipping rule keep
the contract; the root is divided by a here as in the plain version (the
kernel multiplies by 1/a, held against the plain version on the card by
tests/test_torch_cuda.py). The plain version itself is held against
rt_tpu's Pallas kernel in interpret mode by tests/test_torch_intersect.py.
"""

import numpy as np
import pytest
import torch

from rt_tpu_torch.ops import cuda_intersect
from rt_tpu_torch.ops import geometry as geom
from rt_tpu_torch.scene import builders, types

torch.set_num_threads(1)

INF = float("inf")


def kernel_rule(table, ro, rd, t_min=1e-3):
    """The kernel's loop over the packed rows [N,4], vectorised over rays:
    (t [B], pid [B] int32)."""
    a = geom.length_squared(rd)
    rd_dot_ro = geom.dot(rd, ro)
    ro_sq = geom.length_squared(ro)
    t_best = torch.full((ro.shape[0],), INF)
    id_best = torch.zeros(ro.shape[0], dtype=torch.int32)
    for j in range(table.shape[0]):
        cx, cy, cz, c2r = table[j]
        hb = rd_dot_ro - (rd[:, 0] * cx + rd[:, 1] * cy + rd[:, 2] * cz)
        c_term = (ro_sq - 2.0 * (ro[:, 0] * cx + ro[:, 1] * cy
                                 + ro[:, 2] * cz) + c2r)
        disc = hb * hb - a * c_term
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        r1 = (-hb - sq) / a
        r2 = (-hb + sq) / a
        t = torch.where(r1 >= t_min, r1, torch.where(r2 >= t_min, r2, INF))
        take = (disc >= 0.0) & (t <= t_best)    # skipped where disc < 0
        t_best = torch.where(take, t, t_best)
        id_best = torch.where(take, j, id_best).to(torch.int32)
    n = table.shape[0]
    return t_best, torch.where(torch.isfinite(t_best), id_best, n - 1).to(
        torch.int32)


def _case(name, b=700):
    """(centers, radii, live, ro, rd) float32 / bool tensors."""
    rs = np.random.default_rng(17)
    if name == "cover":
        tt = types.build_tables(builders.cover_scene(grid=4)[0])
        c, r = tt.sph_center.numpy(), tt.sph_radius.numpy()
        live = (tt.sph_obj >= 0).numpy()
        assert not live.all()            # the table has pad rows
    elif name == "ties":
        c = np.repeat(rs.normal(0, 2, (30, 3)), 3, 0)
        r = np.repeat(rs.uniform(0.2, 0.8, 30), 3)
        live = np.ones(90, bool)
    elif name == "pad":
        c = rs.normal(0, 2, (120, 3))
        r = rs.uniform(0.2, 0.6, 120)
        live = rs.random(120) >= 1 / 3
        c[~live] = c[rs.choice(np.flatnonzero(live), (~live).sum())] \
            + np.array([0.0, 0.0, 0.5])  # nearer the camera than a live row
    else:  # miss: every sphere behind every ray
        c = rs.normal(0, 1, (40, 3)) + np.array([0.0, 0.0, -50.0])
        r = rs.uniform(0.2, 0.6, 40)
        live = np.ones(40, bool)
    if name == "miss":
        ro = rs.normal(0, 1, (b, 3))
        rd = rs.normal(0, 0.2, (b, 3)) + np.array([0.0, 0.0, 1.0])
    elif name == "cover":
        ro = rs.normal(0, 3, (b, 3))
        rd = rs.normal(0, 1, (b, 3))
    else:
        ro = rs.normal(0, 1, (b, 3)) + np.array([0.0, 0.0, 12.0])
        rd = c[rs.integers(0, c.shape[0], b)] + rs.normal(0, 0.3, (b, 3)) - ro
    rd = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
    f = lambda x: torch.from_numpy(np.asarray(x, np.float32))  # noqa: E731
    return f(c), f(r), torch.from_numpy(live), f(ro), f(rd)


def test_pack_table_rows():
    """[N,4] contiguous float32 rows: the centre, then the plain version's
    c2r bit for bit on live rows and +inf on pad rows."""
    c, r, live, _, _ = _case("pad")
    table = cuda_intersect.pack_table(c, r, live)
    assert table.shape == (c.shape[0], 4) and table.is_contiguous()
    assert table.dtype == torch.float32
    assert torch.equal(table[:, :3], c)
    c2r = geom.length_squared(c) - r * r
    assert torch.equal(table[live, 3], c2r[live])
    assert bool(torch.isposinf(table[~live, 3]).all())


@pytest.mark.parametrize("name", ["cover", "ties", "pad", "miss"])
def test_kernel_rule_on_packed_rows_matches_plain(name):
    """The packed rows through the kernel's discriminant-first loop give
    the plain version's t and pid bit for bit: a pad row never wins, a
    ray that hits nothing reports N-1, equal spheres go to the last
    copy."""
    c, r, live, ro, rd = _case(name)
    t_k, pid_k = kernel_rule(cuda_intersect.pack_table(c, r, live), ro, rd)
    t_p, pid_p = cuda_intersect.sphere_closest_hit_plain(c, r, live, ro, rd)
    assert torch.equal(t_k.view(torch.int32), t_p.view(torch.int32))
    assert torch.equal(pid_k, pid_p)
    hit = torch.isfinite(t_k)
    n = c.shape[0]
    assert bool((pid_k[~hit] == n - 1).all())
    assert bool(live[pid_k[hit].long()].all())
    if name == "miss":
        assert not bool(hit.any())
    else:
        assert float(hit.float().mean()) > 0.1
    if name == "ties":
        assert bool((pid_k[hit] % 3 == 2).all())


def test_kernel_rule_without_the_pad_sentinel_differs():
    """The +inf sentinel is what keeps a pad row out: packed with its
    real c2r, a pad row in front of a live one takes some rays."""
    c, r, live, ro, rd = _case("pad")
    loose = cuda_intersect.pack_table(c, r, torch.ones_like(live))
    _, pid = kernel_rule(loose, ro, rd)
    t_p, _ = cuda_intersect.sphere_closest_hit_plain(c, r, live, ro, rd)
    assert bool((~live[pid.long()] & torch.isfinite(t_p)).any())
