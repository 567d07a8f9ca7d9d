"""The warp-cooperative closest hit of the kernels B2-B7
(csrc/bounce.cuh `warp_hit`, `warp_last_min`) and the warp loops around
it, emulated step by step in numpy on one warp of 32 lanes, against the
sequential `<=` loop of one lane at a time and against the plain
version's chunk fold (ops/mega_plain `_last_argmin` + `_take`).

The emulation does what the kernel does per chunk c, in ascending order:
each lane with a ray decides whether it needs the chunk against its own
closest hit so far (a stand-in for box_visible: the box's entry t no
later than t_best), the warp ballots the needing lanes, and when at most
kDenseMax of them need it thread l holds row c + l: for each needing
lane src in turn every thread computes its row's t for src's ray (+inf
past the table's end), the warp takes the least order key of t + 0.0f
(__reduce_min_sync), the ballot of the threads holding it, masked to the
chunk's rows, and its last set bit, shuffles that thread's t, and lane
src folds it with `if (t_win <= t_best)`. Above kDenseMax the needing
lanes run the rows in turn with the same `<=`. The kernel's results must
be the sequential loop's bits: t_best's bits and its row (on a miss too,
where the `<=` loop ends on the chunk's last row), and the plain
version's t_best and, where it is finite, its row (the plain fold takes
no infinite tie, so a miss's row means nothing there)."""

import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from rt_tpu_torch.ops import mega_plain

torch.set_num_threads(1)

WARP = 32
CHUNK = 32
SRC = Path(__file__).resolve().parents[1] / "rt_tpu_torch" / "csrc"
# the default build's kDenseMax, read from the source the kernels build
K_DENSE_MAX = int(re.search(r"#define RTT_DENSE_MAX (\d+)",
                            (SRC / "bounce.cuh").read_text()).group(1))


def order_key(t):
    """warp_last_min's key of float32 t: t + 0.0f (-0 becomes +0), its bits
    as an unsigned integer, negatives flipped so that keys order as the
    floats do."""
    bits = (t + np.float32(0.0)).astype(np.float32).view(np.uint32)
    neg = (bits & np.uint32(0x80000000)) != 0
    return np.where(neg, ~bits, bits | np.uint32(0x80000000)).astype(
        np.uint32)


def warp_last_min(t, rows):
    """(t_win, last) of warp_last_min: t [32] float32, one per thread;
    rows the chunk's row mask."""
    key = order_key(t)
    least = key.min()                                   # __reduce_min_sync
    eq = sum(1 << l for l in range(WARP) if key[l] == least)  # __ballot_sync
    last = (eq & rows).bit_length() - 1                 # 31 - __clz
    return t[last], last                                # __shfl_sync


def sequential(t, entry, active):
    """The per-lane kernels' loop: per lane, chunks in ascending order, a
    chunk taken when entry <= t_best, its rows in ascending order with
    `if (t <= t_best)`. t [32, N] float32; entry [32, K]."""
    n = t.shape[1]
    best = np.full(WARP, np.inf, np.float32)
    row = np.zeros(WARP, np.int64)
    for l in range(WARP):
        if not active[l]:
            continue
        for c in range(0, n, CHUNK):
            if not entry[l, c // CHUNK] <= best[l]:
                continue
            for j in range(c, min(c + CHUNK, n)):
                if t[l, j] <= best[l]:
                    best[l], row[l] = t[l, j], j
    return best, row


def warp_fold(t, entry, active, dense_max):
    """The warp-cooperative loop of warp_hit, step by step."""
    n = t.shape[1]
    best = np.full(WARP, np.inf, np.float32)
    row = np.zeros(WARP, np.int64)
    dense_chunks = 0
    for c in range(0, n, CHUNK):
        end = min(c + CHUNK, n)
        need = [bool(active[l] and entry[l, c // CHUNK] <= best[l])
                for l in range(WARP)]
        needs = sum(1 << l for l in range(WARP) if need[l])  # __ballot_sync
        if needs == 0:
            continue
        if bin(needs).count("1") > dense_max:
            for l in range(WARP):
                if need[l]:
                    for j in range(c, end):
                        if t[l, j] <= best[l]:
                            best[l], row[l] = t[l, j], j
            continue
        dense_chunks += 1
        rows = (1 << (end - c)) - 1
        m = needs
        while m:
            src = (m & -m).bit_length() - 1                 # __ffs(m) - 1
            m &= m - 1
            # thread l tests src's ray against row c + l
            tl = np.full(WARP, np.inf, np.float32)
            tl[:end - c] = t[src, c:end]
            tw, last = warp_last_min(tl, rows)
            if tw <= best[src]:
                best[src], row[src] = tw, c + last
    return best, row, dense_chunks


def plain_fold(t, entry, active):
    """ops/mega_plain's chunk fold (_culled_best's loop): each chunk's
    _last_argmin, taken where the lane needs the chunk and _take holds."""
    n = t.shape[1]
    k = -(-n // CHUNK)
    tp = torch.full((WARP, k * CHUNK), float("inf"))
    tp[:, :n] = torch.from_numpy(t)
    tk, rk = mega_plain._last_argmin(tp.view(WARP, k, CHUNK))
    tb = torch.full((WARP,), float("inf"))
    rb = torch.zeros(WARP, dtype=torch.long)
    act = torch.from_numpy(active)
    ent = torch.from_numpy(entry)
    for j in range(k):
        vis = act & (ent[:, j] <= tb)
        take = vis & mega_plain._take(tk[:, j], tb)
        tb = torch.where(take, tk[:, j], tb)
        rb = torch.where(take, rk[:, j] + j * CHUNK, rb)
    return tb.numpy(), rb.numpy()


def make_case(case, n_active, seed):
    """(t [32, N], box entry [32, K], active [32]) of a named case."""
    rs = np.random.default_rng(seed)
    n = {"partial_last": 77, "all_inf_chunk": 96}.get(case, 128)
    k = -(-n // CHUNK)
    # coarse values so that equal t within and across chunks are common
    t = rs.integers(1, 40, (WARP, n)).astype(np.float32) * np.float32(0.25)
    t[rs.random((WARP, n)) < 0.5] = np.inf              # rows missed
    if case == "ties_in_chunk":
        t[:, 3:9] = t[:, 3:4]
        t[:, 20:31] = np.float32(0.5)
    elif case == "ties_across_chunks":
        t[:, 30:34] = np.float32(0.25)                  # rows 30-33
        t[:, 64 + 5] = np.float32(0.25)
    elif case == "all_inf_chunk":
        t[:, 32:64] = np.inf
        t[:8] = np.inf                                  # 8 lanes miss all
    elif case == "neg_zero":                            # t_min 0
        z = rs.random((WARP, n)) < 0.2
        t[z] = np.where(rs.random(z.sum()) < 0.5, np.float32(-0.0),
                        np.float32(0.0))
    # a box's entry t: the first chunk always visible, later ones by
    # entry <= t_best, as box_visible against the closest hit so far
    entry = rs.integers(0, 40, (WARP, k)).astype(np.float32) * np.float32(
        0.25)
    entry[:, 0] = -np.inf
    active = np.zeros(WARP, bool)
    active[rs.choice(WARP, n_active, replace=False)] = True
    if case == "partial_last":
        # the partial chunk misses every ray, and one lane with a ray
        # misses everything: its `<=` loop ends on the table's last row,
        # not on a thread past it
        t[:, 64:] = np.inf
        t[np.flatnonzero(active)[0]] = np.inf
    return t, entry, active


CASES = ["random", "ties_in_chunk", "ties_across_chunks", "all_inf_chunk",
         "partial_last", "neg_zero"]


@pytest.mark.parametrize("n_active", [1, 7, 32])
@pytest.mark.parametrize("case", CASES)
def test_dense_fold_matches_sequential_and_plain(case, n_active):
    """Always dense (kDenseMax 32): every chunk any lane needs goes through
    warp_last_min; the winner's t bits and row equal the sequential `<=`
    loop's on every lane, and the plain fold's t (its row where t is
    finite)."""
    for seed in range(3):
        t, entry, active = make_case(case, n_active, seed)
        want_t, want_r = sequential(t, entry, active)
        got_t, got_r, dense = warp_fold(t, entry, active, WARP)
        assert dense >= 1
        np.testing.assert_array_equal(got_t.view(np.uint32),
                                      want_t.view(np.uint32))
        np.testing.assert_array_equal(got_r, want_r)
        plain_t, plain_r = plain_fold(t, entry, active)
        np.testing.assert_array_equal(plain_t.view(np.uint32),
                                      want_t.view(np.uint32))
        fin = np.isfinite(want_t)
        np.testing.assert_array_equal(plain_r[fin], want_r[fin])
        if case == "neg_zero":
            assert (want_t == 0).any()


@pytest.mark.parametrize("n_active", [1, 7, 32])
def test_mixed_schedule_matches_sequential(n_active):
    """The default build's kDenseMax: chunks with more needing lanes take
    the per-lane loop, the others the dense fold; the result is the
    sequential loop's on every lane."""
    assert 0 < K_DENSE_MAX <= WARP
    for seed in range(3):
        t, entry, active = make_case("ties_in_chunk", n_active, 10 + seed)
        want_t, want_r = sequential(t, entry, active)
        got_t, got_r, _ = warp_fold(t, entry, active, K_DENSE_MAX)
        np.testing.assert_array_equal(got_t.view(np.uint32),
                                      want_t.view(np.uint32))
        np.testing.assert_array_equal(got_r, want_r)


def warp_bounce(go, dense_max, case_seed):
    """One bounce's closest hit, entered by every thread of the warp: the
    winners of the lanes that go (go [32] bool) are the sequential loop's,
    a helper's winner stays empty (it folds nothing). Returns (t, row)."""
    t, entry, _ = make_case("ties_in_chunk", WARP, case_seed)
    want_t, want_r = sequential(t, entry, go)
    got_t, got_r, _ = warp_fold(t, entry, go, dense_max)
    np.testing.assert_array_equal(got_t[go].view(np.uint32),
                                  want_t[go].view(np.uint32))
    np.testing.assert_array_equal(got_r[go], want_r[go])
    assert np.isinf(got_t[~go]).all() and (got_r[~go] == 0).all()
    return got_t, got_r


def mega_loop(n_lanes, dense_max, seed, max_depth=6):
    """B2's loop in mega.cu on one warp, bounce by bounce: lanes past n
    (n_lanes of the 32 hold a lane) and lanes dead on entry never go;
    a lane goes while it is alive and below max_depth, and dies after its
    own number of bounces (a miss, or the roulette); every thread enters
    each bounce's warp_fold while any lane goes, those that do not go
    helping. Each bounce's winners of the lanes that go are checked
    against the sequential loop; returns (bounces per lane, steps, each
    lane's bounces to death)."""
    rs = np.random.default_rng(seed)
    alive = np.arange(WARP) < n_lanes
    alive[rs.random(WARP) < 0.2] = False               # dead on entry
    alive[0] = n_lanes > 0
    life = rs.integers(1, 9, WARP)                      # bounces to death
    b = np.zeros(WARP, np.int64)
    steps = 0
    while True:
        go = alive & (b < max_depth)
        if not go.any():                                # __any_sync
            break
        warp_bounce(go, dense_max, seed * 100 + steps)
        b[go] += 1
        alive &= b < life
        steps += 1
    return b, steps, life


@pytest.mark.parametrize("dense_max", [0, K_DENSE_MAX, WARP])
@pytest.mark.parametrize("n_lanes", [32, 19, 1])
def test_mega_loop_with_lanes_dropping_out(n_lanes, dense_max):
    """B2's warp-cooperative loop: the active lanes change between
    bounces (lanes die) and lanes past n only help, yet each lane's
    winner at each of its bounces is the per-lane sequential loop's, and
    the warp runs as many steps as its longest-lived lane."""
    for seed in range(3):
        b, steps, life = mega_loop(n_lanes, dense_max, 7 + seed)
        assert (b[n_lanes:] == 0).all()
        assert steps == b.max()
        went = b > 0
        np.testing.assert_array_equal(b[went],
                                      np.minimum(life[went], 6))


UNSET = -7          # an element of B4's codes no thread has written


def capture_case(seed, max_depth, all_stop_at):
    """B4's per-(bounce, lane) data on one warp: each bounce's (t, entry)
    from make_case (lane l's ray at bounce b; every fifth (bounce, lane)
    misses every row), the roulette's stops per (bounce, lane) (every
    lane at bounce all_stop_at, unless None), each row's family and its
    SceneTables row (scene_row of a Morton-sorted row)."""
    rs = np.random.default_rng(seed)
    cases = []
    for b in range(max_depth):
        t, entry, _ = make_case("ties_in_chunk", WARP, seed * 100 + b)
        t[rs.random(WARP) < 0.2] = np.inf
        cases.append((t, entry))
    stop = rs.random((max_depth, WARP)) < 0.25
    if all_stop_at is not None:
        stop[all_stop_at] = True
    n = cases[0][0].shape[1]
    return cases, stop, rs.integers(0, 4, n), rs.permutation(n)


def tape_code(t, row, fam, scene_row):
    """kCapture's code of a winner: `family << 24 | SceneTables row`, -1
    on a miss."""
    return int(fam[row] << 24 | scene_row[row]) if np.isfinite(t) else -1


def capture_loop(n_lanes, dense_max, data, max_depth):
    """B4's loop in capture.cu on one warp, iteration by iteration: n_lanes
    of the 32 threads hold a lane; iteration b is bounce b of every lane
    that goes (alive), left when none does (__any_sync); every thread
    enters the bounce's warp_fold, the lanes that go active, a lane that
    the roulette stops among them (it records this bounce's winner, then
    dies); a miss kills the lane. Each thread with a lane stores row b
    (its code, -1 once dead) in iteration b, then the rows [b,
    max_depth) with -1. Returns (codes [max_depth, 32], UNSET where no
    thread stored; death [32]; the stores as (row, lanes) in issue
    order)."""
    cases, stop, fam, scene_row = data
    mine = np.arange(WARP) < n_lanes
    alive = mine.copy()
    codes = np.full((max_depth, WARP), UNSET, np.int64)
    death = np.full(WARP, UNSET, np.int64)
    after = np.zeros(WARP, np.int64)
    stores = []
    b = 0
    while b < max_depth:
        go = alive.copy()
        if not go.any():                                # __any_sync
            break
        t, entry = cases[b]
        want_t, want_r = sequential(t, entry, go)
        got_t, got_r, _ = warp_fold(t, entry, go, dense_max)
        np.testing.assert_array_equal(got_t[go].view(np.uint32),
                                      want_t[go].view(np.uint32))
        np.testing.assert_array_equal(got_r[go], want_r[go])
        code = np.full(WARP, -1, np.int64)
        for l in np.flatnonzero(go):
            code[l] = tape_code(got_t[l], got_r[l], fam, scene_row)
        codes[b, mine] = code[mine]                     # every lane, row b
        stores.append((b, mine.copy()))
        alive = go & (code >= 0) & ~stop[b]
        after += alive
        b += 1
    for r in range(b, max_depth):                       # the rows after
        codes[r, mine] = -1
        stores.append((r, mine.copy()))
    death[mine] = after[mine]
    return codes, death, stores


def capture_sequential(n_lanes, data, max_depth):
    """The per-lane loop B4 ran before its warp loop: each lane alone,
    bounce by bounce while alive, its code stored at its bounce, then -1
    for each bounce after its death."""
    cases, stop, fam, scene_row = data
    codes = np.full((max_depth, WARP), UNSET, np.int64)
    death = np.full(WARP, UNSET, np.int64)
    for l in range(n_lanes):
        one = np.arange(WARP) == l
        b, after, alive = 0, 0, True
        while b < max_depth and alive:
            t, entry = cases[b]
            bt, br = sequential(t, entry, one)
            codes[b, l] = tape_code(bt[l], br[l], fam, scene_row)
            alive = codes[b, l] >= 0 and not stop[b, l]
            after += alive
            b += 1
        codes[b:, l] = -1
        death[l] = after
    return codes, death


def capture_plain_run(n_lanes, data, max_depth, monkeypatch):
    """ops/mega_plain.capture_plain itself on the lanes (pixel = lane),
    its bounce replaced by the lanes' data through the plain chunk fold:
    its bookkeeping of codes and deaths. Returns (codes, death) of the
    n_lanes lanes."""
    cases, stop, fam, scene_row = data

    def bounce(tab, st, pix, sample, k, seed, **kw):
        active = np.zeros(WARP, bool)
        active[pix.numpy()] = True
        t, entry = cases[k]
        tb, rb = (torch.from_numpy(x)[pix] for x in plain_fold(t, entry,
                                                                active))
        hit = torch.isfinite(tb)
        return SimpleNamespace(
            hit=hit, family=torch.from_numpy(fam)[rb],
            row=torch.from_numpy(scene_row)[rb], state=st,
            scattered=hit & ~torch.from_numpy(stop[k])[pix])

    monkeypatch.setattr(mega_plain, "bounce_plain", bounce)
    codes, death = mega_plain.capture_plain(
        None, torch.zeros((mega_plain.NSTATE, n_lanes)),
        torch.arange(n_lanes), 0, 0, max_depth, t_min=1e-3, p_rr=0.5,
        grad_bg=False, bg=None)
    return codes.numpy().astype(np.int64), death.numpy().astype(np.int64)


@pytest.mark.parametrize("all_stop_at", [None, 0, 2])
@pytest.mark.parametrize("dense_max", [0, K_DENSE_MAX, WARP])
@pytest.mark.parametrize("n_lanes", [32, 19, 1])
def test_capture_loop_matches_per_lane_and_plain(n_lanes, dense_max,
                                                 all_stop_at, monkeypatch):
    """B4's warp loop (capture.cu): lanes past n, misses, lanes that the
    roulette stops (at all_stop_at every live lane of the warp at once),
    every thread in each bounce's warp_fold. The codes and deaths equal
    the per-lane sequential loop's and capture_plain's, code for code
    and death for death;
    each element of a lane's codes is stored once and lanes past n store
    nothing; every store of the warp writes one row for all its lanes
    (one segment); and a lane the roulette stops on a hit records that
    hit."""
    max_depth = 6
    for seed in range(3):
        data = capture_case(50 + seed, max_depth, all_stop_at)
        codes, death, stores = capture_loop(n_lanes, dense_max, data,
                                            max_depth)
        want, want_death = capture_sequential(n_lanes, data, max_depth)
        np.testing.assert_array_equal(codes, want)
        np.testing.assert_array_equal(death, want_death)
        plain, plain_death = capture_plain_run(n_lanes, data, max_depth,
                                               monkeypatch)
        np.testing.assert_array_equal(codes[:, :n_lanes], plain)
        np.testing.assert_array_equal(death[:n_lanes], plain_death)
        mine = np.arange(WARP) < n_lanes
        assert (codes[:, ~mine] == UNSET).all()
        assert sorted(r for r, _ in stores) == list(range(max_depth))
        assert all((lanes == mine).all() for _, lanes in stores)
        # a death bounce that ends on a hit: the roulette's stop
        lane = np.arange(WARP)[mine]
        ends = death[mine] < max_depth
        at = codes[np.minimum(death[mine], max_depth - 1), lane]
        if all_stop_at is not None:
            assert (death[mine] <= all_stop_at).all()
        if seed == 0 and n_lanes == WARP:
            assert (ends & (at >= 0)).any()


# B7's lanes owe REGEN_SPP samples of at most REGEN_DEPTH bounces each
REGEN_SPP, REGEN_DEPTH = 4, 5
UNCAPPED = 1000     # more iterations than any lane needs: one segment


def regen_lanes(seed):
    """A resumed segment's entry (init 0) for one warp: each lane's alive,
    samp, bvec, and life[l, s], the bounces sample s of lane l lives (a
    path dies after its bounce at bvec when bvec + 1 >= life). Some lanes
    are dead with nothing owed (not pending on entry); some are alive at
    bvec max_depth (retired by step (1) at once)."""
    rs = np.random.default_rng(seed)
    samp = rs.integers(0, REGEN_SPP, WARP)
    bvec = rs.integers(0, REGEN_DEPTH + 1, WARP)
    alive = rs.random(WARP) < 0.6
    idle = rs.random(WARP) < 0.25
    alive[idle] = False
    samp[idle] = REGEN_SPP - 1
    alive[0], samp[0], bvec[0] = True, 0, 0            # lane 0 owes all
    life = rs.integers(1, 9, (WARP, REGEN_SPP))
    return dict(alive=alive, samp=samp, bvec=bvec, life=life)


def regen_steps(lane, pending):
    """Steps (1) and (2) of B7's iteration for the lanes `pending`: retire
    a lane alive at max_depth, then start the next sample of a dead lane
    that owes one. Returns the lanes that bounce (alive after (2))."""
    alive, samp, bvec = lane["alive"], lane["samp"], lane["bvec"]
    alive[pending & alive & (bvec >= REGEN_DEPTH)] = False
    nxt = pending & ~alive & (samp + 1 < REGEN_SPP)
    samp[nxt] += 1
    bvec[nxt] = 0
    alive[nxt] = True
    return pending & alive


def regen_bounce(lane, go, bounces, coords):
    """Step (3) for the lanes `go`: the bounce at (samp, bvec), recorded
    in coords, and each path's death by its life."""
    alive, samp, bvec, life = (lane[k] for k in ("alive", "samp", "bvec",
                                                 "life"))
    for l in np.flatnonzero(go):
        coords.append((int(l), int(samp[l]), int(bvec[l])))
        alive[l] = bvec[l] + 1 < life[l, samp[l]]
    bounces[go] += 1


def regen_loop(n_lanes, dense_max, entry, seg_iters, seed):
    """B7's loop in regen.cu on one warp, iteration by iteration: n_lanes
    of the 32 threads hold a lane; a lane not pending on entry (dead, no
    sample owed) is not handled; each iteration computes `pending`
    (alive, or a sample owed), leaves when no lane is (__any_sync), runs
    steps (1) and (2) on the pending lanes, then every thread enters the
    bounce's warp_fold, the lanes alive after (2) going, and bvec + 1 for
    the lanes pending at the top only. Returns (the lanes' state, bounces,
    the bounces' (lane, samp, bvec), iterations run)."""
    lane = {k: v.copy() for k, v in entry.items()}
    mine = (np.arange(WARP) < n_lanes) & (
        lane["alive"] | (lane["samp"] + 1 < REGEN_SPP))
    bounces = np.zeros(WARP, np.int64)
    coords = []
    steps = 0
    for it in range(seg_iters):
        pending = mine & (lane["alive"] | (lane["samp"] + 1 < REGEN_SPP))
        if not pending.any():                           # __any_sync
            break
        go = regen_steps(lane, pending)
        warp_bounce(go, dense_max, seed * 1000 + it)    # every thread
        regen_bounce(lane, go, bounces, coords)
        lane["bvec"][pending] += 1
        steps += 1
    return lane, bounces, coords, steps


def regen_sequential(n_lanes, entry, seg_iters):
    """The per-lane loop B7 ran before its warp loop: each lane alone while
    it is pending, at most seg_iters iterations. Returns (state, bounces,
    coords, iterations per lane)."""
    lane = {k: v.copy() for k, v in entry.items()}
    bounces = np.zeros(WARP, np.int64)
    iters = np.zeros(WARP, np.int64)
    coords = []
    for l in range(n_lanes):
        one = np.arange(WARP) == l
        while iters[l] < seg_iters and (
                lane["alive"][l] or lane["samp"][l] + 1 < REGEN_SPP):
            go = regen_steps(lane, one)
            regen_bounce(lane, go, bounces, coords)
            lane["bvec"][l] += 1
            iters[l] += 1
    return lane, bounces, coords, iters


def regen_plain_run(n_lanes, entry, seg_iters, monkeypatch):
    """ops/mega_plain.regen_plain itself on the lanes (pixel = lane), its
    bounce replaced by the lanes' lives and its camera by constant rays:
    its bookkeeping of samp, bvec, the depth count and alive. Returns
    (state, bounces, coords, lanes past n untouched)."""
    coords = []
    life = torch.from_numpy(entry["life"])

    def bounce(tab, st, pix, s_, b_, seed, **kw):
        coords.extend(zip(pix.tolist(), s_.tolist(), b_.tolist()))
        out = st.clone()
        out[mega_plain.ALIVE] = (b_ + 1 < life[pix, s_]).float()
        return out

    def rays(cam_def, w, h, px, py, sample, *args):
        return torch.zeros((px.shape[0], 3)), torch.ones((px.shape[0], 3))

    monkeypatch.setattr(mega_plain, "do_bounce_plain", bounce)
    monkeypatch.setattr(mega_plain, "camera", SimpleNamespace(
        camera_of_vec=lambda cam, dev: None, generate_rays=rays))
    state = torch.zeros((mega_plain.NSTATE, WARP))
    state[mega_plain.ALIVE] = torch.from_numpy(entry["alive"]).float()
    before = state.clone()
    samp = torch.from_numpy(entry["samp"]).to(torch.int32)
    bvec = torch.from_numpy(entry["bvec"]).to(torch.int32)
    depth = torch.zeros(WARP, dtype=torch.int32)
    lanes = torch.arange(WARP, dtype=torch.int32)
    mega_plain.regen_plain(
        None, [0.0] * 19, state, lanes, torch.zeros_like(lanes), samp, bvec,
        0, 0, seg_iters, max_depth=REGEN_DEPTH, spp=REGEN_SPP, init=False,
        width=WARP, height=1, defocus=False, n=n_lanes, bg=None,
        depth=depth)
    lane = dict(alive=(state[mega_plain.ALIVE] > 0).numpy(),
                samp=samp.numpy().astype(np.int64),
                bvec=bvec.numpy().astype(np.int64))
    untouched = torch.equal(state[:, n_lanes:], before[:, n_lanes:])
    return lane, depth.numpy().astype(np.int64), coords, untouched


def assert_lanes_equal(a, b, n_lanes):
    for k in ("alive", "samp", "bvec"):
        np.testing.assert_array_equal(a[k][:n_lanes], b[k][:n_lanes], k)


@pytest.mark.parametrize("capped", [False, True])
@pytest.mark.parametrize("dense_max", [0, K_DENSE_MAX, WARP])
@pytest.mark.parametrize("n_lanes", [32, 19, 1])
def test_regen_loop_matches_per_lane_and_plain(n_lanes, dense_max, capped,
                                               monkeypatch):
    """B7's warp loop (regen.cu): lanes past n, lanes not pending on entry,
    per-lane lives and owed samples, every thread in each bounce's
    warp_fold. Each lane's (samp, bvec, bounces, alive) and bounce
    coordinates equal the per-lane sequential loop's and regen_plain's
    (bvec + 1 only while the lane is pending), the warp runs as many
    iterations as its slowest pending lane, lanes past n keep their
    values, and with a cap of seg_iters that falls mid-sample, two
    segments equal one uncapped segment."""
    for seed in range(3):
        entry = regen_lanes(40 + seed)
        first = 7 if capped else UNCAPPED
        got, bounces, coords, steps = regen_loop(n_lanes, dense_max, entry,
                                                 first, seed)
        want, want_b, want_c, iters = regen_sequential(n_lanes, entry,
                                                       first)
        plain, plain_b, plain_c, untouched = regen_plain_run(
            n_lanes, entry, first, monkeypatch)
        for other, other_b, other_c in ((want, want_b, want_c),
                                        (plain, plain_b, plain_c)):
            assert_lanes_equal(got, other, n_lanes)
            np.testing.assert_array_equal(bounces[:n_lanes],
                                          other_b[:n_lanes])
            assert sorted(coords) == sorted(other_c)
        assert steps == iters.max() and steps <= first
        assert untouched and (bounces[n_lanes:] == 0).all()
        for k in ("alive", "samp", "bvec"):
            np.testing.assert_array_equal(got[k][n_lanes:],
                                          entry[k][n_lanes:])
        idle = ~entry["alive"][:n_lanes] & (
            entry["samp"][:n_lanes] + 1 >= REGEN_SPP)
        assert (got["bvec"][:n_lanes][idle]
                == entry["bvec"][:n_lanes][idle]).all()
        if not capped:
            assert not got["alive"][:n_lanes].any()
            assert (got["samp"][:n_lanes] == REGEN_SPP - 1).all()
            continue
        # the cap fell mid-sample: a lane alive past its first bounce
        assert (got["alive"] & (got["bvec"] > 0))[:n_lanes].any()
        rest = {**got, "life": entry["life"]}
        got2, bounces2, coords2, _ = regen_loop(n_lanes, dense_max, rest,
                                                UNCAPPED, seed + 7)
        one, one_b, one_c, _ = regen_loop(n_lanes, dense_max, entry,
                                          UNCAPPED, seed)
        assert_lanes_equal(got2, one, n_lanes)
        np.testing.assert_array_equal(bounces + bounces2, one_b)
        assert sorted(coords + coords2) == sorted(one_c)


def adjoint_loop(n_lanes, dense_max, seed, max_depth=6):
    """B5's loop in mega_adjoint.cu on one warp: lanes past n and lanes
    dead on entry never go; every thread enters each bounce's warp_fold
    while any lane goes; a lane that goes adds its cotangent to its
    winner's slot (a miss: the sky's), a helper adds nothing; a lane
    alive at max_depth credits the sky after the loop; every thread then
    reaches the flush. Returns (the slots, bounces, steps, threads at
    the flush)."""
    rs = np.random.default_rng(seed)
    mine = np.arange(WARP) < n_lanes
    mine[rs.random(WARP) < 0.2] = False                 # dead on entry
    mine[0] = n_lanes > 0
    life = rs.integers(1, 9, WARP)
    g = rs.integers(1, 100, WARP)
    acc = np.zeros(4 * CHUNK + 1, np.int64)             # rows, then sky
    alive = mine.copy()
    b = np.zeros(WARP, np.int64)
    steps = 0
    while True:
        go = mine & alive & (b < max_depth)
        if not go.any():                                # __any_sync
            break
        t, row = warp_bounce(go, dense_max, seed * 100 + steps)
        for l in np.flatnonzero(go):
            acc[row[l] if np.isfinite(t[l]) else -1] += g[l]
        b[go] += 1
        alive &= ~go | (b < life)
        steps += 1
    for l in np.flatnonzero(mine & alive):              # exhaust_bg
        acc[-1] += g[l]
    at_flush = WARP                                     # no thread left
    return acc, b, steps, at_flush, (mine, life, g)


@pytest.mark.parametrize("dense_max", [0, K_DENSE_MAX, WARP])
@pytest.mark.parametrize("n_lanes", [32, 19, 1])
def test_adjoint_loop_helpers_credit_nothing(n_lanes, dense_max):
    """B5's warp loop: the slots equal a per-lane replay's (each lane's
    k-th bounce against that bounce's rows, alone), so the helpers (past
    n, dead on entry, dead or at max_depth) credit nothing; each lane
    runs min(life, max_depth) bounces, the warp as many steps as its
    longest; every thread reaches the flush."""
    for seed in range(3):
        acc, b, steps, at_flush, (mine, life, g) = adjoint_loop(
            n_lanes, dense_max, 30 + seed)
        want = np.zeros_like(acc)
        for l in np.flatnonzero(mine):
            one = np.arange(WARP) == l
            for k in range(min(life[l], 6)):
                t, entry, _ = make_case("ties_in_chunk", WARP,
                                        (30 + seed) * 100 + k)
                best, row = sequential(t, entry, one)
                want[row[l] if np.isfinite(best[l]) else -1] += g[l]
            if life[l] > 6:
                want[-1] += g[l]
        np.testing.assert_array_equal(acc, want)
        np.testing.assert_array_equal(b, np.where(mine, np.minimum(life, 6),
                                                  0))
        assert steps == b.max() and at_flush == WARP


def test_order_key_orders_as_floats():
    """The key orders float32 values as `<` does, -0 and +0 alike, +inf
    above every finite value."""
    v = np.array([-np.inf, -3.5, -1e-30, -0.0, 0.0, 1e-30, 1e-3, 2.0,
                  3.4e38, np.inf], np.float32)
    k = order_key(v)
    assert k[3] == k[4]
    for i in range(len(v)):
        for j in range(len(v)):
            assert (k[i] < k[j]) == (v[i] < v[j]), (v[i], v[j])


def test_count_warp_need_histogram():
    """mega_plain's estimate of the warp's masked share: per culled family,
    how many (32-lane group, chunk) pairs have n lanes visiting the chunk,
    the last group padded with lanes that visit nothing."""
    need = torch.zeros((70, 3), dtype=torch.bool)
    need[0:5, 0] = True      # group 0: 5 lanes need chunk 0
    need[32:64, 1] = True    # group 1: all 32 need chunk 1
    need[69, 2] = True       # group 2 (6 lanes, padded): 1 needs chunk 2
    saved = mega_plain.closest_hit.need
    mega_plain.closest_hit.need = [[0] * (WARP + 1) for _ in range(4)]
    try:
        mega_plain._count_warp_need(need, mega_plain.FAM_TRIANGLE)
        hist = mega_plain.closest_hit.need[mega_plain.FAM_TRIANGLE]
        assert sum(mega_plain.closest_hit.need[0]) == 0
    finally:
        mega_plain.closest_hit.need = saved
    want = [0] * (WARP + 1)
    want[0], want[1], want[5], want[32] = 6, 1, 1, 1
    assert hist == want
