"""The port's DP scan and traceback (plain PyTorch versions on the CPU)
against the JAX package's Pallas kernels (interpret mode) and the numpy
oracles.  Every output must be bit-equal."""

import numpy as np
import pytest
import torch

from zopfli_tpu.ops import scan_kernel as jsk
from zopfli_tpu_torch.ops import scan_kernel as sk

# The tensors here are tiny: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

TILE, NT, KBP, GROUPS = 128, 8, 4, 2

# Scan cases: (tile, lanes, kbp, unsorted breakpoints, costs on the
# 1/128-bit grid).  The CUDA scan works in 32-row chunks of 8 lanes, so
# "odd" has a tile that is no multiple of 32 and lanes no multiple of 8.
SCAN_CASES = {
    "base": (TILE, NT, KBP, False, False),
    "grid_ties": (TILE, NT, KBP, False, True),
    "unsorted": (TILE, NT, 6, True, False),
    "kbp1": (TILE, NT, 1, True, True),
    "kbp16": (TILE, NT, 16, True, True),
    "odd": (80, 13, KBP, True, True),
}


def _random_bp(rng, rows, kbp, nt, unsorted=False):
    """Random breakpoint tables.  Sorted: ascending lengths, as the
    candidate builder gives them.  Unsorted: any order, repeats, zeros
    anywhere, lengths past 258, and lengths no breakpoint covers."""
    if unsorted:
        bp_len = rng.integers(0, 300, (rows, kbp, nt))
        bp_len = np.where(rng.random(bp_len.shape) < 0.3, 0, bp_len)
        bp_len = np.where(rng.random(bp_len.shape) < 0.2, bp_len[:, :1],
                          bp_len).astype(np.int32)
    else:
        bp_len = np.sort(rng.integers(0, 80, (rows, kbp, nt)), axis=1)
        bp_len = np.where(bp_len < 3, 0, bp_len).astype(np.int32)
    bp_dist = rng.integers(1, 3000, (rows, kbp, nt)).astype(np.int32)
    return bp_len, bp_dist


def _costs(rng, shape, lo, hi, grid):
    """Uniform costs; on the grid, few distinct multiples of 1/128, so
    that many relaxations tie exactly."""
    if grid:
        return (rng.integers(int(lo * 4), int(hi * 4), shape) * 32
                / 128).astype(np.float32)
    return rng.uniform(lo, hi, shape).astype(np.float32)


def _scan_inputs(seed, litlo=1.0, case="base"):
    tile, nt, kbp, unsorted, grid = SCAN_CASES[case]
    rng = np.random.default_rng(seed)
    rows = GROUPS * tile
    bp_len, bp_dist = _random_bp(rng, rows, kbp, nt, unsorted)
    bp_dcost = _costs(rng, (rows, kbp, nt), 1, 15, grid)
    litcost = _costs(rng, (rows, nt), litlo, 12, grid)
    lcost = _costs(rng, (GROUPS * sk.W, nt), 1, 10, grid)
    return bp_len, bp_dist, bp_dcost, litcost, lcost


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@pytest.fixture(scope="module", params=list(SCAN_CASES))
def scan_case(request):
    tile, nt, kbp = SCAN_CASES[request.param][:3]
    args = _scan_inputs(5, case=request.param)
    ce, cost = sk.scan(*_t(*args), groups=GROUPS)
    run = jsk.make_scan(tile, nt, kbp, interpret=True, groups=GROUPS)
    jce, jcost = run(*args)
    return (tile, args, ce.numpy(), cost.numpy(), np.asarray(jce),
            np.asarray(jcost))


def test_scan_plain_matches_pallas_kernel(scan_case):
    _, _, ce, cost, jce, jcost = scan_case
    np.testing.assert_array_equal(ce, jce)
    np.testing.assert_array_equal(cost.view(np.int32), jcost.view(np.int32))


@pytest.mark.parametrize("g", range(GROUPS))
def test_scan_plain_matches_numpy_oracle(scan_case, g):
    tile, args, ce, cost, _, _ = scan_case
    sl = slice(g * tile, (g + 1) * tile)
    bp_len, bp_dist, bp_dcost, litcost, lcost = args
    rce, rcost = sk.scan_reference(bp_len[sl], bp_dist[sl], bp_dcost[sl],
                                   litcost[sl],
                                   lcost[g * sk.W:(g + 1) * sk.W])
    np.testing.assert_array_equal(ce[sl], rce)
    np.testing.assert_array_equal(cost[sl].view(np.int32),
                                  rcost.view(np.int32))


def _random_edges(rng, rows, nt, tile=TILE):
    """Plausible packed edges: random lengths, <= position."""
    ce = np.zeros((rows, nt), np.int32)
    for lane in range(nt):
        for r in range(rows):
            p = r % tile + 1
            if rng.random() < 0.7 or p < 4:
                ce[r, lane] = 1
            else:
                l = int(rng.integers(3, min(p, 258) + 1))
                d = int(rng.integers(1, 2000))
                ce[r, lane] = sk.pack_edge(l, d)
    return ce


# Traceback cases: (tile, lanes, cut).  "cut" puts tile_nbytes of 0, of
# tile and past the tile, and edges of length 0 and 2 on the paths; the
# numpy oracle cannot walk those (it would loop at a length-0 row), so
# there the Pallas kernel alone is the yardstick.
TRACEBACK_CASES = {
    "base": (TILE, NT, False),
    "odd": (80, 13, False),
    "cut": (TILE, NT, True),
}


@pytest.mark.parametrize("case", list(TRACEBACK_CASES))
def test_traceback_plain_matches_pallas_kernel(case):
    tile, nt, cut = TRACEBACK_CASES[case]
    rng = np.random.default_rng(9)
    rows = GROUPS * tile
    ce = _random_edges(rng, rows, nt, tile)
    lit = rng.integers(0, 256, (rows, nt)).astype(np.int32)
    nbyt = rng.integers(0, tile + 1, (GROUPS, nt)).astype(np.int32)
    nbyt[0, 0] = tile
    nbyt[1, 1] = 0
    if cut:
        nbyt[0, 1] = tile + 5
        nbyt[1, 2:] = tile
        _, pe0 = sk.traceback(*_t(ce, lit, nbyt), sk.symbol_range_table(),
                              groups=GROUPS)
        for lane in range(2, nt):       # cut each path in its middle
            on = np.nonzero(pe0.numpy()[tile:, lane])[0]
            ce[tile + on[len(on) // 2], lane] = (
                0 if lane % 2 else sk.pack_edge(2, 9))
    symtab = sk.symbol_range_table()
    np.testing.assert_array_equal(symtab, jsk.symbol_range_table())

    hist, pe = sk.traceback(*_t(ce, lit, nbyt), symtab, groups=GROUPS)
    run = jsk.make_traceback(tile, nt, ch=16, interpret=True, groups=GROUPS)
    jhist, jpe = run(ce, lit, nbyt, symtab)
    np.testing.assert_array_equal(hist.numpy(), np.asarray(jhist))
    np.testing.assert_array_equal(pe.numpy(), np.asarray(jpe))
    if cut:
        return
    for g in range(GROUPS):
        rhist, rpe = sk.traceback_reference(
            ce[g * tile:(g + 1) * tile], lit[g * tile:(g + 1) * tile],
            nbyt[g:g + 1])
        np.testing.assert_array_equal(
            hist.numpy()[g * sk.HBINS:(g + 1) * sk.HBINS], rhist)
        np.testing.assert_array_equal(pe.numpy()[g * tile:(g + 1) * tile],
                                      rpe)


def test_scan_traceback_path_covers_tile():
    # Distance-capture regression (resolving distances at the destination
    # row instead of carrying them from the source row made paths stop
    # covering their tiles): the path's edge lengths must sum to exactly
    # tile_nbytes for every lane, and every match edge's distance must
    # be one its source row offered.
    bp_len, bp_dist, bp_dcost, litcost, lcost = _scan_inputs(11, litlo=4.0)
    ce, _ = sk.scan(*_t(bp_len, bp_dist, bp_dcost, litcost, lcost),
                    groups=GROUPS)
    nbyt = np.full((GROUPS, NT), TILE, np.int32)
    lit = np.random.default_rng(12).integers(
        0, 256, (GROUPS * TILE, NT)).astype(np.int32)
    _, pe = sk.traceback(ce, *_t(lit, nbyt), sk.symbol_range_table(),
                         groups=GROUPS)
    pe = pe.numpy()
    lens = pe & sk.LEN_MASK
    dists = pe >> sk.LEN_BITS
    for g in range(GROUPS):
        sl = slice(g * TILE, (g + 1) * TILE)
        np.testing.assert_array_equal(lens[sl].sum(axis=0), nbyt[g])
        for lane in range(NT):
            for j in np.nonzero(lens[sl, lane] >= 3)[0]:
                l, d = int(lens[sl][j, lane]), int(dists[sl][j, lane])
                src = g * TILE + j + 1 - l  # source row of the edge
                covering = bp_len[src, :, lane] >= l
                assert covering.any()
                assert d in bp_dist[src, covering, lane]


def test_traceback_stops_at_unreachable_row():
    # A row with a length-0 edge is unreachable: the walk stops there
    # (the Pallas cursor never matches again), counting nothing below.
    ce = np.ones((TILE, NT), np.int32)
    ce[TILE - 10, 0] = 0                  # lane 0: unreachable row
    ce[TILE - 1, 1] = sk.pack_edge(5, 7)  # lane 1: match, then literals
    lit = np.full((TILE, NT), 65, np.int32)
    nbyt = np.full((1, NT), TILE, np.int32)
    hist, pe = sk.traceback(*_t(ce, lit, nbyt), sk.symbol_range_table())
    hist, pe = hist.numpy(), pe.numpy()
    jhist, jpe = jsk.make_traceback(TILE, NT, interpret=True)(
        ce, lit, nbyt, sk.symbol_range_table())
    np.testing.assert_array_equal(hist, np.asarray(jhist))
    np.testing.assert_array_equal(pe, np.asarray(jpe))
    assert hist[65, 0] == 9 and pe[:TILE - 10, 0].sum() == 0
    assert hist[65, 1] == TILE - 5
    assert hist[259, 1] == 1 and hist[288 + 5, 1] == 1  # len 5, dist 7


def test_bin_tables_follow_symbol_table():
    len_bin, dist_bin = sk.bin_tables(sk.symbol_range_table())
    assert (len_bin[:3] == -1).all() and (len_bin[259:] == -1).all()
    assert len_bin[258] == 285 and len_bin[3] == 257
    assert dist_bin[0] == -1 and dist_bin[1] == 288
    assert dist_bin[32768] == 317 and dist_bin[32769] == -1
    bad = sk.symbol_range_table()
    bad[258, 0:2] = (3, 5)                 # overlaps symbol 257's range
    with pytest.raises(ValueError):
        sk.bin_tables(bad)


def test_wrappers_take_plain_version_on_cpu():
    args = _t(*_scan_inputs(3))
    before = dict(sk.LAUNCHES)
    ce, cost = sk.scan(*args, groups=GROUPS)
    pce, pcost = sk.scan_plain(*args, groups=GROUPS)
    assert torch.equal(ce, pce) and torch.equal(cost, pcost)
    assert sk.LAUNCHES == before          # no kernel was launched
    with pytest.raises(ValueError):
        sk.scan(*(a.to("meta") for a in args), groups=GROUPS)


def test_prefix_max_picks_lowest_covering_k():
    # The CUDA scan finds a length's breakpoint as the first k whose
    # prefix maximum of bp_len reaches it; the reference overwrites in
    # descending k.  Both must pick the lowest k with l <= bp_len[k], for
    # any order of breakpoints.
    rng = np.random.default_rng(21)
    lengths = np.arange(3, sk.W + 3)
    for kbp in (1, 4, 12, 16):
        bl, _ = _random_bp(rng, 400, kbp, 1, unsorted=True)
        for row in bl[:, :, 0]:
            over = np.full(lengths.shape, -1)
            for k in range(kbp - 1, -1, -1):
                over = np.where(lengths <= row[k], k, over)
            pm = np.maximum.accumulate(row)
            first = np.argmax(pm[None, :] >= lengths[:, None], axis=1)
            first = np.where(pm[-1] >= lengths, first, -1)
            np.testing.assert_array_equal(first, over)


def _interval_scan(bp_len, bp_dist, bp_dcost, litcost, lcost_vec):
    """Numpy mirror of one chain of csrc/scan.cu (groups=1): the cost of
    position j carried from the literal relaxation, and per step only the
    lengths (pm[k-1], bp_len[k]] of the breakpoints k that raise the
    prefix maximum, capped at 258 and at the tile's end."""
    tile, kbp, nt = bp_len.shape
    f32 = np.float32
    ce = np.zeros((tile + 1, nt), np.int32)
    cost = np.full((tile + 1, nt), f32(sk.BIG), f32)
    for lane in range(nt):
        rc, re = cost[:, lane], ce[:, lane]
        cj = f32(0.0)
        for j in range(tile):
            lt = f32(cj + litcost[j, lane])
            if lt < rc[j + 1]:
                rc[j + 1], re[j + 1] = lt, 1
            cur, cj = cj, rc[j + 1]
            lim = min(sk.W + 2, tile - j)
            lo = 2
            for k in range(kbp):
                hi = int(bp_len[j, k, lane])
                if hi <= lo:
                    continue
                if lo >= lim:
                    break
                dc = bp_dcost[j, k, lane]
                for l in range(lo + 1, min(hi, lim) + 1):
                    nw = f32(f32(cur + lcost_vec[l - 3, lane]) + dc)
                    if nw < rc[j + l]:
                        rc[j + l] = nw
                        re[j + l] = sk.pack_edge(l, int(bp_dist[j, k, lane]))
                lo = hi
    return ce[1:], cost[1:]


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_interval_scan_matches_numpy_oracle(case):
    # Skipping the lengths no breakpoint covers changes no bit: a skipped
    # relaxation costs (c + lcost) + BIG, never < a ring value.
    tile = SCAN_CASES[case][0]
    *bp, lcost = _scan_inputs(17, case=case)
    args = [a[:tile] for a in bp] + [lcost[:sk.W]]
    ce, cost = _interval_scan(*args)
    rce, rcost = sk.scan_reference(*args)
    np.testing.assert_array_equal(ce, rce)
    np.testing.assert_array_equal(cost.view(np.int32), rcost.view(np.int32))


def test_traceback_wants_host_symtab():
    # A device copy of the symbol table would sync the stream on every
    # call: the wrapper takes the host table only.
    ce = torch.ones((TILE, NT), dtype=torch.int32)
    nbyt = torch.full((1, NT), TILE, dtype=torch.int32)
    tab = torch.from_numpy(sk.symbol_range_table())
    hist, _ = sk.traceback(ce, ce, nbyt, tab)
    assert float(hist.sum()) == TILE * NT
    with pytest.raises(ValueError):
        sk.traceback(ce, ce, nbyt, tab.to("meta"))
