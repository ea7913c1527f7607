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


def _random_bp(rng, rows, kbp, nt):
    """Random but well-formed breakpoint tables: ascending lengths."""
    bp_len = np.sort(rng.integers(0, 80, (rows, kbp, nt)), axis=1)
    bp_len = np.where(bp_len < 3, 0, bp_len).astype(np.int32)
    bp_dist = rng.integers(1, 3000, (rows, kbp, nt)).astype(np.int32)
    return bp_len, bp_dist


def _scan_inputs(seed, litlo=1.0):
    rng = np.random.default_rng(seed)
    rows = GROUPS * TILE
    bp_len, bp_dist = _random_bp(rng, rows, KBP, NT)
    bp_dcost = rng.uniform(1, 15, (rows, KBP, NT)).astype(np.float32)
    litcost = rng.uniform(litlo, 12, (rows, NT)).astype(np.float32)
    lcost = rng.uniform(1, 10, (GROUPS * sk.W, NT)).astype(np.float32)
    return bp_len, bp_dist, bp_dcost, litcost, lcost


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@pytest.fixture(scope="module")
def scan_case():
    args = _scan_inputs(5)
    ce, cost = sk.scan(*_t(*args), groups=GROUPS)
    run = jsk.make_scan(TILE, NT, KBP, interpret=True, groups=GROUPS)
    jce, jcost = run(*args)
    return args, ce.numpy(), cost.numpy(), np.asarray(jce), np.asarray(jcost)


def test_scan_plain_matches_pallas_kernel(scan_case):
    _, ce, cost, jce, jcost = scan_case
    np.testing.assert_array_equal(ce, jce)
    np.testing.assert_array_equal(cost.view(np.int32), jcost.view(np.int32))


@pytest.mark.parametrize("g", range(GROUPS))
def test_scan_plain_matches_numpy_oracle(scan_case, g):
    args, ce, cost, _, _ = scan_case
    sl = slice(g * TILE, (g + 1) * TILE)
    bp_len, bp_dist, bp_dcost, litcost, lcost = args
    rce, rcost = sk.scan_reference(bp_len[sl], bp_dist[sl], bp_dcost[sl],
                                   litcost[sl],
                                   lcost[g * sk.W:(g + 1) * sk.W])
    np.testing.assert_array_equal(ce[sl], rce)
    np.testing.assert_array_equal(cost[sl].view(np.int32),
                                  rcost.view(np.int32))


def _random_edges(rng, rows, nt):
    """Plausible packed edges: random lengths, <= position."""
    ce = np.zeros((rows, nt), np.int32)
    for lane in range(nt):
        for r in range(rows):
            p = r % TILE + 1
            if rng.random() < 0.7 or p < 4:
                ce[r, lane] = 1
            else:
                l = int(rng.integers(3, min(p, 258) + 1))
                d = int(rng.integers(1, 2000))
                ce[r, lane] = sk.pack_edge(l, d)
    return ce


def test_traceback_plain_matches_pallas_kernel():
    rng = np.random.default_rng(9)
    rows = GROUPS * TILE
    ce = _random_edges(rng, rows, NT)
    lit = rng.integers(0, 256, (rows, NT)).astype(np.int32)
    nbyt = rng.integers(0, TILE + 1, (GROUPS, NT)).astype(np.int32)
    nbyt[0, 0] = TILE
    nbyt[1, 1] = 0
    symtab = sk.symbol_range_table()
    np.testing.assert_array_equal(symtab, jsk.symbol_range_table())

    hist, pe = sk.traceback(*_t(ce, lit, nbyt), symtab, groups=GROUPS)
    run = jsk.make_traceback(TILE, NT, interpret=True, groups=GROUPS)
    jhist, jpe = run(ce, lit, nbyt, symtab)
    np.testing.assert_array_equal(hist.numpy(), np.asarray(jhist))
    np.testing.assert_array_equal(pe.numpy(), np.asarray(jpe))
    for g in range(GROUPS):
        rhist, rpe = sk.traceback_reference(
            ce[g * TILE:(g + 1) * TILE], lit[g * TILE:(g + 1) * TILE],
            nbyt[g:g + 1])
        np.testing.assert_array_equal(
            hist.numpy()[g * sk.HBINS:(g + 1) * sk.HBINS], rhist)
        np.testing.assert_array_equal(pe.numpy()[g * TILE:(g + 1) * TILE],
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
