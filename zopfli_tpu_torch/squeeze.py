"""Iterative entropy-cost optimal parse ("squeeze") driver.

The per-run forward DP executes in an engine (native C++ host engine or
the TPU kernel pipeline); this module owns the outer iteration of
reference ZopfliLZ77Optimal (squeeze.c:446-526): statistics feedback,
best-result tracking by exact dynamic-block size, weighted stat blending
after randomization kicks in, and the fixed-seed multiply-with-carry
frequency randomization that shakes the cost model out of fixed points.
"""

from __future__ import annotations

import numpy as np

from . import blocks, entropy, spec
from .lz77 import LZ77Store


class SymbolStats:
    """Litlen/dist symbol frequencies plus their entropy-model bit costs."""

    def __init__(self):
        self.litlens = np.zeros(spec.NUM_LL, dtype=np.int64)
        self.dists = np.zeros(spec.NUM_D, dtype=np.int64)
        self.ll_symbols = np.zeros(spec.NUM_LL, dtype=np.float64)
        self.d_symbols = np.zeros(spec.NUM_D, dtype=np.float64)

    def copy(self) -> "SymbolStats":
        s = SymbolStats()
        s.litlens = self.litlens.copy()
        s.dists = self.dists.copy()
        s.ll_symbols = self.ll_symbols.copy()
        s.d_symbols = self.d_symbols.copy()
        return s

    def recalculate(self) -> None:
        self.ll_symbols = entropy.calculate_entropy(self.litlens)
        self.d_symbols = entropy.calculate_entropy(self.dists)

    def fill_from_store(self, store: LZ77Store) -> None:
        is_match = store.dists != 0
        self.litlens = np.bincount(store.ll_symbol,
                                   minlength=spec.NUM_LL).astype(np.int64)
        self.dists = np.bincount(store.d_symbol[is_match],
                                 minlength=spec.NUM_D).astype(np.int64)
        self.litlens[256] = 1  # end symbol
        self.recalculate()


def add_weighed_freqs(s1: SymbolStats, w1: float, s2: SymbolStats,
                      w2: float) -> SymbolStats:
    """result = trunc(s1*w1 + s2*w2), end symbol pinned (squeeze.c:65-78)."""
    out = SymbolStats()
    out.litlens = (s1.litlens * w1 + s2.litlens * w2).astype(np.int64)
    out.dists = (s1.dists * w1 + s2.dists * w2).astype(np.int64)
    out.litlens[256] = 1
    return out


class MwcRng:
    """Marsaglia multiply-with-carry PRNG, fixed seed (squeeze.c:80-94)."""

    def __init__(self):
        self.m_w = 1
        self.m_z = 2

    def next(self) -> int:
        self.m_z = (36969 * (self.m_z & 0xFFFF) + (self.m_z >> 16)) & 0xFFFFFFFF
        self.m_w = (18000 * (self.m_w & 0xFFFF) + (self.m_w >> 16)) & 0xFFFFFFFF
        return ((self.m_z << 16) + self.m_w) & 0xFFFFFFFF


def randomize_freqs(rng: MwcRng, freqs: np.ndarray) -> None:
    n = len(freqs)
    for i in range(n):
        if (rng.next() >> 4) % 3 == 0:
            freqs[i] = freqs[rng.next() % n]


def randomize_stat_freqs(rng: MwcRng, stats: SymbolStats) -> None:
    randomize_freqs(rng, stats.litlens)
    randomize_freqs(rng, stats.dists)
    stats.litlens[256] = 1


def lz77_optimal(engine, data: np.ndarray, instart: int, inend: int,
                 numiterations: int, greedy_fn, trace=None) -> LZ77Store:
    """Best parse over `numiterations` squeeze runs (squeeze.c:446-526).

    engine: object with squeeze_run(ll_cost, d_cost) -> (litlens, dists).
    greedy_fn(data, instart, inend) -> (litlens, dists) seeds the stats.
    trace: optional callable(iteration, cost_bits) for instrumentation.
    """
    if numiterations < 1:
        raise ValueError("numiterations must be >= 1")
    rng = MwcRng()
    stats = SymbolStats()

    glit, gdist = greedy_fn(data, instart, inend)
    stats.fill_from_store(LZ77Store(data, glit, gdist, instart))

    best_store = None
    best_stats = None
    bestcost = spec.LARGE_FLOAT
    lastcost = 0.0
    lastrandomstep = -1

    for i in range(numiterations):
        litlens, dists = engine.squeeze_run(stats.ll_symbols, stats.d_symbols)
        currentstore = LZ77Store(data, litlens, dists, instart)
        cost = blocks.calculate_block_size(currentstore, 0, currentstore.size, 2)
        if trace is not None:
            trace(i, cost)
        if cost < bestcost:
            best_store = currentstore
            best_stats = stats.copy()
            bestcost = cost
        laststats = stats.copy()
        stats = SymbolStats()
        stats.fill_from_store(currentstore)
        if lastrandomstep != -1:
            # Once randomization has kicked in, blend with the previous
            # stats: slower but better convergence (squeeze.c:505-511).
            stats = add_weighed_freqs(stats, 1.0, laststats, 0.5)
            stats.recalculate()
        if i > 5 and cost == lastcost:
            stats = best_stats.copy()
            randomize_stat_freqs(rng, stats)
            stats.recalculate()
            lastrandomstep = i
        lastcost = cost

    return best_store


def lz77_optimal_fixed(engine, data: np.ndarray, instart: int,
                       inend: int) -> LZ77Store:
    """Single squeeze run under the fixed-tree cost model (squeeze.c:528+)."""
    litlens, dists = engine.squeeze_run(None, None)
    return LZ77Store(data, litlens, dists, instart)
