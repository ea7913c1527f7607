"""Fused squeeze drivers: host glue around ops.fused_engine.

The reference's per-block iteration loop (squeeze.c:446-526 -- stats
feedback, keep-best by exact dynamic-block size, fixed-seed MWC
randomization, 1.0/0.5 blending) runs on the device inside the fused
engine; this module owns dispatch/collect with greedy-seeded stats and
the hash-collision verify + native fallback.
"""

from __future__ import annotations

import numpy as np

from . import spec
from .lz77 import LZ77Store
from .squeeze import SymbolStats
from .utils.logging import span


def lz77_optimal_fused(data: np.ndarray, masters, numiterations: int,
                       greedy_fn, device="cuda",
                       trace=None) -> list[list[LZ77Store]]:
    """Fused-squeeze parses for a batch of masters.

    masters: list of (instart, inend, block_bounds).  The full iteration
    control (squeeze.c:446-526) runs on `device` (ops.fused_engine);
    per-block final stores come back compacted.
    Returns one list of LZ77Store per master, blocks in order.
    """
    fs, handle = fused_dispatch(data, masters, numiterations, greedy_fn,
                                device=device)
    return fused_collect(fs, handle, numiterations, trace=trace)


def greedy_seed_stats(data: np.ndarray, block_bounds, greedy_fn):
    """Per-block seed stats from the greedy parse (squeeze.c:481-482)."""
    nb = len(block_bounds)
    seed_ll = np.zeros((nb, spec.NUM_LL), np.int64)
    seed_d = np.zeros((nb, spec.NUM_D), np.int64)
    for b, (bs, be) in enumerate(block_bounds):
        glit, gdist = greedy_fn(data, bs, be)
        st = SymbolStats()
        st.fill_from_store(LZ77Store(data, glit, gdist, bs))
        seed_ll[b] = st.litlens
        seed_d[b] = st.dists
    return seed_ll, seed_d


def fused_dispatch(data: np.ndarray, masters, numiterations: int,
                   greedy_fn, device="cuda"):
    """Async half of lz77_optimal_fused: build + queue the device loop."""
    from .ops.fused_engine import FusedSqueeze

    if numiterations < 1:
        raise ValueError("numiterations must be >= 1")

    fs = FusedSqueeze(data, masters, device=device)
    with span("zt.seed"):
        seed_ll, seed_d = greedy_seed_stats(data, fs.block_bounds, greedy_fn)
    return fs, fs.dispatch(seed_ll, seed_d, numiterations)


# Diagnostic counter: silent native fallbacks on verify failure make
# sizes look fine while time doubles -- experiments must check this.
VERIFY_FAILS = [0]


def fused_collect(fs, handle, numiterations: int,
                  trace=None) -> list[list[LZ77Store]]:
    """Blocking half: pull parses, verify, fall back on collisions."""
    from . import native

    data = fs.data
    with span("zt.collect"):
        parses, best_cost, best_sll, best_sd = fs.collect(handle)

    out: list[list[LZ77Store]] = []
    b = 0
    for (instart, inend, bb) in fs.masters:
        stores = []
        for _ in range(len(bb) - 1):
            bs, be = fs.block_bounds[b]
            lit, dst = parses[b]
            if trace is not None:
                trace(b, numiterations - 1, float(best_cost[b]))
            if not fs.verify_parse(b, lit, dst):
                VERIFY_FAILS[0] += 1
                # Hash collision (cryptographically unlikely): exact host
                # fallback for this block using the best stats.
                eng = native.BlockEngine(data, bs, be)
                try:
                    ll_cost = np.asarray(
                        _entropy_f64(best_sll[b]), np.float64)
                    d_cost = np.asarray(
                        _entropy_f64(best_sd[b]), np.float64)
                    lit, dst = eng.squeeze_run(ll_cost, d_cost)
                finally:
                    eng.close()
            stores.append(LZ77Store(data, lit, dst, bs))
            b += 1
        out.append(stores)
    return out


def _entropy_f64(counts: np.ndarray) -> np.ndarray:
    from .entropy import calculate_entropy
    return calculate_entropy(counts.astype(np.int64))
