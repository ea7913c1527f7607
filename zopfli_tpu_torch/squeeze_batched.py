"""Fused squeeze host glue around ops.fused_engine / ops.seed.

The reference's per-block iteration loop (squeeze.c:446-526 -- stats
feedback, keep-best by exact dynamic-block size, fixed-seed MWC
randomization, 1.0/0.5 blending) runs on the device inside the fused
engine.  This module owns the seed pipeline's stages for a chunk of
masters, which deflate.deflate_device runs in turn: devseed_fire (queue
the seed programs), devseed_dispatch (seed results, then the fused
squeeze queued) and devseed_collect (pull, verify, native fallback on a
hash collision).  greedy_seed_stats seeds a FusedSqueeze from the host
greedy parse, as the JAX package's greedy-seeded path does: the tests
and chip_smoke.py hold the fused loop against that package through it
and fused_collect.
"""

from __future__ import annotations

import numpy as np

from . import spec
from .lz77 import LZ77Store
from .squeeze import SymbolStats
from .utils.counters import bump
from .utils.logging import span


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


# Diagnostic counter: silent native fallbacks on verify failure make
# sizes look fine while time doubles -- experiments must check this.
VERIFY_FAILS = [0]


def fused_collect(fs, handle, numiterations: int,
                  trace=None) -> list[list[LZ77Store]]:
    """Pull the parses of fs.dispatch's handle, check each block's parse
    and build its store in one native pass (fs.verify_parse), fall back
    on collisions."""
    data = fs.data
    with span("zt.collect"):
        parses, best_cost, best_sll, best_sd = fs.collect(handle)

    out: list[list[LZ77Store]] = []
    b = 0
    with span("zt.verify"):
        for (instart, inend, bb) in fs.masters:
            stores = []
            for _ in range(len(bb) - 1):
                bs, be = fs.block_bounds[b]
                lit, dst = parses[b]
                if trace is not None:
                    trace(b, numiterations - 1, float(best_cost[b]))
                store = fs.verify_parse(b, lit, dst)
                if not store:
                    bump(VERIFY_FAILS)
                    with span("zt.verify_fallback"):
                        lit, dst = _native_squeeze(fs, b, best_sll[b],
                                                   best_sd[b])
                    store = LZ77Store(data, lit, dst, bs)
                stores.append(store)
                b += 1
            out.append(stores)
    return out


def _native_squeeze(fs, b: int, sll, sd):
    """Block b's exact host parse under its best stats, after a hash
    collision (cryptographically unlikely) spoiled the device's.  The
    window starts at the owning input's first byte (multi-file batches
    concatenate independent inputs)."""
    from . import native

    bs, be = fs.block_bounds[b]
    ws = fs.block_wstart[b]
    eng = native.BlockEngine(fs.data[ws:], bs - ws, be - ws)
    try:
        ll_cost = np.asarray(_entropy_f64(sll), np.float64)
        d_cost = np.asarray(_entropy_f64(sd), np.float64)
        return eng.squeeze_run(ll_cost, d_cost)
    finally:
        eng.close()


def _entropy_f64(counts: np.ndarray) -> np.ndarray:
    from .entropy import calculate_entropy
    return calculate_entropy(counts.astype(np.int64))


# ---------------------------------------------------------------------------
# Device-seeded path: no host greedy parse.
# ---------------------------------------------------------------------------

def _use_mega(inend: int, instart: int, devices) -> bool:
    """A master takes the megafused program: ZT_MEGA=1, unsharded (the
    counterpart of the reference's `mesh is None`) and at least
    ops.mega.MEGA_MIN bytes."""
    from .ops import mega as mega_mod
    return (devices is None and mega_mod.enabled()
            and inend - instart >= mega_mod.MEGA_MIN)


def devseed_fire(data: np.ndarray, ranges, maxblocks: int = 15,
                 window_starts=None, device="cuda", numiterations: int = 15,
                 devices=None):
    """Queue the seed parses (or megafused programs) for a chunk of
    masters, without a sync.

    First half of devseed_dispatch, exposed so the caller can do host
    work (emitting the previous chunk) while the device runs the seed
    parses -- pass the result as devseed_dispatch(..., fired=...).

    Large masters (>= ops.mega.MEGA_MIN, unsharded, ZT_MEGA=1) queue the
    whole seed + split + squeeze pipeline as one megafused program;
    smaller ones keep the two-phase path, whose squeeze shares lane
    groups across the chunk.
    """
    from .ops import mega as mega_mod
    from .ops import seed as seed_mod

    if window_starts is None:
        window_starts = [0] * len(ranges)
    handles = []
    with span("zt.seed"):
        for (instart, inend), ws in zip(ranges, window_starts):
            with span("zt.seed.probe"):
                cheap = seed_mod.probably_incompressible(data, instart,
                                                         inend)
            if not cheap and _use_mega(inend, instart, devices):
                handles.append(("mega", ws, mega_mod.mega_dispatch(
                    data, instart, inend, maxblocks, numiterations,
                    window_start=ws, device=device)))
            else:
                handles.append(("seed", cheap, ws, seed_mod.seed_dispatch(
                    data, instart, inend, maxblocks, cheap=cheap,
                    window_start=ws, device=device)))
    return handles


def devseed_dispatch(data: np.ndarray, ranges, numiterations: int,
                     maxblocks: int = 15, window_starts=None, fired=None,
                     device="cuda", devices=None):
    """Seed + split + squeeze-dispatch for a chunk of masters, no greedy.

    ranges: [(instart, inend)].  Per master, the seed program (ops.seed)
    builds candidates, runs the fixed-cost seed parse, splits, and
    returns seed stats + stored-exit costs; the fused squeeze then reuses
    the candidate tables.  Masters whose every block prefers stored by a
    clear margin skip the squeeze entirely.  Megafused masters
    (devseed_fire) are only carried to devseed_collect.

    window_starts: per-range first byte the LZ77 halo may reach back to
    (multi-file batches concatenate independent inputs into one array).
    fired: optional result of devseed_fire (seed parses already queued,
    so the host could emit the previous chunk in between).
    devices: optional list of devices to shard the squeeze's lane groups
    over (the seed parses run on `device`).

    Returns an opaque entry for devseed_collect().
    """
    from .ops import fused_engine
    from .ops import mega as mega_mod
    from .ops import seed as seed_mod

    if numiterations < 1:
        raise ValueError("numiterations must be >= 1")
    if window_starts is None:
        window_starts = [0] * len(ranges)

    # Every seed parse goes in flight before any result is pulled: the
    # device stays busy and the host syncs only in the splits.
    handles = fired if fired is not None else devseed_fire(
        data, ranges, maxblocks, window_starts, device=device,
        numiterations=numiterations, devices=devices)
    seeds = [None] * len(ranges)     # SeedResult for the fused path
    megas = [None] * len(ranges)     # mega handle (pulled in collect)
    with span("zt.split"):
        for i, ((instart, inend), tagged) in enumerate(zip(ranges,
                                                           handles)):
            if tagged[0] == "mega":
                megas[i] = tagged[2]
                continue
            _, cheap, ws, h = tagged
            sr = seed_mod.seed_finish(h)
            if cheap and not sr.all_stored:
                # Probe false positive: redo with full-quality candidates
                # (megafused when the master qualifies).
                if _use_mega(inend, instart, devices):
                    megas[i] = mega_mod.mega_dispatch(
                        data, instart, inend, maxblocks, numiterations,
                        window_start=ws, device=device)
                    continue
                sr = seed_mod.seed_master(data, instart, inend, maxblocks,
                                          cheap=False, window_start=ws,
                                          device=device)
            seeds[i] = sr

    live = [i for i, sr in enumerate(seeds)
            if sr is not None and not sr.all_stored]
    fs = handle = None
    if live:
        masters = [(ranges[i][0], ranges[i][1], seeds[i].bounds)
                   for i in live]
        cand = [(seeds[i].bp_len, seeds[i].bp_dist) for i in live]
        fs = fused_engine.FusedSqueeze(data, masters, device=device,
                                       devices=devices, cand=cand,
                                       window_starts=[window_starts[i]
                                                      for i in live])
        # Exact density prediction from the seed parse (pow2-bucketed).
        want = int(max(seeds[i].max_lane_rows for i in live) * 1.5) + 8
        cap = 512
        while cap < want and cap < fused_engine.TILE:
            cap *= 2
        fs.default_fetch_cap = min(cap, fused_engine.TILE)

        seed_ll = np.vstack([seeds[i].seed_ll for i in live])
        seed_d = np.vstack([seeds[i].seed_d for i in live])
        handle = fs.dispatch(seed_ll, seed_d, numiterations)
    return (ranges, seeds, fs, handle, megas)


def devseed_collect(entry, numiterations: int, trace=None):
    """Blocking half of devseed_dispatch.

    Returns one result per master: ("stores", [LZ77Store...]) for
    squeezed masters, ("stores", [LZ77Store...], split2) for megafused
    ones (split2 = the device's second-split decision, or None after a
    verify fallback), ("stored", instart, inend) for stored-exit ones.
    Megafused masters pass no trace hooks (as in the reference).
    """
    from .ops import mega as mega_mod

    ranges, seeds, fs, handle, megas = entry
    results = [None] * len(ranges)
    # Megafused masters were queued first: pull them first.
    for i, mh in enumerate(megas):
        if mh is None:
            continue
        mr = mega_mod.mega_finish(mh)
        instart, inend = ranges[i]
        if mr.all_stored:
            results[i] = ("stored", instart, inend)
        else:
            fails = VERIFY_FAILS[0]
            stores = fused_collect(mr, None, numiterations)[0]
            # The device's second-split decision holds for the device's
            # own parse only; after a hash-collision fallback replaced a
            # block's parse, the host splits again.
            split2 = mr.split2 if VERIFY_FAILS[0] == fails else None
            results[i] = ("stores", stores, split2)
    if fs is not None:
        all_stores = fused_collect(fs, handle, numiterations, trace=trace)
    k = 0
    for i, (sr, (instart, inend)) in enumerate(zip(seeds, ranges)):
        if sr is None:
            continue               # megafused master, handled above
        if sr.all_stored:
            results[i] = ("stored", instart, inend)
        else:
            results[i] = ("stores", all_stores[k])
            k += 1
    return results
