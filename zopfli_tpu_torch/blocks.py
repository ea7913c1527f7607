"""Exact DEFLATE block-size calculators and optimal block splitting.

Semantics follow the reference (src/zopfli/deflate.c:348-621 size
calculators, src/zopfli/blocksplitter.c split search) with the histogram
work vectorized over the store's cumulative checkpoints.
"""

from __future__ import annotations

import numpy as np

from . import entropy, spec, tree_encode
from .lz77 import LZ77Store

# Route exact cost evaluation through the native engine (the splitter
# probes thousands of ranges; the pure-Python path below is kept as the
# cross-checked reference implementation).
USE_NATIVE_COSTS = True


def _native_ctx(store: LZ77Store):
    ctx = getattr(store, "_native_cost_ctx", None)
    if ctx is None:
        from . import native
        ctx = native.CostContext(store.litlens.astype(np.uint16),
                                 store.dists.astype(np.uint16))
        store._native_cost_ctx = ctx
    return ctx

# Extra-bit counts per litlen symbol index 257..285 and dist symbol 0..29.
_LL_EXTRA = np.zeros(spec.NUM_LL, dtype=np.int64)
_LL_EXTRA[257:286] = spec.LENGTH_SYMBOL_EXTRA_BITS
_D_EXTRA = np.zeros(spec.NUM_D, dtype=np.int64)
_D_EXTRA[:30] = spec.DIST_SYM_EXTRA_BITS


def block_symbol_size(ll_counts, d_counts, ll_lengths, d_lengths) -> int:
    """Bits for the symbol payload of a block, given its histogram.

    Matches CalculateBlockSymbolSizeGivenCounts (deflate.c:375-401): the
    end symbol is charged once; symbols 286/287 and dist 30/31 never occur.
    """
    ll_l = np.asarray(ll_lengths, dtype=np.int64)
    d_l = np.asarray(d_lengths, dtype=np.int64)
    ll_c = np.asarray(ll_counts, dtype=np.int64)
    d_c = np.asarray(d_counts, dtype=np.int64)
    # Index 256 (end symbol) is charged once, independent of its count.
    r = int((ll_l[:256] * ll_c[:256]).sum())
    r += int((ll_l[257:286] * ll_c[257:286]).sum())
    r += int((_LL_EXTRA[257:286] * ll_c[257:286]).sum())
    r += int((d_l[:30] * d_c[:30]).sum()) + int((_D_EXTRA[:30] * d_c[:30]).sum())
    r += int(ll_l[256])  # end symbol
    return r


def get_dynamic_lengths(store: LZ77Store, lstart: int, lend: int):
    """Tree lengths minimizing tree+data size for a dynamic block.

    Returns (cost_bits, ll_lengths, d_lengths).  Mirrors GetDynamicLengths
    + TryOptimizeHuffmanForRle (deflate.c:525-582).
    """
    if USE_NATIVE_COSTS:
        return _native_ctx(store).dynamic_lengths(lstart, lend)
    ll_counts, d_counts = store.histogram(lstart, lend)
    ll_counts[256] = 1
    ll_lengths = entropy.calculate_bit_lengths(ll_counts, 15)
    d_lengths = entropy.calculate_bit_lengths(d_counts, 15)
    d_lengths = tree_encode.patch_distance_codes(d_lengths)

    treesize = tree_encode.calculate_tree_size(ll_lengths, d_lengths)
    datasize = block_symbol_size(ll_counts, d_counts, ll_lengths, d_lengths)

    ll_counts2 = tree_encode.optimize_huffman_for_rle(ll_counts)
    d_counts2 = tree_encode.optimize_huffman_for_rle(d_counts)
    ll_lengths2 = entropy.calculate_bit_lengths(ll_counts2, 15)
    d_lengths2 = entropy.calculate_bit_lengths(d_counts2, 15)
    d_lengths2 = tree_encode.patch_distance_codes(d_lengths2)
    treesize2 = tree_encode.calculate_tree_size(ll_lengths2, d_lengths2)
    datasize2 = block_symbol_size(ll_counts, d_counts, ll_lengths2, d_lengths2)

    if treesize2 + datasize2 < treesize + datasize:
        return treesize2 + datasize2, ll_lengths2, d_lengths2
    return treesize + datasize, ll_lengths, d_lengths


def calculate_block_size(store: LZ77Store, lstart: int, lend: int,
                         btype: int) -> float:
    """Exact encoded size in bits of one block (deflate.c:584-608)."""
    if USE_NATIVE_COSTS:
        return _native_ctx(store).block_cost(lstart, lend, btype)
    result = 3.0  # bfinal + btype
    if btype == 0:
        length = store.byte_range(lstart, lend)
        rem = length % 65535
        blocks = length // 65535 + (1 if rem else 0)
        return blocks * 5 * 8 + length * 8
    if btype == 1:
        ll, d = spec.fixed_tree_lengths()
        ll_counts, d_counts = store.histogram(lstart, lend)
        return result + block_symbol_size(ll_counts, d_counts, ll, d)
    cost, _, _ = get_dynamic_lengths(store, lstart, lend)
    return result + cost


def calculate_block_size_auto_type(store: LZ77Store, lstart: int,
                                   lend: int) -> float:
    """Min over uncompressed/fixed/dynamic (deflate.c:610-621).

    As in the reference, the fixed-tree size is only probed for small
    blocks (<=1000 symbols) since it practically never wins on large ones.
    """
    if USE_NATIVE_COSTS:
        return _native_ctx(store).block_cost(lstart, lend, -1)
    uncompressed = calculate_block_size(store, lstart, lend, 0)
    # The reference gates the fixed-cost probe on the *store* size, not the
    # range size (deflate.c:615-616).
    fixed = (uncompressed if store.size > 1000
             else calculate_block_size(store, lstart, lend, 1))
    dyn = calculate_block_size(store, lstart, lend, 2)
    return min(uncompressed, fixed, dyn)


# ---------------------------------------------------------------------------
# Block splitting (blocksplitter.c).
# ---------------------------------------------------------------------------

_SPLIT_PROBES = 9


def _find_minimum(f, start: int, end: int):
    """Reference FindMinimum (blocksplitter.c:43-96).

    Linear scan under 1024 candidates, otherwise iterative 9-probe
    bracketing.  The probe costs within a round are independent; the
    callable `f` may accept a numpy array of indices and return an array
    of costs, which the TPU/pipelined paths exploit.
    """
    if end - start < 1024:
        idx = np.arange(start, end)
        v = f(idx)
        k = int(np.argmin(v))
        return int(idx[k]), float(v[k])
    lastbest = spec.LARGE_FLOAT
    pos = start
    while True:
        if end - start <= _SPLIT_PROBES:
            break
        p = start + (np.arange(1, _SPLIT_PROBES + 1)
                     * ((end - start) // (_SPLIT_PROBES + 1)))
        vp = f(p)
        besti = int(np.argmin(vp))
        best = float(vp[besti])
        if best > lastbest:
            break
        start = start if besti == 0 else int(p[besti - 1])
        end = end if besti == _SPLIT_PROBES - 1 else int(p[besti + 1])
        pos = int(p[besti])
        lastbest = best
    return pos, lastbest


def estimate_cost(store: LZ77Store, lstart: int, lend: int) -> float:
    return calculate_block_size_auto_type(store, lstart, lend)


def block_split_lz77(store: LZ77Store, maxblocks: int) -> list[int]:
    """Optimal split points in LZ77-symbol coordinates.

    Mirrors ZopfliBlockSplitLZ77 (blocksplitter.c:215-273): repeatedly
    bisect the largest remaining segment at the minimum-cost point, keeping
    a split only if it lowers total cost.
    """
    if store.size < 10:
        return []
    done = set()
    splitpoints: list[int] = []
    lstart, lend = 0, store.size
    numblocks = 1
    while True:
        if maxblocks > 0 and numblocks >= maxblocks:
            break

        def split_cost(i):
            idx = np.atleast_1d(i)
            if USE_NATIVE_COSTS:
                return _native_ctx(store).split_costs(lstart, lend, idx)
            return np.array([
                estimate_cost(store, lstart, int(x))
                + estimate_cost(store, int(x), lend) for x in idx
            ])

        llpos, splitcost = _find_minimum(split_cost, lstart + 1, lend)
        origcost = estimate_cost(store, lstart, lend)
        if splitcost > origcost or llpos == lstart + 1 or llpos == lend:
            done.add(lstart)
        else:
            splitpoints.append(llpos)
            splitpoints.sort()
            numblocks += 1

        # Largest remaining splittable segment.
        found = False
        longest = 0
        bounds = [0] + splitpoints + [store.size - 1]
        for i in range(len(bounds) - 1):
            s, e = bounds[i], bounds[i + 1]
            if s not in done and e - s > longest:
                lstart, lend = s, e
                longest = e - s
                found = True
        if not found:
            break
        if lend - lstart < 10:
            break
    return splitpoints


def block_split(data: np.ndarray, instart: int, inend: int,
                maxblocks: int, greedy_fn) -> list[int]:
    """Split points in byte coordinates via a greedy pre-parse.

    greedy_fn(data, instart, inend) -> (litlens, dists); the greedy parse
    gives better split points than the optimal one (blocksplitter.c:294).
    """
    litlens, dists = greedy_fn(data, instart, inend)
    store = LZ77Store(data, litlens, dists, instart)
    lz77_points = block_split_lz77(store, maxblocks)
    return [int(store.pos[p]) for p in lz77_points]
