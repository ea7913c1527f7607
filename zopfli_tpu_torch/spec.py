"""DEFLATE (RFC 1951) constant tables, derived directly from the spec.

This is the TPU-native analogue of the reference's symbol utilities
(reference: src/zopfli/symbols.h:38-237 and the fixed tree in
src/zopfli/deflate.c:335-342).  Everything here is pure data: numpy arrays
that are cheap to close over in jitted JAX functions (they become XLA
constants).

Tables are *generated* from the RFC rules rather than transcribed:
  - length symbols 257..285 cover match lengths 3..258 with extra bits
    0,0,0,0,0,0,0,0,1,1,1,1,2,2,2,2,3,3,3,3,4,4,4,4,5,5,5,5,0
    (RFC 1951 section 3.2.5).
  - distance symbols 0..29 cover distances 1..32768 with extra bits
    0,0,0,0,1,1,2,2,...,13,13.
"""

from __future__ import annotations

import numpy as np

# Core DEFLATE limits (RFC 1951; reference src/zopfli/util.h:31-44).
MIN_MATCH = 3
MAX_MATCH = 258
WINDOW_SIZE = 32768
WINDOW_MASK = WINDOW_SIZE - 1
NUM_LL = 288  # literal/length alphabet size used by the encoder
NUM_D = 32    # distance alphabet size used by the encoder
NUM_CL = 19   # code-length alphabet size

# Master block size: the whole pipeline (splitting included) runs
# independently per master block so memory stays bounded on GB inputs
# (reference src/zopfli/util.h:52-60).
MASTER_BLOCK_SIZE = 1_000_000

LARGE_FLOAT = 1e30

# Order in which code-length-code lengths are stored in a dynamic block
# header (RFC 1951 section 3.2.7).
CL_ORDER = np.array(
    [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15],
    dtype=np.int32,
)


def _build_length_tables():
    """Build length->symbol/extra-bits tables for l in 0..258."""
    # (symbol, base_length, extra_bits) triples per RFC 1951 3.2.5.
    bases = []
    sym = 257
    l = 3
    for eb in (0,) * 8 + (1,) * 4 + (2,) * 4 + (3,) * 4 + (4,) * 4 + (5,) * 4:
        bases.append((sym, l, eb))
        sym += 1
        l += 1 << eb
    # Symbol 285 is the special case: length 258, 0 extra bits.
    bases.append((285, 258, 0))

    symbol = np.zeros(MAX_MATCH + 1, dtype=np.int32)
    extra_bits = np.zeros(MAX_MATCH + 1, dtype=np.int32)
    for s, base, eb in bases:
        span = 1 << eb
        hi = min(base + span, MAX_MATCH + 1)
        for length in range(base, hi):
            # length 258 must map to symbol 285 (handled by later overwrite).
            symbol[length] = s
            extra_bits[length] = eb
    # The 285 entry overwrites the tail of symbol 284's range.
    symbol[258], extra_bits[258] = 285, 0
    return symbol, extra_bits


def _build_dist_tables():
    """Distance symbol metadata per RFC 1951 3.2.5 (symbols 0..29)."""
    # dist_sym_base[s] = smallest distance with symbol s.
    base = np.zeros(30, dtype=np.int32)
    eb = np.zeros(30, dtype=np.int32)
    d = 1
    for s in range(30):
        e = 0 if s < 4 else (s // 2) - 1
        base[s] = d
        eb[s] = e
        d += 1 << e
    return base, eb


LENGTH_SYMBOL, LENGTH_EXTRA_BITS = _build_length_tables()
DIST_SYM_BASE, DIST_SYM_EXTRA_BITS = _build_dist_tables()

# Extra bits indexed by *length symbol* (257..285 -> index 0..28).
LENGTH_SYMBOL_EXTRA_BITS = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2,
     3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0], dtype=np.int32)


def length_symbol(l):
    """DEFLATE litlen symbol (257..285) for match length l (vectorized)."""
    return LENGTH_SYMBOL[l]


def dist_symbol(dist):
    """DEFLATE distance symbol (0..29) for distance >= 1 (vectorized).

    Uses the log2 bucket rule: for dist >= 5, sym = 2*floor(log2(dist-1)) +
    second-highest bit of (dist-1).
    """
    dist = np.asarray(dist)
    d1 = np.maximum(dist.astype(np.int64) - 1, 1)
    lg = np.frexp(d1.astype(np.float64))[1] - 1  # floor(log2(d1)) for d1>=1
    lg = lg.astype(np.int64)
    r = (d1 >> np.maximum(lg - 1, 0)) & 1
    sym = np.where(dist < 5, dist - 1, 2 * lg + r)
    return sym.astype(np.int32)


def fixed_tree_lengths():
    """The fixed Huffman tree of RFC 1951 3.2.6.

    Returns (ll_lengths[288], d_lengths[32]).
    """
    ll = np.zeros(NUM_LL, dtype=np.int32)
    ll[0:144] = 8
    ll[144:256] = 9
    ll[256:280] = 7
    ll[280:288] = 8
    d = np.full(NUM_D, 5, dtype=np.int32)
    return ll, d


# Distances at which a new distance symbol starts (useful for cost-model
# minimum searches; one representative per symbol class).
DSYM_FIRST_DIST = DIST_SYM_BASE.copy()
