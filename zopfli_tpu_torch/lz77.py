"""LZ77 symbol store with O(1) range histograms.

Array-of-columns redesign of the reference store
(reference: src/zopfli/lz77.h:44-62, lz77.c:98-217).  A store is built in
one shot from (litlens, dists) numpy arrays; symbol mapping and the
chunked cumulative histograms are vectorized instead of per-append.
"""

from __future__ import annotations

import numpy as np

from . import spec

# Cumulative-histogram chunk length (symbols per checkpoint).
_CHUNK = 1024


class LZ77Store:
    """Immutable parsed-symbol store over a byte buffer.

    litlens[i]: literal byte value if dists[i]==0 else match length (3..258)
    dists[i]: 0 for a literal, else match distance (1..32768)
    pos[i]: absolute input position of symbol i
    """

    def __init__(self, data: np.ndarray, litlens: np.ndarray,
                 dists: np.ndarray, instart: int = 0):
        self.data = data
        self.litlens = np.asarray(litlens, dtype=np.int32)
        self.dists = np.asarray(dists, dtype=np.int32)
        n = len(self.litlens)
        step = np.where(self.dists == 0, 1, self.litlens).astype(np.int64)
        self.pos = instart + np.concatenate([[0], np.cumsum(step[:-1])])
        self.size = n

        is_match = self.dists != 0
        self.ll_symbol = np.where(
            is_match, spec.LENGTH_SYMBOL[np.minimum(self.litlens, 258)],
            self.litlens).astype(np.int32)
        self.d_symbol = np.where(
            is_match, spec.dist_symbol(np.maximum(self.dists, 1)),
            0).astype(np.int32)

        # Checkpointed cumulative histograms: cum_ll[c] = histogram of
        # symbols [0, c*_CHUNK).
        nchunks = n // _CHUNK + 1
        self._cum_ll = np.zeros((nchunks, spec.NUM_LL), dtype=np.int64)
        self._cum_d = np.zeros((nchunks, spec.NUM_D), dtype=np.int64)
        for c in range(1, nchunks):
            lo, hi = (c - 1) * _CHUNK, c * _CHUNK
            self._cum_ll[c] = self._cum_ll[c - 1] + np.bincount(
                self.ll_symbol[lo:hi], minlength=spec.NUM_LL)
            dseg = self.d_symbol[lo:hi][is_match[lo:hi]]
            self._cum_d[c] = self._cum_d[c - 1] + np.bincount(
                dseg, minlength=spec.NUM_D)
        self._is_match = is_match

    def byte_range(self, lstart: int, lend: int) -> int:
        """Number of input bytes spanned by symbols [lstart, lend)."""
        if lstart == lend:
            return 0
        l = lend - 1
        end = self.pos[l] + (1 if self.dists[l] == 0 else self.litlens[l])
        return int(end - self.pos[lstart])

    def _cum_at(self, k: int):
        """Histograms of symbols [0, k)."""
        c = k // _CHUNK
        ll = self._cum_ll[c].copy()
        d = self._cum_d[c].copy()
        lo = c * _CHUNK
        if k > lo:
            ll += np.bincount(self.ll_symbol[lo:k], minlength=spec.NUM_LL)
            seg = self.d_symbol[lo:k][self._is_match[lo:k]]
            d += np.bincount(seg, minlength=spec.NUM_D)
        return ll, d

    def histogram(self, lstart: int, lend: int):
        """(ll_counts[288], d_counts[32]) over symbols [lstart, lend)."""
        ll1, d1 = self._cum_at(lend)
        if lstart > 0:
            ll0, d0 = self._cum_at(lstart)
            ll1 -= ll0
            d1 -= d0
        return ll1, d1


def concat_stores(stores) -> "LZ77Store":
    """Concatenate per-block stores over the same data buffer."""
    stores = list(stores)
    assert stores
    data = stores[0].data
    litlens = np.concatenate([s.litlens for s in stores])
    dists = np.concatenate([s.dists for s in stores])
    instart = int(stores[0].pos[0]) if stores[0].size else 0
    return LZ77Store(data, litlens, dists, instart)


def verify_store(store: LZ77Store) -> None:
    """Assert every match reproduces the bytes it references.

    Semantics of reference ZopfliVerifyLenDist (lz77.c:273-286), applied to
    the whole store at once.
    """
    data = store.data
    for i in np.nonzero(store.dists)[0]:
        p = int(store.pos[i])
        d = int(store.dists[i])
        l = int(store.litlens[i])
        if not np.array_equal(data[p : p + l], data[p - d : p - d + l]):
            raise AssertionError(f"bad match at symbol {i}: pos={p} len={l} dist={d}")
    # Literal symbols must equal the data bytes.
    lit = store.dists == 0
    if lit.any():
        pl = store.pos[lit]
        if not np.array_equal(store.litlens[lit], data[pl].astype(np.int32)):
            raise AssertionError("literal symbol mismatch")
