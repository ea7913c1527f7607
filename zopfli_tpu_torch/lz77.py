"""LZ77 symbol store with O(1) range histograms.

Array-of-columns redesign of the reference store
(reference: src/zopfli/lz77.h:44-62, lz77.c:98-217).  A store is built in
one shot from (litlens, dists) numpy arrays: positions, symbols and the
chunked cumulative histograms come from one native pass
(native.parse_index), which can also check the parse against its bytes.
"""

from __future__ import annotations

import numpy as np

from . import native, spec


class LZ77Store:
    """Immutable parsed-symbol store over a byte buffer.

    litlens[i]: literal byte value if dists[i]==0 else match length (3..258)
    dists[i]: 0 for a literal, else match distance (1..32768)
    pos[i]: absolute input position of symbol i
    """

    def __init__(self, data: np.ndarray, litlens: np.ndarray,
                 dists: np.ndarray, instart: int = 0):
        self._index(data, litlens, dists, instart, None)

    @classmethod
    def checked(cls, data: np.ndarray, litlens: np.ndarray,
                dists: np.ndarray, instart: int, inend: int, wstart: int):
        """(store, matched bytes compared) of a parse of
        data[instart:inend], or (None, 0) when the parse is unsound: its
        steps do not cover the range exactly, a distance passes the window
        (32,768) or reaches before `wstart`, or a match's bytes differ
        from those it copies."""
        store = cls.__new__(cls)
        compared = store._index(data, litlens, dists, instart,
                                (inend, wstart))
        return (store, compared) if compared >= 0 else (None, 0)

    def _index(self, data, litlens, dists, instart, check) -> int:
        self.data = data
        self.litlens = np.asarray(litlens, dtype=np.int32)
        self.dists = np.asarray(dists, dtype=np.int32)
        (self.pos, self.ll_symbol, self.d_symbol, self._cum_ll, self._cum_d,
         compared) = native.parse_index(
            data, np.ascontiguousarray(self.litlens),
            np.ascontiguousarray(self.dists), instart, check)
        self.size = len(self.litlens)
        self._is_match = self.dists != 0
        return compared

    def byte_range(self, lstart: int, lend: int) -> int:
        """Number of input bytes spanned by symbols [lstart, lend)."""
        if lstart == lend:
            return 0
        l = lend - 1
        end = self.pos[l] + (1 if self.dists[l] == 0 else self.litlens[l])
        return int(end - self.pos[lstart])

    def _cum_at(self, k: int):
        """Histograms of symbols [0, k)."""
        c = k // native.INDEX_CHUNK
        ll = self._cum_ll[c].copy()
        d = self._cum_d[c].copy()
        lo = c * native.INDEX_CHUNK
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
    """Assert every match reproduces the bytes it references and every
    literal equals its byte.

    Semantics of reference ZopfliVerifyLenDist (lz77.c:273-286), applied to
    the whole store at once; the matches go through the native check.
    """
    data = store.data
    instart = int(store.pos[0])
    end = instart + store.byte_range(0, store.size)
    if LZ77Store.checked(data, store.litlens, store.dists, instart, end,
                         0)[0] is None:
        raise AssertionError("a match does not reproduce its bytes")
    # Literal symbols must equal the data bytes.
    lit = store.dists == 0
    if lit.any():
        pl = store.pos[lit]
        if not np.array_equal(store.litlens[lit], data[pl].astype(np.int32)):
            raise AssertionError("literal symbol mismatch")
