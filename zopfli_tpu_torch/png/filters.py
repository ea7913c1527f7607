"""PNG scanline filtering: apply/undo + strategy search, vectorized.

Covers the reference's filter machinery (lodepng unfilter
lodepng.cpp:4101-4305; encoder filter search lodepng.cpp:5444-5636 and
the zopflipng strategy set zopflipng_lib.h:36-47): filter types 0-4,
minsum and entropy heuristics, fixed/predefined strategies, and the
brute-force per-line search (driven from png.optimize with trial
deflates).

Unfiltering is serial in the Up/Paeth dependency on the previous line
but each line is a vector op over its bytes; filtering a KNOWN raw
image is fully parallel over lines (the previous RAW line is already
known) — that is what makes the strategy search cheap and batchable.
"""

from __future__ import annotations

import numpy as np


def _paeth(a, b, c):
    """Paeth predictor, vectorized (RFC 2083 §6.6)."""
    a = a.astype(np.int16)
    b = b.astype(np.int16)
    c = c.astype(np.int16)
    p = a + b - c
    pa = np.abs(p - a)
    pb = np.abs(p - b)
    pc = np.abs(p - c)
    out = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return out.astype(np.uint8)


def unfilter(raw: np.ndarray, height: int, stride: int,
             bpp_bytes: int) -> np.ndarray:
    """Undo per-line filters.  raw: height*(1+stride) filtered bytes.

    Returns (height, stride) uint8 of reconstructed scanlines.  The
    Sub/Avg/Paeth recurrences are serial per byte, so the hot path is
    the native C unfilter; the numpy loop below is the fallback oracle.
    """
    try:
        from .. import native
        return native.png_unfilter(raw, height, stride, bpp_bytes)
    except (OSError, ImportError):  # no compiler: pure-python fallback
        pass
    raw = raw.reshape(height, 1 + stride)
    ftypes = raw[:, 0]
    data = raw[:, 1:].astype(np.uint8)
    out = np.zeros((height, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.uint8)
    for y in range(height):
        f = int(ftypes[y])
        line = data[y].copy()
        if f == 0:
            rec = line
        elif f == 1:  # Sub: serial in x with lag bpp -> per-phase cumsum
            rec = line
            for x in range(bpp_bytes, stride):
                rec[x] = (int(rec[x]) + int(rec[x - bpp_bytes])) & 0xFF
        elif f == 2:  # Up
            rec = (line + prev) & 0xFF
        elif f == 3:  # Average
            rec = line
            for x in range(stride):
                left = rec[x - bpp_bytes] if x >= bpp_bytes else 0
                rec[x] = (int(rec[x]) + ((int(left) + int(prev[x])) >> 1)) \
                    & 0xFF
        elif f == 4:  # Paeth
            rec = line
            for x in range(stride):
                a = rec[x - bpp_bytes] if x >= bpp_bytes else 0
                c = prev[x - bpp_bytes] if x >= bpp_bytes else 0
                rec[x] = (rec[x] + _paeth(np.uint8(a), prev[x],
                                          np.uint8(c))) & 0xFF
        else:
            raise ValueError(f"bad filter type {f} on line {y}")
        out[y] = rec
        prev = out[y]
    return out


def filter_all_types(img: np.ndarray, bpp_bytes: int) -> np.ndarray:
    """All five filtered versions of every line, in one shot.

    img: (height, stride) raw scanlines.
    Returns (5, height, stride) uint8 — candidates[f][y] is line y
    filtered with type f.  Fully vectorized: the predictors read the
    RAW previous line/bytes, which are known.
    """
    h, stride = img.shape
    a = np.zeros_like(img)       # left neighbor (by bpp)
    a[:, bpp_bytes:] = img[:, :-bpp_bytes]
    b = np.zeros_like(img)       # above
    b[1:] = img[:-1]
    c = np.zeros_like(img)       # above-left
    c[1:, bpp_bytes:] = img[:-1, :-bpp_bytes]

    out = np.empty((5, h, stride), dtype=np.uint8)
    out[0] = img
    out[1] = img - a
    out[2] = img - b
    out[3] = img - ((a.astype(np.uint16) + b.astype(np.uint16)) >> 1).astype(
        np.uint8)
    out[4] = img - _paeth(a, b, c)
    return out


def serialize(candidates: np.ndarray, ftypes: np.ndarray) -> bytes:
    """Assemble the filtered byte stream for chosen per-line types."""
    _, h, stride = candidates.shape
    out = np.empty((h, 1 + stride), dtype=np.uint8)
    out[:, 0] = ftypes
    out[:, 1:] = candidates[ftypes, np.arange(h)]
    return out.tobytes()


def strategy_zero(h: int) -> np.ndarray:
    return np.zeros(h, dtype=np.int64)


def strategy_fixed(h: int, f: int) -> np.ndarray:
    return np.full(h, f, dtype=np.int64)


def strategy_minsum(candidates: np.ndarray) -> np.ndarray:
    """Per line, the filter minimizing sum of |signed byte| (lodepng's
    default heuristic, lodepng.cpp:5512-5541)."""
    v = candidates.astype(np.int16)
    mag = np.where(v < 128, v, 256 - v)
    sums = mag.sum(axis=2)            # (5, h)
    return np.argmin(sums, axis=0)


def strategy_entropy(candidates: np.ndarray) -> np.ndarray:
    """Per line, the filter minimizing the byte-histogram entropy
    (LFS_ENTROPY, lodepng.cpp:5566-5599).  One bincount over offset
    line ids replaces the per-line Python loop."""
    nf, h, stride = candidates.shape
    ids = np.arange(nf * h, dtype=np.int64)[:, None] * 256
    flat = candidates.reshape(nf * h, stride).astype(np.int64) + ids
    counts = np.bincount(flat.ravel(), minlength=nf * h * 256)
    counts = counts.reshape(nf, h, 256)
    p = counts / stride
    with np.errstate(divide="ignore", invalid="ignore"):
        terms = np.where(counts > 0, -p * np.log2(p, where=counts > 0), 0.0)
    scores = terms.sum(axis=2)
    return np.argmin(scores, axis=0)
