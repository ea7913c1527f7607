"""A plain PNG writer (RFC 2083), independent of the program: NumPy and
the standard library's zlib.

It writes what the input kind hands to the program and the size
yardstick the PNG check holds the program's output below.  By default
it writes as libpng does by default: non-interlaced, every line's
filter chosen by the minimum sum of its bytes read as signed (libpng's
adaptive heuristic; a tie goes to the lower type), the filtered lines
through zlib at level 6 with the `Z_FILTERED` strategy, window 15 and
memory level 8, and the stream cut into IDAT chunks of 8,192 bytes.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def chunk(kind: bytes, data: bytes) -> bytes:
    """One chunk: length, type, data and the CRC-32 of type and data."""
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def pack(samples: np.ndarray, bitdepth: int) -> np.ndarray:
    """(h, w, channels) samples -> (h, stride) bytes of the raw lines:
    big-endian at 16 bits, packed from the high bit below 8."""
    h, w, ch = samples.shape
    if bitdepth == 16:
        return samples.astype(">u2").reshape(h, w * ch).view(np.uint8)
    if bitdepth == 8:
        return samples.astype(np.uint8).reshape(h, w * ch)
    vals = samples.astype(np.uint8).reshape(h, w * ch)
    bits = np.unpackbits(vals[:, :, None], axis=2)[:, :, 8 - bitdepth:]
    return np.packbits(bits.reshape(h, -1), axis=1)


def filtered(lines: np.ndarray, bpp: int) -> np.ndarray:
    """(5, h, stride): every line under each filter type 0-4, the
    predictors read from the raw lines (RFC 2083 section 6)."""
    x = lines.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = (np.zeros_like(x), a, b, (a + b) >> 1, paeth)
    return np.stack([(x - q) & 0xFF for q in preds]).astype(np.uint8)


def minsum(cand: np.ndarray) -> np.ndarray:
    """Each line's filter type of least sum of |byte as signed|."""
    v = cand.astype(np.int32)
    return np.argmin(np.minimum(v, 256 - v).sum(axis=2), axis=0)


def write(samples: np.ndarray, colortype: int, bitdepth: int = 8,
          level: int = 6, filters=None, palette: np.ndarray | None = None,
          trns: bytes | None = None, idat_size: int = 8192) -> bytes:
    """A PNG of `samples` ((h, w, channels) of the color type, palette
    indices for type 3).  `filters`: None for the minimum-sum choice, an
    int for one type on every line, or a type a line."""
    h, w, ch = samples.shape
    if CHANNELS[colortype] != ch:
        raise ValueError(f"{ch} channels for color type {colortype}")
    lines = pack(samples, bitdepth)
    bpp = max(1, ch * bitdepth // 8)
    cand = filtered(lines, bpp)
    if filters is None:
        ftypes = minsum(cand)
    else:
        ftypes = np.broadcast_to(np.asarray(filters, np.int64), (h,))
    raw = np.empty((h, 1 + lines.shape[1]), np.uint8)
    raw[:, 0] = ftypes
    raw[:, 1:] = cand[ftypes, np.arange(h)]
    z = zlib.compressobj(level, zlib.DEFLATED, 15, 8, zlib.Z_FILTERED)
    stream = z.compress(raw.tobytes()) + z.flush()
    out = [SIGNATURE, chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, bitdepth,
                                                 colortype, 0, 0, 0))]
    if palette is not None:
        out.append(chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes()))
    if trns is not None:
        out.append(chunk(b"tRNS", trns))
    out += [chunk(b"IDAT", stream[i:i + idat_size])
            for i in range(0, len(stream), idat_size)]
    out.append(chunk(b"IEND", b""))
    return b"".join(out)
