"""A plain PNG decoder (RFC 2083), independent of the program: NumPy and
the standard library's zlib, which inflates the image data.

`decode(png)` reads a non-interlaced PNG of any legal color type and
bit depth to (h, w, 4) RGBA at 16 bits a sample, so that pixels of any
depth compare exactly: a sample of depth d is scaled by 65535 / (2^d -
1), as the PNG specification scales by bit replication.  Every fault it
finds raises `Bad` with the reason.  It checks, in order: the
signature; every chunk's length and CRC-32, and that nothing follows
IEND; IHDR first, its fields and a legal pair of bit depth and color
type; PLTE and tRNS as the color type allows them; the IDAT chunks
consecutive and joined into one zlib stream with a sound header, a
final block, an Adler-32 that matches and nothing after it; the
inflated size; each line's filter type; palette indices in range.  An
interlaced image is refused with its own reason: ZopfliPNG writes none.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
          6: (8, 16)}


class Bad(ValueError):
    """The bytes are not a PNG this decoder accepts; the message says
    why."""


def chunks(png: bytes) -> list[tuple[bytes, bytes]]:
    """[(type, data)] up to and including IEND, each CRC checked."""
    if png[:8] != SIGNATURE:
        raise Bad("no PNG signature")
    out, pos = [], 8
    while True:
        if pos + 12 > len(png):
            raise Bad("no IEND chunk")
        n, kind = struct.unpack(">I4s", png[pos:pos + 8])
        if n > 2 ** 31 - 1 or pos + 12 + n > len(png):
            raise Bad(f"chunk at byte {pos} runs past the end")
        if not kind.isalpha():
            raise Bad(f"chunk type {kind!r} is not four letters")
        data = png[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", png[pos + 8 + n:pos + 12 + n])
        if crc != zlib.crc32(kind + data):
            raise Bad(f"{kind.decode()} chunk CRC-32 wrong")
        out.append((kind, data))
        pos += 12 + n
        if kind == b"IEND":
            break
    if pos != len(png):
        raise Bad(f"{len(png) - pos} bytes after IEND")
    return out


def inflate(stream: bytes) -> bytes:
    """The zlib stream's data, its header and Adler-32 checked."""
    if len(stream) < 6:
        raise Bad("zlib stream too short")
    cmf, flg = stream[0], stream[1]
    if cmf & 0x0F != 8 or cmf >> 4 > 7 or (cmf * 256 + flg) % 31:
        raise Bad("zlib header wrong")
    if flg & 0x20:
        raise Bad("zlib preset dictionary")
    d = zlib.decompressobj(-15)
    try:
        data = d.decompress(stream[2:]) + d.flush()
    except zlib.error as e:
        raise Bad(f"inflate: {e}") from None
    if not d.eof:
        raise Bad("DEFLATE stream has no final block")
    if len(d.unused_data) != 4:
        raise Bad(f"{len(d.unused_data)} bytes after the DEFLATE stream, "
                  "not the 4 of the Adler-32")
    if struct.unpack(">I", d.unused_data)[0] != zlib.adler32(data):
        raise Bad("Adler-32 wrong")
    return data


def unfilter(raw: np.ndarray, bpp: int) -> np.ndarray:
    """(h, 1 + stride) filtered lines -> (h, stride) raw lines.

    A byte's predictor reads the reconstructed bytes to its left (a),
    above (b) and above-left (c), so the pixels (y, j) with y + j = t
    depend only on those of t - 1 and t - 2.  The lines are sheared so
    that each such antidiagonal is one row of an array, S[t, y] = pixel
    (y, t - y), and each step is a few NumPy operations on whole rows:
    a = S[t-1, y], b = S[t-1, y-1], c = S[t-2, y-1].  S has a zero row
    above (y = -1) and positions that no pixel fills stay zero, which
    are the zeros the filters read at the image's top and left edges."""
    h, width = raw.shape
    ftype = raw[:, 0]
    if (ftype > 4).any():
        bad = int(np.argmax(ftype > 4))
        raise Bad(f"filter type {int(ftype[bad])} on line {bad}")
    stride = width - 1
    n = stride // bpp
    x = raw[:, 1:].reshape(h, n, bpp).astype(np.int16)
    steps = h + n - 1
    ys, js = np.divmod(np.arange(h * n), n)
    xs = np.zeros((steps, h, bpp), np.int16)          # xs[t, y] = x[y, t-y]
    xs[ys + js, ys] = x[ys, js]
    s = np.zeros((steps + 2, h + 1, bpp), np.int16)   # s[t+2, y+1]
    ft = ftype.astype(np.int16)[:, None]
    for t in range(steps):
        lo, hi = max(0, t - n + 1), min(h, t + 1)
        a = s[t + 1, lo + 1:hi + 1]
        b = s[t + 1, lo:hi]
        c = s[t, lo:hi]
        f = ft[lo:hi]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        pred = np.where(f == 1, a, np.where(f == 2, b, np.where(
            f == 3, (a + b) >> 1, np.where(f == 4, paeth, 0))))
        s[t + 2, lo + 1:hi + 1] = (xs[t, lo:hi] + pred) & 0xFF
    rec = s[ys + js + 2, ys + 1].reshape(h, n * bpp)
    return rec.astype(np.uint8)


def samples(lines: np.ndarray, w: int, ch: int, depth: int) -> np.ndarray:
    """(h, stride) raw lines -> (h, w, ch) samples at their depth."""
    h = lines.shape[0]
    if depth == 16:
        return lines.view(">u2").astype(np.uint32).reshape(h, w, ch)
    if depth == 8:
        return lines.astype(np.uint32).reshape(h, w, ch)
    bits = np.unpackbits(lines, axis=1)[:, :w * ch * depth]
    vals = bits.reshape(h, w * ch, depth).astype(np.uint32)
    weights = 1 << np.arange(depth - 1, -1, -1, dtype=np.uint32)
    return (vals * weights).sum(axis=2, dtype=np.uint32).reshape(h, w, ch)


def decode(png: bytes) -> np.ndarray:
    """(h, w, 4) uint16 RGBA of a non-interlaced PNG; raises `Bad`."""
    cl = chunks(png)
    if cl[0][0] != b"IHDR" or len(cl[0][1]) != 13:
        raise Bad("first chunk is not a 13-byte IHDR")
    w, h, depth, ct, comp, filt, lace = struct.unpack(">IIBBBBB", cl[0][1])
    if not (0 < w < 2 ** 31 and 0 < h < 2 ** 31):
        raise Bad(f"IHDR size {w}x{h}")
    if depth not in DEPTHS.get(ct, ()):
        raise Bad(f"bit depth {depth} with color type {ct}")
    if comp or filt:
        raise Bad(f"compression method {comp}, filter method {filt}")
    if lace == 1:
        raise Bad("interlaced output (ZopfliPNG writes none)")
    if lace:
        raise Bad(f"interlace method {lace}")
    kinds = [k for k, _ in cl]
    if kinds.count(b"IHDR") != 1 or b"IDAT" not in kinds:
        raise Bad("IHDR twice or no IDAT")
    first = kinds.index(b"IDAT")
    last = len(kinds) - 1 - kinds[::-1].index(b"IDAT")
    if kinds[first:last + 1] != [b"IDAT"] * (last + 1 - first):
        raise Bad("IDAT chunks not consecutive")
    meta = {k: d for k, d in cl if k in (b"PLTE", b"tRNS")}
    for k in meta:
        if kinds.count(k) != 1 or kinds.index(k) > first:
            raise Bad(f"{k.decode()} twice or after IDAT")
    palette = meta.get(b"PLTE")
    trns = meta.get(b"tRNS")
    if ct == 3:
        if palette is None or not len(palette) or len(palette) % 3 \
                or len(palette) // 3 > 2 ** depth:
            raise Bad("palette image without a sound PLTE")
        if trns is not None and len(trns) > len(palette) // 3:
            raise Bad("tRNS longer than the palette")
    elif palette is not None and ct in (0, 4):
        raise Bad(f"PLTE with color type {ct}")
    elif palette is not None and len(palette) % 3:
        raise Bad("PLTE length not a multiple of 3")
    if trns is not None and (ct in (4, 6)
                             or (ct in (0, 2) and len(trns) != 2 * (ct + 1))):
        raise Bad(f"tRNS of {len(trns)} bytes with color type {ct}")

    ch = CHANNELS[ct]
    stride = (w * ch * depth + 7) // 8
    data = inflate(b"".join(d for k, d in cl if k == b"IDAT"))
    if len(data) != h * (1 + stride):
        raise Bad(f"{len(data)} bytes of image data, not "
                  f"{h * (1 + stride)}")
    raw = np.frombuffer(data, np.uint8).reshape(h, 1 + stride)
    v = samples(unfilter(raw, max(1, ch * depth // 8)), w, ch, depth)
    scale = 65535 // (2 ** depth - 1)
    rgba = np.empty((h, w, 4), np.uint32)
    rgba[:, :, 3] = 65535
    if ct == 3:
        pal = np.frombuffer(palette, np.uint8).reshape(-1, 3)
        idx = v[:, :, 0]
        if idx.max() >= len(pal):
            raise Bad("palette index out of range")
        rgba[:, :, :3] = pal[idx].astype(np.uint32) * 257
        alpha = np.full(len(pal), 255, np.uint32)
        if trns is not None:
            alpha[:len(trns)] = np.frombuffer(trns, np.uint8)
        rgba[:, :, 3] = alpha[idx] * 257
        return rgba.astype(np.uint16)
    color = v[:, :, :3] if ct in (2, 6) else v[:, :, :1]
    rgba[:, :, :3] = color * scale
    if ct in (4, 6):
        rgba[:, :, 3] = v[:, :, -1] * scale
    elif trns is not None:
        key = np.array(struct.unpack(f">{ch}H", trns), np.uint32)
        rgba[:, :, 3] = np.where((v == key).all(axis=2), 0, 65535)
    return rgba.astype(np.uint16)
