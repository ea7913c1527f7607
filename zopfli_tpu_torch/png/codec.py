"""PNG decode/encode built on the framework's deflate core.

Decode path (input side — out of scope for our compressor per the
reference's own stance, README:21-22): stock zlib inflates IDAT; the
scanline unfilter, Adam7 deinterlace, palette/bit-depth expansion to
RGBA are implemented here (lodepng decode semantics,
lodepng.cpp:4951-5110).

Encode path: RGBA (or reduced raw) pixels -> scanline filters ->
zlib-container compression through zopfli_tpu_torch.compress (the
CustomPNGDeflate bridge of zopflipng_lib.cc:47-63 without the C
function-pointer boundary; Options() runs it on "cuda") -> chunk
assembly.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field

import numpy as np

from .. import compress as _compress
from ..deflate import Options
from . import chunks as chunklib
from .chunks import Chunk
from . import filters as filtlib

CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}

# Adam7 pass grids: (x0, y0, dx, dy) per pass (RFC 2083 §8.2).
_ADAM7 = [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)]


@dataclass
class PNGInfo:
    width: int
    height: int
    bitdepth: int
    colortype: int
    interlace: int
    palette: np.ndarray | None = None      # (n, 3) uint8
    trns: bytes | None = None              # tRNS payload
    chunks: list = field(default_factory=list)  # all original chunks


def _stride(width: int, colortype: int, bitdepth: int) -> int:
    return (width * CHANNELS[colortype] * bitdepth + 7) // 8


def _bpp_bytes(colortype: int, bitdepth: int) -> int:
    return max(1, CHANNELS[colortype] * bitdepth // 8)


def _unpack_bits(line: np.ndarray, width: int, bitdepth: int) -> np.ndarray:
    """Sub-byte sample unpacking (1/2/4-bit) to one value per sample."""
    if bitdepth == 8:
        return line
    bits = np.unpackbits(line)
    per = bitdepth
    count = width
    vals = bits[: count * per].reshape(count, per)
    weights = (1 << np.arange(per - 1, -1, -1)).astype(np.uint16)
    return (vals * weights).sum(axis=1).astype(np.uint8)


def _scanlines_to_pixels(rec: np.ndarray, info: PNGInfo, width: int,
                         height: int) -> np.ndarray:
    """Reconstructed scanline bytes -> (h, w, ch) samples at 8/16 bits."""
    ct, bd = info.colortype, info.bitdepth
    ch = CHANNELS[ct]
    if bd == 16:
        arr = rec.reshape(height, -1).view(">u2")[:, : width * ch]
        return arr.reshape(height, width, ch).astype(np.uint16)
    if bd == 8:
        return rec.reshape(height, -1)[:, : width * ch].reshape(
            height, width, ch)
    out = np.empty((height, width, ch), dtype=np.uint8)
    for y in range(height):
        out[y, :, 0] = _unpack_bits(rec[y], width, bd)
    return out


def _to_rgba8(samples: np.ndarray, info: PNGInfo) -> np.ndarray:
    """Any color type/bit depth -> (h, w, 4) uint8 RGBA."""
    ct, bd = info.colortype, info.bitdepth
    h, w, _ = samples.shape
    # Keep the full-depth samples for tRNS color-key comparison: 16-bit
    # keys must match at 16-bit precision (an 8-bit comparison would mark
    # extra pixels transparent; lodepng compares at full depth).
    samples_full = samples
    if bd == 16:
        samples = (samples >> 8).astype(np.uint8)
    rgba = np.empty((h, w, 4), dtype=np.uint8)
    if ct == 0:
        scale = {1: 255, 2: 85, 4: 17, 8: 1, 16: 1}[bd]
        g = (samples[:, :, 0] * scale).astype(np.uint8)
        rgba[:, :, 0] = rgba[:, :, 1] = rgba[:, :, 2] = g
        rgba[:, :, 3] = 255
        if info.trns and len(info.trns) >= 2:
            key = int.from_bytes(info.trns[0:2], "big")
            if bd == 16:
                key_mask = samples_full[:, :, 0] == key
            else:
                key_mask = g == ((key * scale) & 0xFF)
            rgba[:, :, 3] = np.where(key_mask, 0, 255)
    elif ct == 2:
        rgba[:, :, :3] = samples
        rgba[:, :, 3] = 255
        if info.trns and len(info.trns) >= 6:
            kr = int.from_bytes(info.trns[0:2], "big")
            kg = int.from_bytes(info.trns[2:4], "big")
            kb = int.from_bytes(info.trns[4:6], "big")
            key_mask = ((samples_full[:, :, 0] == kr)
                        & (samples_full[:, :, 1] == kg)
                        & (samples_full[:, :, 2] == kb))
            rgba[:, :, 3] = np.where(key_mask, 0, 255)
    elif ct == 3:
        pal = info.palette
        if pal is None:
            raise ValueError("palette image without PLTE")
        idx = samples[:, :, 0]
        rgba[:, :, :3] = pal[idx]
        alpha = np.full(len(pal), 255, dtype=np.uint8)
        if info.trns:
            t = np.frombuffer(info.trns, dtype=np.uint8)
            alpha[: len(t)] = t
        rgba[:, :, 3] = alpha[idx]
    elif ct == 4:
        rgba[:, :, 0] = rgba[:, :, 1] = rgba[:, :, 2] = samples[:, :, 0]
        rgba[:, :, 3] = samples[:, :, 1]
    elif ct == 6:
        rgba[:] = samples
    else:
        raise ValueError(f"bad color type {ct}")
    return rgba


def decode(png: bytes):
    """PNG bytes -> ((h, w, 4) uint8 RGBA, PNGInfo).

    16-bit inputs also set info.raw16 with the (h, w, 4) uint16 image so
    the optimizer can preserve 16-bit content when asked.
    """
    cl = chunklib.parse(png)
    ihdr = next(c for c in cl if c.type == "IHDR")
    w = int.from_bytes(ihdr.data[0:4], "big")
    h = int.from_bytes(ihdr.data[4:8], "big")
    bd = ihdr.data[8]
    ct = ihdr.data[9]
    interlace = ihdr.data[12]
    info = PNGInfo(w, h, bd, ct, interlace, chunks=cl)
    for c in cl:
        if c.type == "PLTE":
            info.palette = np.frombuffer(c.data, dtype=np.uint8).reshape(-1, 3)
        elif c.type == "tRNS":
            info.trns = c.data

    idat = b"".join(c.data for c in cl if c.type == "IDAT")
    raw = np.frombuffer(zlib.decompress(idat), dtype=np.uint8)

    bpp = _bpp_bytes(ct, bd)
    if interlace == 0:
        stride = _stride(w, ct, bd)
        rec = filtlib.unfilter(raw, h, stride, bpp)
        info.raw_scanlines = rec  # pre-conversion bytes (keepcolortype)
        samples = _scanlines_to_pixels(rec, info, w, h)
    else:  # Adam7 (incl. sub-byte depths: per-pass bit unpacking,
        # lodepng.cpp:4101-4305 semantics)
        ch = CHANNELS[ct]
        samples = np.zeros((h, w, ch),
                           dtype=np.uint16 if bd == 16 else np.uint8)
        pos = 0
        for (x0, y0, dx, dy) in _ADAM7:
            pw = (w - x0 + dx - 1) // dx
            ph = (h - y0 + dy - 1) // dy
            if pw == 0 or ph == 0:
                continue
            stride = _stride(pw, ct, bd)
            nbytes = ph * (1 + stride)
            rec = filtlib.unfilter(raw[pos:pos + nbytes], ph, stride, bpp)
            pos += nbytes
            sub = _scanlines_to_pixels(rec, info, pw, ph)
            samples[y0::dy, x0::dx] = sub
    rgba = _to_rgba8(samples, info)
    if bd == 16 and ct in (0, 2, 4, 6):
        info.raw16 = samples
    return rgba, info


# ---------------------------------------------------------------------------
# Encoding
# ---------------------------------------------------------------------------

@dataclass
class EncodeSpec:
    """Raw image + header fields chosen by the optimizer."""
    scanlines: np.ndarray        # (h, stride) raw bytes (pre-filter)
    width: int
    height: int
    bitdepth: int
    colortype: int
    palette: np.ndarray | None = None
    trns: bytes | None = None


def encode(spec: EncodeSpec, ftypes: np.ndarray,
           options: Options | None = None,
           extra_chunks: tuple[list, list, list] = ([], [], []),
           deflater=None) -> bytes:
    """Assemble a PNG with the given per-line filter choices.

    deflater(raw_bytes) -> zlib container bytes; defaults to the
    framework compressor with `options`.
    """
    cand = filtlib.filter_all_types(spec.scanlines,
                                    _bpp_bytes(spec.colortype, spec.bitdepth))
    raw = filtlib.serialize(cand, np.asarray(ftypes, dtype=np.int64))
    if deflater is None:
        opts = options or Options()
        deflater = lambda b: _compress(b, "zlib", opts)
    idat = deflater(raw)

    ihdr = (spec.width.to_bytes(4, "big") + spec.height.to_bytes(4, "big") +
            bytes([spec.bitdepth, spec.colortype, 0, 0, 0]))
    out = [Chunk("IHDR", ihdr)]
    before_plte, before_idat, after_idat = extra_chunks
    out += before_plte
    if spec.palette is not None:
        out.append(Chunk("PLTE", spec.palette.astype(np.uint8).tobytes()))
    if spec.trns:
        out.append(Chunk("tRNS", spec.trns))
    out += before_idat
    out.append(Chunk("IDAT", idat))
    out += after_idat
    out.append(Chunk("IEND", b""))
    return chunklib.assemble(out)
