"""The gzip (RFC 1952), zlib (RFC 1950) and raw DEFLATE (RFC 1951)
containers, checked field by field.  The standard library's zlib
inflates the DEFLATE stream as the independent decoder; the framing,
CRC-32, Adler-32 and ISIZE are read here.

Each check returns (decoded bytes, None) or (what it got, a reason).
"""

from __future__ import annotations

import struct
import zlib


def inflate_raw(stream: bytes) -> tuple[bytes, bytes, str | None]:
    """(decoded, bytes after the final block, reason or None)."""
    d = zlib.decompressobj(-15)
    try:
        raw = d.decompress(stream) + d.flush()
    except zlib.error as e:
        return b"", b"", f"inflate: {e}"
    if not d.eof:
        return raw, b"", "DEFLATE stream has no final block"
    return raw, d.unused_data, None


def check_deflate(out: bytes, data: bytes | None):
    raw, rest, why = inflate_raw(out)
    if why:
        return raw, why
    if rest:
        return raw, f"{len(rest)} bytes after the final block"
    if data is not None and raw != data:
        return raw, "decodes to other bytes"
    return raw, None


def check_gzip(out: bytes, data: bytes | None):
    if len(out) < 18 or out[:3] != b"\x1f\x8b\x08":
        return b"", "no gzip header"
    flg = out[3]
    if flg & 0xE0:
        return b"", "reserved FLG bits set"
    pos = 10
    if flg & 4:
        xlen, = struct.unpack("<H", out[pos:pos + 2])
        pos += 2 + xlen
    for bit in (8, 16):
        if flg & bit:
            end = out.find(b"\0", pos)
            if end < 0:
                return b"", "unterminated header field"
            pos = end + 1
    if flg & 2:
        if struct.unpack("<H", out[pos:pos + 2])[0] != \
                zlib.crc32(out[:pos]) & 0xFFFF:
            return b"", "header CRC wrong"
        pos += 2
    raw, rest, why = inflate_raw(out[pos:])
    if why:
        return raw, why
    if len(rest) != 8:
        return raw, f"trailer of {len(rest)} bytes"
    crc, isize = struct.unpack("<II", rest)
    if crc != zlib.crc32(raw):
        return raw, "CRC-32 wrong"
    if isize != len(raw) & 0xFFFFFFFF:
        return raw, "ISIZE wrong"
    if data is not None and raw != data:
        return raw, "decodes to other bytes"
    return raw, None


def check_zlib(out: bytes, data: bytes | None):
    if len(out) < 6:
        return b"", "no zlib header"
    cmf, flg = out[0], out[1]
    if cmf & 0x0F != 8 or cmf >> 4 > 7 or (cmf * 256 + flg) % 31:
        return b"", "zlib header wrong"
    if flg & 0x20:
        return b"", "preset dictionary"
    raw, rest, why = inflate_raw(out[2:])
    if why:
        return raw, why
    if len(rest) != 4:
        return raw, f"trailer of {len(rest)} bytes"
    if struct.unpack(">I", rest)[0] != zlib.adler32(raw):
        return raw, "Adler-32 wrong"
    if data is not None and raw != data:
        return raw, "decodes to other bytes"
    return raw, None


CHECKS = {"gzip": check_gzip, "zlib": check_zlib, "deflate": check_deflate}
WBITS = {"gzip": 31, "zlib": 15, "deflate": -15}


def zlib9_size(fmt: str, data: bytes) -> int:
    """Bytes of the standard library's zlib at level 9 (its default
    window and memory level) on `data`, in container `fmt`."""
    c = zlib.compressobj(9, zlib.DEFLATED, WBITS[fmt])
    return len(c.compress(data)) + len(c.flush())
