"""Container formats: gzip (RFC 1952), zlib (RFC 1950), raw DEFLATE.

Byte-exact framing per the reference (src/zopfli/gzip_container.c:84-123,
src/zopfli/zlib_container.c:50-79).  Checksums run in the native host
library; `crc32_combine`/`adler32_combine` let shards checksum their
master blocks independently and merge on the gather host (no reference
counterpart — required by the distributed pipeline).
"""

from __future__ import annotations

import numpy as np

from . import native


def crc32(data, value: int = 0) -> int:
    data = np.ascontiguousarray(np.frombuffer(bytes(data), dtype=np.uint8)
                                if not isinstance(data, np.ndarray) else data)
    return native.crc32(data, value)


def adler32(data, value: int = 1) -> int:
    data = np.ascontiguousarray(np.frombuffer(bytes(data), dtype=np.uint8)
                                if not isinstance(data, np.ndarray) else data)
    return native.adler32(data, value)


# -- checksum combination (shard-parallel checksums) -------------------------

def _gf2_matrix_times(mat, vec: int) -> int:
    s = 0
    i = 0
    while vec:
        if vec & 1:
            s ^= mat[i]
        vec >>= 1
        i += 1
    return s


def _gf2_matrix_square(square, mat) -> None:
    for n in range(32):
        square[n] = _gf2_matrix_times(mat, mat[n])


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """CRC of concat(A, B) from crc(A), crc(B), len(B).

    Standard GF(2) matrix-power technique: advancing a CRC over len2 zero
    bytes is a linear operator; apply it to crc1 then xor crc2.
    """
    if len2 == 0:
        return crc1
    even = [0] * 32
    odd = [0] * 32
    # Operator for one zero bit.
    odd[0] = 0xEDB88320
    row = 1
    for n in range(1, 32):
        odd[n] = row
        row <<= 1
    _gf2_matrix_square(even, odd)   # 2-bit operator
    _gf2_matrix_square(odd, even)   # 4-bit operator
    # First squaring inside the loop yields the 1-byte operator, so len2
    # counts bytes from here on.
    while True:
        _gf2_matrix_square(even, odd)
        if len2 & 1:
            crc1 = _gf2_matrix_times(even, crc1)
        len2 >>= 1
        if len2 == 0:
            break
        _gf2_matrix_square(odd, even)
        if len2 & 1:
            crc1 = _gf2_matrix_times(odd, crc1)
        len2 >>= 1
        if len2 == 0:
            break
    return crc1 ^ crc2


def adler32_combine(adler1: int, adler2: int, len2: int) -> int:
    """Adler of concat(A, B) via modular shift of the component sums."""
    BASE = 65521
    rem = len2 % BASE
    sum1 = adler1 & 0xFFFF
    sum2 = (adler1 >> 16) & 0xFFFF
    s1b = adler2 & 0xFFFF
    s2b = (adler2 >> 16) & 0xFFFF
    s1 = (sum1 + s1b + BASE - 1) % BASE
    s2 = (rem * sum1 + sum2 + s2b + BASE - rem) % BASE
    return (s2 << 16) | s1


# -- framing ------------------------------------------------------------------

def gzip_frame(deflate_payload: bytes, crc: int, isize: int) -> bytes:
    """10-byte header + payload + CRC/ISIZE trailer (gzip_container.c:90-116)."""
    header = bytes([31, 139, 8, 0, 0, 0, 0, 0, 2, 3])
    trailer = (crc & 0xFFFFFFFF).to_bytes(4, "little") + \
        (isize & 0xFFFFFFFF).to_bytes(4, "little")
    return header + deflate_payload + trailer


def zlib_frame(deflate_payload: bytes, adler: int) -> bytes:
    """CMF/FLG header + payload + Adler trailer (zlib_container.c:50-71)."""
    cmf = 120  # CM 8, CINFO 7
    flevel = 3
    fdict = 0
    cmfflg = 256 * cmf + fdict * 32 + flevel * 64
    fcheck = 31 - cmfflg % 31
    cmfflg += fcheck
    header = bytes([cmfflg // 256, cmfflg % 256])
    trailer = (adler & 0xFFFFFFFF).to_bytes(4, "big")
    return header + deflate_payload + trailer
