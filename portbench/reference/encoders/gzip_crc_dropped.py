"""zlib at level 9 framed as gzip with the CRC-32 left 0: the step a
change that skips the checksum to save host time would take."""

import struct
import zlib


def encode(item) -> bytes:
    raw = item.raw
    c = zlib.compressobj(9, zlib.DEFLATED, -15)
    body = c.compress(raw) + c.flush()
    return (b"\x1f\x8b\x08\x00\x00\x00\x00\x00\x02\xff" + body
            + struct.pack("<II", 0, len(raw) & 0xFFFFFFFF))
