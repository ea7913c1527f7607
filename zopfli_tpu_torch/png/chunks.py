"""PNG chunk-level I/O (the lodepng_util.h:52-108 equivalents).

Pure byte plumbing: split a PNG into chunks, reassemble, CRC per chunk
(PNG CRC-32 is the same polynomial as gzip — the native table CRC is
reused).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import containers

SIGNATURE = b"\x89PNG\r\n\x1a\n"


@dataclass
class Chunk:
    type: str
    data: bytes

    def tobytes(self) -> bytes:
        tb = self.type.encode("ascii")
        crc = containers.crc32(np.frombuffer(tb + self.data, dtype=np.uint8))
        return (len(self.data).to_bytes(4, "big") + tb + self.data +
                crc.to_bytes(4, "big"))


def parse(png: bytes) -> list[Chunk]:
    if png[:8] != SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    chunks = []
    pos = 8
    n = len(png)
    while pos + 8 <= n:
        length = int.from_bytes(png[pos:pos + 4], "big")
        ctype = png[pos + 4:pos + 8].decode("latin1")
        data = png[pos + 8:pos + 8 + length]
        if len(data) != length:
            raise ValueError(f"truncated chunk {ctype}")
        # stored CRC at pos+8+length (not validated strictly; encoders
        # occasionally ship bad ancillary CRCs and lodepng tolerates
        # them outside strict mode)
        chunks.append(Chunk(ctype, data))
        pos += 12 + length
        if ctype == "IEND":
            break
    if not chunks or chunks[-1].type != "IEND":
        raise ValueError("missing IEND")
    return chunks


def assemble(chunks: list[Chunk]) -> bytes:
    return SIGNATURE + b"".join(c.tobytes() for c in chunks)
