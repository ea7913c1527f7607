"""zlib at level 9 with sound gzip framing: the step a change that gives
up bytes for speed would take to its end."""

import zlib


def encode(item) -> bytes:
    c = zlib.compressobj(9, zlib.DEFLATED, 31)
    return c.compress(item.raw) + c.flush()
