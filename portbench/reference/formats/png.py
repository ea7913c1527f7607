"""PNG (RFC 2083), checked by the plain decoder `png_read.decode`: the
output is a sound PNG (signature, chunk CRC-32s, IHDR, one zlib stream
over the IDAT chunks with its Adler-32) whose pixels are exactly the
input's, whatever color type and bit depth it chose.  The yardstick is
the same pixels written by the plain writer that made the input, with
zlib at level 9 in place of 6."""

import numpy as np

from portbench.reference import png_read, png_write


def judge(out: bytes, item) -> str | None:
    try:
        rgba = png_read.decode(out)
    except png_read.Bad as e:
        return str(e)
    h, w, _ = item.expect.shape
    if rgba.shape[:2] != (h, w):
        return f"IHDR size {rgba.shape[1]}x{rgba.shape[0]}, not {w}x{h}"
    want = np.empty((h, w, 4), np.uint16)
    want[:, :, :3] = item.expect.astype(np.uint16) * 257
    want[:, :, 3] = 65535
    if not np.array_equal(rgba, want):
        return "pixels differ from the input's"
    return None


def zlib9_size(item) -> int:
    return len(png_write.write(item.expect, 2, 8, level=9))
