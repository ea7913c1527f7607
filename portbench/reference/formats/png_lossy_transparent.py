"""PNG (RFC 2083) under `--lossy_transparent`, checked by the plain
decoder `png_read.decode`: the output is a sound PNG (signature, chunk
CRC-32s, IHDR, one zlib stream over the IDAT chunks with its Adler-32)
whose alpha equals the input's at every pixel and whose RGB equals the
input's at every pixel with alpha above 0, whatever color type and bit
depth it chose.  Where the input's alpha is 0 the RGB is free: the
flag lets the optimizer rewrite colors no one sees.  The yardstick is
the input's RGBA pixels written by the plain writer that made the input
(color type 6, minimum-sum filters), with zlib at level 9 in place of
6."""

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
    want = item.expect.astype(np.uint16) * 257
    if not np.array_equal(rgba[:, :, 3], want[:, :, 3]):
        return "alpha differs from the input's"
    seen = want[:, :, 3] > 0
    if not np.array_equal(rgba[:, :, :3][seen], want[:, :, :3][seen]):
        return "RGB differs from the input's where alpha is above 0"
    return None


def zlib9_size(item) -> int:
    return len(png_write.write(item.expect, 6, 8, level=9))
