"""The size yardstick with the alpha of one pixel changed, the middle
pixel's, which is opaque: a sound PNG that moves an edge of the icon."""

from portbench.reference import png_write


def encode(item) -> bytes:
    pixels = item.expect.copy()
    h, w, _ = pixels.shape
    pixels[h // 2, w // 2, 3] ^= 1
    return png_write.write(pixels, 6, 8, level=9)
