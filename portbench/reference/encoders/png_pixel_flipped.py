"""The size yardstick with the low bit of one sample flipped, the red
of the middle pixel: a sound PNG of other pixels, the step a lossy
change would take."""

from portbench.reference import png_write


def encode(item) -> bytes:
    pixels = item.expect.copy()
    h, w, _ = pixels.shape
    pixels[h // 2, w // 2, 0] ^= 1
    return png_write.write(pixels, 2, 8, level=9)
