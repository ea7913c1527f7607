"""The size yardstick with the low bit of one sample flipped where the
pixel is seen, the red of the middle pixel (alpha above 0): a sound PNG
of other pixels, the step a lossy change would take."""

from portbench.reference import png_write


def encode(item) -> bytes:
    pixels = item.expect.copy()
    h, w, _ = pixels.shape
    if pixels[h // 2, w // 2, 3] == 0:
        raise ValueError("the middle pixel is clear: no seen sample there")
    pixels[h // 2, w // 2, 0] ^= 1
    return png_write.write(pixels, 6, 8, level=9)
