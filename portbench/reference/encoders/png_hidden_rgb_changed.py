"""The size yardstick with the RGB of every pixel whose alpha is 0 set
to 0: what `--lossy_transparent` allows, so the check must pass it."""

from portbench.reference import png_write


def encode(item) -> bytes:
    pixels = item.expect.copy()
    pixels[pixels[:, :, 3] == 0, :3] = 0
    return png_write.write(pixels, 6, 8, level=9)
