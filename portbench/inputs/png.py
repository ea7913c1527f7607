"""Photographs: seeded photo-like 8-bit RGB images, saved as PNG as a
common encoder saves them.

The mix's `sizes` is a list of [width, height], one pass of the mix.
Each pass deals every size once, in an order the seed draws, and every
item is an image of its own, drawn from its own stream of the seed.
The mix's `photo` sets the generator (`photo` below) and its `writer`
the PNG writer's settings (`reference/png_write.py`: minimum-sum
filters, zlib level 6, IDAT chunks of 8,192 bytes, as libpng writes by
default).  An item's `raw` is that PNG, `expect` its pixels ((h, w, 3)
uint8) and `nbytes` its pixel bytes, w x h x 3.
"""

from __future__ import annotations

import numpy as np

from portbench.gen import Item, rng_for
from portbench.reference import png_write


def smooth(rng, h: int, w: int, cell: float, ch: int = 3) -> np.ndarray:
    """(h, w, ch) noise of about unit deviation that varies over about `cell`
    pixels: normal values on a grid of that spacing, interpolated
    bilinearly."""
    gh, gw = int(h / cell) + 2, int(w / cell) + 2
    grid = rng.standard_normal((gh, gw, ch), dtype=np.float32)
    y, x = np.arange(h) / cell, np.arange(w) / cell
    y0, x0 = y.astype(np.int64), x.astype(np.int64)
    fy = (y - y0).astype(np.float32)[:, None, None]
    fx = (x - x0).astype(np.float32)[None, :, None]
    top = grid[y0][:, x0] * (1 - fx) + grid[y0][:, x0 + 1] * fx
    bot = grid[y0 + 1][:, x0] * (1 - fx) + grid[y0 + 1][:, x0 + 1] * fx
    return top * (1 - fy) + bot * fy


def photo(rng, h: int, w: int, p: dict) -> np.ndarray:
    """(h, w, 3) uint8: smooth fields at several scales, in luma and
    colour difference; `regions` sharp-edged ellipses and rectangles,
    each with its own colour offset and texture; and per-pixel noise,
    mostly in luma, so correlated across the three channels."""
    yuv = np.zeros((h, w, 3), np.float32)
    yuv[:, :, 0] = p["mean"]
    for cell, amp in zip(p["scales"], p["amplitudes"]):
        yuv += smooth(rng, h, w, cell) * np.asarray(amp, np.float32)
    for _ in range(p["regions"]):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        ry, rx = rng.uniform(*p["region_size"], 2) * min(h, w)
        y0, y1 = max(0, int(cy - ry)), min(h, int(cy + ry) + 1)
        x0, x1 = max(0, int(cx - rx)), min(w, int(cx + rx) + 1)
        yy, xx = np.mgrid[y0:y1, x0:x1].astype(np.float32)
        if rng.random() < 0.5:
            mask = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1
        else:
            mask = (np.abs(yy - cy) <= ry) & (np.abs(xx - cx) <= rx)
        offset = rng.normal(0, p["region_offset"], 3).astype(np.float32)
        tex = smooth(rng, y1 - y0, x1 - x0, p["texture_cell"], 1)
        box = yuv[y0:y1, x0:x1]
        box[mask] += offset + tex[mask] * p["texture"]
    noise = rng.standard_normal((h, w, 3), dtype=np.float32)
    yuv += noise * np.asarray(p["noise"], np.float32)
    # Luma and two colour-difference axes to RGB, so that the channels
    # move together, as a camera's do; element by element, so that the
    # rounding is IEEE's on every machine (a BLAS product may differ).
    y, u, v = yuv[:, :, 0], yuv[:, :, 1], yuv[:, :, 2]
    rgb = np.stack([y + 0.6 * u, y - 0.3 * u + 0.5 * v,
                    y - 0.3 * u - 0.5 * v], axis=2)
    return np.clip(np.rint(rgb), 0, 255).astype(np.uint8)


def save(pixels: np.ndarray, writer: dict) -> bytes:
    """The pixels as an 8-bit RGB PNG, by the mix's writer settings."""
    return png_write.write(pixels, 2, 8, level=writer["level"],
                           idat_size=writer["idat_size"])


def items(mix: dict, seed: int) -> list:
    sizes = [tuple(int(v) for v in s) for s in mix["sizes"]]
    rng = rng_for(seed, 0)
    deal = [sizes[j] for _ in range(int(mix["passes"]))
            for j in rng.permutation(len(sizes))]
    out = []
    for k, (w, h) in enumerate(deal):
        pixels = photo(rng_for(seed, 1, k), h, w, mix["photo"])
        out.append(Item(f"p{k}", save(pixels, mix["writer"]), w * h * 3,
                        pixels))
    return out
