"""Launcher icons: seeded 8-bit RGBA app icons, saved as PNG as a common
encoder saves them.

A pass of the mix is one app's launcher icons: the app's design, one of
the mix's `apps` in turn, rendered at each density of `densities`
(name: square size in pixels) in both of its `shapes`: `ic_launcher`, a
rounded square, and `ic_launcher_round`, a circle.  A pass deals them
in the order of a sorted listing of `res/mipmap-<density>/`, each
density's shapes in the mix's order.  An app is a two-stop gradient
fill (its two `colors`) and a flat glyph (a `disc` or a `ring`); every
icon has a soft highlight, a soft drop shadow of partial alpha and
anti-aliased edges, on a transparent margin whose RGB is the fill's
colour carried out to the canvas's edge, as image editors export it.
The seed draws each app's glyph size from `glyph_size` and nothing
else, so that every seed's pool compresses alike and costs alike (the
colours alone move a pool's bits by a few percent, and the order in
which jobs reach compress_many decides which share a fused loop).  The
mix's `icon` sets the drawing (`render` below), its `writer` the PNG
writer's settings (`reference/png_write.py`: minimum-sum filters, zlib
level 6, IDAT chunks of 8,192 bytes, as libpng writes by default).  An
item's `raw` is that PNG at colour type 6, `expect` its pixels ((h, w,
4) uint8) and `nbytes` its pixel bytes, w x h x 4.

Only IEEE arithmetic (+, -, x, /, sqrt) on float64, element by element,
so the pixels are the same on every machine.
"""

from __future__ import annotations

import numpy as np

from portbench.gen import Item, rng_for
from portbench.reference import png_write


def design(app: dict, rng, p: dict) -> dict:
    """An app's design, its glyph's size drawn from `glyph_size`."""
    d = np.asarray(p["direction"], np.float64)
    return {"c0": np.asarray(app["colors"][0], np.float64),
            "c1": np.asarray(app["colors"][1], np.float64),
            "dir": d / np.sqrt((d * d).sum()),
            "light": np.asarray(p["light"], np.float64),
            "glyph": app["glyph"],
            "glyph_size": float(rng.uniform(*p["glyph_size"])),
            "glyph_rgb": np.asarray(p["glyph_rgb"], np.float64)}


def _cover(sd, width: float = 1.0):
    """Coverage of a pixel whose centre lies `sd` pixels outside an edge
    (negative inside): a linear ramp `width` pixels wide."""
    return np.clip(0.5 - sd / width, 0.0, 1.0)


def _box(px, py, cx, cy, half: float, radius: float):
    """Signed distance to a square of half side `half` whose corners are
    rounded by `radius`."""
    qx = np.abs(px - cx) - (half - radius)
    qy = np.abs(py - cy) - (half - radius)
    ox, oy = np.maximum(qx, 0.0), np.maximum(qy, 0.0)
    return (np.sqrt(ox * ox + oy * oy) + np.minimum(np.maximum(qx, qy), 0.0)
            - radius)


def _disc(px, py, cx, cy, r: float):
    dx, dy = px - cx, py - cy
    return np.sqrt(dx * dx + dy * dy) - r


def _glyph(px, py, c: float, s: float, kind: str):
    """Signed distance to the glyph of size `s` (pixels) centred at
    (c, c): a disc of radius `s`, or a ring about as wide."""
    if kind == "disc":
        return _disc(px, py, c, c, s)
    if kind == "ring":
        return np.abs(_disc(px, py, c, c, 0.8 * s)) - 0.22 * s
    raise ValueError(f"unknown glyph {kind!r}")


def render(d: dict, size: int, shape: str, p: dict) -> np.ndarray:
    """(size, size, 4) uint8 straight-alpha RGBA of design `d` as
    `shape` ("ic_launcher" or "ic_launcher_round")."""
    s = float(size)
    coord = np.arange(size, dtype=np.float64) + 0.5
    py, px = np.meshgrid(coord, coord, indexing="ij")
    c = s / 2
    half = s / 2 - p["margin"] * s
    dy = p["shadow_offset"] * s

    def outline(oy: float):
        if shape == "ic_launcher_round":
            return _disc(px, py, c, c + oy, half)
        return _box(px, py, c, c + oy, half, p["corner"] * half)

    body = _cover(outline(0.0))
    # The shadow: the same outline lower down, its edge a ramp of
    # `shadow_blur` x size pixels, at `shadow_alpha` at most.
    shadow = p["shadow_alpha"] * _cover(outline(dy), p["shadow_blur"] * s)

    # Fill: the gradient across the canvas, lightened towards a spot.
    t = np.clip(((px - c) * d["dir"][0] + (py - c) * d["dir"][1]) / s + 0.5,
                0.0, 1.0)
    fill = d["c0"] * (1 - t)[:, :, None] + d["c1"] * t[:, :, None]
    lx, ly = px - d["light"][0] * s, py - d["light"][1] * s
    glow = p["highlight"] * np.clip(
        1 - np.sqrt(lx * lx + ly * ly) / (0.75 * s), 0.0, 1.0)
    fill = fill * (1 - glow)[:, :, None] + 255.0 * glow[:, :, None]
    g = _cover(_glyph(px, py, c, d["glyph_size"] * s, d["glyph"]))
    rgb = fill * (1 - g)[:, :, None] + d["glyph_rgb"] * g[:, :, None]

    # The body over its shadow (black), straight alpha.
    alpha = body + shadow * (1 - body)
    lit = rgb * body[:, :, None]
    out_rgb = np.where(alpha[:, :, None] > 0,
                       lit / np.maximum(alpha, 1e-12)[:, :, None], fill)
    a8 = np.rint(alpha * 255.0)
    rgb8 = np.rint(np.clip(out_rgb, 0.0, 255.0))
    # Where the alpha rounds to 0 the exporter leaves the fill's colour.
    rgb8 = np.where((a8 == 0)[:, :, None], np.rint(fill), rgb8)
    return np.concatenate([rgb8, a8[:, :, None]], axis=2).astype(np.uint8)


def save(pixels: np.ndarray, writer: dict) -> bytes:
    """The pixels as an 8-bit RGBA PNG, by the mix's writer settings."""
    return png_write.write(pixels, 6, 8, level=writer["level"],
                           idat_size=writer["idat_size"])


def items(mix: dict, seed: int) -> list:
    listing = [(f"mipmap-{name}/{shape}", size)
               for name, size in sorted(mix["densities"].items())
               for shape in mix["shapes"]]
    out = []
    for k in range(int(mix["passes"])):
        app = mix["apps"][k % len(mix["apps"])]
        d = design(app, rng_for(seed, 1, k), mix["icon"])
        for path, size in listing:
            pixels = render(d, size, path.split("/")[1], mix["icon"])
            out.append(Item(f"a{k}.{path}", save(pixels, mix["writer"]),
                            size * size * 4, pixels))
    return out
