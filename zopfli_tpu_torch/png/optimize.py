"""ZopfliPNG-equivalent optimizer.

Mirrors the reference pipeline (zopflipng_lib.cc:355-467): decode ->
optional 16->8 bit reduction -> optional lossy-transparent rewrite ->
automatic color-type selection -> filter-strategy search (each strategy
re-encodes the IDAT with the framework's zopfli-class deflate; when
`auto`, a probe of stdlib zlib trials on a host thread pool picks the
strategy first and hands its filtered stream on) -> keepchunks
copy-through -> verify by decoding the result and comparing pixels.
"""

from __future__ import annotations

import os
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from ..deflate import Options
from ..utils.counters import bump
from ..utils.logging import span
from . import codec, filters as filtlib
from .chunks import Chunk
from .codec import EncodeSpec

STRATEGIES = ("zero", "one", "two", "three", "four", "minsum", "entropy",
              "predefined", "bruteforce")

# The automatic strategy's trials, in the order that breaks size ties
# (AutoChooseFilterStrategy, zopflipng_lib.cc:270-305).
PROBE_ORDER = ("zero", "one", "two", "three", "four", "minsum", "entropy",
               "bruteforce")

# Brute force's per-line trials go to the pool in ranges of this many lines.
LINES_PER_JOB = 64

# The probe's work on the host: trial jobs run (`trials`), brute force's
# line-range jobs (`line_jobs`), winners handed on to the IDAT jobs
# without recomputation (`reused`), and the pool's width (`workers`).
PROBE = {"trials": 0, "line_jobs": 0, "reused": 0, "workers": 0}

_pool_lock = threading.Lock()
_POOL: list = []


def _pool() -> ThreadPoolExecutor:
    """The probe's thread pool, made on first use and kept for the
    process: one thread a trial of an image, at most one a core the
    process may run on.  stdlib zlib releases the interpreter lock while
    it deflates, so the trials run side by side."""
    with _pool_lock:
        if not _POOL:
            width = min(len(PROBE_ORDER), len(os.sched_getaffinity(0)))
            _POOL.append(ThreadPoolExecutor(
                width, thread_name_prefix="zt-png-probe"))
            bump(PROBE, "workers", width)
        return _POOL[0]


@dataclass
class PNGOptions:
    """Reference ZopfliPNGOptions (zopflipng_lib.h:92-133)."""
    lossy_transparent: bool = False
    lossy_8bit: bool = False
    keep_colortype: bool = False
    filter_strategies: list = field(default_factory=list)  # [] = auto
    auto_filter_strategy: bool = True
    keepchunks: list = field(default_factory=list)
    use_zopfli: bool = True
    num_iterations: int = 15
    num_iterations_large: int = 5
    # The deflate engine and torch device of the IDAT jobs, as in
    # zopfli_tpu_torch.Options: "device" or "native"; "cuda" or "cpu".
    engine: str = "device"
    device: str = "cuda"


def _pack_scanlines(img: np.ndarray, colortype: int, bitdepth: int,
                    pal_index: np.ndarray | None = None) -> np.ndarray:
    """(h, w, 4) RGBA (or palette indices) -> (h, stride) raw bytes."""
    h, w, _ = img.shape
    if colortype == 3:
        samples = pal_index
        if bitdepth == 8:
            return samples.astype(np.uint8)
        packed = np.zeros((h, codec._stride(w, 3, bitdepth)), np.uint8)
        per_byte = 8 // bitdepth
        for y in range(h):
            bits = np.unpackbits(
                samples[y].astype(np.uint8)[:, None], axis=1,
                count=8)[:, 8 - bitdepth:]
            flat = bits.reshape(-1)
            pad = (-len(flat)) % 8
            flat = np.concatenate([flat, np.zeros(pad, np.uint8)])
            packed[y] = np.packbits(flat)
        return packed
    if colortype == 0:
        g = img[:, :, 0]
        if bitdepth == 8:
            return g.astype(np.uint8)
        factor = {1: 255, 2: 85, 4: 17}[bitdepth]
        samples = (g // factor).astype(np.uint8)
        packed = np.zeros((h, codec._stride(w, 0, bitdepth)), np.uint8)
        for y in range(h):
            bits = np.unpackbits(samples[y][:, None], axis=1,
                                 count=8)[:, 8 - bitdepth:]
            flat = bits.reshape(-1)
            pad = (-len(flat)) % 8
            flat = np.concatenate([flat, np.zeros(pad, np.uint8)])
            packed[y] = np.packbits(flat)
        return packed
    if colortype == 2:
        return img[:, :, :3].reshape(h, -1)
    if colortype == 4:
        return img[:, :, [0, 3]].reshape(h, -1)
    return img.reshape(h, -1)  # 6: RGBA


def choose_color_encoding(img: np.ndarray):
    """lodepng auto_choose_color semantics (lodepng.cpp:3902-):

    Returns (colortype, bitdepth, palette or None, trns bytes or None,
    pal_index or None).  8-bit-per-channel inputs only (16-bit handled
    by the caller).
    """
    h, w, _ = img.shape
    alpha = img[:, :, 3]
    opaque = bool((alpha == 255).all())
    grey = bool((img[:, :, 0] == img[:, :, 1]).all()
                and (img[:, :, 1] == img[:, :, 2]).all())

    # Count distinct colors (RGBA as u32).
    flat = img.reshape(-1, 4).view(np.uint32).reshape(-1)
    colors, first_idx, inv = np.unique(flat, return_index=True,
                                       return_inverse=True)
    ncolors = len(colors)

    # Transparent color key possible? (single fully-transparent color,
    # used instead of an alpha channel when pixels are otherwise opaque)
    # Palette if small enough and pays off vs raw encoding.
    # Grayscale bit depth if representable (None otherwise).
    grey_bd = None
    if grey and opaque:
        g = img[:, :, 0]
        for bd in (1, 2, 4):
            factor = {1: 255, 2: 85, 4: 17}[bd]
            if (g % factor == 0).all() and (g // factor < (1 << bd)).all():
                grey_bd = bd
                break
        else:
            grey_bd = 8

    if ncolors <= 256:
        pal_bd = 8
        for bd in (1, 2, 4):
            if ncolors <= (1 << bd):
                pal_bd = bd
                break
        palette_bytes = ncolors * 3 + (0 if opaque else ncolors) + 8
        raw_channels = (1 if grey else 3) + (0 if opaque else 1)
        # lodepng heuristics: palette only when it actually saves bits,
        # and grayscale wins when its depth is <= the palette's
        # (lodepng.cpp auto_choose_color: gray avoids the PLTE chunk).
        if (palette_bytes < w * h * raw_channels
                and not (grey_bd is not None and grey_bd <= pal_bd)):
            order = np.argsort(first_idx)
            ordered = colors[order]
            lut = np.empty(ncolors, dtype=np.int64)
            lut[order] = np.arange(ncolors)
            pal_rgba = ordered.view(np.uint8).reshape(-1, 4)
            pal_index = lut[inv].reshape(h, w)
            trns = None
            a = pal_rgba[:, 3]
            if not opaque:
                last = int(np.max(np.nonzero(a != 255)[0])) + 1
                trns = a[:last].tobytes()
            return 3, pal_bd, pal_rgba[:, :3].copy(), trns, pal_index

    if grey and opaque:
        g = img[:, :, 0]
        for bd in (1, 2, 4):
            factor = {1: 255, 2: 85, 4: 17}[bd]
            if (g % factor == 0).all() and (g // factor < (1 << bd)).all():
                return 0, bd, None, None, None
        return 0, 8, None, None, None
    if grey:
        return 4, 8, None, None, None
    if opaque:
        return 2, 8, None, None, None
    return 6, 8, None, None, None


def _strategy_ftypes(name, cand, spec, probe_deflate, predefined=None):
    h = cand.shape[1]
    if name == "zero":
        return filtlib.strategy_zero(h)
    if name in ("one", "two", "three", "four"):
        return filtlib.strategy_fixed(
            h, ("one", "two", "three", "four").index(name) + 1)
    if name == "minsum":
        return filtlib.strategy_minsum(cand)
    if name == "entropy":
        return filtlib.strategy_entropy(cand)
    if name == "predefined":
        if predefined is None or len(predefined) != h:
            return filtlib.strategy_zero(h)
        return np.asarray(predefined, dtype=np.int64)
    if name == "bruteforce":
        with span("zt.png.bruteforce"):
            return _bruteforce_lines(cand, 0, h)
    raise ValueError(f"unknown strategy {name}")


def _bruteforce_lines(cand, lo: int, hi: int) -> np.ndarray:
    """Brute force's filter types of lines [lo, hi): per line, the
    smallest quick-deflate size, the lower filter on ties (lodepng
    LFS_BRUTE_FORCE, lodepng.cpp:5444-5509)."""
    ftypes = np.zeros(hi - lo, dtype=np.int64)
    for y in range(lo, hi):
        best = None
        for f in range(5):
            size = len(zlib.compress(bytes([f]) + cand[f, y].tobytes(), 6))
            if best is None or size < best:
                best = size
                ftypes[y - lo] = f
    return ftypes


def _trial(name, cand, ftypes=None):
    """One trial of the probe: (stdlib zlib level 6's size of the
    stream, the filter types, the stream)."""
    if ftypes is None:
        ftypes = _strategy_ftypes(name, cand, None, None)
    raw = filtlib.serialize(cand, ftypes)
    bump(PROBE, "trials")
    return len(zlib.compress(raw, 6)), ftypes, raw


def _probe(cand):
    """The automatic filter strategy: every strategy of PROBE_ORDER as a
    job on the pool, brute force's per-line trials submitted first as
    jobs of LINES_PER_JOB contiguous lines, and its whole-stream trial
    once their results are joined in line order.  The smallest size
    wins and a tie goes to the strategy earlier in PROBE_ORDER, whatever
    order the jobs finish in.  Returns the winner's (name, ftypes,
    stream)."""
    pool, h = _pool(), cand.shape[1]
    lines = [pool.submit(_bruteforce_lines, cand, lo,
                         min(lo + LINES_PER_JOB, h))
             for lo in range(0, h, LINES_PER_JOB)]
    bump(PROBE, "line_jobs", len(lines))
    jobs = {name: pool.submit(_trial, name, cand)
            for name in PROBE_ORDER if name != "bruteforce"}
    jobs["bruteforce"] = pool.submit(
        _trial, "bruteforce", cand,
        np.concatenate([job.result() for job in lines]))
    best = None
    for name in PROBE_ORDER:
        with span("zt.png.trial"):
            size, ftypes, raw = jobs[name].result()
        if best is None or size < best[0]:
            best = (size, name, ftypes, raw)
    return best[1:]


@dataclass
class _Prepared:
    """Host-side per-image state between strategy prep and IDAT deflate."""
    opts: PNGOptions
    rgba: np.ndarray
    spec: EncodeSpec
    strategies: list
    ftypes: list            # aligned with strategies
    raws: list              # serialized filtered streams, aligned
    keep: tuple
    iters: int


def optimize(origpng: bytes, png_options: PNGOptions | None = None,
             verbose: bool = False) -> bytes:
    """ZopfliPNGOptimize (zopflipng_lib.cc:355-467).

    Returns the optimized PNG (caller decides keep-if-smaller).
    """
    return optimize_many([origpng], png_options, verbose)[0]


def optimize_many(pngs: list[bytes], png_options: PNGOptions | None = None,
                  verbose: bool = False) -> list[bytes]:
    """Batched ZopfliPNGOptimize: ALL images' (strategy x IDAT) deflate
    jobs run through compress_many, which batches them into shared
    lane groups of the fused loop on the device engine, one call per
    iteration budget (the reference processes files strictly
    sequentially, zopflipng_bin.cc:291-460)."""
    from .. import compress_many

    opts = png_options or PNGOptions()
    preps = []
    for png in pngs:
        with span("zt.png.prepare"):
            preps.append(_prepare(png, opts, verbose))

    jobs = [raw for p in preps for raw in p.raws]
    if opts.use_zopfli:
        iters_opts = {}
        outs = []
        # Group jobs by iteration budget (images can differ).
        order = list(range(len(jobs)))
        job_iters = [p.iters for p in preps for _ in p.raws]
        outs = [None] * len(jobs)
        for it in sorted(set(job_iters)):
            sel = [i for i in order if job_iters[i] == it]
            with span("zt.png.deflate"):
                res = compress_many(
                    [jobs[i] for i in sel], "zlib",
                    Options(numiterations=it, engine=opts.engine,
                            device=opts.device))
            for i, o in zip(sel, res):
                outs[i] = o
    else:
        with span("zt.png.deflate"):
            outs = [zlib.compress(bytes(raw), 9) for raw in jobs]

    results = []
    k = 0
    for png, p in zip(pngs, preps):
        with span("zt.png.verify"):
            best_png = None
            for name, idat in zip(p.strategies, outs[k:k + len(p.raws)]):
                out = _assemble(p.spec, idat, p.keep)
                if verbose:
                    print(f"strategy {name}: {len(out)} bytes")
                if best_png is None or len(out) < len(best_png):
                    best_png = out
            k += len(p.raws)
            # Verify by decode + pixel compare (zopflipng_bin.cc:324-357).
            check, _ = codec.decode(best_png)
            if not _pixels_equal(p.rgba, check, opts.lossy_transparent):
                raise AssertionError(
                    "verification failed: output pixels differ")
        results.append(best_png)
    return results


def _assemble(spec: EncodeSpec, idat: bytes, keep) -> bytes:
    from . import chunks as chunklib
    ihdr = (spec.width.to_bytes(4, "big") + spec.height.to_bytes(4, "big") +
            bytes([spec.bitdepth, spec.colortype, 0, 0, 0]))
    out = [Chunk("IHDR", ihdr)]
    before_plte, before_idat, after_idat = keep
    out += before_plte
    if spec.palette is not None:
        out.append(Chunk("PLTE", spec.palette.astype(np.uint8).tobytes()))
    if spec.trns:
        out.append(Chunk("tRNS", spec.trns))
    out += before_idat
    out.append(Chunk("IDAT", idat))
    out += after_idat
    out.append(Chunk("IEND", b""))
    return chunklib.assemble(out)


def _prepare(origpng: bytes, opts: PNGOptions,
             verbose: bool = False) -> _Prepared:
    """Decode + color choice + filter search up to the IDAT deflates."""
    rgba, info = codec.decode(origpng)
    h, w = rgba.shape[:2]

    if opts.lossy_transparent:
        rgba = lossy_optimize_transparent(rgba)

    # Color encoding choice (16-bit preserved unless lossy_8bit or the
    # image is losslessly reducible to 8 bit).
    raw16 = getattr(info, "raw16", None)
    use16 = False
    if raw16 is not None and not opts.lossy_8bit:
        lo = raw16 & 0xFF
        hi = raw16 >> 8
        use16 = not bool((lo == hi).all())
    raw_scan = getattr(info, "raw_scanlines", None)
    if (opts.keep_colortype and raw_scan is not None
            and not opts.lossy_transparent and not use16):
        # --keepcolortype: re-encode with the original header fields and
        # untouched raw scanlines (zopflipng_bin.cc:249-250 semantics).
        spec = EncodeSpec(np.ascontiguousarray(raw_scan), w, h,
                          info.bitdepth, info.colortype, info.palette,
                          info.trns)
        pal_index = None
    elif use16:
        ct, bd = info.colortype, 16
        samples = raw16
        stride = codec._stride(w, ct, 16)
        ch = codec.CHANNELS[ct]
        keep = {0: [0], 2: [0, 1, 2], 4: [0, 3], 6: [0, 1, 2, 3]}[ct]
        if ct == 0:
            sel = raw16[:, :, :1]
        elif ct == 2:
            sel = raw16[:, :, :3]
        else:
            sel = raw16
        spec_img = sel.astype(">u2").reshape(h, -1).view(np.uint8)
        # tRNS is a 16-bit color key for color types 0/2 and must ride
        # along or transparency is lost (the reference lodepng keeps it).
        trns16 = info.trns if ct in (0, 2) else None
        spec = EncodeSpec(np.ascontiguousarray(spec_img), w, h, 16, ct,
                          trns=trns16)
        pal_index = None
    else:
        ct, bd, palette, trns, pal_index = choose_color_encoding(rgba)
        scan = _pack_scanlines(rgba, ct, bd, pal_index)
        spec = EncodeSpec(np.ascontiguousarray(scan), w, h, bd, ct,
                          palette, trns)

    cand = filtlib.filter_all_types(
        spec.scanlines, codec._bpp_bytes(spec.colortype, spec.bitdepth))

    # Iteration budget by IDAT size (zopflipng_lib.cc:57-58; the
    # reference threshold is decimal 200000, not 200 KiB).
    raw_size = spec.scanlines.size + h
    iters = (opts.num_iterations if raw_size < 200000
             else opts.num_iterations_large)

    strategies = opts.filter_strategies or None
    ftypes_list, raws = [], []
    if strategies is None:
        if opts.auto_filter_strategy:
            # Fast pre-pass with stock zlib as the probe deflater; its
            # winner's filter types and stream are the IDAT job's.
            with span("zt.png.probe"):
                best_name, ftypes, raw = _probe(cand)
            strategies = [best_name]
            ftypes_list, raws = [ftypes], [raw]
            bump(PROBE, "reused")
        else:
            strategies = list(STRATEGIES)

    if not raws:  # the probe hands its winner on already serialized
        with span("zt.png.strategies"):
            predefined = (_predefined(info, w, h)
                          if "predefined" in strategies else None)
            for name in strategies:
                ftypes = _strategy_ftypes(name, cand, spec, None,
                                          predefined=predefined)
                ftypes_list.append(ftypes)
                raws.append(filtlib.serialize(cand,
                                              np.asarray(ftypes, np.int64)))

    keep = _keepchunks(info.chunks, opts.keepchunks)

    return _Prepared(opts=opts, rgba=rgba, spec=spec,
                     strategies=list(strategies), ftypes=ftypes_list,
                     raws=raws, keep=keep, iters=iters)


def _predefined(info, w: int, h: int):
    """The input's own filter type a line (non-interlaced input of the
    same geometry), else None."""
    try:
        idat = b"".join(c.data for c in info.chunks if c.type == "IDAT")
        raw0 = np.frombuffer(zlib.decompress(idat), np.uint8)
        if info.interlace == 0:
            st0 = codec._stride(w, info.colortype, info.bitdepth)
            return raw0.reshape(h, 1 + st0)[:, 0].astype(np.int64)
    except Exception:
        pass
    return None


def _pixels_equal(a: np.ndarray, b: np.ndarray, alpha_aware: bool) -> bool:
    if a.shape != b.shape:
        return False
    if not alpha_aware:
        return bool(np.array_equal(a, b))
    both_clear = (a[:, :, 3] == 0) & (b[:, :, 3] == 0)
    rgb_same = (a[:, :, :3] == b[:, :, :3]).all(axis=2)
    return bool(np.logical_or(both_clear, rgb_same & (
        a[:, :, 3] == b[:, :, 3])).all())


def lossy_optimize_transparent(rgba: np.ndarray) -> np.ndarray:
    """Rewrite RGB of fully transparent pixels for better compression
    (LossyOptimizeTransparent, zopflipng_lib.cc:86-156), all 3 modes:

    - key/palette mode (no partial alpha, or <=256 distinct colors with
      transparency counted as one): every transparent pixel gets the RGB
      of the FIRST transparent pixel, preserving a valid color key /
      palette entry.
    - otherwise: each transparent pixel copies the most recent opaque
      pixel's RGB (0,0,0 before the first opaque one) so PNG filters
      see runs of zeros.

    The reference's final palette-shrink step (zopflipng_lib.cc:137-155)
    mutates lodepng's input state; here the palette is rebuilt from the
    rewritten pixels by choose_color_encoding, which subsumes it.
    """
    out = rgba.copy()
    flat = out.reshape(-1, 4)
    clear = flat[:, 3] == 0
    if not clear.any():
        return out

    # key: alpha is pure 0/255 everywhere (zopflipng_lib.cc:90-96).
    key = not bool(((flat[:, 3] > 0) & (flat[:, 3] < 255)).any())
    # palette: <=256 distinct colors, transparent-as-one (cc:97-102).
    color_id = (flat[:, 0].astype(np.uint32)
                | (flat[:, 1].astype(np.uint32) << 8)
                | (flat[:, 2].astype(np.uint32) << 16)
                | (flat[:, 3].astype(np.uint32) << 24))
    palette = len(np.unique(np.where(clear, 0, color_id))) <= 256

    if key or palette:
        first_clear = int(np.nonzero(clear)[0][0])
        flat[clear, :3] = flat[first_clear, :3]
    else:
        # Last-opaque propagation; positions before the first opaque
        # pixel keep the 0,0,0 initial value (cc:103,119-131).
        idx = np.arange(len(flat))
        keep = np.where(~clear, idx + 1, 0)   # 0 = "no opaque yet"
        np.maximum.accumulate(keep, out=keep)
        src = np.maximum(keep - 1, 0)
        vals = np.where((keep == 0)[:, None], 0, flat[src, :3])
        flat[clear, :3] = vals[clear]
    return out


def _keepchunks(all_chunks, names):
    before_plte, before_idat, after = [], [], []
    if not names:
        return before_plte, before_idat, after
    seen_plte = False
    seen_idat = False
    for c in all_chunks:
        if c.type == "PLTE":
            seen_plte = True
        elif c.type == "IDAT":
            seen_idat = True
        elif c.type in names:
            if seen_idat:
                after.append(Chunk(c.type, c.data))
            elif seen_plte:
                before_idat.append(Chunk(c.type, c.data))
            else:
                before_plte.append(Chunk(c.type, c.data))
    return before_plte, before_idat, after
