"""The port's ZopfliPNG optimizer (zopfli_tpu_torch.png) against the JAX
package's (zopfli_tpu.png) on the same inputs, made from a seed.

Chunks, decode, filters, color choice and packing must be equal; the
optimized PNGs byte-identical: with the native engine on both sides for
every option tests/test_png.py covers, and with the port's device engine
on the CPU against the reference's TPU engine (one device, as
tests/test_torch_devseed_many.py runs it)."""

import importlib
import io
import os
import sys
import threading
import time
import zlib

import numpy as np
import pytest
import torch

from zopfli_tpu.png import chunks as ref_chunks
from zopfli_tpu.png import codec as ref_codec
from zopfli_tpu.png import filters as ref_filters
from zopfli_tpu_torch import native
from zopfli_tpu_torch.png import chunks, codec, filters

# The packages export optimize() under their submodule's name.
opt = importlib.import_module("zopfli_tpu_torch.png.optimize")
ref_opt = importlib.import_module("zopfli_tpu.png.optimize")

PIL = pytest.importorskip("PIL.Image")

# The tensors here are tiny: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)


def _pil_png(arr, mode, **save):
    buf = io.BytesIO()
    img = PIL.fromarray(arr, mode)
    if mode == "RGB" and save.pop("quantize", None):
        img = img.quantize(colors=4)
    pnginfo = save.pop("text", None)
    if pnginfo is not None:
        from PIL import PngImagePlugin
        meta = PngImagePlugin.PngInfo()
        meta.add_text("Comment", pnginfo)
        save["pnginfo"] = meta
    img.save(buf, format="PNG", **save)
    return buf.getvalue()


def _raw_png(lines: bytes, w, h, bitdepth, colortype, interlace=0,
             extra=()):
    ihdr = (w.to_bytes(4, "big") + h.to_bytes(4, "big")
            + bytes([bitdepth, colortype, 0, 0, interlace]))
    return chunks.assemble([chunks.Chunk("IHDR", ihdr), *extra,
                            chunks.Chunk("IDAT", zlib.compress(lines, 6)),
                            chunks.Chunk("IEND", b"")])


def _adam7_lines(arr, pack):
    raw = bytearray()
    for (x0, y0, dx, dy) in codec._ADAM7:
        sub = arr[y0::dy, x0::dx]
        if sub.shape[0] == 0 or sub.shape[1] == 0:
            continue
        for y in range(sub.shape[0]):
            raw.append(0)
            raw.extend(pack(sub[y]))
    return bytes(raw)


def _pack_bits(bitdepth):
    def pack(row):
        bits = np.unpackbits(row[:, None] << (8 - bitdepth),
                             axis=1)[:, :bitdepth]
        return np.packbits(bits.reshape(-1)).tobytes()
    return pack


def _images() -> dict:
    """The kinds of input of tests/test_png.py, seeded."""
    rng = np.random.default_rng(20260817)
    out = {}
    rgb = rng.integers(0, 255, (40, 60, 3), dtype=np.uint8)
    rgb[10:30, 10:50] = [200, 10, 10]
    out["rgb"] = _pil_png(rgb, "RGB")
    rgba = rng.integers(0, 255, (32, 32, 4), dtype=np.uint8)
    rgba[:8, :, 3] = 0
    rgba[8:, :, 3] = 255
    out["rgba"] = _pil_png(rgba, "RGBA")
    partial = rng.integers(0, 255, (24, 20, 4), dtype=np.uint8)
    partial[:6, :, 3] = 0
    partial[6:12, :, 3] = 128
    partial[12:, :, 3] = 255
    out["rgba_partial"] = _pil_png(partial, "RGBA")
    out["gray"] = _pil_png(np.tile(np.arange(64, dtype=np.uint8) * 4,
                                   (32, 1)), "L")
    idx = rng.integers(0, 7, (48, 48), dtype=np.uint8) * 30
    buf = io.BytesIO()
    PIL.fromarray(idx, "L").convert("P").save(buf, format="PNG")
    out["palette"] = buf.getvalue()
    bw = np.zeros((40, 40), np.uint8)
    bw[::2] = 255
    out["bit1"] = _pil_png(bw, "L")
    pal4 = np.array([[0, 0, 0], [255, 0, 0], [0, 255, 0], [40, 40, 255]],
                    np.uint8)
    out["pal4_2bit"] = _pil_png(pal4[rng.integers(0, 4, (21, 19))], "RGB",
                                quantize=True, bits=2)
    out["interlaced_rgb"] = _raw_png(
        _adam7_lines(rng.integers(0, 256, (19, 23, 3)).astype(np.uint8),
                     lambda r: r.tobytes()), 23, 19, 8, 2, interlace=1)
    for bd in (1, 2, 4):
        g = rng.integers(0, 1 << bd, (13, 21), dtype=np.uint8)
        out[f"interlaced_gray{bd}"] = _raw_png(
            _adam7_lines(g, _pack_bits(bd)), 21, 13, bd, 0, interlace=1)
    g16 = (np.arange(12 * 16, dtype=np.int64).reshape(12, 16) * 4099
           % 65536).astype(np.uint16)
    key = int(g16[3, 5])
    g16[g16 == key] = key ^ 1
    g16[3, 5] = g16[7, 2] = key
    lines = b"".join(b"\x00" + r.astype(">u2").tobytes() for r in g16)
    out["gray16_trns"] = _raw_png(lines, 16, 12, 16, 0, extra=(
        chunks.Chunk("tRNS", key.to_bytes(2, "big")),))
    rgb16 = rng.integers(0, 65536, (9, 11, 3)).astype(np.uint16)
    rgb16[::2] = (rgb16[::2] >> 8) * 257        # reducible rows
    out["rgb16"] = _raw_png(b"".join(
        b"\x00" + r.astype(">u2").tobytes() for r in rgb16), 11, 9, 16, 2)
    out["text"] = _pil_png(np.zeros((8, 8, 3), np.uint8), "RGB",
                           text="hello metadata")
    stripes = np.zeros((24, 24, 3), np.uint8)
    stripes[::2] = [200, 30, 30]
    out["stripes"] = _pil_png(stripes, "RGB")
    return out


IMAGES = _images()
KINDS = sorted(IMAGES)


@pytest.mark.parametrize("kind", KINDS)
def test_chunks_identical(kind):
    png = IMAGES[kind]
    ours, ref = chunks.parse(png), ref_chunks.parse(png)
    assert [(c.type, c.data) for c in ours] == [(c.type, c.data)
                                                for c in ref]
    assert chunks.assemble(ours) == ref_chunks.assemble(ref) == png
    with pytest.raises(ValueError):
        chunks.parse(png[:-12])      # no IEND
    with pytest.raises(ValueError):
        chunks.parse(b"GIF89a" + png[6:])


@pytest.mark.parametrize("kind", KINDS)
def test_decode_equal(kind):
    png = IMAGES[kind]
    rgba, info = codec.decode(png)
    ref_rgba, ref_info = ref_codec.decode(png)
    assert np.array_equal(rgba, ref_rgba)
    if info.bitdepth <= 8:
        assert np.array_equal(rgba, np.asarray(PIL.open(io.BytesIO(png))
                                               .convert("RGBA")))
    for f in ("width", "height", "bitdepth", "colortype", "interlace",
              "trns"):
        assert getattr(info, f) == getattr(ref_info, f), f
    for f in ("palette", "raw16", "raw_scanlines"):
        a, b = getattr(info, f, None), getattr(ref_info, f, None)
        assert (a is None) == (b is None), f
        if a is not None:
            assert np.array_equal(a, b), f


@pytest.mark.parametrize("bpp,stride", [(1, 17), (3, 33), (4, 64), (8, 40)])
def test_filters_equal(bpp, stride, monkeypatch):
    rng = np.random.default_rng(bpp * 100 + stride)
    h = 23
    img = rng.integers(0, 256, (h, stride), dtype=np.uint8)
    img[5:9] = img[4]                                  # runs for Up/Paeth
    cand = filters.filter_all_types(img, bpp)
    assert np.array_equal(cand, ref_filters.filter_all_types(img, bpp))
    minsum = filters.strategy_minsum(cand)
    entropy = filters.strategy_entropy(cand)
    assert np.array_equal(minsum, ref_filters.strategy_minsum(cand))
    assert np.array_equal(entropy, ref_filters.strategy_entropy(cand))
    for ftypes in (rng.integers(0, 5, h), minsum, entropy):
        raw = filters.serialize(cand, np.asarray(ftypes, np.int64))
        assert raw == ref_filters.serialize(cand, np.asarray(ftypes,
                                                             np.int64))
        arr = np.frombuffer(raw, np.uint8)
        got = filters.unfilter(arr, h, stride, bpp)
        assert np.array_equal(got, img)
        assert np.array_equal(got, ref_filters.unfilter(arr, h, stride, bpp))

    def no_native(*a, **k):
        raise OSError("no compiler")
    monkeypatch.setattr(native, "png_unfilter", no_native)
    raw = filters.serialize(cand, rng.integers(0, 5, h))
    assert np.array_equal(
        filters.unfilter(np.frombuffer(raw, np.uint8), h, stride, bpp), img)


@pytest.mark.parametrize("kind", ["rgb", "rgba", "rgba_partial", "gray",
                                  "palette", "bit1", "pal4_2bit",
                                  "stripes"])
def test_color_choice_and_packing_equal(kind):
    rgba, _ = codec.decode(IMAGES[kind])
    got = opt.choose_color_encoding(rgba)
    want = ref_opt.choose_color_encoding(rgba)
    assert got[:2] == want[:2] and got[3] == want[3]
    for a, b in ((got[2], want[2]), (got[4], want[4])):
        assert (a is None and b is None) or np.array_equal(a, b)
    ct, bd, _, _, pal_index = got
    assert np.array_equal(opt._pack_scanlines(rgba, ct, bd, pal_index),
                          ref_opt._pack_scanlines(rgba, ct, bd, pal_index))


def test_lossy_transparent_equal():
    rng = np.random.default_rng(5)
    key = np.zeros((6, 7, 4), np.uint8)
    key[:, :, 3] = 255
    key[0, 1] = [10, 20, 30, 0]
    key[2, 2] = [90, 91, 92, 0]
    many = rng.integers(0, 256, (32, 32, 4)).astype(np.uint8)
    many[:, :, 3] = 255
    many[0, 0] = [7, 8, 9, 128]
    many[0, 1] = [1, 2, 3, 0]
    many[5, 5] = [99, 98, 97, 0]
    lead = many.copy()
    lead[0, 0] = [50, 60, 70, 0]
    lead[16, 16, 3] = 128
    for rgba in (key, many, lead, codec.decode(IMAGES["rgba"])[0]):
        assert np.array_equal(opt.lossy_optimize_transparent(rgba),
                              ref_opt.lossy_optimize_transparent(rgba))


# (image, options) for every option tests/test_png.py covers; the
# native engine on both sides.
NATIVE_CASES = {
    "default": ("rgb", {}),
    "interlaced_subbyte": ("interlaced_gray2", {}),
    "gray16_trns": ("gray16_trns", {}),
    "palette": ("palette", {}),
    "lossy_transparent": ("rgba", {"lossy_transparent": True}),
    "lossy_transparent_partial": ("rgba_partial",
                                  {"lossy_transparent": True}),
    "lossy_8bit": ("rgb16", {"lossy_8bit": True}),
    "keep_colortype": ("stripes", {"keep_colortype": True}),
    "keepchunks": ("text", {"keepchunks": ["tEXt"]}),
    "predefined": ("rgb", {"filter_strategies": ["predefined"],
                           "auto_filter_strategy": False}),
    "bruteforce_entropy": ("pal4_2bit", {
        "filter_strategies": ["bruteforce", "entropy", "one"],
        "auto_filter_strategy": False}),
    "all_strategies": ("bit1", {"auto_filter_strategy": False}),
    "quick": ("rgba_partial", {"use_zopfli": False}),
}


@pytest.mark.parametrize("case", sorted(NATIVE_CASES))
def test_optimize_native_identical(case):
    kind, kw = NATIVE_CASES[case]
    png = IMAGES[kind]
    ours = opt.optimize(png, opt.PNGOptions(
        num_iterations=2, num_iterations_large=2, engine="native", **kw))
    ref = ref_opt.optimize(png, ref_opt.PNGOptions(
        num_iterations=2, num_iterations_large=2, engine="native", **kw))
    assert ours == ref
    if not kw.get("lossy_transparent"):
        assert np.array_equal(codec.decode(ours)[0], codec.decode(png)[0])


def test_optimize_many_device_cpu_identical_to_tpu(monkeypatch):
    for var in ("ZT_SEED", "ZT_DEVICE_SPLIT", "ZT_MEGA", "ZT_MASTER_SIZE"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(importlib.import_module("zopfli_tpu.deflate"),
                        "_LOCAL_MESH", [None])
    pngs = [IMAGES["rgba"], IMAGES["stripes"], IMAGES["interlaced_gray4"]]
    ref = ref_opt.optimize_many(pngs, ref_opt.PNGOptions(
        num_iterations=2, num_iterations_large=2, engine="tpu"))

    def boom(*a, **k):
        raise AssertionError("native.greedy called on the device path")
    monkeypatch.setattr(native, "greedy", boom)
    ours = opt.optimize_many(pngs, opt.PNGOptions(
        num_iterations=2, num_iterations_large=2, device="cpu"))
    assert ours == ref
    for png, out in zip(pngs, ours):
        assert np.array_equal(codec.decode(out)[0], codec.decode(png)[0])


def _photos(shapes):
    """Photo-like PNGs from the benchmark's PNG kind, at the benchmark's
    generator settings and writer, at small (h, w)."""
    from portbench.manifest import Manifest
    man = Manifest()
    kind, mix = man.module("inputs", "png"), man.traffic("photos")
    return [kind.save(kind.photo(np.random.default_rng([k, h, w]), h, w,
                                 mix["photo"]), mix["writer"])
            for k, (h, w) in enumerate(shapes)]


@pytest.mark.parametrize("engine,shapes", [
    ("native", [(48, 64)]), ("native", [(64, 48)]),
    ("native", [(48, 64), (64, 48), (48, 64)]),
    ("device", [(48, 64), (64, 48)])])
def test_optimize_many_photos_identical(engine, shapes, monkeypatch):
    """The benchmark cell's kind of input, landscape and portrait, alone
    and in one batch: the bytes of both packages' optimize_many at the
    defaults but for the iterations; the native engine on both sides,
    or the port's device engine on the CPU against the TPU engine."""
    pngs = _photos(shapes)
    kw = dict(num_iterations=2, num_iterations_large=2)
    if engine == "native":
        ours = opt.optimize_many(pngs, opt.PNGOptions(engine="native", **kw))
        ref = ref_opt.optimize_many(pngs, ref_opt.PNGOptions(
            engine="native", **kw))
    else:
        for var in ("ZT_SEED", "ZT_DEVICE_SPLIT", "ZT_MEGA",
                    "ZT_MASTER_SIZE"):
            monkeypatch.delenv(var, raising=False)
        monkeypatch.setattr(importlib.import_module("zopfli_tpu.deflate"),
                            "_LOCAL_MESH", [None])
        ref = ref_opt.optimize_many(pngs, ref_opt.PNGOptions(
            engine="tpu", **kw))
        ours = opt.optimize_many(pngs, opt.PNGOptions(device="cpu", **kw))
    assert ours == ref
    for png, out in zip(pngs, ours):
        assert np.array_equal(codec.decode(out)[0], codec.decode(png)[0])


def _bruteforce_one_loop(cand):
    """Brute force's filter types in one loop over every line: the
    smallest zlib level 6 size of the filter byte and the line, the
    lower filter on ties."""
    h = cand.shape[1]
    ftypes = np.zeros(h, dtype=np.int64)
    for y in range(h):
        best = None
        for f in range(5):
            size = len(zlib.compress(bytes([f]) + cand[f, y].tobytes(), 6))
            if best is None or size < best:
                best = size
                ftypes[y] = f
    return ftypes


def _serial_probe(cand):
    """The automatic strategy as one loop over the probe order: each
    strategy's filter types, stream and zlib level 6 size in turn, the
    earliest of equal sizes kept.  Returns (name, ftypes, stream,
    sizes)."""
    fixed = ("zero", "one", "two", "three", "four")
    best, sizes = None, {}
    for name in opt.PROBE_ORDER:
        if name == "minsum":
            ftypes = filters.strategy_minsum(cand)
        elif name == "entropy":
            ftypes = filters.strategy_entropy(cand)
        elif name == "bruteforce":
            ftypes = _bruteforce_one_loop(cand)
        else:
            ftypes = np.full(cand.shape[1], fixed.index(name), np.int64)
        raw = filters.serialize(cand, ftypes)
        sizes[name] = len(zlib.compress(raw, 6))
        if best is None or sizes[name] < best[0]:
            best = (sizes[name], name, ftypes, raw)
    return (*best[1:], sizes)


def _candidates(png):
    """The five filtered versions of an 8-bit image's lines, as
    `_prepare` makes them."""
    rgba, _ = codec.decode(png)
    ct, bd, _, _, pal_index = opt.choose_color_encoding(rgba)
    scan = opt._pack_scanlines(rgba, ct, bd, pal_index)
    return filters.filter_all_types(np.ascontiguousarray(scan),
                                    codec._bpp_bytes(ct, bd))


def _tie_png():
    """One grey line of a ramp: Sub and Paeth filter it alike (Paeth
    reads the left byte where there is no line above), so `one` and
    `four` deflate to the same size, and that size is the least."""
    ramp = np.arange(64, dtype=np.uint8) * 3
    return _raw_png(b"\x00" + ramp.tobytes(), 64, 1, 8, 0)


@pytest.mark.parametrize("case", ["photo_72x40", "photo_40x72", "tie"])
def test_probe_picks_what_the_serial_probe_picks(case, monkeypatch):
    """`_prepare`'s automatic strategy, its trials on the pool finishing
    in about the reverse of the probe order, hands on the strategy,
    filter types and stream that the one-loop probe picks: on photos
    from the benchmark's PNG kind, and on an image where two strategies
    tie, which the earlier one wins."""
    png = (_tie_png() if case == "tie"
           else _photos([tuple(map(int, case[6:].split("x")))])[0])
    cand = _candidates(png)
    name, ftypes, raw, sizes = _serial_probe(cand)
    if case == "tie":
        least = [n for n in opt.PROBE_ORDER if sizes[n] == min(sizes.values())]
        assert least[:2] == ["one", "four"] and name == "one"

    trial = opt._trial

    def late_if_early(name, *a):
        time.sleep(0.004 * (len(opt.PROBE_ORDER)
                            - opt.PROBE_ORDER.index(name)))
        return trial(name, *a)
    monkeypatch.setattr(opt, "_trial", late_if_early)
    before = dict(opt.PROBE)
    p = opt._prepare(png, opt.PNGOptions(engine="native"))
    assert p.strategies == [name]
    assert len(p.ftypes) == len(p.raws) == 1
    assert np.array_equal(p.ftypes[0], ftypes)
    assert p.raws[0] == raw
    h = cand.shape[1]
    assert {k: opt.PROBE[k] - before[k] for k in before if k != "workers"} \
        == {"trials": 8, "reused": 1, "line_jobs": -(-h // opt.LINES_PER_JOB)}
    assert opt.PROBE["workers"] == min(8, len(os.sched_getaffinity(0)))


@pytest.mark.parametrize("bpp", [1, 3, 4])
@pytest.mark.parametrize("lines", ["one", "range_less_one", "range_plus_one"])
def test_bruteforce_line_split_equals_one_loop(bpp, lines, monkeypatch):
    """Brute force's line ranges on the pool, joined in line order for
    its whole-stream trial, give the one-loop filter types on heights
    that are not a multiple of the range."""
    h = {"one": 1, "range_less_one": opt.LINES_PER_JOB - 1,
         "range_plus_one": opt.LINES_PER_JOB + 1}[lines]
    rng = np.random.default_rng([bpp, h])
    # Smooth rows with noise, so that different filters win lines.
    img = np.cumsum(rng.integers(-3, 4, (h, bpp * 13)), axis=1)
    img = (img + rng.integers(0, 2, (h, 1)) * np.arange(h)[:, None]
           ).astype(np.uint8)
    cand = filters.filter_all_types(img, bpp)
    trial, joined = opt._trial, []

    def keep_bruteforce(name, cand, ftypes=None):
        if name == "bruteforce":
            joined.append(ftypes)
        return trial(name, cand, ftypes)
    monkeypatch.setattr(opt, "_trial", keep_bruteforce)
    before = opt.PROBE["line_jobs"]
    opt._probe(cand)
    assert opt.PROBE["line_jobs"] - before == -(-h // opt.LINES_PER_JOB)
    assert len(joined) == 1
    assert np.array_equal(joined[0], _bruteforce_one_loop(cand))


def test_probes_from_many_threads_count_every_trial():
    """Twice as many threads as cores run `_prepare` at once on small
    photos through the one pool, the interpreter switching threads
    often: each hands on the bytes one thread alone gets, and the
    probe's counters lose no bump."""
    pngs = _photos([(12, 20), (20, 12)])
    opts = opt.PNGOptions(engine="native")
    want = [opt._prepare(png, opts).raws for png in pngs]
    n = 2 * len(os.sched_getaffinity(0))
    got = [None] * n

    def run(i):
        got[i] = opt._prepare(pngs[i % 2], opts).raws

    before = dict(opt.PROBE)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert got == [want[i % 2] for i in range(n)]
    assert opt.PROBE["trials"] - before["trials"] == 8 * n
    assert opt.PROBE["reused"] - before["reused"] == n


def test_default_options_run_on_cuda_and_never_fall_back():
    o = opt.PNGOptions()
    assert (o.engine, o.device) == ("device", "cuda")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        opt.optimize(IMAGES["stripes"])
