"""The PNG cell's parts on the CPU: the photo kind's pools, frozen; the
plain decoder against the plain writer on every color type and bit
depth, against lines filtered here byte by byte, and against faults;
the check accepting the port's output and refusing each control; and
the reference importing nothing of the program."""

import functools
import hashlib
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
from helpers import make_manifest, no_card

from portbench import calls, gen, run
from portbench.gen import Item
from portbench.manifest import Manifest
from portbench.reference import control, png_read, png_write

MAN = Manifest()
KIND = MAN.module("inputs", "png")
FMT = MAN.module("reference/formats", "png")
MIX = MAN.traffic("photos")

# seed: sha-256 over each item's key, raw, nbytes, and expect's shape
# and bytes, in call order.  Two calls of four images, one a pass.
FROZEN = (2, 1, [
    "3fd584b6b5c9ac8390cd84a29c2166dfed53db7a179471f1669a656b2e407e8b",
    "65a475bb8789f726aab4a69e0a3033980a28cf1cc9082c96cf20391f7ed22e77",
    "59c8b24726afcb85fe8c3f4071dc031a50a3a28568668e42686ebc11b650cd6b",
    "a49ab9506decfb394e71594b77e579776376319135b462bb88e0b451ed5c6b0d",
])


def pool_digest(pool) -> str:
    h = hashlib.sha256()
    for item in pool.items():
        for part in (item.key.encode(), item.raw, str(item.nbytes).encode(),
                     str(item.expect.shape).encode(), item.expect.tobytes()):
            h.update(len(part).to_bytes(8, "little"))
            h.update(part)
    return h.hexdigest()


@functools.lru_cache(maxsize=None)
def pool(seed):
    return gen.make_pool(MIX, seed, MAN)


@pytest.mark.parametrize("seed", range(4))
def test_pool_is_frozen(seed):
    p = pool(seed)
    ncalls, cycle, digests = FROZEN
    assert (len(p.calls), p.cycle) == (ncalls, cycle)
    assert pool_digest(p) == digests[seed]


def test_each_pass_deals_the_suites_sizes_and_the_yardstick_band():
    """Three landscape and one portrait image a pass, every image of its
    own, each `raw` an 8-bit RGB PNG of its pixels; the yardstick reads
    3.5-5 bits a pixel byte over the pool (the band under `assumed`)."""
    p = pool(0)
    for call in p.calls:
        assert sorted(i.expect.shape for i in call) == [
            (512, 768, 3)] * 3 + [(768, 512, 3)]
    items = p.items()
    assert len({i.expect.tobytes() for i in items}) == len(items)
    for i in items:
        assert i.nbytes == i.expect.size == 1_179_648
        rgba = png_read.decode(i.raw)
        assert np.array_equal(rgba[:, :, :3] >> 8, i.expect)
        assert i.raw[24:26] == bytes([8, 2])            # depth, color type
    bits = 8 * sum(FMT.zlib9_size(i) for i in items) / sum(
        i.nbytes for i in items)
    assert 3.5 <= bits <= 5.0


def _expected(samples, ct, depth, palette=None, trns=None):
    """RGBA at 16 bits from first principles, one sample at a time."""
    h, w, _ = samples.shape
    scale = 65535 // (2 ** depth - 1)
    out = np.zeros((h, w, 4), np.uint16)
    for y in range(h):
        for x in range(w):
            s = [int(v) for v in samples[y, x]]
            if ct == 3:
                r, g, b = palette[s[0]]
                a = trns[s[0]] if trns and s[0] < len(trns) else 255
                out[y, x] = [r * 257, g * 257, b * 257, a * 257]
                continue
            color = s[:3] if ct in (2, 6) else s[:1] * 3
            alpha = s[-1] * scale if ct in (4, 6) else 65535
            if trns is not None and ct in (0, 2):
                key = list(struct.unpack(f">{len(trns) // 2}H", trns))
                alpha = 0 if s == key else 65535
            out[y, x] = [c * scale for c in color] + [alpha]
    return out


CASES = [(0, d) for d in (1, 2, 4, 8, 16)] + [(2, 8), (2, 16)] + [
    (3, d) for d in (1, 2, 4, 8)] + [(4, 8), (4, 16), (6, 8), (6, 16)]
# tRNS only where the color type has no alpha channel.
CASES = [(ct, d, t) for ct, d in CASES for t in (False, True)
         if not (t and ct in (4, 6))]


@pytest.mark.parametrize("ct,depth,trns", CASES)
def test_decoder_reads_the_writer_on_every_color_type_and_depth(ct, depth,
                                                                trns):
    rng = np.random.default_rng([ct, depth])
    h, w = 7, 13
    ch = png_write.CHANNELS[ct]
    top = 2 ** depth
    samples = rng.integers(0, top, (h, w, ch)).astype(
        np.uint16 if depth == 16 else np.uint8)
    palette, key = None, None
    if ct == 3:
        n = min(top, 6)
        samples %= n
        palette = rng.integers(0, 256, (n, 3)).astype(np.uint8)
        key = bytes(rng.integers(0, 256, n - 1).astype(np.uint8)) \
            if trns else None
    elif trns:
        key = struct.pack(f">{ch}H", *(int(v) for v in samples[3, 5]))
    for filters in (None, 0, 1, 2, 3, 4):
        png = png_write.write(samples, ct, depth, filters=filters,
                              palette=palette, trns=key, idat_size=37)
        want = _expected(samples, ct, depth,
                         palette.tolist() if palette is not None else None,
                         list(key) if ct == 3 and key else key)
        assert np.array_equal(png_read.decode(png), want), filters


def _filter_line(line, prev, bpp, f):
    """RFC 2083 section 6, byte by byte."""
    out = []
    for i, x in enumerate(line):
        a = line[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        paeth = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out.append((x - (0, a, b, (a + b) // 2, paeth)[f]) % 256)
    return out


def _stdlib_png(lines, ftypes, w, h, depth, ct):
    """IHDR, one IDAT of stdlib zlib over lines filtered here, IEND."""
    bpp = max(1, png_write.CHANNELS[ct] * depth // 8)
    raw, prev = bytearray(), [0] * len(lines[0])
    for line, f in zip(lines, ftypes):
        raw.append(f)
        line = [int(v) for v in line]
        raw.extend(_filter_line(line, prev, bpp, f))
        prev = line
    return b"".join([
        png_write.SIGNATURE,
        png_write.chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ct,
                                             0, 0, 0)),
        png_write.chunk(b"IDAT", zlib.compress(bytes(raw), 9)),
        png_write.chunk(b"IEND", b"")])


@pytest.mark.parametrize("ftypes", [[0] * 9, [1] * 9, [2] * 9, [3] * 9,
                                    [4] * 9, [4, 3, 2, 1, 0, 1, 2, 3, 4]])
@pytest.mark.parametrize("ct,depth,w", [(2, 8, 11), (6, 16, 5), (0, 4, 13),
                                        (4, 8, 10)])
def test_decoder_unfilters_lines_filtered_byte_by_byte(ftypes, ct, depth, w):
    rng = np.random.default_rng(len(set(ftypes)) * 100 + ct * 10 + depth)
    stride = (w * png_write.CHANNELS[ct] * depth + 7) // 8
    lines = rng.integers(0, 256, (9, stride)).astype(np.uint8)
    lines[4:6] = lines[3]                              # runs for Up, Paeth
    if depth < 8:
        lines[:, -1] &= 0xFF << (8 - (w * depth) % 8) & 0xFF
    png = _stdlib_png(lines, ftypes, w, 9, depth, ct)
    got = png_read.decode(png)
    packed = png_write.pack(
        (got[:, :, {0: [0], 2: [0, 1, 2], 4: [0, 3], 6: [0, 1, 2, 3]}[ct]]
         // (65535 // (2 ** depth - 1))), depth)
    assert np.array_equal(packed, lines)


def test_decoder_agrees_with_pil():
    image = pytest.importorskip("PIL.Image")
    import io
    px = KIND.photo(np.random.default_rng(3), 40, 56, MIX["photo"])
    png = KIND.save(px, MIX["writer"])
    pil = np.asarray(image.open(io.BytesIO(png)).convert("RGB"))
    assert np.array_equal(pil, px)
    assert np.array_equal(png_read.decode(png)[:, :, :3] >> 8, px)


def _small():
    px = KIND.photo(np.random.default_rng(9), 6, 10, MIX["photo"])
    return px, png_write.write(px, 2, 8)


def _rechunk(png, kind, data):
    """`png` with chunk `kind`'s data replaced, its CRC made anew."""
    out, pos = [png[:8]], 8
    while pos < len(png):
        n, k = struct.unpack(">I4s", png[pos:pos + 8])
        d = png[pos + 8:pos + 8 + n]
        out.append(png_write.chunk(k, data if k == kind else d))
        pos += 12 + n
    return b"".join(out)


def _faults():
    px, png = _small()
    idat = png.index(b"IDAT") - 4
    n = struct.unpack(">I", png[idat:idat + 4])[0]
    stream = png[idat + 8:idat + 8 + n]
    body = zlib.decompress(stream)
    ihdr = png[16:29]
    return px, {
        "signature": (b"\x89PNG\r\n\x1b\n" + png[8:], "signature"),
        "crc": (png[:idat + 8] + bytes([png[idat + 8] ^ 1])
                + png[idat + 9:], "CRC-32"),
        "after_iend": (png + b"\0", "after IEND"),
        "no_iend": (png[:-12], "IEND"),
        "depth": (_rechunk(png, b"IHDR", ihdr[:8] + b"\x04" + ihdr[9:]),
                  "bit depth 4 with color type 2"),
        "interlaced": (_rechunk(png, b"IHDR", ihdr[:12] + b"\x01"),
                       "interlaced"),
        "size": (_rechunk(png, b"IHDR", struct.pack(">I", 11) + ihdr[4:]),
                 "bytes of image data"),
        "adler": (_rechunk(png, b"IDAT", stream[:-1] + bytes(
            [stream[-1] ^ 1])), "Adler-32"),
        "trailing": (_rechunk(png, b"IDAT", stream + b"\0"),
                     "after the DEFLATE stream"),
        "zlib_header": (_rechunk(png, b"IDAT", b"\x78\x9d" + stream[2:]),
                        "zlib header"),
        "filter": (_rechunk(png, b"IDAT", zlib.compress(
            b"\x05" + body[1:])), "filter type 5"),
        "trns": (_rechunk(png, b"IDAT", stream)[:-12]
                 + png_write.chunk(b"tRNS", b"\0\0") + png[-12:],
                 "tRNS"),
    }


@pytest.mark.parametrize("fault", sorted(_faults()[1]))
def test_decoder_refuses_each_fault_with_its_reason(fault):
    px, faults = _faults()
    png, reason = faults[fault]
    item = Item("f", b"", px.size, px)
    got = FMT.judge(png, item)
    assert got is not None and reason in got, got


def test_judge_refuses_a_palette_index_out_of_range():
    idx = np.zeros((3, 4, 1), np.uint8)
    idx[1, 2] = 3
    png = png_write.write(idx, 3, 2, palette=np.zeros((3, 3), np.uint8))
    assert FMT.judge(png, Item("p", b"", 36, np.zeros((3, 4, 3), np.uint8))) \
        == "palette index out of range"


def test_judge_compares_every_pixel_at_full_depth():
    px, png = _small()
    item = Item("s", png, px.size, px)
    assert FMT.judge(png, item) is None
    wide = png_write.write(px.astype(np.uint16) * 257, 2, 16)
    assert FMT.judge(wide, item) is None
    off = png_write.write(px.astype(np.uint16) * 257 + 1, 2, 16)
    assert FMT.judge(off, item) == "pixels differ from the input's"
    alpha = np.concatenate([px, np.full(px.shape[:2] + (1,), 254,
                                        np.uint8)], axis=2)
    assert FMT.judge(png_write.write(alpha, 6, 8), item) \
        == "pixels differ from the input's"
    assert FMT.judge(png_write.write(px[:, :-1], 2, 8), item).startswith(
        "IHDR size")


def _items(shapes, seed):
    out = []
    for k, (h, w) in enumerate(shapes):
        px = KIND.photo(np.random.default_rng([seed, k]), h, w, MIX["photo"])
        out.append(Item(f"s{k}", KIND.save(px, MIX["writer"]), px.size, px))
    return out


def test_judge_accepts_the_ports_cpu_output():
    """The port at its defaults but for the device and the iterations,
    on small photos of the kind, landscape and portrait."""
    from zopfli_tpu_torch.png.optimize import PNGOptions, optimize_many
    items = _items([(48, 64), (64, 48)], 1)
    outs = optimize_many([i.raw for i in items],
                         PNGOptions(device="cpu", num_iterations=2))
    for item, out in zip(items, outs):
        assert FMT.judge(out, item) is None
        assert out[:8] == png_write.SIGNATURE and out != item.raw


TINY = dict(MIX, sizes=[[24, 16], [16, 24]], per_call=2, trace_calls=2)


@pytest.fixture(scope="module")
def man(tmp_path_factory):
    real = MAN.config("zopflipng-default")
    cpu = dict(real, options=dict(real["options"], device="cpu",
                                  num_iterations=2, num_iterations_large=2))
    cells = [{"name": n, "config": c, "traffic": "tiny-photos", "chips": 1,
              "why": "t"} for n, c in (("png.tiny", "zopflipng-default"),
                                       ("png.cpu", "cpu-png"))]
    return make_manifest(str(tmp_path_factory.mktemp("png")), cells,
                         configs={"cpu-png": cpu},
                         mixes={"tiny-photos": TINY})


def test_the_entry_runs_the_port_and_every_output_passes_the_check(man):
    """The port through `entries/optimize_many.py` on the CPU: every
    output a sound PNG of its input's pixels, none missing.  (At 24x16
    pixels and 2 iterations the size guarantee is not what is tested.)"""
    r = run.run_cell(man, "png.cpu", 2 ** 31 + 19, 0.01, False,
                     device_info=no_card)
    assert r["attempted"] == 4
    assert r["check"]["bad_outputs"]["value"] == 0
    assert r["check"]["missing_outputs"]["value"] == 0


@pytest.mark.parametrize("name,broken", [
    ("png_zlib9", "not_smaller_than_zlib9"),
    ("png_pixel_flipped", "bad_outputs")])
def test_reference_control_is_not_correct(man, name, broken):
    make = functools.partial(control.entry,
                             program_entry=calls.program_entry, name=name,
                             man=man)
    r = run.run_cell(man, "png.tiny", 2 ** 31 + 19, 0.01, False,
                     make_entry=make, device_info=no_card)
    assert not r["correct"] and r["attempted"] >= 4
    assert r["check"][broken]["value"] == r["attempted"]
    if name == "png_zlib9":
        assert r["check"]["bad_outputs"]["value"] == 0
    assert r["check"]["missing_outputs"]["value"] == 0


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, '.'); "
            "from portbench.manifest import Manifest; m = Manifest(); "
            "m.module('reference/formats', 'png'); m.module('inputs', 'png'); "
            "[m.module('reference/encoders', n) for n in "
            "('png_zlib9', 'png_pixel_flipped')]; "
            "import portbench.reference.png_read; "
            "print(sorted({n.split('.')[0] for n in sys.modules} & "
            "{'torch', 'zopfli_tpu_torch', 'zopfli_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=run.ROOT, check=True)
    assert out.stdout.strip() == "[]"
