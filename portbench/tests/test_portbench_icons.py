"""The launcher-icon cell's parts on the CPU: the icon kind's pools,
frozen; what each pass deals; the alpha-aware check holding alpha
everywhere and RGB where alpha is above 0, and nothing where alpha is
0; each control failing every output, or passing where the flag allows
what it changed; and the reference importing nothing of the program."""

import functools
import hashlib
import subprocess
import sys

import numpy as np
import pytest
from helpers import no_card

from portbench import calls, gen, run
from portbench.manifest import Manifest
from portbench.reference import control, png_read, png_write

MAN = Manifest()
CELL = "zopflipng-i500-all-filters.android-launcher"
FMT = MAN.module("reference/formats", "png_lossy_transparent")
MIX = MAN.traffic("android-launcher")

# seed: sha-256 over each item's key, raw, nbytes, and expect's shape
# and bytes, in call order.  Two calls of ten icons, one a pass.
FROZEN = (2, 1, [
    "d022f47a116f8603ebf084074d1f3a2405e00f42d20d63450b96c44782b74e9f",
    "2ee7ec5cb437722b259f0f056188651a5ff366e8def35657f57658e5c04a48d9",
    "0b3f5341d6ee903883d9402a7e30895db3797f368d3bf33ce31c55cea80bb6d5",
    "7ff3f4459f1a1b71761406aff0e6f4f4a8542e2bcd8c56e024c9b72a9c18035d",
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


@pytest.mark.parametrize("seed", [0, 2 ** 32 + 5])
def test_each_pass_deals_one_apps_icons_at_every_density(seed):
    """Both shapes at the five densities a pass, in the order of a sorted
    listing of res/mipmap-*/, 594,432 pixel bytes a call;
    each `raw` an 8-bit RGBA PNG of its pixels; each icon with more than
    256 colours, partial alpha, and RGB left under its clear margin."""
    p = pool(seed)
    for k, call in enumerate(p.calls):
        assert [(i.key, i.expect.shape) for i in call] == [
            (f"a{k}.mipmap-{d}/{sh}", (s, s, 4))
            for d, s in sorted(MIX["densities"].items())
            for sh in MIX["shapes"]]
        assert sum(i.nbytes for i in call) == 594_432
    for i in p.items():
        h, w, _ = i.expect.shape
        assert i.nbytes == h * w * 4
        assert np.array_equal(png_read.decode(i.raw) >> 8, i.expect)
        assert i.raw[24:26] == bytes([8, 6])            # depth, color type
        a = i.expect[:, :, 3]
        assert len(np.unique(i.expect.reshape(-1, 4).view(np.uint32))) > 256
        assert ((a > 0) & (a < 255)).any() and (a == 255).any()
        assert i.expect[a == 0, :3].any()
        # The raw IDAT stream is under 200,000 B: every job runs at
        # num_iterations.
        assert h * (1 + 4 * w) < 200_000


def test_every_seeds_pool_compresses_alike():
    """The yardstick's bits a pixel byte over a pool spread by well under
    the bits bound's half (0.75%) across seeds: the seed moves only the
    glyphs' sizes (quartiles over 12 seeds)."""
    vals = []
    for seed in range(2 ** 31, 2 ** 31 + 12):
        items = pool(seed).items()
        vals.append(8 * sum(FMT.zlib9_size(i) for i in items)
                    / sum(i.nbytes for i in items))
    q = np.quantile(vals, [0.25, 0.75], method="weibull")
    assert (q[1] - q[0]) / np.median(vals) < 0.004


def _item(seed=1):
    return pool(seed).calls[0][0]


def test_judge_holds_alpha_everywhere_and_rgb_where_seen():
    item = _item()
    px = item.expect
    assert FMT.judge(png_write.write(px, 6, 8, level=9), item) is None
    hidden = px.copy()
    hidden[px[:, :, 3] == 0, :3] ^= 0x55
    assert FMT.judge(png_write.write(hidden, 6, 8), item) is None
    alpha = px.copy()
    y, x = np.argwhere(px[:, :, 3] == 0)[0]
    alpha[y, x, 3] = 1
    assert FMT.judge(png_write.write(alpha, 6, 8), item) == \
        "alpha differs from the input's"
    seen = px.copy()
    y, x = np.argwhere((px[:, :, 3] > 0) & (px[:, :, 3] < 255))[0]
    seen[y, x, 2] ^= 1
    assert FMT.judge(png_write.write(seen, 6, 8), item) == \
        "RGB differs from the input's where alpha is above 0"
    h, w, _ = px.shape
    assert FMT.judge(png_write.write(px[:, :-1], 6, 8), item) == \
        f"IHDR size {w - 1}x{h}, not {w}x{h}"
    assert FMT.judge(b"\x89PNG\r\n\x1a\n", item) == "no IEND chunk"


def test_judge_reads_the_pixels_at_16_bits():
    """The same pixels at 16 bits a sample pass; one sample one step
    off at 16 bits (invisible at 8) fails."""
    item = _item()
    px16 = item.expect.astype(np.uint16) * 257
    assert FMT.judge(png_write.write(px16, 6, 16), item) is None
    y, x = np.argwhere(item.expect[:, :, 3] == 255)[0]
    px16[y, x, 1] += 1
    assert FMT.judge(png_write.write(px16, 6, 16), item) is not None


def test_yardstick_is_the_rgba_pixels_at_zlib_level_9():
    item = _item()
    assert FMT.zlib9_size(item) == len(png_write.write(item.expect, 6, 8,
                                                       level=9))
    assert FMT.zlib9_size(item) < len(item.raw)


@pytest.mark.parametrize("name,broken", [
    ("png_rgba_zlib9", "not_smaller_than_zlib9"),
    ("png_alpha_changed", "bad_outputs"),
    ("png_visible_rgb_changed", "bad_outputs"),
    ("png_hidden_rgb_changed", None)])
def test_each_control_fails_every_output_or_passes(name, broken):
    """The configuration's controls through the cell, on the CPU: the
    three that break a guarantee fail every output; the one that changes
    only RGB under alpha 0 is correct."""
    make = functools.partial(control.entry,
                             program_entry=calls.program_entry, name=name,
                             man=MAN)
    r = run.run_cell(MAN, CELL, 2 ** 31 + 23, 0.01, False,
                     make_entry=make, device_info=no_card)
    assert r["attempted"] == 20
    assert r["check"]["missing_outputs"]["value"] == 0
    if broken is None:
        assert r["correct"] and r["failed"] == 0
        assert r["check"]["not_smaller_than_zlib9"]["value"] == 0
        return
    assert not r["correct"]
    assert r["check"][broken]["value"] == r["attempted"]
    if broken != "bad_outputs":
        assert r["check"]["bad_outputs"]["value"] == 0


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, '.'); "
            "from portbench.manifest import Manifest; m = Manifest(); "
            "m.module('reference/formats', 'png_lossy_transparent'); "
            "m.module('inputs', 'icons'); "
            "[m.module('reference/encoders', n) for n in "
            "('png_rgba_zlib9', 'png_alpha_changed', "
            "'png_visible_rgb_changed', 'png_hidden_rgb_changed')]; "
            "print(sorted({n.split('.')[0] for n in sys.modules} & "
            "{'torch', 'zopfli_tpu_torch', 'zopfli_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=run.ROOT, check=True)
    assert out.stdout.strip() == "[]"
