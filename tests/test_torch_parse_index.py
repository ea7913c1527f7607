"""The native parse index (`native.parse_index`, `zt_parse_index`) behind
`lz77.LZ77Store` and the fused loop's match check, against numpy oracles:
the reference package's `LZ77Store` (positions, symbols, a `bincount`
pair a 1,024-symbol chunk) and the gather-compare that
`FusedSqueeze.verify_parse` replaced.

Every store attribute is bit-equal to the reference's, in value and dtype,
on greedy parses of corpus slices cut at chosen symbol counts (0, 1,
1,023, 1,024, 1,025, ...) and on literal-only parses; range histograms
agree; the check gives the oracle's answer on sound parses and on each
kind of fault; a `compress` on the CPU sends every block through it.
"""

import os
import zlib

import numpy as np
import pytest

import zopfli_tpu_torch as zt
from zopfli_tpu.lz77 import LZ77Store as RefStore
from zopfli_tpu_torch import native, spec, squeeze_batched
from zopfli_tpu_torch.lz77 import LZ77Store, concat_stores, verify_store
from zopfli_tpu_torch.ops import fused_engine
from zopfli_tpu_torch.ops.engine import DeviceBlockEngine

CORPUS = np.fromfile(os.path.join(os.path.dirname(__file__), "..",
                                  "portbench", "data", "corpus.txt"),
                     np.uint8)


# ---------------------------------------------------------------------------
# Oracles: the reference package's numpy store, and the gather-compare
# match check the native pass replaced (the reference package has no
# standalone check: its verify_parse is a method of its device squeeze).
# ---------------------------------------------------------------------------

STORE_ATTRS = ("litlens", "dists", "pos", "size", "ll_symbol", "d_symbol",
               "_cum_ll", "_cum_d", "_is_match")


def oracle_store(data, litlens, dists, instart=0):
    """The reference package's store (plain numpy), attribute by
    attribute."""
    ref = RefStore(data, litlens, dists, instart)
    return {name: getattr(ref, name) for name in STORE_ATTRS}


def oracle_check(data, litlens, dists, instart, inend, wstart):
    if len(litlens) == 0:
        return inend == instart
    step = np.where(dists == 0, 1, litlens).astype(np.int64)
    if int(step.sum()) != inend - instart:
        return False
    pos = np.concatenate([[0], np.cumsum(step[:-1])]) + instart
    m = dists != 0
    if not m.any():
        return True
    mp = pos[m]
    md = dists[m].astype(np.int64)
    ml = litlens[m].astype(np.int64)
    if (md > mp - wstart).any() or (md > spec.WINDOW_SIZE).any():
        return False
    total = int(ml.sum())
    offs = np.arange(total) - np.repeat(np.cumsum(ml) - ml, ml)
    dsts = np.repeat(mp, ml) + offs
    srcs = np.repeat(mp - md, ml) + offs
    return bool(np.array_equal(data[dsts], data[srcs]))


def _greedy_prefix(nsym, instart=0):
    """The first `nsym` symbols of the greedy parse of the corpus from
    `instart`, and the byte after them."""
    lit, dst = native.greedy(CORPUS, instart, instart + 8 * nsym + 16)
    assert len(lit) >= nsym
    lit, dst = lit[:nsym], dst[:nsym]
    end = instart + int(np.where(dst == 0, 1, lit).astype(np.int64).sum())
    return lit, dst, end


def _assert_store_equal(store, want):
    for name, value in want.items():
        got = getattr(store, name)
        if name == "size":
            assert got == value
            continue
        assert got.dtype == value.dtype, name
        np.testing.assert_array_equal(got, value, err_msg=name)


SIZES = [0, 1, 2, 1023, 1024, 1025, 2048, 5000]


@pytest.mark.parametrize("nsym", SIZES)
@pytest.mark.parametrize("instart", [0, 70001])
def test_store_equals_oracle_on_greedy_parses(nsym, instart):
    lit, dst, end = _greedy_prefix(nsym, instart)
    want = oracle_store(CORPUS, lit, dst, instart)
    _assert_store_equal(LZ77Store(CORPUS, lit, dst, instart), want)
    store, compared = LZ77Store.checked(CORPUS, lit, dst, instart, end,
                                        max(instart - 32768, 0))
    assert oracle_check(CORPUS, lit.astype(np.int64), dst, instart, end,
                        max(instart - 32768, 0))
    _assert_store_equal(store, want)
    assert compared == int(lit[dst != 0].astype(np.int64).sum())


@pytest.mark.parametrize("nsym", [1, 1023, 1024, 1025, 3000])
def test_store_equals_oracle_on_literal_parses(nsym):
    lit = CORPUS[1000:1000 + nsym].astype(np.uint16)
    dst = np.zeros(nsym, np.uint16)
    want = oracle_store(CORPUS, lit, dst, 1000)
    _assert_store_equal(LZ77Store(CORPUS, lit, dst, 1000), want)
    store, compared = LZ77Store.checked(CORPUS, lit, dst, 1000,
                                        1000 + nsym, 0)
    _assert_store_equal(store, want)
    assert compared == 0


@pytest.mark.parametrize("nsym", [1025, 4100])
def test_histograms_equal_oracle_on_random_ranges(nsym):
    lit, dst, _ = _greedy_prefix(nsym, 5)
    store = LZ77Store(CORPUS, lit, dst, 5)
    want = oracle_store(CORPUS, lit, dst, 5)
    rng = np.random.default_rng(nsym)
    ranges = [(0, nsym), (0, 0), (1024, min(2048, nsym))] + [
        tuple(sorted(rng.integers(0, nsym + 1, 2))) for _ in range(40)]
    for lo, hi in ranges:
        ll, d = store.histogram(int(lo), int(hi))
        seg = slice(int(lo), int(hi))
        m = want["_is_match"][seg]
        np.testing.assert_array_equal(ll, np.bincount(
            want["ll_symbol"][seg], minlength=spec.NUM_LL))
        np.testing.assert_array_equal(d, np.bincount(
            want["d_symbol"][seg][m], minlength=spec.NUM_D))


def test_concat_stores_equals_one_store():
    lit, dst, end = _greedy_prefix(3000, 40)
    cut = [0, 700, 1024, 2500, 3000]
    parts = []
    for a, b in zip(cut[:-1], cut[1:]):
        start = 40 + int(np.where(dst[:a] == 0, 1, lit[:a]).astype(
            np.int64).sum())
        parts.append(LZ77Store(CORPUS, lit[a:b], dst[a:b], start))
    _assert_store_equal(concat_stores(parts),
                        oracle_store(CORPUS, lit, dst, 40))


# ---------------------------------------------------------------------------
# The check: each kind of fault gives the oracle's answer.
# ---------------------------------------------------------------------------

def _window_fault():
    """A batch whose second input starts at byte 2000, over one run of
    bytes: five literals, then a match of 10 at distance 6, one byte past
    pos - wstart, whose bytes are equal all the same."""
    data = np.full(4000, 97, np.uint8)
    lit = np.array([97] * 5 + [10], np.int32)
    dst = np.array([0] * 5 + [6], np.int32)
    return data, lit, dst, 2000, 2015, 2000


def _faults():
    lit, dst, end = _greedy_prefix(1500, 33000)
    m = np.nonzero(dst)[0]
    cases = {}

    wrong_sum = lit.copy()
    wrong_sum[m[3]] += 1
    cases["wrong_step_sum"] = (CORPUS, wrong_sum, dst, 33000, end, 0)
    cases["short_step_sum"] = (CORPUS, lit[:-1], dst[:-1], 33000, end, 0)
    cases["empty_parse_nonempty_range"] = (
        CORPUS, lit[:0], dst[:0], 33000, 33005, 0)
    cases["empty_parse_empty_range"] = (
        CORPUS, lit[:0], dst[:0], 33000, 33000, 0)

    # A match whose distance is one past pos - wstart.
    d, l, ds, s, e, w = _window_fault()
    cases["distance_past_window_start"] = (d, l, ds, s, e, w)
    ok = ds.copy()
    ok[5] = 5
    cases["distance_at_window_start"] = (d, l, ok, s, e, w)

    # 32,769 back over repeated bytes: every byte equal, the distance too
    # long for DEFLATE.
    rep = np.tile(CORPUS[:32769], 2)
    far_l = np.concatenate([rep[:32769], [20]]).astype(np.int32)
    far_d = np.zeros(32770, np.int32)
    far_d[-1] = 32769
    cases["distance_32769"] = (rep, far_l, far_d, 0, 32789, 0)
    near_d = far_d.copy()
    near_d[-1] = 32768
    cases["distance_32768_bytes_differ"] = (rep, far_l, near_d, 0, 32789, 0)

    # One matched byte flipped, in the data under the copy.
    flipped = CORPUS.copy()
    i = int(m[len(m) // 2])
    pos = 33000 + int(np.where(dst[:i] == 0, 1, lit[:i]).astype(
        np.int64).sum())
    flipped[pos + int(lit[i]) - 1] ^= 1
    cases["matched_byte_flipped"] = (flipped, lit, dst, 33000, end, 0)

    # Overlapping matches (dist < length): sound over a run, unsound
    # where the run breaks.
    run = np.frombuffer(b"ab" + b"a" * 40 + b"xyz" + b"a" * 3, np.uint8)
    o_l = np.array([97, 98, 97, 39, 120, 121, 122, 3], np.int32)
    o_d = np.array([0, 0, 0, 1, 0, 0, 0, 6], np.int32)
    cases["overlap_sound"] = (run, o_l, o_d, 0, len(run), 0)
    bad = o_d.copy()
    bad[3] = 2
    cases["overlap_unsound"] = (run, o_l, bad, 0, len(run), 0)
    cases["sound"] = (CORPUS, lit, dst, 33000, end, 0)
    cases["matches_before_window_start"] = (CORPUS, lit, dst, 33000, end,
                                           32000)
    return cases


FAULTS = _faults()
EXPECT = {"empty_parse_empty_range": True, "distance_at_window_start": True,
          "overlap_sound": True, "sound": True}


@pytest.mark.parametrize("name", sorted(FAULTS))
def test_check_gives_the_oracles_answer(name):
    data, lit, dst, instart, inend, wstart = FAULTS[name]
    lit = np.asarray(lit, np.int32)
    dst = np.asarray(dst, np.int32)
    want = oracle_check(data, lit, dst, instart, inend, wstart)
    assert want == EXPECT.get(name, False), name
    store, compared = LZ77Store.checked(data, lit, dst, instart, inend,
                                        wstart)
    assert (store is not None) == want
    if want:
        _assert_store_equal(store, oracle_store(data, lit, dst, instart))
        assert compared == int(lit[dst != 0].sum())
    else:
        assert compared == 0


@pytest.mark.parametrize("name", ["sound", "matched_byte_flipped",
                                  "wrong_step_sum", "distance_32769",
                                  "overlap_sound", "overlap_unsound"])
def test_engine_verify_is_the_same_check(name):
    """DeviceBlockEngine._verify: the native check with the window at the
    buffer's first byte (no device work: the engine is never prepared)."""
    data, lit, dst, instart, inend, _ = FAULTS[name]
    eng = DeviceBlockEngine(data, instart, inend, device="cpu")
    got = eng._verify(np.asarray(lit, np.int32), np.asarray(dst, np.int32))
    assert got == oracle_check(data, np.asarray(lit, np.int32),
                               np.asarray(dst, np.int32), instart, inend, 0)


def test_verify_store_raises_on_a_flipped_byte():
    data, lit, dst, instart, _, _ = FAULTS["sound"]
    verify_store(LZ77Store(data, lit, dst, instart))
    flipped, *_ = FAULTS["matched_byte_flipped"]
    with pytest.raises(AssertionError):
        verify_store(LZ77Store(flipped, lit, dst, instart))


@pytest.mark.parametrize("lit,dst", [([300], [0]), ([-1], [0]),
                                     ([-3], [5]), ([10], [70000])])
def test_symbols_outside_the_alphabets_raise(lit, dst):
    data = np.zeros(100000, np.uint8)
    with pytest.raises(ValueError):
        LZ77Store(data, np.array(lit, np.int32), np.array(dst, np.int32), 0)


def test_check_refuses_a_range_outside_the_data():
    with pytest.raises(ValueError):
        LZ77Store.checked(CORPUS[:10], np.zeros(20, np.int32),
                          np.zeros(20, np.int32), 0, 20, 0)


# ---------------------------------------------------------------------------
# The collect path: every block of a compress goes through the pass.
# ---------------------------------------------------------------------------

def test_compress_checks_every_block_natively(monkeypatch):
    collected = []
    collect = squeeze_batched.fused_collect

    def spy(fs, handle, numiterations, trace=None):
        out = collect(fs, handle, numiterations, trace)
        collected.extend(s for stores in out for s in stores)
        return out

    monkeypatch.setattr(squeeze_batched, "fused_collect", spy)
    blocks0 = fused_engine.VERIFY["blocks"]
    bytes0 = fused_engine.VERIFY["match_bytes"]
    fails0 = squeeze_batched.VERIFY_FAILS[0]
    blobs = [CORPUS[:30000].tobytes(), CORPUS[200000:212000].tobytes()]
    outs = zt.compress_many(blobs, "gzip",
                            zt.Options(device="cpu", numiterations=2))
    for blob, out in zip(blobs, outs):
        assert zlib.decompress(out, 31) == blob
    assert squeeze_batched.VERIFY_FAILS[0] == fails0
    assert len(collected) >= 2
    assert fused_engine.VERIFY["blocks"] - blocks0 == len(collected)
    assert fused_engine.VERIFY["match_bytes"] - bytes0 == sum(
        int(s.litlens[s._is_match].sum()) for s in collected)
