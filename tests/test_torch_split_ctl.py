"""The block-split search as the card runs it, on the CPU.

The port's ops.devsplit runs ZopfliBlockSplitLZ77 as one launch of the
split_search kernel (csrc/split_search.cu) on the card: its control and
the costs of every round it issues.  On CPU tensors split_search takes
split_search_plain, split_step_plain (the kernel's step) and
autotype_costs_plain (a round's costs) in turn.  Here the plain search
must give the host splitter's split points (tests/test_torch_devsplit.py holds it against the JAX
package's split_lz77_device), never set its overflow flag, and stop at
the step that finishes the search; a search of k steps must equal k plain steps and
their rounds' costs, and a cap below the steps a search needs must set
S_OVERFLOW; the seed program's device-resident finish must equal its
host finish bit for bit.  The megafused program's second split
(ZT_MEGA=1, MEGA_MIN patched to 1000) must equal the host splitter's on
the collected stores at nb_pad 128 (the JAX program's 32-bit stream key
holds 64 lane blocks; its assert checks only MB + 1 <= 64), and its
decision must be dropped after a verify fallback.  Here the blocks and
replicas fill fewer than 64 lane blocks: the 64-bit key's order past 64
is held by
tests/test_torch_mega.py::test_stream_offsets_order_past_64_lane_blocks
on the CPU, and in a program run by chip_smoke.py's mega phase ("wide":
90 lane blocks, bytes equal to the two-phase path).  Tolerance: exact."""

import numpy as np
import pytest
import torch

from zopfli_tpu_torch import blocks, native, squeeze_batched
from zopfli_tpu_torch.lz77 import LZ77Store, concat_stores
from zopfli_tpu_torch.ops import devsplit as ds
from zopfli_tpu_torch.ops import mega, seed

# The tensors here are tiny: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

MB = 15


def _stream(rng, n, p_match, max_len=258):
    is_m = rng.random(n) < p_match
    lit = np.where(is_m, rng.integers(3, max_len + 1, n),
                   rng.integers(0, 256, n))
    dist = np.where(is_m, rng.integers(1, 32769, n), 0)
    return lit.astype(np.int32), dist.astype(np.int32)


def _linear_only(rng, n=60):
    """Four runs of n symbols the split separates (3 points, 7 linear
    rounds): low literals, short matches, high literals, long matches."""
    def lits(lo, hi):
        return rng.integers(lo, hi, n), np.zeros(n, np.int64)

    def matches(lo, hi):
        return rng.integers(lo, hi, n), rng.integers(1, 4000, n)

    parts = [lits(0, 4), matches(3, 12), lits(200, 256), matches(100, 258)]
    return tuple(np.concatenate(p).astype(np.int32) for p in zip(*parts))


def _streams():
    rng = np.random.default_rng(2026)
    words = [b"alpha ", b"beta ", b"gamma ", b"delta "]
    text = b"".join(words[i] for i in rng.integers(0, 4, 8000))
    noise = rng.integers(0, 256, 1500, dtype=np.uint8).tobytes()
    data = np.frombuffer(b"\x00" * 3000 + text[:6000] + noise
                         + text[6000:12000] + b"z" * 2000, np.uint8)
    return {
        "under_10": _stream(rng, 7, 0.3),
        "under_1000": _stream(rng, 500, 0.3),
        "linear_only": _linear_only(np.random.default_rng(7)),
        "greedy_text": tuple(a.astype(np.int32)
                             for a in native.greedy(data, 0, len(data))),
        "long_synthetic": _stream(rng, 60_000, 0.35),
    }


STREAMS = _streams()


def _padded(lit, dist):
    n = len(lit)
    ncap = ds.CKPT
    while ncap < n + 1:
        ncap *= 2
    ll = np.zeros(ncap, np.int32)
    dd = np.zeros(ncap, np.int32)
    ll[:n] = lit
    dd[:n] = dist
    return torch.from_numpy(ll), torch.from_numpy(dd), ncap, n


def test_streams_reach_both_round_kinds():
    assert len(STREAMS["under_10"][0]) < 10
    assert len(STREAMS["under_1000"][0]) <= 1000
    assert len(STREAMS["linear_only"][0]) <= ds.LINEAR_MAX
    assert len(STREAMS["greedy_text"][0]) > ds.LINEAR_MAX
    assert len(STREAMS["long_synthetic"][0]) > 50 * ds.LINEAR_MAX


def _tabs(ll, dd, ncap, n):
    nsym = torch.tensor(n)
    ll_sym, d_sym, nb = ds.stream_symbols(ll, dd, ncap, nsym)
    ll_ck, d_ck, bcum = ds.checkpoints(ll_sym, d_sym, nb, ncap, nsym)
    return (ll_ck, d_ck, ll_sym, d_sym, bcum), nsym


def _host_split(lit, dist):
    """The host splitter's points on a stream (its bytes made up: the
    split reads only the symbols)."""
    n = len(lit)
    data = np.zeros(int(np.where(dist > 0, lit, 1).sum()), np.uint8)
    return blocks.block_split_lz77(LZ77Store(data, lit, dist, 0), MB)


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_chain_to_n_max_equals_host_split(name):
    """The plain search allowed its N_MAX steps: the host splitter's
    points, no overflow, and it stops at the step that finishes the
    search (one step past its rounds); steps past that one change
    nothing."""
    lit, dist = STREAMS[name]
    ll, dd, ncap, n = _padded(lit, dist)
    tabs, nsym = _tabs(ll, dd, ncap, n)
    state, costs, starts, ends, rows = ds.split_search(
        tabs, nsym, ncap, MB, return_round=True)
    assert int(state[ds.S_OVERFLOW]) == 0 and int(state[ds.S_FINISHED])
    npts = int(state[ds.S_NPTS])
    sp = state[ds.S_HEAD:ds.S_HEAD + MB].tolist()
    assert sp[:npts] == _host_split(lit, dist)
    assert sp[npts:] == [ncap + 1] * (MB - npts)
    for _ in range(3):
        before = state.clone()
        ds.split_step_plain(state, nsym, costs, starts, ends, rows, MB,
                            ncap, True)
        assert torch.equal(state, before)
    # split_lz77_resident and split_lz77_device (the same search) agree.
    sp2, npts2, fin = ds.split_lz77_resident(ll, dd, ncap, MB, nsym,
                                             return_state=True)
    assert sp2.tolist() == sp and int(npts2) == npts
    assert torch.equal(fin, state)
    assert ds.split_lz77_device(ll, dd, ncap, MB, n) == (sp, npts)


def _stepped(tabs, nsym, ncap, k):
    """k plain steps, each followed by its round's costs, as split_search
    composes them."""
    state = ds.split_state(MB, ncap, "cpu")
    R = ds.MAX_RANGES
    costs, starts, ends = (torch.zeros(R, dtype=torch.int64)
                           for _ in range(3))
    rows = torch.zeros(R, dtype=torch.bool)
    for j in range(k):
        ds.split_step_plain(state, nsym, costs, starts, ends, rows, MB, ncap,
                            j == k - 1)
        c = int(state[ds.S_COUNT])
        if c == 0:
            break
        costs[:c] = ds.autotype_costs_plain(*tabs, starts[:c], ends[:c],
                                            ncap, rows[:c])
    return state, costs, starts, ends, rows


@pytest.mark.parametrize("k", [1, 2, 3, 8, 17, 20])
def test_steps_prefix_equals_plain_steps(k):
    """split_search(steps=k) is k steps and their rounds' costs: state,
    the last round's ranges, gates and costs (what chip_smoke.py holds
    the kernel to at steps = 1, 2, ...).  The stream's search takes 17
    steps (16 rounds): 20 passes its end."""
    ll, dd, ncap, n = _padded(*STREAMS["greedy_text"])
    tabs, nsym = _tabs(ll, dd, ncap, n)
    got = ds.split_search(tabs, nsym, ncap, MB, steps=k, return_round=True)
    want = _stepped(tabs, nsym, ncap, k)
    assert torch.equal(got[0], want[0])
    c = int(want[0][ds.S_COUNT])
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g[:c], w[:c])
    finished = bool(want[0][ds.S_FINISHED])
    assert finished == (k >= 17)
    assert int(got[0][ds.S_OVERFLOW]) == (not finished)
    assert int(got[0][ds.S_ROUNDS]) == min(k, 16)


def test_short_chain_sets_overflow_and_raises():
    """A cap below the steps the search needs sets S_OVERFLOW, and the
    host's pull raises on it."""
    ll, dd, ncap, n = _padded(*STREAMS["greedy_text"])
    tabs, nsym = _tabs(ll, dd, ncap, n)
    state = ds.split_search(tabs, nsym, ncap, MB, steps=3)
    assert int(state[ds.S_OVERFLOW]) == 1 and not int(state[ds.S_FINISHED])
    assert int(state[ds.S_ROUNDS]) == 3
    with pytest.raises(RuntimeError, match="did not finish"):
        ds.pull_split(state, MB)


def test_probe_round_bound_holds_for_any_narrowing():
    """FindMinimum's narrowing, with the best probe drawn at random, never
    runs more rounds than probe_rounds_max of its span."""
    rng = np.random.default_rng(5)
    for span in list(range(ds.LINEAR_MAX, 6000, 37)) + [1 << 20, 1 << 21]:
        for _ in range(20):
            start, end, rounds = 0, span, 0
            while True:
                rounds += 1
                step = (end - start) // (ds.NUM + 1)
                besti = int(rng.integers(0, ds.NUM))
                nstart = start if besti == 0 else start + besti * step
                nend = end if besti == ds.NUM - 1 else \
                    start + (besti + 2) * step
                start, end = nstart, nend
                if end - start <= ds.NUM:
                    break
            assert rounds <= ds.probe_rounds_max(span), (span, rounds)
    assert ds.probe_rounds_max((1 << 20) + ds.CKPT) == 9
    assert ds.n_max(16, (1 << 20) + ds.CKPT) == 2 * 16 * 9 + 1


def test_finish_resident_equals_finish():
    rng = np.random.default_rng(3)
    words = [b"one ", b"two ", b"three ", b"four\n"]
    text = b"".join(words[i] for i in rng.integers(0, 4, 3000))
    data = np.frombuffer(text[:6000] + rng.integers(
        0, 256, 3000, dtype=np.uint8).tobytes() + text[6000:11000], np.uint8)
    buf, cap, min_pos, inend_real = seed.master_buffer(data, 0, len(data))
    core = seed.make_seed_core(cap, MB)
    parsed = core.parse(torch.from_numpy(buf), min_pos, inend_real)
    host = core.finish(parsed)
    dev = core.finish_resident(parsed)
    assert int(host[1]) > 1 and int(dev[1]) == host[1]
    assert int(dev[-1][ds.S_OVERFLOW]) == 0
    for i, (h, d) in enumerate(zip(host, dev[:-1])):
        if i == 1:
            continue
        assert torch.equal(torch.as_tensor(h), d), i


ITERATIONS = 2


def _mixed(seed_: int, n: int) -> bytes:
    rng = np.random.default_rng(seed_)
    words = [b"compress ", b"every ", b"block ", b"of ", b"the ",
             b"input\n", b"{\"key\": ", b"42}, "]
    text = b"".join(words[i] for i in rng.integers(0, len(words), n // 5))
    noise = rng.integers(0, 256, n // 6, dtype=np.uint8).tobytes()
    runs = b"\x00" * (n // 10) + bytes(range(256)) * 4
    third = n // 3
    return (text[:third] + noise + runs + text[third:])[:n]


SMALL = _mixed(9, 12000)


@pytest.fixture()
def mega_on(monkeypatch):
    monkeypatch.setenv("ZT_MEGA", "1")
    for knob in ("ZT_SEED", "ZT_FETCH_CAP", "ZT_REPLICAS"):
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setattr(mega, "MEGA_MIN", 1000)


def test_verify_failure_drops_the_device_split_decision(mega_on, monkeypatch):
    arr = np.frombuffer(SMALL[:6000], np.uint8)
    verify = mega.MegaResult.verify_parse
    monkeypatch.setattr(mega.MegaResult, "verify_parse",
                        lambda self, b, lit, dist: b != 0 and verify(
                            self, b, lit, dist))
    fails = squeeze_batched.VERIFY_FAILS[0]
    entry = squeeze_batched.devseed_dispatch(arr, [(0, len(arr))],
                                             ITERATIONS, MB, device="cpu")
    assert entry[2] is None and entry[4][0] is not None
    (res,) = squeeze_batched.devseed_collect(entry, ITERATIONS)
    assert squeeze_batched.VERIFY_FAILS[0] == fails + 1
    assert res[0] == "stores" and res[2] is None
    lz77 = concat_stores(res[1])
    assert lz77.byte_range(0, lz77.size) == len(arr)


def test_wide_key_second_split_equals_host(mega_on, monkeypatch):
    """ZT_REPLICAS=4: nb_pad is 128, past the JAX key's 64 lane blocks,
    though the blocks and their replicas fill fewer than 64 here; the
    device's second split and both cost totals equal the host's on the
    collected stores."""
    monkeypatch.setenv("ZT_REPLICAS", "4")
    kept = []
    finish = mega.mega_finish
    monkeypatch.setattr(mega, "mega_finish",
                        lambda h: kept.append(finish(h)) or kept[-1])
    assert mega.lane_geometry(16384, MB, 4)[1] == 128
    arr = np.frombuffer(SMALL, np.uint8)
    entry = squeeze_batched.devseed_dispatch(arr, [(0, len(arr))],
                                             ITERATIONS, MB, device="cpu")
    (res,) = squeeze_batched.devseed_collect(entry, ITERATIONS)
    stores = res[1]
    assert len(stores) > 2 and res[2] is not None
    assert kept[0].nb < kept[0].nb_total < 64
    lz77 = concat_stores(stores)
    sp = blocks.block_split_lz77(lz77, MB)
    tc1 = sum(blocks.calculate_block_size_auto_type(st, 0, st.size)
              for st in stores)
    b2 = [0] + sp + [lz77.size]
    tc2 = sum(blocks.calculate_block_size_auto_type(lz77, b2[i], b2[i + 1])
              for i in range(len(b2) - 1))
    assert res[2] == (sp, int(tc1), int(tc2))
