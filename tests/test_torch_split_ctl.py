"""The block-split search under device control, on the CPU.

The port's ops.devsplit runs ZopfliBlockSplitLZ77 two ways: with its
control on the host (split_lz77_device, the default path's; held equal to
the JAX splitter and the host splitter in tests/test_torch_devsplit.py)
and as a chain of split steps and cost rounds that never reads the device
(split_lz77_resident, the megafused program's).  On CPU tensors a step is
split_step_plain, the plain version of the split_step kernel
(csrc/split_ctl.cu), and a round's costs autotype_costs_plain.  Here the
chain, stepped to its bound N_MAX, must give the host-controlled split
points and never set its overflow flag; the seed program's device-resident
finish must equal its host finish bit for bit.  The megafused program's
second split (ZT_MEGA=1, MEGA_MIN patched to 1000) must equal the host
splitter's on the collected stores at nb_pad 128 (the JAX program's
32-bit stream key holds 64 lane blocks; its assert checks only MB + 1 <=
64), and its decision must be dropped after a verify fallback.  Here the
blocks and replicas fill fewer than 64 lane blocks: the 64-bit key's
order past 64 is held
by tests/test_torch_mega.py::test_stream_offsets_order_past_64_lane_blocks
on the CPU, and in a program run by chip_smoke.py's mega phase ("wide":
90 lane blocks, bytes equal to the two-phase path)."""

import numpy as np
import pytest
import torch

from zopfli_tpu_torch import blocks, native, squeeze_batched
from zopfli_tpu_torch.lz77 import concat_stores
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


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_chain_to_n_max_equals_host_split(name):
    """Every one of the N_MAX steps runs (the steps after the search
    finished, and their cost rounds, must change nothing)."""
    ll, dd, ncap, n = _padded(*STREAMS[name])
    sp, npts = ds.split_lz77_device(ll, dd, ncap, MB, n)
    nsym = torch.tensor(n)
    ll_sym, d_sym, nb = ds.stream_symbols(ll, dd, ncap, nsym)
    ll_ck, d_ck, bcum = ds.checkpoints(ll_sym, d_sym, nb, ncap, nsym)
    tabs = (ll_ck, d_ck, ll_sym, d_sym, bcum)
    state = ds.split_state(MB, ncap, "cpu")
    R = ds.MAX_RANGES
    costs, starts, ends = (torch.zeros(R, dtype=torch.int64)
                           for _ in range(3))
    rows = torch.zeros(R, dtype=torch.bool)
    steps = ds.n_max(MB, ncap)
    finished_at = None
    for k in range(steps):
        before = state.clone()
        ds.split_step(state, nsym, costs, starts, ends, rows, MB, ncap,
                      k == steps - 1)
        if finished_at is not None:
            before[ds.S_COUNT] = 0
            assert torch.equal(state, before), k
        ds.autotype_costs_counted(tabs, starts, ends, rows, state, costs,
                                  ncap)
        if finished_at is None and state[ds.S_FINISHED]:
            finished_at = k
    assert finished_at is not None and finished_at < steps - 1
    assert int(state[ds.S_OVERFLOW]) == 0
    assert int(state[ds.S_NPTS]) == npts
    assert state[ds.S_HEAD:ds.S_HEAD + MB].tolist() == sp
    # split_lz77_resident (the chain with its early stop) agrees.
    sp2, npts2, fin = ds.split_lz77_resident(ll, dd, ncap, MB, nsym,
                                             return_state=True)
    assert sp2.tolist() == sp and int(npts2) == npts
    assert int(fin[ds.S_ROUNDS]) == int(state[ds.S_ROUNDS]) == finished_at


def test_short_chain_sets_overflow_and_raises():
    ll, dd, ncap, n = _padded(*STREAMS["greedy_text"])
    nsym = torch.tensor(n)
    ll_sym, d_sym, nb = ds.stream_symbols(ll, dd, ncap, nsym)
    ll_ck, d_ck, bcum = ds.checkpoints(ll_sym, d_sym, nb, ncap, nsym)
    tabs = (ll_ck, d_ck, ll_sym, d_sym, bcum)
    with pytest.raises(RuntimeError, match="did not finish"):
        ds.split_chain(tabs, nsym, ncap, MB, steps=3)


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


def test_counted_costs_leave_the_rest_untouched():
    ll, dd, ncap, n = _padded(*STREAMS["greedy_text"])
    nsym = torch.tensor(n)
    ll_sym, d_sym, nb = ds.stream_symbols(ll, dd, ncap, nsym)
    ll_ck, d_ck, bcum = ds.checkpoints(ll_sym, d_sym, nb, ncap, nsym)
    tabs = (ll_ck, d_ck, ll_sym, d_sym, bcum)
    rng = np.random.default_rng(9)
    R = ds.MAX_RANGES
    a = torch.from_numpy(rng.integers(0, n, R))
    b = torch.clamp(a + torch.from_numpy(rng.integers(-5, 900, R)), max=n)
    rows = torch.from_numpy(rng.random(R) < 0.5)
    state = ds.split_state(MB, ncap, "cpu")
    state[ds.S_COUNT] = 23
    costs = torch.full((R,), -7, dtype=torch.int64)
    ds.autotype_costs_counted(tabs, a, b, rows, state, costs, ncap)
    want = ds.autotype_costs_plain(*tabs, a[:23], b[:23], ncap, rows[:23])
    assert torch.equal(costs[:23], want)
    assert bool((costs[23:] == -7).all())


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
