"""The megafused program (ZT_MEGA=1) of the port against the JAX package's.

Reference: zopfli_tpu.ops.mega in interpret mode on the CPU, one device
(_LOCAL_MESH pinned to [None]), with MEGA_MIN patched to 1000 on both
sides so that a small master takes the megafused path.  The port:
zopfli_tpu_torch.ops.mega on the CPU (plain versions of every kernel, the
split searches as split_search_plain).  Every MegaResult
field, the collected parses and costs, the device's second-split
decision and the compressed bytes in all three formats must be equal.
The pure pieces (_geometry, _replica_seeds) are also held against the
fused engine's host geometry and seeds; the routing and the fetch-cap
overflow are checked on the port alone (the second split's decision and
the wide stream key in tests/test_torch_split_ctl.py)."""

import importlib
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zopfli_tpu
import zopfli_tpu_torch as zt
from zopfli_tpu import containers as ref_containers
from zopfli_tpu.ops import mega as jmega
from zopfli_tpu_torch import squeeze_batched
from zopfli_tpu_torch.ops import fused_engine, mega

# The tensors here are tiny: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

ITERATIONS = 2
MB = 15
FORMATS = ("gzip", "zlib", "deflate")


def _mixed(seed: int, n: int) -> bytes:
    rng = np.random.default_rng(seed)
    words = [b"compress ", b"every ", b"block ", b"of ", b"the ",
             b"input\n", b"{\"key\": ", b"42}, "]
    text = b"".join(words[i] for i in rng.integers(0, len(words), n // 5))
    noise = rng.integers(0, 256, n // 6, dtype=np.uint8).tobytes()
    runs = b"\x00" * (n // 10) + bytes(range(256)) * 4
    third = n // 3
    return (text[:third] + noise + runs + text[third:])[:n]


DATA = _mixed(5, 40000)        # one master of 6 blocks
SMALL = _mixed(9, 12000)


@pytest.fixture(autouse=True)
def mega_on(monkeypatch):
    """ZT_MEGA=1 and MEGA_MIN 1000 in both packages, the reference on one
    device, the other knobs at their defaults."""
    monkeypatch.setenv("ZT_MEGA", "1")
    for knob in ("ZT_SEED", "ZT_MASTER_SIZE", "ZT_FETCH_CAP",
                 "ZT_REPLICAS", "ZT_REPLICA_CHAOS"):
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setattr(jmega, "MEGA_MIN", 1000)
    monkeypatch.setattr(mega, "MEGA_MIN", 1000)
    monkeypatch.setattr(importlib.import_module("zopfli_tpu.deflate"),
                        "_LOCAL_MESH", [None])


_REF: dict = {}
_OURS: dict = {}


def _captured(mod, monkeypatch, into: dict):
    """Keep the MegaResult that mod.mega_finish builds, and its collect()."""
    finish = mod.mega_finish

    def keeping(handle):
        mr = finish(handle)
        collect = mr.collect
        into["mr"] = mr
        mr.collect = lambda *a: into.setdefault("collect", collect(*a))
        return mr

    monkeypatch.setattr(mod, "mega_finish", keeping)


def _reference(monkeypatch):
    """The JAX package's raw DEFLATE bytes of DATA, its MegaResult and
    that result's collect(), from one compress."""
    if "payload" not in _REF:
        _captured(jmega, monkeypatch, _REF)
        _REF["payload"] = zopfli_tpu.compress(
            DATA, "deflate", zopfli_tpu.Options(engine="tpu",
                                                numiterations=ITERATIONS))
    return _REF


def _ours(fmt: str, monkeypatch):
    """The port's bytes of DATA in `fmt`.  The first call also keeps its
    MegaResult and collect() and the megafused program's handle; later
    formats reuse that handle (the program does not depend on the
    format), the rest of compress runs anew."""
    if fmt not in _OURS:
        dispatch = mega.mega_dispatch
        if "mr" not in _OURS:
            _captured(mega, monkeypatch, _OURS)

        def kept(*a, **k):
            if "handle" not in _OURS:
                _OURS["handle"] = dispatch(*a, **k)
            return _OURS["handle"]

        monkeypatch.setattr(mega, "mega_dispatch", kept)
        _OURS[fmt] = zt.compress(DATA, fmt, zt.Options(
            device="cpu", numiterations=ITERATIONS))
        monkeypatch.setattr(mega, "mega_dispatch", dispatch)
    return _OURS


FIELDS = ("bounds", "seed_ll", "seed_d", "block_costs", "tile_start",
          "tile_nbytes", "tile_block", "nb_total", "replica_of", "split2",
          "all_stored")


@pytest.mark.parametrize("field", FIELDS)
def test_mega_result_field_equals_reference(field, monkeypatch):
    ours = _ours("deflate", monkeypatch)["mr"]
    theirs = _reference(monkeypatch)["mr"]
    a, b = getattr(ours, field), getattr(theirs, field)
    if isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, np.asarray(b))
    else:
        assert a == b


@pytest.mark.parametrize("part", ["parses", "best_cost", "best_sll",
                                  "best_sd"])
def test_mega_collect_equals_reference(part, monkeypatch):
    i = ("parses", "best_cost", "best_sll", "best_sd").index(part)
    ours = _ours("deflate", monkeypatch)["collect"][i]
    theirs = _reference(monkeypatch)["collect"][i]
    if part == "parses":
        assert len(ours) == len(theirs)
        for (ol, od), (tl, td) in zip(ours, theirs):
            np.testing.assert_array_equal(ol, tl)
            np.testing.assert_array_equal(od, td)
    else:
        np.testing.assert_array_equal(ours, np.asarray(theirs))


def test_case_has_blocks_replicas_and_no_overflow(monkeypatch):
    mr = _ours("deflate", monkeypatch)["mr"]
    assert mr.nb >= 4 and mr.nb_total > mr.nb and not mr.all_stored
    assert all(r > 0 for r in mr.search_rounds)
    G, nb_pad = mega.lane_geometry(65536, MB, 2)
    assert len(mr.tile_block) == G * mega.LANES and nb_pad == 64


def _expected(fmt: str, payload: bytes) -> bytes:
    arr = np.frombuffer(DATA, np.uint8)
    if fmt == "gzip":
        return ref_containers.gzip_frame(payload, ref_containers.crc32(arr),
                                         len(DATA))
    if fmt == "zlib":
        return ref_containers.zlib_frame(payload, ref_containers.adler32(arr))
    return payload


@pytest.mark.parametrize("fmt", FORMATS)
def test_mega_compress_bytes_equal_reference(fmt, monkeypatch):
    calls = []
    use_mega = squeeze_batched._use_mega
    monkeypatch.setattr(squeeze_batched, "_use_mega", lambda *a: (
        calls.append(use_mega(*a)) or calls[-1]))
    got = _ours(fmt, monkeypatch)[fmt]
    assert calls == [True] or (fmt == "deflate" and not calls)
    assert got == _expected(fmt, _reference(monkeypatch)["payload"])
    if fmt == "gzip":
        assert zlib.decompress(got, 31) == DATA


def _split_case(seed: int, L: int):
    """A random split of L bytes: (byte_splits (MB,) padded with L, npts,
    ll_h1 (MB+1, 288), d_hist (MB+1, 32)) as the seed program gives them
    (dead blocks count only the end symbol)."""
    rng = np.random.default_rng(seed)
    npts = int(rng.integers(1, MB))
    pts = np.sort(rng.choice(np.arange(1, L), npts, replace=False))
    bs = np.full(MB, L, np.int64)
    bs[:npts] = pts
    ll = np.zeros((MB + 1, 288), np.int64)
    d = np.zeros((MB + 1, 32), np.int64)
    ll[:npts + 1] = rng.integers(0, 50, (npts + 1, 288))
    d[:npts + 1] = rng.integers(0, 20, (npts + 1, 32))
    ll[:, 256] = 1
    return bs, npts, ll, d


@pytest.mark.parametrize("seed,replicas,chaos",
                         [(1, 2, True), (2, 2, True), (3, 4, True),
                          (4, 2, False), (5, 0, True), (6, 3, True)])
def test_geometry_and_seeds_equal_reference_and_host(seed, replicas, chaos,
                                                     monkeypatch):
    L, cap = 16000, 16384
    bs, npts, ll, d = _split_case(seed, L)
    G, nb_pad = mega.lane_geometry(cap, MB, replicas)
    NL = G * mega.LANES
    ours = mega._geometry(torch.from_numpy(bs), torch.tensor(npts), L, MB,
                          NL, nb_pad, replicas)
    theirs = jmega._geometry(jnp.asarray(bs.astype(np.int32)),
                             jnp.int32(npts), jnp.int32(L), cap, MB, NL,
                             nb_pad, replicas)
    for o, t in zip(ours, theirs):
        np.testing.assert_array_equal(o.numpy(), np.asarray(t))
    tabs = mega._perturb_tables(nb_pad)
    seeds = mega._replica_seeds(
        torch.from_numpy(ll), torch.from_numpy(d), ours[5], ours[6],
        *(torch.from_numpy(t) for t in tabs), nb_pad, chaos)
    jseeds = jmega._replica_seeds(
        jnp.asarray(ll.astype(np.int32)), jnp.asarray(d.astype(np.int32)),
        theirs[5], theirs[6], *(jnp.asarray(t) for t in tabs), nb_pad,
        chaos)
    for o, t in zip(seeds, jseeds):
        np.testing.assert_array_equal(o.numpy(), np.asarray(t))

    # The fused engine's host geometry and seeds, where its lane count
    # is the megafused program's.
    monkeypatch.setenv("ZT_REPLICAS", str(replicas))
    monkeypatch.setenv("ZT_REPLICA_CHAOS", "1" if chaos else "0")
    bounds = [0] + [int(x) for x in bs[:npts]] + [L]
    zeros = np.zeros((cap, mega.KBP), np.int32)
    fs = fused_engine.FusedSqueeze(np.zeros(L, np.uint8), [(0, L, bounds)],
                                   device="cpu", cand=[(zeros, zeros)])
    assert fs.ngroups == G
    nt = int(ours[4])
    assert fs.nb_total == nt
    np.testing.assert_array_equal(fs.tile_start, ours[0].numpy())
    np.testing.assert_array_equal(fs.tile_nbytes, ours[1].numpy())
    np.testing.assert_array_equal(fs.tile_block, ours[2].numpy())
    np.testing.assert_array_equal(fs.replica_of, ours[5][:nt].numpy())
    sll, sd, rep_off = fs.initial_stats(ll[:npts + 1], d[:npts + 1])
    np.testing.assert_array_equal(sll[:nt], seeds[0][:nt].numpy())
    np.testing.assert_array_equal(sd[:nt], seeds[1][:nt].numpy())
    np.testing.assert_array_equal(rep_off[:nt], seeds[2][:nt].numpy())


def test_fetch_overflow_round_trips(monkeypatch):
    monkeypatch.setenv("ZT_FETCH_CAP", "64")
    before = fused_engine.FETCH_RETRIES[0]
    out = zt.compress(SMALL, "gzip", zt.Options(device="cpu",
                                                numiterations=ITERATIONS))
    assert zlib.decompress(out, 31) == SMALL
    assert fused_engine.FETCH_RETRIES[0] > before


def _no_mega(*a, **k):
    raise AssertionError("the megafused program was dispatched")


def test_small_and_sharded_masters_stay_two_phase(monkeypatch):
    assert squeeze_batched._use_mega(5000, 0, None)
    assert not squeeze_batched._use_mega(999, 0, None)
    assert not squeeze_batched._use_mega(5000, 0, ["cpu", "cpu"])
    monkeypatch.setattr(mega, "mega_dispatch", _no_mega)
    small = SMALL[:900]
    out = zt.compress(small, "gzip", zt.Options(device="cpu",
                                                numiterations=ITERATIONS))
    assert zlib.decompress(out, 31) == small
    arr = np.frombuffer(SMALL[:4000], np.uint8)
    entry = squeeze_batched.devseed_dispatch(
        arr, [(0, len(arr))], ITERATIONS, MB, device="cpu",
        devices=["cpu", "cpu"])
    assert entry[4] == [None] and len(entry[2].shards) == 2
    res = squeeze_batched.devseed_collect(entry, ITERATIONS)
    assert res[0][0] == "stores" and len(res[0]) == 2
    monkeypatch.setenv("ZT_MEGA", "0")
    assert not squeeze_batched._use_mega(5000, 0, None)


def test_stream_offsets_order_past_64_lane_blocks():
    """Lanes of lane blocks 64 and up: the port's 64-bit key keeps the
    (owner, lane block, tile) order; the JAX program's 32-bit key
    (zopfli_tpu/ops/mega.py:312) gives lane blocks 6 bits and orders
    these lanes otherwise."""
    rng = np.random.default_rng(21)
    NL = 512
    owner = rng.integers(0, 40, NL)
    block = np.where(rng.random(NL) < 0.5, owner, rng.integers(40, 128, NL))
    k = rng.integers(0, 256, NL)
    cnt = rng.integers(0, 300, NL)
    got = mega.stream_offsets(*(torch.from_numpy(x) for x in (owner, block,
                                                              k, cnt)))
    order = np.lexsort((np.arange(NL), k, block, owner))
    want = np.empty(NL, np.int64)
    want[order] = np.cumsum(cnt[order]) - cnt[order]
    np.testing.assert_array_equal(got.numpy(), want)
    jkey = (owner << 16) | (block << 10) | k
    assert not np.array_equal(np.argsort(jkey, kind="stable"), order)
