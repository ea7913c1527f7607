"""The port's device block split against the JAX package's and the host
splitter.

The same greedy LZ77 streams go through zopfli_tpu.ops.devsplit (one
jitted program on the CPU), the port's ops.devsplit (the split_search
kernel's plain version on CPU tensors: split_step_plain and the plain
cost stack in turn) and the port's host splitter
blocks.block_split_lz77.  Split points must be equal; the histogram and
cost helpers bit-equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zopfli_tpu.ops import devsplit as jds
from zopfli_tpu_torch import blocks, native
from zopfli_tpu_torch.lz77 import LZ77Store
from zopfli_tpu_torch.ops import devsplit as ds

# The tensors here are tiny: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

# One capacity bucket for every stream: the JAX program compiles once
# (results are capacity-independent, tests/test_blocks.py).
FLOOR = 16384


def _cases():
    rng = np.random.default_rng(1234)
    words = [b"alpha ", b"beta ", b"gamma ", b"delta "]
    text = b"".join(words[i] for i in rng.integers(0, 4, 30000))
    # The four inputs of tests/test_blocks.py::test_device_split_matches_host.
    cases = {
        "text60k": np.frombuffer(text[:60000], np.uint8),
        "zeros_text_z": np.frombuffer(
            b"\x00" * 5000 + text[:20000] + b"z" * 4000, np.uint8),
        "random12k": rng.integers(0, 256, 12000, dtype=np.uint8),
        "tiny": np.frombuffer(text[:300], np.uint8),
    }
    # A stream past LINEAR_MAX symbols whose segments split.
    mixed = (rng.integers(0, 256, 600, dtype=np.uint8).tobytes()
             + text[:3000] + bytes(range(256)) * 2
             + rng.integers(0, 4, 400, dtype=np.uint8).tobytes())
    cases["mixed_past_linear"] = np.frombuffer(mixed, np.uint8)
    return cases


CASES = _cases()


@pytest.fixture(scope="module")
def streams():
    return {name: native.greedy(data, 0, len(data))
            for name, data in CASES.items()}


def test_mixed_stream_goes_past_linear_max(streams):
    assert len(streams["mixed_past_linear"][0]) > ds.LINEAR_MAX


@pytest.mark.parametrize("name", sorted(CASES))
def test_device_split_matches_jax_and_host(streams, name):
    gl, gd = streams[name]
    data = CASES[name]
    host = blocks.block_split_lz77(LZ77Store(data, gl, gd, 0), 15)
    port = ds.block_split_lz77_device(gl.astype(np.int32),
                                      gd.astype(np.int32), 15, floor=FLOOR,
                                      device="cpu")
    ref = jds.block_split_lz77_device(gl.astype(np.int32),
                                      gd.astype(np.int32), 15, floor=FLOOR)
    assert port == ref == host, (port, ref, host)


def test_prefix_hist_and_autotype_costs_bit_equal(streams):
    """Both packages' helpers on the same stream, checkpoints and random
    ranges (the JAX helpers run eagerly, op by op)."""
    gl, gd = streams["zeros_text_z"]
    n = len(gl)
    ncap = 1024
    ll = np.zeros(ncap, np.int32)
    dd = np.zeros(ncap, np.int32)
    ll[:n] = gl
    dd[:n] = gd
    ll_sym, d_sym, nbytes = ds.stream_symbols(
        torch.from_numpy(ll), torch.from_numpy(dd), ncap, n)
    jsym = jds.stream_symbols(jnp.asarray(ll), jnp.asarray(dd), ncap,
                              jnp.int32(n))
    for ours, theirs in zip((ll_sym, d_sym, nbytes), jsym):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    ll_ck, d_ck, bcum = ds.checkpoints(ll_sym, d_sym, nbytes, ncap, n)
    # Checkpoints against a direct count of the stream's symbols.
    ls, dsy = ll_sym.numpy()[:n], d_sym.numpy()[:n]
    for j in range(ncap // ds.CKPT + 1):
        end = min(j * ds.CKPT, n)
        np.testing.assert_array_equal(
            ll_ck[j].numpy(), np.bincount(ls[:end], minlength=288))
        np.testing.assert_array_equal(
            d_ck[j].numpy(),
            np.bincount(dsy[:end][dsy[:end] >= 0], minlength=32))
    jck = [jnp.asarray(t.numpy().astype(np.int32))
           for t in (ll_ck, d_ck, bcum)]
    jll_sym, jd_sym = (jnp.asarray(t.numpy().astype(np.int32))
                       for t in (ll_sym, d_sym))

    rng = np.random.default_rng(8)
    pts = np.concatenate([[0, n, ncap, ds.CKPT, ds.CKPT - 1],
                          rng.integers(0, ncap + 1, 27)]).astype(np.int32)
    got = ds.prefix_hist_at(ll_ck, d_ck, ll_sym, d_sym,
                            torch.from_numpy(pts), ncap)
    want = jds.prefix_hist_at(jck[0], jck[1], jll_sym, jd_sym,
                              jnp.asarray(pts), ncap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    a = rng.integers(0, n + 1, 24).astype(np.int32)
    b = rng.integers(0, n + 1, 24).astype(np.int32)
    a[:4] = [0, 0, 5, n]          # whole stream, a tiny block, empty ones
    b[:4] = [n, 3, 5, n]
    # The per-block fixed-cost gate, both ways (the scalar gate is the
    # split's own call, held by the split tests).
    gate = rng.random(24) < 0.5
    got = ds.autotype_costs(ll_ck, d_ck, ll_sym, d_sym, bcum,
                            torch.from_numpy(a), torch.from_numpy(b), ncap,
                            torch.from_numpy(gate))
    want = jds.autotype_costs(jck[0], jck[1], jll_sym, jd_sym, jck[2],
                              jnp.asarray(a), jnp.asarray(b), ncap,
                              jnp.asarray(gate))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_split_counts_rounds_and_syncs(streams):
    """One search, one read of its result; its rounds come from the
    search's final state."""
    gl, gd = streams["text60k"]
    before = dict(ds.STATS)
    ds.block_split_lz77_device(gl.astype(np.int32), gd.astype(np.int32), 15,
                               device="cpu")
    rounds = ds.STATS["rounds"] - before["rounds"]
    assert ds.STATS["searches"] == before["searches"] + 1
    assert rounds > 0 and ds.STATS["syncs"] - before["syncs"] == 1


def _search_stream(name):
    """(litlens, dists) int32: under 10 symbols (no round), two runs of
    60 symbols the split separates with linear rounds only, and 1100
    random literals past LINEAR_MAX (probe rounds).  Small: every linear
    round of the JAX program costs its 2047 ranges."""
    rng = np.random.default_rng(77)
    if name == "under_10":
        return rng.integers(0, 256, 7).astype(np.int32), np.zeros(7, np.int32)
    if name == "probe":
        return (rng.integers(0, 256, 1100).astype(np.int32),
                np.zeros(1100, np.int32))
    runs = [(rng.integers(0, 4, 60), np.zeros(60, np.int64)),
            (rng.integers(100, 258, 60), rng.integers(1, 4000, 60))]
    return tuple(np.concatenate(p).astype(np.int32) for p in zip(*runs))


@pytest.mark.parametrize("name", ["under_10", "linear_only", "probe"])
def test_search_equals_jax_split(name):
    """The plain search (split_search on CPU tensors), capped at N_MAX
    steps, against the JAX package's split_lz77_device on the same
    stream: the same split points (none for the random literals, whose
    probe rounds reject the split), no overflow, rounds only where the
    stream has 10 symbols or more."""
    lit, dist = _search_stream(name)
    n = len(lit)
    ll = np.zeros(FLOOR, np.int32)
    dd = np.zeros(FLOOR, np.int32)
    ll[:n] = lit
    dd[:n] = dist
    nsym = torch.tensor(n)
    tabs = ds._tables(torch.from_numpy(ll), torch.from_numpy(dd), FLOOR,
                      nsym)
    state = ds.split_search(tabs, nsym, FLOOR, 15, steps=ds.n_max(15, FLOOR))
    jsp, jnpts = jds.split_lz77_device(jnp.asarray(ll), jnp.asarray(dd),
                                       FLOOR, 15, jnp.int32(n))
    npts = int(state[ds.S_NPTS])
    assert npts == int(jnpts)
    assert (state[ds.S_HEAD:ds.S_HEAD + 15].tolist()
            == np.where(np.arange(15) < npts, np.asarray(jsp),
                        FLOOR + 1).tolist())
    assert int(state[ds.S_OVERFLOW]) == 0 and int(state[ds.S_FINISHED])
    rounds = int(state[ds.S_ROUNDS])
    assert rounds > 0 if n >= 10 else rounds == npts == 0
