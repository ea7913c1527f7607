"""The port's block-engine DP (ops/dp.py) against the JAX package's.

The same inputs, made from numpy seeds, go through zopfli_tpu.ops.dp and
zopfli_tpu_torch.ops.dp (its plain version on the CPU); the candidate
tables come from the JAX package's hashmatch.  Every comparison is
exact: integer outputs equal, float32 outputs bit-equal.  Also the K2
contract at a tile too large for the staged CUDA entry (32,768 rows):
traceback_plain against the JAX package's numpy oracle."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zopfli_tpu import spec as jspec
from zopfli_tpu.ops import dp as jdp
from zopfli_tpu.ops import hashmatch as jhm
from zopfli_tpu.ops import scan_kernel as jsk
from zopfli_tpu.ops.engine import _FILLER
from zopfli_tpu_torch.ops import dp
from zopfli_tpu_torch.ops import scan_kernel as sk

# The tensors here are tiny: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

CAP = 2048


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


def _text(seed: int, n: int) -> bytes:
    rng = np.random.default_rng(seed)
    words = [b"min ", b"plus ", b"scan ", b"over ", b"every ", b"block ",
             b"position\n", b"(", b")"]
    text = b"".join(words[i] for i in rng.integers(0, len(words), n))
    return text[:n]


def _rows(blobs, cap=CAP):
    """Candidate tables of each blob as one block row, from the JAX
    package's hashmatch, plus the row's bytes and mask."""
    bl, bd, block, mask = [], [], [], []
    for data in blobs:
        n = len(data)
        buf = np.zeros(jhm.PREFIX + cap + 264, np.uint8)
        buf[:jhm.PREFIX] = _FILLER[:jhm.PREFIX]
        buf[jhm.PREFIX:jhm.PREFIX + n] = np.frombuffer(data, np.uint8)
        l, d, _ = jhm.build_candidates(
            jnp.asarray(buf), cap, jnp.int32(jhm.PREFIX),
            jnp.int32(jhm.PREFIX + n))
        bl.append(np.asarray(l))
        bd.append(np.asarray(d))
        blk = np.zeros(cap, np.int32)
        blk[:n] = np.frombuffer(data, np.uint8)
        block.append(blk)
        mask.append(np.arange(cap) < n)
    return (np.stack(bl), np.stack(bd), np.stack(block), np.stack(mask))


def _models(rng, B, kind):
    if kind == "fixed":
        ll = np.zeros((B, 288), np.float32)
        ll[:, 0:144] = 8
        ll[:, 144:256] = 9
        ll[:, 256:280] = 7
        ll[:, 280:288] = 8
        return ll, np.full((B, 32), 5, np.float32)
    return (rng.uniform(1, 15, (B, 288)).astype(np.float32),
            rng.uniform(1, 12, (B, 32)).astype(np.float32))


def test_dist_symbol_every_distance():
    d = np.arange(1, jspec.WINDOW_SIZE + 1, dtype=np.int32)
    want = np.asarray(jdp.dist_symbol_jax(jnp.asarray(d)))
    got = dp.dist_symbol(torch.from_numpy(d)).numpy()
    np.testing.assert_array_equal(got, want)


def _tables(bl, bd, block, ll, dd):
    dsym = np.asarray(jdp.dist_symbol_jax(jnp.maximum(jnp.asarray(bd), 1)))
    dextra = np.asarray(jdp._DSYM_EXTRA[dsym])
    want = jdp.edge_cost_tables(jnp.asarray(ll), jnp.asarray(dd),
                                jnp.asarray(dsym), jnp.asarray(dextra),
                                jnp.asarray(block))
    tdsym = dp.dist_symbol(torch.from_numpy(bd).clamp(min=1))
    got = dp.edge_cost_tables(
        torch.from_numpy(ll), torch.from_numpy(dd), tdsym,
        torch.from_numpy(dp.DSYM_EXTRA)[tdsym.long()],
        torch.from_numpy(block))
    return [np.array(w) for w in want], [g.numpy() for g in got]


@pytest.mark.parametrize("kind", ["fixed", "stat"])
def test_edge_cost_tables(kind):
    rng = np.random.default_rng(3)
    bl, bd, block, _ = _rows([_text(1, 1500), _text(2, CAP)])
    ll, dd = _models(rng, 2, kind)
    want, got = _tables(bl, bd, block, ll, dd)
    for w, g in zip(want, got):
        assert w.shape == g.shape
        np.testing.assert_array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize("kind", ["fixed", "stat", "grid"])
def test_squeeze_scan_and_traceback(kind):
    """Two rows, one cut short (padding positions), one full; costs of
    the fixed model (integer ties), random ones, and ones on a 1/4-bit
    grid (many ties)."""
    rng = np.random.default_rng({"fixed": 5, "stat": 6, "grid": 7}[kind])
    blobs = [_text(11, 1300), _text(12, CAP)]
    bl, bd, block, mask = _rows(blobs)
    ll, dd = _models(rng, 2, "fixed" if kind == "fixed" else "stat")
    if kind == "grid":
        ll, dd = np.round(ll * 4) / 4, np.round(dd * 4) / 4
    want_t, got_t = _tables(bl, bd, block, ll, dd)
    lcost, bp_dcost, litcost = want_t
    want = [np.asarray(x) for x in jdp.squeeze_scan(
        jnp.asarray(bl), jnp.asarray(bd), jnp.asarray(bp_dcost),
        jnp.asarray(litcost), jnp.asarray(lcost), jnp.asarray(mask))]
    got = [x.numpy() for x in dp.squeeze_scan(
        torch.from_numpy(bl), torch.from_numpy(bd),
        torch.from_numpy(bp_dcost), torch.from_numpy(litcost),
        torch.from_numpy(lcost), torch.from_numpy(mask))]
    assert [g.shape for g in got] == [(2, CAP + 1), (2, CAP + 1), (2, CAP)]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(_bits(got[2]), _bits(want[2]))
    for b, data in enumerate(blobs):
        n = len(data)
        arr = np.frombuffer(data, np.uint8)
        jl, jd = jdp.traceback(want[0][b], want[1][b], n, arr)
        tl, td = dp.traceback(got[0][b], got[1][b], n, arr)
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_array_equal(td, jd)
        assert np.where(td == 0, 1, tl).sum() == n


def test_squeeze_scan_random_breakpoints():
    """Unsorted breakpoint tables with repeats, zeros anywhere and lengths
    past 258: the lowest covering k sets each length's distance."""
    rng = np.random.default_rng(9)
    B, L, K = 3, 700, jhm.MAX_BP
    bl = rng.integers(0, 300, (B, L, K))
    bl = np.where(rng.random(bl.shape) < 0.3, 0, bl)
    bl = np.where(rng.random(bl.shape) < 0.2, bl[:, :, :1], bl)
    bl = bl.astype(np.int32)
    bd = rng.integers(1, 32769, (B, L, K)).astype(np.int32)
    dcost = rng.uniform(1, 20, (B, L, K)).astype(np.float32)
    lit = rng.uniform(1, 12, (B, L)).astype(np.float32)
    lcost = rng.uniform(1, 10, (B, 256)).astype(np.float32)
    mask = np.arange(L)[None, :] < np.array([L, 500, 0])[:, None]
    want = [np.asarray(x) for x in jdp.squeeze_scan(
        *(jnp.asarray(a) for a in (bl, bd, dcost, lit, lcost, mask)))]
    got = [x.numpy() for x in dp.squeeze_scan(
        *(torch.from_numpy(a) for a in (bl, bd, dcost, lit, lcost, mask)))]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(_bits(got[2]), _bits(want[2]))


def test_traceback_plain_large_tile():
    """K2's contract at a tile of 32,768 rows (the staged CUDA entry
    takes at most 17,611; the wrapper picks the large-tile entry there):
    traceback_plain against the JAX package's numpy oracle, on random
    valid paths (literal or match edges that fit), with one lane empty
    and one starting short of the tile's end."""
    T, L = 32768, 3
    rng = np.random.default_rng(17)
    pos = np.arange(1, T + 1)[:, None]
    ln = rng.integers(3, 259, (T, L))
    ce = np.where((rng.random((T, L)) < 0.6) | (ln > pos), 1,
                  ln | (rng.integers(1, 32769, (T, L)) << 9)).astype(np.int32)
    lit = rng.integers(0, 256, (T, L)).astype(np.int32)
    nbytes = np.array([[T, 0, T - 1000]], np.int32)
    want_h, want_pe = jsk.traceback_reference(ce, lit, nbytes)
    hist, pe = sk.traceback_plain(torch.from_numpy(ce),
                                  torch.from_numpy(lit),
                                  torch.from_numpy(nbytes),
                                  sk.symbol_range_table())
    np.testing.assert_array_equal(pe.numpy(), want_pe)
    np.testing.assert_array_equal(hist.numpy(), want_h)
    assert (pe.numpy() != 0).sum(axis=0)[1] == 0
