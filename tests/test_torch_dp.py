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


# ---------------------------------------------------------------------------
# Numpy mirrors of the two CUDA designs' schedules.
# ---------------------------------------------------------------------------

_BANDS = 8
_GATE = 16
_F32 = np.float32


def _key(v, src, k):
    """dp_scan's 64-bit relaxation keys (uint64): the f32 value mapped to
    an unsigned that orders as f32 < does (-0.0 and 0.0 tied), then the
    source + 1, the value's sign bit and the breakpoint index."""
    v = np.asarray(v, np.float32)
    u = (v + np.float32(0.0)).view(np.uint32).astype(np.uint64)
    ordv = np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    sign = (v.view(np.uint32) >> 31).astype(np.uint64)
    src1 = (np.asarray(src, np.int64) + 1).astype(np.uint64)
    return (ordv << 32 | src1 << 5 | sign << 4
            | np.asarray(k, np.int64).astype(np.uint64))


def _unkey(x, q):
    """(value, edge) of keys x at positions q; BIG and 0 for an empty slot."""
    x = np.asarray(x, np.uint64)
    ordv, lo = x >> 32, x & 0xFFFFFFFF
    u = np.where(ordv & 0x80000000, ordv & 0x7FFFFFFF, ~ordv & 0xFFFFFFFF)
    v = (u | (lo >> 4 & 1) << 31).astype(np.uint32).view(np.float32)
    src = (lo >> 5).astype(np.int64) - 1
    return v, np.where(src < 0, 0, (q - src) | (lo & 15).astype(np.int64) << 9)


def _band_scan(bl, bd, bdc, lit, lcost, mask, rng):
    """Numpy mirror of one row of csrc/dp_scan.cu, in a random order of
    its warps' steps.

    Bands 1..7 (lengths 3+32w..34+32w) relax, each as soon as a source's
    cost is final and at a random lag behind, into one window of packed
    keys by minimum (the kernel's shared atomicMin); masked sources and
    sources whose longest breakpoint falls short of a band are skipped.
    The chain (warp 0) relaxes band 0 from position p in order with
    strict <, then finalizes p+1 from the decoded key (taken every 16
    steps, once each band has relaxed every source that reaches those
    positions), band 0 and the literal, each with strict <.  An edge is
    (length, breakpoint index); the writer takes the distance from
    bp_dist at the source.  Positions past the last real one are decoded
    at the end, not stepped."""
    L, K = bl.shape
    big = _F32(sk.BIG)
    real = mask.astype(bool)
    last = int(np.nonzero(real)[0][-1]) if real.any() else -1
    # Prepared rows: the breakpoints that raise the prefix maximum.
    raise_hi, raise_k = [], []
    for p in range(L):
        pm, his, ks = 2, [], []
        for k in range(K):
            if bl[p, k] > pm:
                his.append(min(int(bl[p, k]), 258))
                ks.append(k)
                pm = int(bl[p, k])
        raise_hi.append(np.array(his, np.int64))
        raise_k.append(np.array(ks, np.int64))
    hmax = np.array([h[-1] if len(h) and real[p] else 0
                     for p, h in enumerate(raise_hi)])
    plit = np.where(real, lit, big).astype(_F32)

    def band_edges(p, lengths):
        """(edge cost, edge) of the lengths at p; edge 0 = not relaxed."""
        e = np.searchsorted(raise_hi[p], lengths, side="left")
        cov = (e < len(raise_hi[p])) & real[p] & (lengths <= L - p)
        e = np.minimum(e, max(len(raise_hi[p]) - 1, 0))
        dc = bdc[p, raise_k[p][e]] if len(raise_hi[p]) else 0
        ec = np.where(cov, (lcost[lengths - 3] + dc).astype(_F32), 0)
        ek = raise_k[p][e] if len(raise_hi[p]) else np.zeros_like(lengths)
        return ec.astype(_F32), np.where(cov, lengths | ek << 9, 0), ek

    key0 = int(_key(big, -1, 0))
    kw = np.full(L + 260, key0, np.uint64)        # bands 1..7
    w0v = np.full(L + 260, big, _F32)             # band 0
    w0m = np.zeros(L + 260, np.int64)
    ov = np.full(L + 1, big, _F32)
    om = np.zeros(L + 1, np.int64)
    ov[0] = 0
    fin = 1                        # positions < fin are final
    done = [0] * _BANDS            # sources relaxed, bands 1..7
    gv = gm = None
    p = 0

    def band_step(w):
        j = done[w]
        lmin = 3 + 32 * w
        if hmax[j] >= lmin:
            lengths = np.arange(lmin, lmin + 32)
            ec, em, ek = band_edges(j, lengths)
            on = em != 0
            keys = _key((ov[j] + ec).astype(_F32), j, ek)
            np.minimum.at(kw, j + lengths[on], keys[on])
        done[w] += 1

    while p <= last or any(done[w] <= last for w in range(1, _BANDS)):
        q = p + 1
        chain_ok = p <= last
        if chain_ok and p % _GATE == 0:
            qmax = min(p + _GATE, last + 1)
            chain_ok = all(done[w] >= qmax - 2 - 32 * w
                           for w in range(1, _BANDS))
        bands = [w for w in range(1, _BANDS)
                 if done[w] <= last and done[w] < fin]
        if chain_ok and (not bands or rng.random() < 0.4):
            if p % _GATE == 0:
                qs = np.arange(q, min(p + _GATE, last + 1) + 1)
                gv, gm = _unkey(kw[qs], qs)
                kw[qs] = key0
            cp = ov[p]
            ec, em, _ = band_edges(p, np.arange(3, 35))
            nw = (cp + np.where(em != 0, ec, big)).astype(_F32)
            t = p + np.arange(3, 35)
            upd = nw < w0v[t]
            w0v[t[upd]] = nw[upd]
            w0m[t[upd]] = em[upd]
            bv, bm = gv[p % _GATE], gm[p % _GATE]
            if w0v[q] < bv:
                bv, bm = w0v[q], w0m[q]
            ln = _F32(cp + plit[p])
            if ln < bv:
                bv, bm = ln, 1
            ov[q], om[q] = bv, bm
            fin, p = q + 1, q
        elif bands:
            band_step(bands[rng.integers(len(bands))])
    for q in range(last + 2, L + 1):
        bv, bm = big, 0
        if q <= last + 258:
            bv, bm = _unkey(kw[q:q + 1], q)
            bv, bm = bv[0], bm[0]
            if w0v[q] < bv:
                bv, bm = w0v[q], w0m[q]
        ov[q], om[q] = bv, bm
    cl = (om & 511).astype(np.int32)
    src = np.maximum(np.arange(L + 1) - cl, 0)
    cd = np.where(cl >= 3, bd[np.minimum(src, L - 1), om >> 9], 0)
    cl[0] = cd[0] = 0
    return cl, cd.astype(np.int32), ov[1:].copy()


def _band_case(case):
    """(bl, bd, dcost, lit, lcost, mask) rows for a _band_scan case."""
    rng = np.random.default_rng(
        {"fixed": 41, "stat": 42, "grid": 43, "random_bp": 44,
         "zeros": 45, "random_grid": 46, "random_zeros": 47}[case])
    if case in ("random_bp", "random_grid", "random_zeros"):
        B, L, K = 2, 1200, jhm.MAX_BP
        bl = rng.integers(0, 300, (B, L, K))
        bl = np.where(rng.random(bl.shape) < 0.3, 0, bl)
        bl = np.where(rng.random(bl.shape) < 0.2, bl[:, :, :1], bl)
        bl = bl.astype(np.int32)
        bd = rng.integers(1, 32769, (B, L, K)).astype(np.int32)
        dcost = rng.uniform(1, 20, (B, L, K)).astype(np.float32)
        lit = rng.uniform(1, 12, (B, L)).astype(np.float32)
        lcost = rng.uniform(1, 10, (B, 256)).astype(np.float32)
        mask = np.arange(L)[None, :] < np.array([L, 0])[:, None]
        if case == "random_grid":
            # Long matches at whole-bit costs: relaxations of different
            # bands tie on one position, so the merge order decides.
            dcost, lit, lcost = (np.round(a / 4) for a in (dcost, lit, lcost))
            mask[1] = np.arange(L) < 900
        if case == "random_zeros":
            # Long matches at costs of 0.0 and -0.0: ties between bands
            # whose winners differ only in the sign of zero.
            dcost, lit, lcost = (
                np.where(rng.random(a.shape) < 0.5, -0.0, 0.0).astype(
                    np.float32) for a in (dcost, lit, lcost))
            mask[1] = np.arange(L) < 1000
        return bl, bd, dcost, lit, lcost, mask
    blobs = [_text(51, 1100), _text(52, 1400)]
    bl, bd, block, mask = _rows(blobs)
    ll, dd = _models(rng, 2, "fixed" if case == "fixed" else "stat")
    if case == "grid":
        ll, dd = np.round(ll * 4) / 4, np.round(dd * 4) / 4
    if case == "zeros":
        # Zero costs of both signs: ties everywhere, and -0.0 + -0.0
        # keeps its sign while -0.0 + 0.0 does not.
        ll = np.where(rng.random(ll.shape) < 0.5, -0.0, 0.0)
        dd = np.where(rng.random(dd.shape) < 0.5, -0.0, 0.0)
    ll, dd = ll.astype(np.float32), dd.astype(np.float32)
    _, (lcost, dcost, lit) = _tables(bl, bd, block, ll, dd)
    return bl, bd, dcost, lit, lcost, mask


@pytest.mark.parametrize("case", ["fixed", "stat", "grid", "random_bp",
                                  "random_grid", "zeros", "random_zeros"])
def test_band_schedule_matches_plain_and_jax(case):
    """The dp_scan kernel's order of relaxations changes no bit: its
    numpy mirror equals squeeze_scan_plain and the JAX squeeze_scan on
    rows cut short, all-masked, with unsorted breakpoints and repeats,
    and on the fixed, statistical, 1/4-bit-grid and zero costs."""
    ins = _band_case(case)
    want = [np.asarray(x) for x in jdp.squeeze_scan(
        *(jnp.asarray(a) for a in ins))]
    plain = [x.numpy() for x in dp.squeeze_scan_plain(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in ins))]
    np.testing.assert_array_equal(plain[0], want[0])
    np.testing.assert_array_equal(plain[1], want[1])
    np.testing.assert_array_equal(_bits(plain[2]), _bits(want[2]))
    rng = np.random.default_rng(7)
    bl, bd, dcost, lit, lcost, mask = ins
    for b in range(bl.shape[0]):
        cl, cd, cost = _band_scan(bl[b], bd[b], dcost[b], lit[b], lcost[b],
                                  mask[b], rng)
        np.testing.assert_array_equal(cl, want[0][b])
        np.testing.assert_array_equal(cd, want[1][b])
        np.testing.assert_array_equal(_bits(cost), _bits(want[2][b]))


_LG_C = 512  # rows per chunk of csrc/traceback.cu's large-tile entry


def _streamed_walk(ce, lit, nbytes, chunk=_LG_C):
    """Numpy mirror of zt_traceback_large, vectorised over lanes: chunks
    of `chunk` rows from the tile's last row upwards; every walk steps
    inside the current chunk until it leaves it (or stops: a row of
    length 0, past the tile's start, or never started when
    tile_nbytes > tile), marking the rows it visits; then the chunk's pe
    is the edge on marked rows and 0 elsewhere, and its marked rows add
    their symbols to the lane's histogram."""
    tile, nt = ce.shape
    len_bin, dist_bin = sk.bin_tables(sk.symbol_range_table())
    p = nbytes[0].astype(np.int64).copy()
    p[p > tile] = 0
    pe = np.zeros_like(ce)
    hist = np.zeros((sk.HBINS, nt), np.int64)
    lanes = np.arange(nt)
    for hi in range(tile, 0, -chunk):
        lo = max(0, hi - chunk)
        marks = np.zeros((hi - lo, nt), bool)
        while (p > lo).any():
            idx = np.nonzero(p > lo)[0]
            r = p[idx] - 1 - lo
            v = ce[lo + r, idx]
            marks[r, idx] = True
            ln = v & sk.LEN_MASK
            p[idx] = np.where(ln == 0, 0, p[idx] - ln)
        v = np.where(marks, ce[lo:hi], 0)
        pe[lo:hi] = v
        ln, d = v & sk.LEN_MASK, v >> sk.LEN_BITS
        lane = np.broadcast_to(lanes, v.shape)
        lb = lit[lo:hi]
        m = marks & (ln == 1) & (lb >= 0) & (lb < sk.HBINS)
        np.add.at(hist, (lb[m], lane[m]), 1)
        m = marks & (ln >= 3)
        bins = len_bin[ln[m]]
        np.add.at(hist, (bins[bins >= 0], lane[m][bins >= 0]), 1)
        dm = m & (d >= 0) & (d < len(dist_bin))
        bins = dist_bin[d[dm]]
        np.add.at(hist, (bins[bins >= 0], lane[dm][bins >= 0]), 1)
    return hist.astype(np.float32), pe


def _random_paths(rng, T, L):
    pos = np.arange(1, T + 1)[:, None]
    ln = rng.integers(3, 259, (T, L))
    ce = np.where((rng.random((T, L)) < 0.6) | (ln > pos), 1,
                  ln | (rng.integers(1, 32769, (T, L)) << 9))
    return ce.astype(np.int32), rng.integers(0, 256, (T, L)).astype(np.int32)


def test_streamed_walk_matches_reference_past_16_bits():
    """The large-tile entry's chunked walk at a tile of 70,000 rows (past
    the 16-bit positions of the staged entry's jump table): walks that
    cross chunk boundaries, start mid-chunk, stop on a length-0 row, or
    never start (tile_nbytes > tile), against the JAX package's numpy
    oracle (for the lanes it walks) and traceback_plain."""
    T = 70_000
    rng = np.random.default_rng(23)
    ce, lit = _random_paths(rng, T, 6)
    # Lane 3 meets a length-0 row (with distance bits) on its path.
    _, pe_full = jsk.traceback_reference(ce[:, 3:4], lit[:, 3:4],
                                         np.array([[T]], np.int32))
    rows = np.nonzero(pe_full[:, 0])[0]
    ce[rows[len(rows) // 2], 3] = 5 << 9
    nbytes = np.array([[T, T - 1000, T - 1, T, T + 1, 0]], np.int32)
    hist, pe = _streamed_walk(ce, lit, nbytes)
    want_h, want_pe = jsk.traceback_reference(ce[:, :3], lit[:, :3],
                                              nbytes[:, :3])
    np.testing.assert_array_equal(pe[:, :3], want_pe)
    np.testing.assert_array_equal(hist[:, :3], want_h)
    plain_h, plain_pe = sk.traceback_plain(
        torch.from_numpy(ce), torch.from_numpy(lit),
        torch.from_numpy(nbytes), sk.symbol_range_table())
    np.testing.assert_array_equal(pe, plain_pe.numpy())
    np.testing.assert_array_equal(hist, plain_h.numpy())
    assert pe[rows[len(rows) // 2], 3] == 5 << 9
    assert not pe[:rows[len(rows) // 2], 3].any()
    assert not pe[:, 4:].any() and not hist[:, 4:].any()
