"""The formulation of the two cost kernels (csrc/hist_cost.cu), on the CPU.

The kernels run only on a card.  Here:
  - autotype_costs (the plain version on a CPU tensor) against the JAX
    package's autotype_costs on edge ranges of a real stream: ends on and
    beside checkpoint boundaries, at nsym and at ncap, empty and reversed
    ranges, ranges inside one checkpoint, both fixed-cost gates;
  - numpy mirrors of what the kernels compute differently from the plain
    cost stack, held equal to it: the key sort (bitonic chunks, then merge
    rounds by rank), package-merge with fixed-step searches and package
    sums built by adding each item into its pair, RleOptimize as one
    boundary chain plus a fill from prefix sums, and the tree header
    counted by runs in closed form."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zopfli_tpu.ops import devsplit as jds
from zopfli_tpu_torch import native, spec
from zopfli_tpu_torch.ops import costmodel as cm
from zopfli_tpu_torch.ops import devsplit as ds

# The tensors here are tiny: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

INF = 1 << 29
SENT = 0x7FFFFFFF


# ---------------------------------------------------------------------------
# Numpy mirrors of the kernel's formulation.
# ---------------------------------------------------------------------------

def lower_bound_steps(a, target, R):
    """# of a[0..R) below target (a ascending, R a power of two), as the
    kernel searches: fixed steps R/2, ..., 1, then 1 again."""
    steps, st = [], R // 2
    while st >= 1:
        steps.append(st)
        st //= 2
    pos = 0
    for s in steps + [1]:
        if a[pos + s - 1] < target:
            pos += s
    return pos


def bitonic32(v):
    """The warp's bitonic network: lane l keeps the min of (l, l^j) when
    its bit j agrees with the direction bit k."""
    v = list(v)
    k = 2
    while k <= 32:
        j = k // 2
        while j > 0:
            o = [v[lane ^ j] for lane in range(32)]
            v = [min(v[lane], o[lane])
                 if ((lane & j) == 0) == ((lane & k) == 0)
                 else max(v[lane], o[lane]) for lane in range(32)]
            j //= 2
        k *= 2
    return v


def team_sort(keys):
    """Sorts R unique keys: 32-key chunks by the bitonic network, then
    merge rounds that place each key at its index plus its rank in the
    partner run."""
    R = len(keys)
    a = []
    for c in range(R // 32):
        a += bitonic32(keys[c * 32:(c + 1) * 32])
    run = 32
    while run < R:
        b = [None] * R
        for idx in range(R):
            r = idx // run
            base = (r ^ 1) * run
            dst = (r & ~1) * run + (idx - r * run)
            b[dst + lower_bound_steps(a[base:base + run], a[idx], run)] = \
                a[idx]
        a, run = b, run * 2
    return a


def pm_mirror(cnt, maxbits, log):
    """Length-limited code lengths as the kernel computes them."""
    N, R = len(cnt), 1 << log
    cnt = [int(c) for c in cnt]
    keys = [((min(c, INF) if c else INF) << 9) | i
            for i, c in enumerate(cnt + [0] * (R - N))]
    keys = team_sort(keys)
    leaf = [k >> 9 for k in keys]
    order = [k & 511 for k in keys]
    m = sum(1 for c in cnt if c)
    lengths = [0] * N
    if m <= 2:
        for r in range(m):
            lengths[order[r]] = 1
        return lengths
    mb = min(m - 1, maxbits)
    pkg = [min(leaf[2 * q] + leaf[2 * q + 1], INF) if 2 * q + 1 < m else INF
           for q in range(R)]
    size, sizes, pfx = m, {0: m}, {}
    for level in range(1, mb):
        np_ = size // 2
        size = np_ + m
        sizes[level] = size
        nxt = [0 if q < size // 2 else INF for q in range(R)]
        pf = [0] * (size + 1)
        for k in range(size):
            if k < np_:
                w = min(pkg[k], INF)
                pos = lower_bound_steps(leaf, w, R)
                at = k + pos
                pf[at + 1] = pos
            else:
                l = k - np_
                w = leaf[l]
                pos = lower_bound_steps(pkg, w + 1, R)
                at = l + pos
                pf[at + 1] = l + 1
            nxt[at >> 1] += w
        pfx[level] = pf
        pkg = nxt
    take, taken = 2 * m - 2, {}
    for level in range(mb - 1, -1, -1):
        take = min(take, sizes[level])
        lt = take if level == 0 else pfx[level][take]
        taken[level] = lt
        take = 2 * (take - lt)
    for r in range(m):
        lengths[order[r]] = sum(r < taken[lv] for lv in range(mb))
    return lengths


def _runs(vals, n):
    """Start of each maximal run of equal values in vals[0..n)."""
    return [i for i in range(n) if i == 0 or vals[i] != vals[i - 1]]


def rle_mirror(cnt):
    """RleOptimize as the kernel computes it: good runs, one boundary
    chain (a boundary iff (unsigned)(v - limit) > 6), a fill from
    prefix sums."""
    N = len(cnt)
    c = [int(x) for x in cnt] + [0]
    nz = [i for i in range(N) if c[i]]
    length = nz[-1] + 1 if nz else 0
    if length == 0:
        return c[:N]
    starts = _runs(c, N)
    v, lim = [SENT] * (length + 1), [0] * (length + 1)
    for i in range(length):
        a = max(s for s in starts if s <= i)
        e = min([s for s in starts if s > i] + [N])
        good = e - a >= (5 if c[i] == 0 else 7)
        v[i] = SENT if good else c[i] + 3
        lim[i] = ((c[i] + c[i + 1] + c[i + 2] + c[i + 3] + 2) >> 2
                  if i < length - 3 else c[i])
    limit, bounds, P, s = c[0], [], [], 0
    for i in range(length + 1):
        if ((v[i] - limit) & 0xFFFFFFFF) > 6:
            limit = lim[i]
            bounds.append(i)
        P.append(s)
        s += c[i]
    out = c[:N]
    for i in range(length):
        a = max([x for x in bounds if x <= i], default=0)
        e = min(x for x in bounds if x > i)
        stride, ssum = e - a, P[e] - P[a]
        if stride >= 4 or (stride >= 3 and ssum == 0):
            out[i] = 0 if ssum == 0 else max(1, (ssum + stride // 2) // stride)
    return out


def tree_size_mirror(ll, d):
    """Best of the 8 header variants, each counted over runs of equal
    code lengths in closed form; the 19-symbol merge by pm_mirror."""
    ll, d = [int(x) for x in ll], [int(x) for x in d]
    hlit = max([i + 1 for i in range(29) if ll[257 + i]], default=0)
    hdist = max([i + 1 for i in range(29) if d[1 + i]], default=0)
    hlit2 = hlit + 257
    total = hlit2 + hdist + 1
    J = [ll[k] if k < hlit2 else d[k - hlit2] for k in range(total)]
    starts = _runs(J, total)
    best = None
    for v in range(8):
        u16, u17, u18 = v & 1, v & 2, v & 4
        clc = [0] * 19
        for idx, k in enumerate(starts):
            e = starts[idx + 1] if idx + 1 < len(starts) else total
            rem, sym = e - k, J[k]
            own = rem
            if u16 or (sym == 0 and (u17 or u18)):
                if sym == 0 and rem >= 3:
                    if u18:
                        q, r = divmod(rem, 138)
                        clc[18] += q + (r >= 11)
                        rem = 0 if r >= 11 else r
                    if u17:
                        q, r = divmod(rem, 10)
                        clc[17] += q + (r >= 3)
                        rem = 0 if r >= 3 else r
                lit = 0
                if u16 and rem >= 4:
                    q, r = divmod(rem - 1, 6)
                    clc[16] += q + (r >= 3)
                    rem = 0 if r >= 3 else r
                    lit = 1
                own = lit + rem
            clc[sym] += own
        clcl = pm_mirror(clc, 7, 5)
        hclen = max([i + 1 for i in range(15) if clc[spec.CL_ORDER[i + 4]]],
                    default=0)
        size = (14 + (hclen + 4) * 3
                + sum(clcl[i] * clc[i] for i in range(19))
                + clc[16] * 2 + clc[17] * 3 + clc[18] * 7)
        best = size if best is None else min(best, size)
    return best


# ---------------------------------------------------------------------------
# Rows.
# ---------------------------------------------------------------------------

def _rows(case):
    """(ll (B, 288), d (B, 32)) int64 rows of one kind."""
    rng = np.random.default_rng({"hists0": 0, "hists1": 1, "edges": 2}[case])
    if case != "edges":
        B = 6
        ll = rng.integers(0, 3000, (B, 288)) * (rng.random((B, 288)) < 0.5)
        d = rng.integers(0, 500, (B, 32)) * (rng.random((B, 32)) < 0.6)
        ll[0] = rng.integers(0, 2, 288)            # tiny / flat
        ll[1] = rng.integers(0, 1 << 18, 288)      # large counts
        base = rng.integers(50, 2000)              # slow ramp: long
        ll[2] = np.maximum(base + np.cumsum(rng.integers(-2, 3, 288)), 0)
        d[3] = 0                                   # no distance
        d[4] = 0
        d[4, 5] = 3                                # one distance code
    else:
        ll = np.zeros((6, 288), np.int64)          # all zero
        d = np.zeros((6, 32), np.int64)
        ll[1, 65] = 9                              # one symbol
        d[1, 3] = 1
        ll[2, [1, 270]] = [4, 5]                   # two symbols
        ll[3] = rng.integers(1, 100, 288)          # all nonzero
        d[3] = rng.integers(1, 100, 32)            # incl. 30 and 31
        ll[4] = 7                                  # long equal runs
        ll[4, 100:140] = 0
        ll[4, 200:230] = 12
        d[4] = 3
        ll[5] = np.repeat(rng.integers(0, 6, 36), 8)
        d[5] = np.repeat(rng.integers(0, 3, 8), 4)
    if case != "edges":
        ll[:, 286:] = 0
        d[:, 30:] = 0
    ll[:, 256] = 1          # as the cost stack pins the end symbol
    return ll.astype(np.int64), d.astype(np.int64)


CASES = ["hists0", "hists1", "edges"]


def test_team_sort_sorts_unique_keys():
    rng = np.random.default_rng(3)
    for R in (32, 64, 512):
        keys = [int(x) for x in rng.choice(1 << 38, R, replace=False)]
        assert team_sort(keys) == sorted(keys)


@pytest.mark.parametrize("case", CASES)
def test_package_merge_mirror_equals_plain(case):
    ll, d = _rows(case)
    rng = np.random.default_rng(4)
    cl = rng.integers(0, 40, (6, 19)) * (rng.random((6, 19)) < 0.7)
    for rows, maxbits, log in ((ll, 15, 9), (d, 15, 5), (cl, 7, 5)):
        want = cm.package_merge(torch.from_numpy(rows), maxbits).numpy()
        got = np.array([pm_mirror(r, maxbits, log) for r in rows])
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", CASES)
def test_rle_mirror_equals_plain(case):
    ll, d = _rows(case)
    for rows in (ll, d):
        want = cm.rle_optimize(torch.from_numpy(rows)).numpy()
        got = np.array([rle_mirror(r) for r in rows])
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", CASES)
def test_tree_size_by_runs_equals_plain(case):
    """Both code-length sets of each row (plain and RleOptimize'd)."""
    ll, d = _rows(case)
    llt, dt = torch.from_numpy(ll), torch.from_numpy(d)
    for opt in (False, True):
        a, b = (cm.rle_optimize(llt), cm.rle_optimize(dt)) if opt \
            else (llt, dt)
        ll_len = cm.package_merge(a, 15)
        d_len = cm.patch_dist_codes(cm.package_merge(b, 15))
        want = cm.tree_size(ll_len, d_len).numpy()
        got = [tree_size_mirror(x, y) for x, y in zip(ll_len.numpy(),
                                                        d_len.numpy())]
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# The range entry's plain version against the JAX package.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stream():
    rng = np.random.default_rng(21)
    words = [b"alpha ", b"beta ", b"gamma ", b"delta "]
    text = b"".join(words[i] for i in rng.integers(0, 4, 2000))
    data = np.frombuffer(rng.integers(0, 256, 1500, dtype=np.uint8).tobytes()
                         + text[:6000] + b"\x00" * 900, np.uint8)
    gl, gd = native.greedy(data, 0, len(data))
    n = len(gl)
    ncap = ds.CKPT
    while ncap < n + 1:
        ncap *= 2
    ll = np.zeros(ncap, np.int32)
    dd = np.zeros(ncap, np.int32)
    ll[:n] = gl
    dd[:n] = gd
    ll_sym, d_sym, nbytes = ds.stream_symbols(
        torch.from_numpy(ll), torch.from_numpy(dd), ncap, n)
    tabs = ds.checkpoints(ll_sym, d_sym, nbytes, ncap, n)
    return n, ncap, ll_sym, d_sym, tabs


@pytest.mark.parametrize("small_store", [True, False, "per_block"])
def test_autotype_costs_plain_matches_jax_on_edge_ranges(stream,
                                                         small_store):
    n, ncap, ll_sym, d_sym, (ll_ck, d_ck, bcum) = stream
    assert n > 3 * ds.CKPT
    edges = [0, 1, 255, 256, 257, 511, 512, 513, n - 1, n, ncap - 1, ncap]
    a = [x for x in edges for _ in edges] + [300, 770, 769]
    b = [y for _ in edges for y in edges] + [310, 1000, 1023]  # in one ckpt
    a = np.asarray(a, np.int64)
    b = np.asarray(b, np.int64)
    assert (b <= a).any() and (b == ncap).any()
    jgate = small_store
    if small_store == "per_block":   # the per-block-store rule
        gate = np.random.default_rng(5).random(len(a)) < 0.5
        small_store, jgate = torch.from_numpy(gate), jnp.asarray(gate)
    got = ds.autotype_costs(ll_ck, d_ck, ll_sym, d_sym, bcum,
                            torch.from_numpy(a), torch.from_numpy(b), ncap,
                            small_store)
    np.testing.assert_array_equal(
        got.numpy(),
        ds.autotype_costs_plain(ll_ck, d_ck, ll_sym, d_sym, bcum,
                                torch.from_numpy(a), torch.from_numpy(b),
                                ncap, small_store).numpy())
    j32 = [jnp.asarray(t.numpy().astype(np.int32))
           for t in (ll_ck, d_ck, ll_sym, d_sym, bcum)]
    want = jds.autotype_costs(j32[0], j32[1], j32[2], j32[3], j32[4],
                              jnp.asarray(a.astype(np.int32)),
                              jnp.asarray(b.astype(np.int32)), ncap,
                              jgate)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy()[b <= a] == ds.BIG).all()
