"""Exact DEFLATE cost stack, batched over blocks, in PyTorch.

Port of zopfli_tpu/ops/costmodel.py.  Computes the exact dynamic-block
bit size (Huffman tree header + symbol payload) from litlen/dist
histograms on the tensors' device, so the squeeze iteration control
(keep-best by exact size, stats feedback, randomization -- reference
squeeze.c:446-526) needs no per-iteration host round trip.

Semantics mirror the reference exactly, in fixed-shape array form:
  - package_merge: length-limited Huffman (katajainen.c) via the
    counting formulation (leaves stable-sorted by (weight, symbol); a
    package precedes an equal-weight leaf).
  - rle_optimize: OptimizeHuffmanForRle (deflate.c:434-518).  The serial
    pass's control flow depends only on the ORIGINAL counts, so it runs
    as a loop emitting non-overlapping range-fill events.
  - tree_size: best of the 8 use_16/17/18 RLE variants (EncodeTree size
    path, deflate.c:105-249) in closed form.
  - hist_dynamic_cost: GetDynamicLengths incl. the tried-and-kept
    RleOptimize variant (deflate.c:525-582); exact integer bits.

Integer work is int64 and exact.  The entropy model's float32 series is
written one operation per line, so no two operations fuse and the
results equal the JAX package's bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import spec
from ..utils.counters import bump
from . import scan_kernel

INF = 1 << 29


def floor_log2(c: torch.Tensor) -> torch.Tensor:
    """Exact floor(log2(c)) of positive integers (31 - clz)."""
    e = torch.zeros_like(c)
    t = c
    for s in (16, 8, 4, 2, 1):
        big = t >= (1 << s)
        e = e + torch.where(big, s, 0)
        t = torch.where(big, t >> s, t)
    return e


# ---------------------------------------------------------------------------
# Package-merge (counting formulation).
# ---------------------------------------------------------------------------

def package_merge(freqs: torch.Tensor, maxbits: int) -> torch.Tensor:
    """Batched exact length-limited Huffman code lengths.

    freqs: (B, n) integers (non-negative; weights far below 2^29).
    Returns (B, n) int64 lengths; zero-frequency symbols get 0.
    """
    B, n = freqs.shape
    dev = freqs.device
    freqs = freqs.long()
    iota_n = torch.arange(n, device=dev)

    used = freqs > 0
    m = used.sum(dim=1)                                   # (B,)
    # Stable sort of leaves by (weight, symbol); unused leaves to the end.
    key = torch.where(used, freqs, INF)
    leaf_w, order = torch.sort(key, dim=1, stable=True)

    eff_max = torch.clamp(m - 1, max=maxbits)             # (B,)

    iota_2n1 = torch.arange(2 * n + 1, device=dev)
    pfx_levels = [torch.minimum(iota_2n1[None, :], m[:, None])]
    size_levels = [m]
    prev_w = torch.cat([leaf_w, torch.full((B, n), INF, device=dev)], dim=1)
    prev_size = m

    is_leaf_tpl = torch.cat([torch.zeros((B, n), dtype=torch.int64,
                                         device=dev),
                             torch.ones((B, n), dtype=torch.int64,
                                        device=dev)], dim=1)
    leaves_padded = torch.cat(
        [torch.full((B, n), INF, device=dev), leaf_w], dim=1)

    for _level in range(1, maxbits):
        pw = torch.clamp(prev_w[:, 0::2] + prev_w[:, 1::2], max=INF)
        cand_w = leaves_padded.clone()
        cand_w[:, :n] = pw
        # Stable sort: packages (first) win ties against leaves.
        cur_w, idx = torch.sort(cand_w, dim=1, stable=True)
        leaf_flag = torch.gather(is_leaf_tpl, 1, idx)
        pfx = torch.cat([torch.zeros((B, 1), dtype=torch.int64, device=dev),
                         torch.cumsum(leaf_flag, dim=1)], dim=1)
        pfx_levels.append(pfx)
        size_levels.append(prev_size // 2 + m)
        prev_w = cur_w
        prev_size = size_levels[-1]

    # Top-down take counts; levels >= eff_max are skipped so the chain
    # starts at the effective depth limit (katajainen.c:216 clamp).
    take = 2 * m - 2
    counts = torch.zeros((B, n), dtype=torch.int64, device=dev)
    for level in range(maxbits - 1, -1, -1):
        active = level < eff_max
        t = torch.minimum(take, size_levels[level])
        leaves_taken = torch.where(iota_2n1[None, :] == t[:, None],
                                   pfx_levels[level], 0).sum(dim=1)
        counts = counts + (active[:, None]
                           & (iota_n[None, :] < leaves_taken[:, None])).long()
        take = torch.where(active, 2 * (t - leaves_taken), take)

    lengths = torch.zeros((B, n), dtype=torch.int64, device=dev)
    lengths.scatter_(1, order, counts)
    # Special cases m <= 2: every used symbol gets length 1.
    small = (m <= 2)[:, None]
    return torch.where(small, used.long(), lengths)


# ---------------------------------------------------------------------------
# OptimizeHuffmanForRle.
# ---------------------------------------------------------------------------

def _run_bounds(vals: torch.Tensor):
    """(start, end_exclusive) of the equal-value run containing each pos."""
    B, n = vals.shape
    dev = vals.device
    iota = torch.arange(n, device=dev)[None, :]
    change = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=dev),
                        vals[:, 1:] != vals[:, :-1]], dim=1)
    start = torch.cummax(torch.where(change, iota, -1), dim=1).values
    nxt = torch.cat([change[:, 1:],
                     torch.ones((B, 1), dtype=torch.bool, device=dev)], dim=1)
    marked = torch.where(nxt, iota + 1, n + 1)
    end = -torch.cummax(-marked.flip(1), dim=1).values.flip(1)
    return start, end


def rle_optimize(counts: torch.Tensor) -> torch.Tensor:
    """Batched OptimizeHuffmanForRle (deflate.c:434-518), exact."""
    B, n = counts.shape
    dev = counts.device
    counts = counts.long()
    iota = torch.arange(n, device=dev)[None, :]

    nz = counts != 0
    length = torch.where(nz, iota + 1, 0).amax(dim=1)       # (B,)

    # good_for_rle over the original counts, within [0, length).
    start, end = _run_bounds(counts)
    runlen = end - start
    good = torch.where(counts == 0, runlen >= 5, runlen >= 7) \
        & (iota < length[:, None])

    zcol = torch.zeros((B, 1), dtype=torch.int64, device=dev)
    counts_pad = torch.cat([counts, zcol], dim=1)
    good_pad = torch.cat([good, zcol.bool()], dim=1)

    # Everything that depends only on the original counts, for all steps
    # i = 0..n at once; the loop below carries (stride, limit, sum).
    steps = torch.arange(n + 1, device=dev)[None, :]          # (1, n+1)
    is_end = steps == length[:, None]
    done = steps > length[:, None]
    i1 = torch.clamp(steps + 1, max=n)
    i2 = torch.clamp(steps + 2, max=n)
    i3 = torch.clamp(steps + 3, max=n)
    avg4 = (counts_pad + torch.gather(counts_pad, 1, i1.expand(B, -1))
            + torch.gather(counts_pad, 1, i2.expand(B, -1))
            + torch.gather(counts_pad, 1, i3.expand(B, -1)) + 2) // 4
    new_limit_all = torch.where(
        steps < (length - 3)[:, None], avg4,
        torch.where(steps < length[:, None], counts_pad, 0))
    pre_boundary = is_end | good_pad
    add_all = torch.where(is_end | done, 0, counts_pad)

    stride = torch.zeros(B, dtype=torch.int64, device=dev)
    limit = counts[:, 0]
    ssum = torch.zeros(B, dtype=torch.int64, device=dev)
    ev_on, ev_start, ev_val = [], [], []
    for i in range(n + 1):
        ci = counts_pad[:, i]
        boundary = (pre_boundary[:, i] | ((ci - limit).abs() >= 4)) \
            & ~done[:, i]
        collapse = boundary & ((stride >= 4) | ((stride >= 3) & (ssum == 0)))
        val = torch.where(
            ssum == 0, 0,
            torch.clamp((ssum + stride // 2) // torch.clamp(stride, min=1),
                        min=1))
        ev_on.append(collapse)
        ev_start.append(i - stride)
        ev_val.append(val)
        limit = torch.where(boundary, new_limit_all[:, i], limit)
        stride = torch.where(boundary, 0, stride) + 1
        ssum = torch.where(boundary, 0, ssum) + add_all[:, i]

    # Apply the (non-overlapping) range fills [start, event_step) as
    # +value / -value steps at their ends, summed along the row; events
    # that are off add 0 at column n, past the row.
    on = torch.stack(ev_on, dim=1)                             # (B, E)
    ends = torch.where(on, torch.arange(n + 1, device=dev), n)
    starts = torch.where(on, torch.stack(ev_start, dim=1), n)
    vals = torch.where(on, torch.stack(ev_val, dim=1), 0)
    step = torch.zeros((B, n + 1), dtype=torch.int64, device=dev)
    step.scatter_add_(1, starts, vals).scatter_add_(1, ends, -vals)
    cover = torch.zeros((B, n + 1), dtype=torch.int64, device=dev)
    cover.scatter_add_(1, starts, on.long()).scatter_add_(1, ends, -on.long())
    filled = torch.cumsum(step, dim=1)[:, :n]
    covered = torch.cumsum(cover, dim=1)[:, :n] > 0
    return torch.where(covered, filled, counts)


# ---------------------------------------------------------------------------
# Tree header size (8 RLE variants).
# ---------------------------------------------------------------------------

_CL_ORDER = np.asarray(spec.CL_ORDER, dtype=np.int64)


def patch_dist_codes(d_lengths: torch.Tensor) -> torch.Tensor:
    """>=2 nonzero dist code lengths (deflate.c:86-99), batched."""
    num = (d_lengths[:, :30] != 0).sum(dim=1)
    d0_set = d_lengths[:, 0] != 0
    out = d_lengths.clone()
    out[:, 0] = torch.where(num == 0, 1, out[:, 0])
    out[:, 1] = torch.where(num == 0, 1, out[:, 1])
    out[:, 0] = torch.where((num == 1) & ~d0_set, 1, out[:, 0])
    out[:, 1] = torch.where((num == 1) & d0_set, 1, out[:, 1])
    return out


def tree_size(ll_lengths: torch.Tensor,
              d_lengths: torch.Tensor) -> torch.Tensor:
    """Batched exact dynamic-tree header bits: min of the 8 RLE variants.

    ll_lengths: (B, 288), d_lengths: (B, 32).  Returns (B,) int64.
    """
    B = ll_lengths.shape[0]
    dev = ll_lengths.device
    i29 = torch.arange(29, device=dev)[None, :]
    hlit = torch.where(ll_lengths[:, 257:286] != 0, i29 + 1, 0).amax(dim=1)
    hdist = torch.where(d_lengths[:, 1:30] != 0, i29 + 1, 0).amax(dim=1)
    hlit2 = hlit + 257
    total = hlit2 + hdist + 1

    NJ = 320
    ij = torch.arange(NJ, device=dev)[None, :]
    concat = torch.cat([ll_lengths, d_lengths], dim=1).long()
    src = torch.where(ij < hlit2[:, None], ij, ij - hlit2[:, None] + 288)
    joint = torch.gather(concat, 1, src.clamp(0, NJ - 1))
    valid = ij < total[:, None]
    joint = torch.where(valid, joint, -1)         # sentinel stops runs

    start, end = _run_bounds(joint)
    runlen = end - start
    sym = joint
    use_run = (ij == start) & valid               # one contribution per run

    sizes = []
    for v in range(8):
        use16, use17, use18 = bool(v & 1), bool(v & 2), bool(v & 4)
        if use16:
            grp = torch.ones_like(sym, dtype=torch.bool)
        elif use17 or use18:
            grp = sym == 0
        else:
            grp = torch.zeros_like(sym, dtype=torch.bool)

        cnt = torch.where(grp, runlen, 1)
        # Ungrouped runs contribute element by element: weight the
        # per-run contribution by runlen instead.
        indiv = torch.where(grp, 1, runlen)

        rem = cnt
        n18 = torch.zeros_like(rem)
        n17 = torch.zeros_like(rem)
        zrun = (sym == 0) & (cnt >= 3) & grp
        if use18:
            q, r = rem // 138, rem % 138
            n18 = torch.where(zrun, q + (r >= 11).long(), 0)
            rem = torch.where(zrun, torch.where(r >= 11, 0, r), rem)
        if use17:
            q, r = rem // 10, rem % 10
            n17 = torch.where(zrun, q + (r >= 3).long(), 0)
            rem = torch.where(zrun, torch.where(r >= 3, 0, r), rem)
        n16 = torch.zeros_like(rem)
        lit = torch.zeros_like(rem)
        if use16:
            g16 = rem >= 4
            q, r = (rem - 1) // 6, (rem - 1) % 6
            n16 = torch.where(g16, q + (r >= 3).long(), 0)
            lit = torch.where(g16, 1, 0)
            rem = torch.where(g16, torch.where(r >= 3, 0, r), rem)
        own = torch.where(use_run, (lit + rem) * indiv, 0)
        n16 = torch.where(use_run, n16, 0)
        n17 = torch.where(use_run, n17, 0)
        n18 = torch.where(use_run, n18, 0)

        # Segment-sum into the 19-symbol cl histogram (runs of the -1
        # sentinel contribute 0).
        cl_own = torch.zeros((B, 16), dtype=torch.int64, device=dev)
        cl_own.scatter_add_(1, sym.clamp(0, 15), own)
        sizes.append(torch.cat([
            cl_own, n16.sum(dim=1)[:, None], n17.sum(dim=1)[:, None],
            n18.sum(dim=1)[:, None]], dim=1))     # (B, 19)

    clc_all = torch.stack(sizes, dim=1).reshape(B * 8, 19)
    clcl = package_merge(clc_all, 7)

    i15 = torch.arange(15, device=dev)[None, :]
    clc_tail = clc_all[:, torch.as_tensor(_CL_ORDER[4:19], device=dev)]
    hclen = torch.where(clc_tail != 0, i15 + 1, 0).amax(dim=1)

    size = (14 + (hclen + 4) * 3 + (clcl * clc_all).sum(dim=1)
            + clc_all[:, 16] * 2 + clc_all[:, 17] * 3 + clc_all[:, 18] * 7)
    return size.reshape(B, 8).amin(dim=1)


# ---------------------------------------------------------------------------
# Symbol payload size + full dynamic cost.
# ---------------------------------------------------------------------------

def dist_symbol(dist: torch.Tensor) -> torch.Tensor:
    """DEFLATE distance symbol of distances >= 1 (exact integer ops)."""
    d1 = torch.clamp(dist - 1, min=1)
    lg = floor_log2(d1)
    r = (d1 >> torch.clamp(lg - 1, min=0)) & 1
    return torch.where(dist < 5, dist - 1, 2 * lg + r)


_LL_EXTRA = np.zeros(spec.NUM_LL, dtype=np.int64)
_LL_EXTRA[257:286] = spec.LENGTH_SYMBOL_EXTRA_BITS
_D_EXTRA = np.zeros(spec.NUM_D, dtype=np.int64)
_D_EXTRA[:30] = spec.DIST_SYM_EXTRA_BITS
_LL_PAYLOAD_MASK = np.ones(spec.NUM_LL, dtype=np.int64)
_LL_PAYLOAD_MASK[256] = 0   # end symbol charged once, not by count
_LL_PAYLOAD_MASK[286:] = 0
_D_PAYLOAD_MASK = np.ones(spec.NUM_D, dtype=np.int64)
_D_PAYLOAD_MASK[30:] = 0


def symbol_payload_size(ll_counts, d_counts, ll_lengths, d_lengths):
    """CalculateBlockSymbolSizeGivenCounts (deflate.c:375-401), batched."""
    dev = ll_counts.device

    def t(a):
        return torch.as_tensor(a, device=dev)[None, :]

    r = ((ll_lengths + t(_LL_EXTRA)) * ll_counts * t(_LL_PAYLOAD_MASK)).sum(1)
    r = r + ((d_lengths + t(_D_EXTRA)) * d_counts * t(_D_PAYLOAD_MASK)).sum(1)
    return r + ll_lengths[:, 256]


def hist_dynamic_cost(ll_counts: torch.Tensor,
                      d_counts: torch.Tensor) -> torch.Tensor:
    """Exact dynamic-block tree+data bits from histograms (batched).

    ll_counts: (B, 288), d_counts: (B, 32) integers.  Returns (B,) int64
    bits.  A CPU tensor takes the plain version; a CUDA tensor launches
    the CUDA kernel (csrc/hist_cost.cu) or raises.
    """
    if scan_kernel.device_kind(ll_counts) == "cpu":
        return hist_dynamic_cost_plain(ll_counts, d_counts)
    B = ll_counts.shape[0]
    if B == 0:
        return torch.zeros(0, dtype=torch.int64, device=ll_counts.device)
    ll = ll_counts.to(torch.int64).contiguous()
    d = d_counts.to(torch.int64).contiguous()
    scan_kernel.check(ll, torch.int64, (B, spec.NUM_LL), "ll_counts")
    scan_kernel.check(d, torch.int64, (B, spec.NUM_D), "d_counts")
    if d.device != ll.device:
        raise ValueError("hist_dynamic_cost: inputs on different devices")
    lib = scan_kernel.build_kernels()["hist_cost"]
    out = torch.empty(B, dtype=torch.int64, device=ll.device)
    with torch.cuda.device(ll.device):
        stream = torch.cuda.current_stream(ll.device).cuda_stream
        scan_kernel.raise_on(lib.zt_hist_cost(ll.data_ptr(), d.data_ptr(),
                                              out.data_ptr(), B, stream),
                             "hist_cost")
    bump(scan_kernel.LAUNCHES, "hist_cost")
    return out


def hist_dynamic_cost_plain(ll_counts: torch.Tensor,
                            d_counts: torch.Tensor) -> torch.Tensor:
    """Plain version of the hist_cost kernel (hist_dynamic_cost's contract).

    Mirrors native HistDynamicCost / GetDynamicLengths
    (deflate.c:525-582): plain lengths vs RleOptimize'd lengths, keep
    the smaller total.
    """
    ll_counts = ll_counts.long().clone()
    ll_counts[:, 256] = 1
    d_counts = d_counts.long()

    ll = package_merge(ll_counts, 15)
    d = patch_dist_codes(package_merge(d_counts, 15))
    t1 = tree_size(ll, d) + symbol_payload_size(ll_counts, d_counts, ll, d)

    ll2 = package_merge(rle_optimize(ll_counts), 15)
    d2 = patch_dist_codes(package_merge(rle_optimize(d_counts), 15))
    t2 = tree_size(ll2, d2) + symbol_payload_size(ll_counts, d_counts,
                                                  ll2, d2)

    return torch.minimum(t1, t2)


# ---------------------------------------------------------------------------
# Entropy cost model (tree.c:71-94 conventions).
# ---------------------------------------------------------------------------

_INV_LN2_X2 = float(2.0 / np.log(2.0))


def _f32(x: float, dev) -> torch.Tensor:
    # A fill, not a copy from the host: no sync on a CUDA device.
    return torch.full((), x, dtype=torch.float32, device=dev)


def _log2_int(c: torch.Tensor) -> torch.Tensor:
    """Accurate f32 log2 of positive integer counts.

    c = 2^e * m with exact integer ops (e = floor(log2 c), m in [1, 2] by
    an exact power-of-two divide), then log2(m) = 2*atanh(f/(2+f))/ln2
    with an odd series in z = f/(2+f).  Each float operation is its own
    op (no fused multiply-add), as in the JAX package.
    """
    dev = c.device
    c = c.long()
    e = floor_log2(torch.clamp(c, min=1))
    m = c.to(torch.float32) / (torch.ones_like(e) << e).to(torch.float32)
    f = m - _f32(1.0, dev)
    z = f / (_f32(2.0, dev) + f)
    z2 = z * z
    p = _f32(1.0 / 11.0, dev)
    for q in (9.0, 7.0, 5.0, 3.0):
        zp = z2 * p
        p = _f32(1.0 / q, dev) + zp
    inner = z2 * p
    atanh = z * (_f32(1.0, dev) + inner)
    scaled = atanh * _f32(_INV_LN2_X2, dev)
    return e.to(torch.float32) + scaled


def calculate_entropy(counts: torch.Tensor) -> torch.Tensor:
    """Shannon cost-per-symbol bits, batched (B, n) -> (B, n) float32."""
    dev = counts.device
    n = counts.shape[1]
    ci = counts.long()
    s = ci.sum(dim=1, keepdim=True)
    log2sum = torch.where(s > 0, _log2_int(torch.clamp(s, min=1)),
                          _f32(float(np.log2(n)), dev))
    bl = log2sum - _log2_int(torch.clamp(ci, min=1))
    bl = torch.where(ci == 0, log2sum, bl)
    tiny = (bl < _f32(0.0, dev)) & (bl > _f32(-1e-5, dev))
    return torch.where(tiny, _f32(0.0, dev), bl)


# ---------------------------------------------------------------------------
# Precomputed randomization gather maps (squeeze.c:80-107).
# ---------------------------------------------------------------------------

def randomize_maps(max_events: int):
    """Gather maps equivalent to RandomizeStatFreqs event #e.

    The MWC stream is data-independent and each event consumes a fixed
    number of draws, so the in-place self-referential rewrite
    freqs[i] = freqs[rand % n] resolves to a pure gather through the
    chase map m[i] = m[src[i]] (src < i reads already-rewritten values).
    Event e is the e-th randomize_stat_freqs of one continuing MwcRng.
    Returns (ll_maps (E, 288) int32, d_maps (E, 32) int32) as numpy.
    """
    from ..squeeze import MwcRng
    rng = MwcRng()
    ll_maps = np.empty((max_events, spec.NUM_LL), np.int32)
    d_maps = np.empty((max_events, spec.NUM_D), np.int32)
    for e in range(max_events):
        for arr, n in ((ll_maps[e], spec.NUM_LL), (d_maps[e], spec.NUM_D)):
            m = np.arange(n, dtype=np.int32)
            for i in range(n):
                if (rng.next() >> 4) % 3 == 0:
                    src = rng.next() % n
                    m[i] = m[src] if src < i else src
            arr[:] = m
    return ll_maps, d_maps
