"""Device block splitting: ZopfliBlockSplitLZ77 with its costs on the device.

Port of zopfli_tpu/ops/devsplit.py.  The reference's splitter
(blocksplitter.c:215-275) repeatedly picks the largest unsplit segment
and finds its best single split point with a 9-probe recursive search
(FindMinimum, blocksplitter.c:43-96), where each probe evaluates the
exact auto-type block cost of both halves (deflate.c:585-621).  Range
histograms come from checkpointed cumulative histograms (the lz77.h:56-61
trick as device tensors) and every probe round's costs are ONE launch on
the card (autotype_costs: range histograms, stored, fixed and exact
dynamic costs in the autotype_cost kernel, csrc/hist_cost.cu).

The JAX package compiles the whole search into one program
(while_loop / cond).  Here the accept/mark-done loop and FindMinimum's
narrowing run on the host: each round (probe_round) uploads its probe
pairs, launches one batched cost evaluation (the segment's own cost
folded into its first batch) and pulls the few costs the next round
needs -- one host sync per round.  The control reads only those integer
costs, so the split points equal the JAX program's.

Semantics notes (bit-exact to the reference):
  - auto-type cost = min(uncompressed, fixed, dynamic); the fixed cost
    is only computed when the whole store has <= 1000 symbols
    (deflate.c:612-615), else it aliases the uncompressed cost.
  - FindMinimum's nine probes narrow to [p[i-1], p[i+1]] and stop when
    the best worsens or the range is <= 9; ranges under 1024 are
    scanned linearly.  Ties take the first (lowest) position.
  - done segments are keyed by their start symbol index, and the last
    segment ends at size-1 (FindLargestSplittableBlock quirk,
    blocksplitter.c:201).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import spec
from . import costmodel, scan_kernel
from .fused_engine import dist_symbol

CKPT = 256           # symbols per cumulative-histogram checkpoint
LINEAR_MAX = 1024    # FindMinimum linear-scan bound (blocksplitter.c:44)
NUM = 9              # probe count (blocksplitter.c:59)
BIG = 1 << 30

_LSYM = np.zeros(259, np.int64)
_LSYM[3:259] = spec.LENGTH_SYMBOL[3:259]
_FIXED_LL_BITS = np.zeros(spec.NUM_LL, np.int64)
_FIXED_LL_BITS[:144] = 8
_FIXED_LL_BITS[144:256] = 9
_FIXED_LL_BITS[256:280] = 7
_FIXED_LL_BITS[280:] = 8
_LL_EXTRA = np.zeros(spec.NUM_LL, np.int64)
_LL_EXTRA[257:286] = spec.LENGTH_SYMBOL_EXTRA_BITS
_D_EXTRA = np.zeros(spec.NUM_D, np.int64)
_D_EXTRA[:30] = spec.DIST_SYM_EXTRA_BITS

# Split searches run, their probe rounds (one batched cost evaluation
# each) and their host syncs (result pulls), for reports.
STATS = {"searches": 0, "rounds": 0, "syncs": 0}


def upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on `dev` without syncing the stream (pinned copy)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type != "cuda":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


_TABLES: dict = {}


def table(name: str, a: np.ndarray, dev) -> torch.Tensor:
    """A constant table on `dev`, copied once per device: a fresh copy
    per call would sync the stream every probe round."""
    key = (name, str(dev))
    if key not in _TABLES:
        _TABLES[key] = torch.as_tensor(a, device=dev)
    return _TABLES[key]


def stream_symbols(litlens, dists, ncap: int, nsym):
    """(ll_sym, d_sym, nbytes) int64 for an LZ77 stream, devsplit
    conventions: ll_sym 0 outside [0, nsym), d_sym -1 for literals and
    invalid rows."""
    dev = litlens.device
    litlens = litlens.long()
    dists = dists.long()
    valid = torch.arange(ncap, device=dev) < nsym
    is_match = dists != 0
    ll_sym = torch.where(is_match,
                         table("lsym", _LSYM, dev)[
                             torch.clamp(litlens, 0, 258)],
                         litlens)
    ll_sym = torch.where(valid, ll_sym, 0)
    d_sym = torch.where(is_match & valid, dist_symbol(dists), -1)
    nbytes = torch.where(valid, torch.where(is_match, litlens, 1), 0)
    return ll_sym, d_sym, nbytes


def checkpoints(ll_sym, d_sym, nbytes, ncap: int, nsym):
    """Checkpointed cumulative histograms and the byte prefix:
    ll_ck (ncap/CKPT+1, 288), d_ck (..., 32), bcum (ncap+1,), int64."""
    dev = ll_sym.device
    nck = ncap // CKPT
    ck = torch.arange(ncap, device=dev) // CKPT
    valid = (torch.arange(ncap, device=dev) < nsym).long()
    ll_ck = torch.zeros(nck * spec.NUM_LL, dtype=torch.int64, device=dev)
    ll_ck.scatter_add_(0, ck * spec.NUM_LL + ll_sym, valid)
    d_ck = torch.zeros(nck * spec.NUM_D, dtype=torch.int64, device=dev)
    d_ck.scatter_add_(0, ck * spec.NUM_D + torch.clamp(d_sym, min=0),
                      (d_sym >= 0).long())
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    ll_ck = torch.cat([zero.expand(1, spec.NUM_LL),
                       torch.cumsum(ll_ck.view(nck, spec.NUM_LL), 0)])
    d_ck = torch.cat([zero.expand(1, spec.NUM_D),
                      torch.cumsum(d_ck.view(nck, spec.NUM_D), 0)])
    bcum = torch.cat([zero, torch.cumsum(nbytes, 0)])
    return ll_ck, d_ck, bcum


def prefix_hist_at(ll_ck, d_ck, ll_sym, d_sym, pts, ncap: int):
    """Cumulative (ll, d) histograms of symbols [0, pts[b]), batched.

    ll_ck/d_ck/ll_sym/d_sym as built by split_lz77_device(return_ck=
    True) + stream_symbols; pts (B,) integers in [0, ncap].
    """
    dev = ll_ck.device
    pts = pts.long()
    j = pts // CKPT
    start = j * CKPT
    ck_pos = torch.arange(CKPT, device=dev)
    rows_i = torch.clamp(start[:, None] + ck_pos[None, :], max=ncap - 1)
    sym_rows = ll_sym[rows_i]                           # (B, CKPT)
    dsym_rows = d_sym[rows_i]
    m = ck_pos[None, :] < (pts - start)[:, None]
    B = pts.shape[0]
    part_ll = torch.zeros((B, spec.NUM_LL), dtype=torch.int64, device=dev)
    part_ll.scatter_add_(1, sym_rows, m.long())
    part_d = torch.zeros((B, spec.NUM_D), dtype=torch.int64, device=dev)
    part_d.scatter_add_(1, torch.clamp(dsym_rows, min=0),
                        (m & (dsym_rows >= 0)).long())
    return ll_ck[j] + part_ll, d_ck[j] + part_d


def fixed_cost(ll_h1: torch.Tensor, d_h: torch.Tensor) -> torch.Tensor:
    """Fixed-tree block bits incl. the 3-bit header, batched; ll_h1
    counts the end symbol once."""
    dev = ll_h1.device
    return (3 + (ll_h1 * table("fixed_ll", _FIXED_LL_BITS + _LL_EXTRA,
                               dev)).sum(1)
            + (d_h * table("fixed_d", 5 + _D_EXTRA, dev)).sum(1))


def autotype_costs(ll_ck, d_ck, ll_sym, d_sym, bcum, starts, ends,
                   ncap: int, small_store):
    """Exact auto-type bits of blocks [starts[i], ends[i]), batched.

    Tensors as built by split_lz77_device(return_ck=True) +
    stream_symbols; starts/ends (B,) symbol indices in [0, ncap];
    small_store is the GetFixedCost gate (deflate.c:612-615) -- a bool
    for the whole-store rule (what the split uses) or a (B,) bool tensor
    for the per-block-store rule.
    Returns (B,) int64 (0-length blocks cost BIG).  CPU tensors take the
    plain version; CUDA tensors launch the autotype_cost kernel
    (csrc/hist_cost.cu), one launch for the whole batch, or raise.
    """
    if scan_kernel.device_kind(ll_ck) == "cpu":
        return autotype_costs_plain(ll_ck, d_ck, ll_sym, d_sym, bcum,
                                    starts, ends, ncap, small_store)
    dev = ll_ck.device
    B = starts.shape[0]
    if B == 0:
        return torch.zeros(0, dtype=torch.int64, device=dev)
    nck = ncap // CKPT + 1
    for t, shape, what in ((ll_ck, (nck, spec.NUM_LL), "ll_ck"),
                           (d_ck, (nck, spec.NUM_D), "d_ck"),
                           (ll_sym, (ncap,), "ll_sym"),
                           (d_sym, (ncap,), "d_sym"),
                           (bcum, (ncap + 1,), "bcum"),
                           (starts, (B,), "starts"), (ends, (B,), "ends")):
        scan_kernel.check(t, torch.int64, shape, what)
        if t.device != dev:
            raise ValueError("autotype_costs: inputs on different devices")
    gate_ptr, small = None, 0
    if isinstance(small_store, torch.Tensor):
        scan_kernel.check(small_store, torch.bool, (B,), "small_store")
        if small_store.device != dev:
            raise ValueError("autotype_costs: inputs on different devices")
        gate_ptr = small_store.data_ptr()
    else:
        small = int(bool(small_store))
    lib = scan_kernel.build_kernels()["hist_cost"]
    out = torch.empty(B, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        scan_kernel.raise_on(lib.zt_autotype_cost(
            ll_ck.data_ptr(), d_ck.data_ptr(), ll_sym.data_ptr(),
            d_sym.data_ptr(), bcum.data_ptr(), starts.data_ptr(),
            ends.data_ptr(), gate_ptr, out.data_ptr(), B, ncap, small,
            stream), "autotype_cost")
    scan_kernel.LAUNCHES["autotype_cost"] += 1
    return out


def autotype_costs_plain(ll_ck, d_ck, ll_sym, d_sym, bcum, starts, ends,
                         ncap: int, small_store):
    """Plain version of the autotype_cost kernel (autotype_costs'
    contract): range histograms by prefix_hist_at, then the stored, fixed
    and dynamic costs (the plain cost stack) and their minimum."""
    starts = starts.long()
    ends = ends.long()
    pll, pd = prefix_hist_at(ll_ck, d_ck, ll_sym, d_sym,
                             torch.cat([starts, ends]), ncap)
    B = starts.shape[0]
    ll_h = pll[B:] - pll[:B]
    d_h = pd[B:] - pd[:B]
    length = (bcum[torch.clamp(ends, max=ncap)]
              - bcum[torch.clamp(starts, max=ncap)])
    nblk = length // 65535 + (length % 65535 != 0).long()
    unc = nblk * 40 + length * 8
    dyn = 3 + costmodel.hist_dynamic_cost_plain(ll_h, d_h)
    ll_h1 = ll_h.clone()
    ll_h1[:, 256] = 1
    fx = fixed_cost(ll_h1, d_h)
    if isinstance(small_store, torch.Tensor):
        fixed = torch.where(small_store, fx, unc)
    else:
        fixed = fx if small_store else unc
    cost = torch.minimum(torch.minimum(unc, fixed), dyn)
    return torch.where(ends > starts, cost, BIG)


def probe_round(tabs, a: np.ndarray, b: np.ndarray, ncap: int,
                small_store) -> np.ndarray:
    """Auto-type costs of blocks [a[i], b[i]): one probe round of the
    split -- one pinned upload of the pairs, one cost launch (on the
    card) and one pull.  tabs = (ll_ck, d_ck, ll_sym, d_sym, bcum)."""
    ll_ck, d_ck, ll_sym, d_sym, bcum = tabs
    ab = upload(np.stack([a, b]).astype(np.int64), ll_ck.device)
    c = autotype_costs(ll_ck, d_ck, ll_sym, d_sym, bcum, ab[0], ab[1], ncap,
                       small_store)
    STATS["rounds"] += 1
    STATS["syncs"] += 1
    return c.cpu().numpy()


def split_lz77_device(litlens: torch.Tensor, dists: torch.Tensor,
                      ncap: int, maxblocks: int, nsym: int,
                      return_ck: bool = False):
    """Split points for one LZ77 store, costs on the stream's device.

    litlens/dists: (ncap,) integer tensors, real entries in [0, nsym).
    Returns (splitpoints, npts): a host list of `maxblocks` ascending
    SYMBOL indices, padded with ncap + 1 past the npts real ones.  With
    return_ck, additionally returns the checkpointed cumulative
    histograms and byte prefix (ll_ck (ncap/CKPT+1, 288), d_ck (...,
    32), bcum (ncap+1,)) so the caller can derive per-block histograms
    and bounds without re-paying the stream scatter-adds (ops.seed
    does).
    """
    nsym = int(nsym)
    ll_sym, d_sym, nbytes = stream_symbols(litlens, dists, ncap, nsym)
    ll_ck, d_ck, bcum = checkpoints(ll_sym, d_sym, nbytes, ncap, nsym)
    STATS["searches"] += 1
    tabs = (ll_ck, d_ck, ll_sym, d_sym, bcum)

    def costs(a: np.ndarray, b: np.ndarray) -> np.ndarray:
        return probe_round(tabs, a, b, ncap, nsym <= 1000)

    def split_pairs(lstart, pts, lend):
        """(a, b) of the two halves at each point, then [lstart, lend)."""
        n = len(pts)
        a = np.concatenate([np.full(n, lstart), pts, [lstart]])
        b = np.concatenate([pts, np.full(n, lend), [lend]])
        return a, b

    def find_minimum(lstart: int, lend: int):
        """(pos, smallest, cost of [lstart, lend)) per FindMinimum."""
        start0, end0 = lstart + 1, lend
        if end0 - start0 < LINEAR_MAX:
            pts = np.arange(start0, end0)
            c = costs(*split_pairs(lstart, pts, lend))
            n = len(pts)
            v = c[:n] + c[n:2 * n]
            k = int(np.argmin(v))
            return int(pts[k]), int(v[k]), int(c[2 * n])
        start, end, pos, lastbest = start0, end0, start0, BIG
        origcost = None
        while True:
            step = (end - start) // (NUM + 1)
            p = start + (np.arange(NUM) + 1) * step
            a, b = split_pairs(lstart, p, lend)
            if origcost is not None:
                a, b = a[:-1], b[:-1]
            c = costs(a, b)
            if origcost is None:
                origcost = int(c[2 * NUM])
            vp = c[:NUM] + c[NUM:2 * NUM]
            besti = int(np.argmin(vp))
            best = int(vp[besti])
            if best > lastbest:
                break
            nstart = start if besti == 0 else int(p[besti - 1])
            nend = end if besti == NUM - 1 else int(p[besti + 1])
            start, end, pos, lastbest = nstart, nend, int(p[besti]), best
            if nend - nstart <= NUM:
                break
        return pos, lastbest, origcost

    # --- outer accept/mark-done loop (blocksplitter.c:233-266) ---
    MB = maxblocks
    sp = [ncap + 1] * MB           # sorted, sentinel-padded
    done: set[int] = set()         # done segment starts
    npts, numblocks = 0, 1
    finished = nsym < 10
    it = 0
    while it < 2 * MB and not finished:
        # Largest splittable segment over current splitpoints.  The
        # reference's FIRST evaluation runs on [0, size) before any
        # FindLargestSplittableBlock call; later segment ends use the
        # size-1 quirk (blocksplitter.c:235-236 vs :201).
        starts = ([0] + sp)[:MB + 1]
        ends = (sp + [0])[:MB + 1]
        ends[npts] = nsym - 1
        lengths = [ends[s] - starts[s]
                   if s <= npts and starts[s] not in done else -1
                   for s in range(MB + 1)]
        seg = int(np.argmax(lengths))
        first = it == 0
        lstart = 0 if first else starts[seg]
        lend = nsym if first else ends[seg]
        found = first or lengths[seg] > 0
        finished = (not found) or numblocks >= MB or lend - lstart < 10
        if not finished:
            llpos, splitcost, origcost = find_minimum(lstart, lend)
            if (splitcost > origcost or llpos == lstart + 1
                    or llpos == lend):
                done.add(lstart)
            else:
                sp[npts] = llpos
                sp.sort()
                npts += 1
                numblocks += 1
        it += 1
    if return_ck:
        return sp, npts, ll_ck, d_ck, bcum
    return sp, npts


def block_split_lz77_device_dispatch(litlens: np.ndarray,
                                     dists: np.ndarray,
                                     maxblocks: int = 15,
                                     floor: int = CKPT, device="cuda"):
    """First half of block_split_lz77_device: upload the padded stream.

    Returns an opaque handle for ..._collect() (None for tiny stores).
    The search itself runs in _collect (its control is on the host).
    """
    n = len(litlens)
    if n < 10:
        return None
    ncap = max(CKPT, floor)
    while ncap < n + 1:
        ncap *= 2
    ll = np.zeros(ncap, np.int32)
    dd = np.zeros(ncap, np.int32)
    ll[:n] = litlens
    dd[:n] = dists
    dev = torch.device(device)
    return (upload(ll, dev), upload(dd, dev), ncap, maxblocks, n)


def block_split_lz77_device_collect(handle) -> list[int]:
    """Second half of block_split_lz77_device_dispatch: run the search."""
    if handle is None:
        return []
    ll, dd, ncap, maxblocks, n = handle
    sp, npts = split_lz77_device(ll, dd, ncap, maxblocks, n)
    return [int(x) for x in sp[:npts]]


def block_split_lz77_device(litlens: np.ndarray, dists: np.ndarray,
                            maxblocks: int = 15, floor: int = CKPT,
                            device="cuda") -> list[int]:
    """Host wrapper: returns ascending LZ77-symbol split indices.

    floor: minimum pow2 capacity bucket (capacity only pads; results are
    identical for any ncap >= n + 1).
    """
    return block_split_lz77_device_collect(
        block_split_lz77_device_dispatch(litlens, dists, maxblocks, floor,
                                         device))
