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

split_lz77_resident runs the same search with its control on the device
(the megafused program's, ops.mega): the loop's state lives in one
tensor, one split_step kernel (csrc/split_ctl.cu) advances it by a round
and writes the next round's ranges and their count, and autotype_cost's
device-count entry costs them.  The host queues n_max such pairs without
a sync; the ones after the search finished do nothing.

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

import functools

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

# Split searches run, their host-controlled probe rounds (one batched
# cost evaluation each) and host syncs (result pulls), and the rounds of
# the searches under device control (read from their chains' states when
# the megafused program's results are pulled), for reports.
STATS = {"searches": 0, "rounds": 0, "syncs": 0, "chain_rounds": 0}


def upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on `dev` without syncing the stream (pinned copy)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type != "cuda":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


_TABLES: dict = {}


def table(name: str, a: np.ndarray, dev) -> torch.Tensor:
    """A constant table on `dev`, copied once per device without a sync:
    a fresh blocking copy per call would sync the stream every time."""
    key = (name, str(dev))
    if key not in _TABLES:
        _TABLES[key] = upload(np.asarray(a), torch.device(dev))
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
    _check_ranges((ll_ck, d_ck, ll_sym, d_sym, bcum), ncap,
                  ((starts, "starts"), (ends, "ends")), B, "autotype_costs")
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


def _check_ranges(tabs, ncap: int, ranges, B: int, name: str) -> None:
    """The cost kernel's tables and (B,) int64 range tensors: shapes,
    types, contiguity, one device."""
    nck = ncap // CKPT + 1
    shapes = ((nck, spec.NUM_LL), (nck, spec.NUM_D), (ncap,), (ncap,),
              (ncap + 1,))
    items = [(t, shape, what) for t, shape, what in zip(
        tabs, shapes, ("ll_ck", "d_ck", "ll_sym", "d_sym", "bcum"))]
    items += [(t, (B,), what) for t, what in ranges]
    for t, shape, what in items:
        scan_kernel.check(t, torch.int64, shape, what)
        if t.device != tabs[0].device:
            raise ValueError(f"{name}: inputs on different devices")


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


# ---------------------------------------------------------------------------
# The same search under device control: a chain of split steps.
# ---------------------------------------------------------------------------
#
# The state of split_lz77_device's loop lives in one int64 tensor (the
# layout csrc/split_ctl.cu reads).  One split step consumes the costs of
# the round the previous step issued, advances the state exactly as the
# host loop does, and writes the next round's ranges and their count
# (S_COUNT; 0 once the search has finished).  The host queues N_MAX
# (step, autotype_cost) pairs without a sync; a step after the search
# finished, and the cost launch after it, do nothing.

(S_IT, S_NPTS, S_NDONE, S_NUMBLOCKS, S_FINISHED, S_MODE, S_LSTART, S_LEND,
 S_ORIG, S_START, S_END, S_POS, S_LASTBEST, S_NLIN, S_COUNT, S_OVERFLOW,
 S_ROUNDS) = range(17)
S_HEAD = 20                    # sp at [S_HEAD, +MB), done at [+MB, +2MB+1)
M_SELECT, M_LINEAR, M_PROBE = 0, 1, 2
MAX_RANGES = 2 * (LINEAR_MAX - 1) + 1   # a linear round: 1023 points


@functools.lru_cache(maxsize=None)
def _probe_rounds_table(top: int = 4096) -> tuple:
    """t[s] = the most probe rounds FindMinimum runs on any span <= s."""
    @functools.lru_cache(maxsize=None)
    def rounds(s: int) -> int:
        if s <= NUM:
            return 0
        step = s // (NUM + 1)
        # Interior best: span 2*step; last probe best: 2*step + s % 10.
        return 1 + max(rounds(2 * step), rounds(2 * step + s % (NUM + 1)))
    t = [0] * (top + 1)
    for s in range(1, top + 1):
        t[s] = max(t[s - 1], rounds(s))
    return tuple(t)


def probe_rounds_max(span: int) -> int:
    """The most probe rounds of one FindMinimum on a span <= `span`."""
    t = _probe_rounds_table()
    if span < len(t):
        return t[span]
    # Any span <= S narrows to at most 2 * (S // 10) + 9.
    return 1 + probe_rounds_max(2 * (span // (NUM + 1)) + NUM)


def n_max(maxblocks: int, ncap: int) -> int:
    """Split steps of one chain: the outer loop evaluates at most
    2*maxblocks segments, each one linear round or at most
    probe_rounds_max(ncap) probe rounds; one more step consumes the last
    round's costs."""
    return 2 * maxblocks * max(1, probe_rounds_max(ncap)) + 1


def split_state(maxblocks: int, ncap: int, dev) -> torch.Tensor:
    """A fresh search state on `dev` (uploaded without a sync)."""
    st = np.zeros(S_HEAD + 2 * maxblocks + 1, np.int64)
    st[S_NUMBLOCKS] = 1
    st[S_MODE] = M_SELECT
    st[S_HEAD:S_HEAD + maxblocks] = ncap + 1           # sorted, sentinels
    st[S_HEAD + maxblocks:] = -1                       # done starts
    return upload(st, torch.device(dev))


def _round_ranges(kind: str, lstart: int, lend: int, start: int, end: int):
    """(a, b) of a round: both halves at each point, then [lstart, lend)
    on a linear or first probe round ("probe0"), not on later ones."""
    if kind == "linear":
        pts = np.arange(lstart + 1, lend, dtype=np.int64)
    else:
        step = (end - start) // (NUM + 1)
        pts = start + (np.arange(NUM, dtype=np.int64) + 1) * step
    n = len(pts)
    a = np.concatenate([np.full(n, lstart), pts])
    b = np.concatenate([pts, np.full(n, lend)])
    if kind != "probe":
        a, b = np.append(a, lstart), np.append(b, lend)
    return a.astype(np.int64), b.astype(np.int64)


def split_step_plain(state, nsym, costs, starts, ends, small_rows,
                     maxblocks: int, ncap: int, last: bool) -> None:
    """Plain version of the split_step kernel: one step of the search on
    CPU tensors, in place.  costs (MAX_RANGES,) int64 holds the costs of
    the round the previous step issued; starts/ends (MAX_RANGES,) int64
    and small_rows (MAX_RANGES,) bool receive the next round's ranges and
    fixed-cost gates, state[S_COUNT] their count."""
    MB = maxblocks
    s = [int(x) for x in state.tolist()]
    nsym = int(nsym)
    sp = s[S_HEAD:S_HEAD + MB]
    done = s[S_HEAD + MB:]
    if s[S_FINISHED]:
        state[S_COUNT] = 0
        return
    c = costs.tolist()

    def accept_reject(llpos, splitcost, orig):
        lstart, lend = s[S_LSTART], s[S_LEND]
        if splitcost > orig or llpos == lstart + 1 or llpos == lend:
            if s[S_NDONE] >= MB + 1:
                s[S_OVERFLOW] = 1
            else:
                done[s[S_NDONE]] = lstart
                s[S_NDONE] += 1
        else:
            sp[s[S_NPTS]] = llpos
            sp.sort()
            s[S_NPTS] += 1
            s[S_NUMBLOCKS] += 1
        s[S_IT] += 1
        s[S_MODE] = M_SELECT

    issue = None
    if s[S_MODE] == M_LINEAR:
        n = s[S_NLIN]
        v = [c[i] + c[n + i] for i in range(n)]
        k = int(np.argmin(v))
        accept_reject(s[S_LSTART] + 1 + k, v[k], c[2 * n])
    elif s[S_MODE] == M_PROBE:
        start, end = s[S_START], s[S_END]
        step = (end - start) // (NUM + 1)
        if s[S_NLIN] == 0:
            s[S_ORIG] = c[2 * NUM]
        vp = [c[j] + c[NUM + j] for j in range(NUM)]
        besti = int(np.argmin(vp))
        best = vp[besti]
        stop = best > s[S_LASTBEST]
        if not stop:
            nstart = start if besti == 0 else start + besti * step
            nend = end if besti == NUM - 1 else start + (besti + 2) * step
            s[S_START], s[S_END] = nstart, nend
            s[S_POS], s[S_LASTBEST] = start + (besti + 1) * step, best
            stop = nend - nstart <= NUM
        if stop:
            accept_reject(s[S_POS], s[S_LASTBEST], s[S_ORIG])
        else:
            s[S_NLIN] += 1
            issue = "probe"
    if s[S_MODE] == M_SELECT:
        # Largest splittable segment; the FIRST evaluation runs on
        # [0, nsym), later segment ends use the size-1 quirk.
        npts = s[S_NPTS]
        best_len, seg = None, 0
        for g in range(MB + 1):
            st_g = 0 if g == 0 else sp[g - 1]
            en_g = nsym - 1 if g == npts else (sp[g] if g < MB else 0)
            ln = (en_g - st_g if g <= npts
                  and st_g not in done[:s[S_NDONE]] else -1)
            if best_len is None or ln > best_len:
                best_len, seg = ln, g
                lstart_g, lend_g = st_g, en_g
        first = s[S_IT] == 0
        lstart = 0 if first else lstart_g
        lend = nsym if first else lend_g
        found = first or best_len > 0
        if (nsym < 10 or s[S_IT] >= 2 * MB or not found
                or s[S_NUMBLOCKS] >= MB or lend - lstart < 10):
            s[S_FINISHED] = 1
        else:
            s[S_LSTART], s[S_LEND] = lstart, lend
            if lend - lstart - 1 < LINEAR_MAX:
                s[S_MODE], s[S_NLIN] = M_LINEAR, lend - lstart - 1
                issue = "linear"
            else:
                s[S_MODE], s[S_NLIN] = M_PROBE, 0
                s[S_START], s[S_END] = lstart + 1, lend
                s[S_POS], s[S_LASTBEST] = lstart + 1, BIG
                issue = "probe0"
    count = 0
    if issue is not None:
        a, b = _round_ranges(issue, s[S_LSTART], s[S_LEND], s[S_START],
                             s[S_END])
        count = len(a)
        starts[:count] = torch.from_numpy(a)
        ends[:count] = torch.from_numpy(b)
        small_rows[:count] = nsym <= 1000
        s[S_ROUNDS] += 1
    s[S_COUNT] = count
    if last and not s[S_FINISHED]:
        s[S_OVERFLOW] = 1
    s[S_HEAD:S_HEAD + MB] = sp
    s[S_HEAD + MB:] = done
    state.copy_(torch.tensor(s, dtype=torch.int64))


def split_step(state, nsym, costs, starts, ends, small_rows, maxblocks: int,
               ncap: int, last: bool) -> None:
    """One split step: the split_step kernel (csrc/split_ctl.cu) on CUDA
    tensors, the plain version on CPU tensors.  nsym is a 0-d int64
    tensor on the state's device."""
    if scan_kernel.device_kind(state) == "cpu":
        split_step_plain(state, nsym, costs, starts, ends, small_rows,
                         maxblocks, ncap, last)
        return
    dev = state.device
    scan_kernel.check(state, torch.int64, (S_HEAD + 2 * maxblocks + 1,),
                      "state")
    scan_kernel.check(nsym, torch.int64, (), "nsym")
    for t, what in ((costs, "costs"), (starts, "starts"), (ends, "ends")):
        scan_kernel.check(t, torch.int64, (MAX_RANGES,), what)
    scan_kernel.check(small_rows, torch.bool, (MAX_RANGES,), "small_rows")
    for t in (nsym, costs, starts, ends, small_rows):
        if t.device != dev:
            raise ValueError("split_step: inputs on different devices")
    lib = scan_kernel.build_kernels()["split_ctl"]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        scan_kernel.raise_on(lib.zt_split_step(
            state.data_ptr(), nsym.data_ptr(), costs.data_ptr(),
            starts.data_ptr(), ends.data_ptr(), small_rows.data_ptr(),
            maxblocks, int(bool(last)), stream), "split_step")
    scan_kernel.LAUNCHES["split_step"] += 1


def autotype_costs_counted(tabs, starts, ends, small_rows, state, costs,
                           ncap: int) -> None:
    """Costs of the round a split step issued, into `costs`: ranges
    [0, state[S_COUNT]) of starts/ends.  On CUDA tensors one launch of the
    autotype_cost kernel's device-count entry (grid sized for
    MAX_RANGES, the count read on the device); on CPU tensors the plain
    version on the first count ranges."""
    ll_ck, d_ck, ll_sym, d_sym, bcum = tabs
    if scan_kernel.device_kind(state) == "cpu":
        n = int(state[S_COUNT])
        if n:
            costs[:n] = autotype_costs_plain(
                ll_ck, d_ck, ll_sym, d_sym, bcum, starts[:n], ends[:n],
                ncap, small_rows[:n])
        return
    dev = state.device
    _check_ranges(tabs, ncap, ((starts, "starts"), (ends, "ends"),
                               (costs, "costs")),
                  MAX_RANGES, "autotype_costs_counted")
    scan_kernel.check(small_rows, torch.bool, (MAX_RANGES,), "small_rows")
    if (state.dtype != torch.int64 or not state.is_contiguous()
            or state.numel() <= S_COUNT):
        raise ValueError("autotype_costs_counted: state must be a "
                         "contiguous int64 split state")
    if small_rows.device != dev or ll_ck.device != dev:
        raise ValueError("autotype_costs_counted: inputs on different "
                         "devices")
    lib = scan_kernel.build_kernels()["hist_cost"]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        scan_kernel.raise_on(lib.zt_autotype_cost_dev(
            ll_ck.data_ptr(), d_ck.data_ptr(), ll_sym.data_ptr(),
            d_sym.data_ptr(), bcum.data_ptr(), starts.data_ptr(),
            ends.data_ptr(), small_rows.data_ptr(),
            state.data_ptr() + 8 * S_COUNT, costs.data_ptr(), MAX_RANGES,
            ncap, stream), "autotype_cost")
    scan_kernel.LAUNCHES["autotype_cost"] += 1


def split_chain(tabs, nsym, ncap: int, maxblocks: int,
                steps: int | None = None) -> torch.Tensor:
    """The whole search as a chain of `steps` (default n_max) split
    steps and cost rounds, queued without a host sync; returns the final
    state.  On the CPU the chain stops at the step that finishes the
    search (the rest would do nothing) and an unfinished chain raises; on
    the card the caller reads state[S_OVERFLOW] with its results."""
    dev = tabs[0].device
    if steps is None:
        steps = n_max(maxblocks, ncap)
    state = split_state(maxblocks, ncap, dev)
    costs = torch.zeros(MAX_RANGES, dtype=torch.int64, device=dev)
    starts = torch.zeros(MAX_RANGES, dtype=torch.int64, device=dev)
    ends = torch.zeros(MAX_RANGES, dtype=torch.int64, device=dev)
    small_rows = torch.zeros(MAX_RANGES, dtype=torch.bool, device=dev)
    on_cpu = dev.type == "cpu"
    STATS["searches"] += 1
    for k in range(steps):
        split_step(state, nsym, costs, starts, ends, small_rows, maxblocks,
                   ncap, k == steps - 1)
        autotype_costs_counted(tabs, starts, ends, small_rows, state, costs,
                               ncap)
        if on_cpu and state[S_FINISHED]:
            break
    if on_cpu and state[S_OVERFLOW]:
        raise RuntimeError("split chain: the search did not finish in "
                           f"{steps} steps")
    return state


def split_lz77_resident(litlens: torch.Tensor, dists: torch.Tensor,
                        ncap: int, maxblocks: int, nsym: torch.Tensor,
                        return_ck: bool = False, return_state: bool = False):
    """split_lz77_device with the search's control on the stream's device.

    nsym is a 0-d int64 tensor on that device.  Returns (sp, npts) as
    device tensors: sp (maxblocks,) ascending SYMBOL indices padded with
    ncap + 1, npts 0-d; with return_ck also (ll_ck, d_ck, bcum) as
    split_lz77_device returns them; with return_state also the chain's
    final state (S_OVERFLOW, S_ROUNDS).  Nothing here reads the device.
    """
    ll_sym, d_sym, nbytes = stream_symbols(litlens, dists, ncap, nsym)
    ll_ck, d_ck, bcum = checkpoints(ll_sym, d_sym, nbytes, ncap, nsym)
    state = split_chain((ll_ck, d_ck, ll_sym, d_sym, bcum), nsym, ncap,
                        maxblocks)
    out = (state[S_HEAD:S_HEAD + maxblocks], state[S_NPTS])
    if return_ck:
        out = out + (ll_ck, d_ck, bcum)
    if return_state:
        out = out + (state,)
    return out


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
