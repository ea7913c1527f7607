"""Device block splitting: ZopfliBlockSplitLZ77 with its costs on the device.

Port of zopfli_tpu/ops/devsplit.py.  The reference's splitter
(blocksplitter.c:215-275) repeatedly picks the largest unsplit segment
and finds its best single split point with a 9-probe recursive search
(FindMinimum, blocksplitter.c:43-96), where each probe evaluates the
exact auto-type block cost of both halves (deflate.c:585-621).  Range
histograms come from checkpointed cumulative histograms (the lz77.h:56-61
trick as device tensors).

The JAX package compiles the whole search into one program
(while_loop / cond).  So does the port: the loop's state lives in one
int64 tensor, and one launch of the split_search kernel
(csrc/split_search.cu) runs the whole search on the card, its control
and the costs of every round it issues (the autotype_cost row code).
The host reads the final state once (split_lz77_device, the default
path's two splits) or not at all (split_lz77_resident, the megafused
program's, ops.mega).  Its plain version, split_search_plain, runs
split_step_plain and autotype_costs_plain in turn on CPU tensors.
autotype_costs (one launch of the autotype_cost kernel for a batch of
ranges) serves callers that cost ranges they already know.

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
from ..utils.counters import bump
from ..utils.logging import span
from . import costmodel, scan_kernel
from .costmodel import dist_symbol

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

# Split searches run (split_search calls: one kernel launch each on the
# card), their rounds (read from each search's final state when the host
# pulls it, the megafused program's with its results) and the host reads
# of the splits (one a search on the default path, plus the seed's symbol
# count), for reports.
STATS = {"searches": 0, "rounds": 0, "syncs": 0}


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

    Tensors as built by checkpoints + stream_symbols; starts/ends (B,)
    symbol indices in [0, ncap];
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
    bump(scan_kernel.LAUNCHES, "autotype_cost")
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




# ---------------------------------------------------------------------------
# The search: one split_search kernel a search.
# ---------------------------------------------------------------------------
#
# The state of the reference's loop lives in one int64 tensor (the layout
# csrc/split_search.cu reads).  One step consumes the costs of the round
# the previous step issued, advances the state, and writes the next
# round's ranges and their count (S_COUNT; 0 once the search has
# finished); the round's costs follow.  On the card the whole search is
# one launch of the split_search kernel, on the CPU split_step_plain and
# autotype_costs_plain in turn (split_search_plain).

(S_IT, S_NPTS, S_NDONE, S_NUMBLOCKS, S_FINISHED, S_MODE, S_LSTART, S_LEND,
 S_ORIG, S_START, S_END, S_POS, S_LASTBEST, S_NLIN, S_COUNT, S_OVERFLOW,
 S_ROUNDS) = range(17)
S_HEAD = 20                    # sp at [S_HEAD, +MB), done at [+MB, +2MB+1)
M_SELECT, M_LINEAR, M_PROBE = 0, 1, 2
MAX_RANGES = 2 * (LINEAR_MAX - 1) + 1   # a linear round: 1023 points
SYNC_WORDS = 64                # the kernel's uint32 scratch (split_search.cu)


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
    """Steps that finish any search: the outer loop evaluates at most
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
    """One step of the search on CPU tensors, in place (the split_search
    kernel's step).  costs (MAX_RANGES,) int64 holds the costs of the
    round the previous step issued; starts/ends (MAX_RANGES,) int64 and
    small_rows (MAX_RANGES,) bool receive the next round's ranges and
    fixed-cost gates, state[S_COUNT] their count.  `last` sets S_OVERFLOW
    if the search has not finished."""
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


def _scratch(maxblocks: int, ncap: int, dev, alloc):
    """(state, costs, starts, ends, small_rows) of a fresh search."""
    costs, starts, ends = alloc((3, MAX_RANGES), dtype=torch.int64,
                                device=dev)
    return (split_state(maxblocks, ncap, dev), costs, starts, ends,
            alloc(MAX_RANGES, dtype=torch.bool, device=dev))


def split_search_plain(tabs, nsym, ncap: int, maxblocks: int,
                       steps: int | None = None) -> tuple:
    """Plain version of the split_search kernel on CPU tensors: at most
    `steps` (default n_max) steps, each followed by the costs of the
    round it issued (autotype_costs_plain), stopping at the step that
    finishes the search.  Returns (state, costs, starts, ends,
    small_rows): the final state and the last round issued."""
    if steps is None:
        steps = n_max(maxblocks, ncap)
    nsym = int(nsym)
    out = _scratch(maxblocks, ncap, "cpu", torch.zeros)
    state, costs, starts, ends, small_rows = out
    for k in range(steps):
        split_step_plain(state, nsym, costs, starts, ends, small_rows,
                         maxblocks, ncap, k == steps - 1)
        n = int(state[S_COUNT])
        if n == 0:
            break
        costs[:n] = autotype_costs_plain(*tabs, starts[:n], ends[:n], ncap,
                                         small_rows[:n])
    return out


def split_search(tabs, nsym, ncap: int, maxblocks: int,
                 steps: int | None = None, return_round: bool = False):
    """The whole block-split search on one stream, queued without a host
    read; returns its final state (with return_round also the last
    round's costs, starts, ends and small_rows).

    tabs = (ll_ck, d_ck, ll_sym, d_sym, bcum) as stream_symbols and
    checkpoints build them; nsym a 0-d int64 tensor on their device.  At
    most `steps` (default n_max) steps run; a search cut short has
    state[S_OVERFLOW] set, for the caller's pull to read.  CUDA tensors
    launch the split_search kernel (csrc/split_search.cu) once; CPU
    tensors take split_search_plain.
    """
    if steps is None:
        steps = n_max(maxblocks, ncap)
    if steps < 1:
        raise ValueError(f"split_search: steps={steps}")
    bump(STATS, "searches")
    if scan_kernel.device_kind(tabs[0]) == "cpu":
        out = split_search_plain(tabs, nsym, ncap, maxblocks, steps)
        return out if return_round else out[0]
    dev = tabs[0].device
    _check_ranges(tabs, ncap, (), 0, "split_search")
    scan_kernel.check(nsym, torch.int64, (), "nsym")
    if nsym.device != dev:
        raise ValueError("split_search: inputs on different devices")
    out = _scratch(maxblocks, ncap, dev, torch.empty)
    state, costs, starts, ends, small_rows = out
    sync = torch.empty(SYNC_WORDS, dtype=torch.int32, device=dev)
    lib = scan_kernel.build_kernels()["split_search"]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        scan_kernel.raise_on(lib.zt_split_search(
            *(t.data_ptr() for t in tabs), state.data_ptr(),
            nsym.data_ptr(), costs.data_ptr(), starts.data_ptr(),
            ends.data_ptr(), small_rows.data_ptr(), sync.data_ptr(), ncap,
            maxblocks, steps, stream), "split_search")
    bump(scan_kernel.LAUNCHES, "split_search")
    return out if return_round else state


def search_clusters(dev) -> int:
    """The two-block clusters of the split_search kernel's cooperative
    grid on `dev` (sized at its first launch there; 0 before)."""
    import ctypes

    lib = scan_kernel.build_kernels()["split_search"]
    clusters = ctypes.c_int(0)
    with torch.cuda.device(dev):
        scan_kernel.raise_on(lib.zt_split_search_clusters(
            ctypes.byref(clusters)), "split_search")
    return clusters.value


def _tables(litlens, dists, ncap: int, nsym):
    """(ll_ck, d_ck, ll_sym, d_sym, bcum) of a padded stream."""
    ll_sym, d_sym, nbytes = stream_symbols(litlens, dists, ncap, nsym)
    ll_ck, d_ck, bcum = checkpoints(ll_sym, d_sym, nbytes, ncap, nsym)
    return ll_ck, d_ck, ll_sym, d_sym, bcum


def pull_split(state, maxblocks: int) -> tuple[list[int], int]:
    """The one host read of a search: (sp, npts) from its final state;
    counts its rounds, raises if it was cut short."""
    with span("zt.split_wait"):
        host = state.cpu().tolist()
    bump(STATS, "syncs")
    bump(STATS, "rounds", host[S_ROUNDS])
    if host[S_OVERFLOW]:
        raise RuntimeError("split search: the search did not finish in "
                           "its steps")
    return host[S_HEAD:S_HEAD + maxblocks], host[S_NPTS]


def split_lz77_device(litlens: torch.Tensor, dists: torch.Tensor,
                      ncap: int, maxblocks: int, nsym: int,
                      return_ck: bool = False):
    """Split points for one LZ77 store: the search on the stream's device
    (split_search), then one pull.

    litlens/dists: (ncap,) integer tensors, real entries in [0, nsym).
    Returns (splitpoints, npts): a host list of `maxblocks` ascending
    SYMBOL indices, padded with ncap + 1 past the npts real ones.  With
    return_ck, additionally returns the checkpointed cumulative
    histograms and byte prefix (ll_ck (ncap/CKPT+1, 288), d_ck (...,
    32), bcum (ncap+1,)) so the caller can derive per-block histograms
    and bounds without re-paying the stream scatter-adds (ops.seed
    does).  A store of fewer than 10 symbols is not searched.
    """
    nsym = int(nsym)
    tabs = _tables(litlens, dists, ncap, nsym)
    if nsym < 10:
        sp, npts = [ncap + 1] * maxblocks, 0
    else:
        nsym_t = torch.full((), nsym, dtype=torch.int64,
                            device=litlens.device)
        sp, npts = pull_split(split_search(tabs, nsym_t, ncap, maxblocks),
                              maxblocks)
    if return_ck:
        return sp, npts, tabs[0], tabs[1], tabs[4]
    return sp, npts


def split_lz77_resident(litlens: torch.Tensor, dists: torch.Tensor,
                        ncap: int, maxblocks: int, nsym: torch.Tensor,
                        return_ck: bool = False, return_state: bool = False):
    """split_lz77_device without a host read (the megafused program's).

    nsym is a 0-d int64 tensor on the stream's device.  Returns (sp,
    npts) as device tensors: sp (maxblocks,) ascending SYMBOL indices
    padded with ncap + 1, npts 0-d; with return_ck also (ll_ck, d_ck,
    bcum) as split_lz77_device returns them; with return_state also the
    search's final state (S_OVERFLOW, S_ROUNDS).
    """
    tabs = _tables(litlens, dists, ncap, nsym)
    state = split_search(tabs, nsym, ncap, maxblocks)
    out = (state[S_HEAD:S_HEAD + maxblocks], state[S_NPTS])
    if return_ck:
        out = out + (tabs[0], tabs[1], tabs[4])
    if return_state:
        out = out + (state,)
    return out


def block_split_lz77_device_dispatch(litlens: np.ndarray,
                                     dists: np.ndarray,
                                     maxblocks: int = 15,
                                     floor: int = CKPT, device="cuda"):
    """First half of block_split_lz77_device: upload the padded stream
    and queue its search (no host read).

    Returns an opaque handle for ..._collect() (None for stores of fewer
    than 10 symbols, which are not searched).
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
    nsym_t = torch.full((), n, dtype=torch.int64, device=dev)
    tabs = _tables(upload(ll, dev), upload(dd, dev), ncap, nsym_t)
    return split_search(tabs, nsym_t, ncap, maxblocks), maxblocks


def block_split_lz77_device_collect(handle) -> list[int]:
    """Second half of block_split_lz77_device_dispatch: the search's one
    pull."""
    if handle is None:
        return []
    sp, npts = pull_split(*handle)
    return sp[:npts]


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
