"""Megafused per-master program: seed, both splits and squeeze, no host read.

Port of zopfli_tpu/ops/mega.py.  The two-phase device path (ops.seed ->
host read of the split points -> fused_engine.FusedSqueeze) reads the
device once for the seed's split and block bounds before the squeeze can
be queued.  Here one master's whole pipeline queues on
the device without a host read:

  1. the seed core (ops.seed.SeedCore.parse and finish_resident):
     candidates, fixed-cost seed parse, the reference split search under
     device control (ops.devsplit.split_lz77_resident: one launch of the
     split_search kernel), per-block seed stats
  2. the tile -> block geometry computed on the device from the split
     points, with the replica-lane fill (_geometry): bit-compatible with
     FusedSqueeze's host geometry
  3. candidate-table slicing into block-aligned lanes, all lanes at once
  4. the iteration loop (fused_engine.SqueezeLoop), then a compaction
     that carries literal bytes, the best replica per block, the chosen
     parse's symbol stream, the second split search on it (again under
     device control) and the auto-type cost totals of both bound sets

The host pulls the results once (MegaResult) and the compacted parses
once more (MegaResult.collect).  Mega runs for LARGE masters only (>=
ZT_MEGA_MIN bytes, default 512 KiB) and only with ZT_MEGA=1.

Where the port differs from the JAX program: the stream order key is 64
bits wide (owner block, lane block, tile index), where the JAX key's 6
bits for the lane block permute the stream once nb_pad > 64
(zopfli_tpu/ops/mega.py:312); the two agree wherever nb_pad <= 64.  The
TPU's optimization barriers and byte-value select chain have no
counterpart: the loop gathers literal costs by index.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from .. import spec
from ..utils.counters import bump
from ..utils.logging import span
from . import costmodel, devsplit, fused_engine, hashmatch, scan_kernel
from . import seed as seed_mod

KBP = fused_engine.KBP
TILE = fused_engine.TILE
LANES = fused_engine.LANES
MAX_EVENTS = fused_engine.MAX_EVENTS

# Masters at or above this size route to the megafused program (below
# it, the batched FusedSqueeze shares lane groups across masters).
MEGA_MIN = int(os.environ.get("ZT_MEGA_MIN", str(1 << 19)))


def enabled() -> bool:
    """Megafused routing toggle (ZT_MEGA=1 to enable; off by default)."""
    return os.environ.get("ZT_MEGA", "0") == "1"


@functools.lru_cache(maxsize=None)
def _perturb_tables(nb_pad: int):
    """Replica-seed perturbation masks/takes, bit-equal to the host's.

    Row rb uses numpy default_rng(0xA5F00D + rb) drawing ll then d --
    the exact stream FusedSqueeze.initial_stats consumes per replica
    row.  Data-independent, so they are constant tables.
    """
    mll = np.zeros((nb_pad, spec.NUM_LL), bool)
    tll = np.zeros((nb_pad, spec.NUM_LL), np.int64)
    md = np.zeros((nb_pad, spec.NUM_D), bool)
    td = np.zeros((nb_pad, spec.NUM_D), np.int64)
    for rb in range(nb_pad):
        rng = np.random.default_rng(0xA5F00D + rb)
        mll[rb] = rng.random(spec.NUM_LL) < (1.0 / 3.0)
        tll[rb] = rng.integers(0, spec.NUM_LL, spec.NUM_LL)
        md[rb] = rng.random(spec.NUM_D) < (1.0 / 3.0)
        td[rb] = rng.integers(0, spec.NUM_D, spec.NUM_D)
    return mll, tll, md, td


@functools.lru_cache(maxsize=None)
def _maps():
    """The randomization gather maps as int64 (host constants)."""
    return tuple(m.astype(np.int64)
                 for m in costmodel.randomize_maps(MAX_EVENTS))


def lane_geometry(cap: int, maxblocks: int, replicas: int):
    """(G, nb_pad) of a master capacity bucket: lane groups for every
    tile of the master plus one partial tile per block, and the per-block
    rows for every block and its replicas, both powers of two."""
    ntiles_max = -(-cap // TILE) + maxblocks
    G = 1
    while G * LANES < ntiles_max:
        G *= 2
    nb_pad = 4
    while nb_pad < (maxblocks + 1) * (1 + max(replicas, 1)):
        nb_pad *= 2
    return G, nb_pad


def _geometry(byte_splits, npts, L: int, MB: int, NL: int, nb_pad: int,
              replicas: int):
    """Device tile->block geometry + replica fill from split points.

    Mirrors FusedSqueeze.__init__'s host geometry exactly: data tiles
    cover each block in order; replica lanes copy whole blocks,
    largest-first, for `replicas` rounds while free lanes remain.
    byte_splits (MB,) and npts (0-d) are device tensors.

    Returns (tile_start, tile_nbytes, tile_block, nt0, nb_total,
             replica_of, ordinal, lane_k) -- master-relative int64
    tensors of fixed shapes (NL,) or (nb_pad,), nt0 and nb_total 0-d.
    """
    dev = byte_splits.device

    def ar(n):
        return torch.arange(n, device=dev)

    bidx = ar(MB + 1)
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    bs = torch.clamp(byte_splits, max=L)
    starts = torch.cat([zero, bs])[:MB + 1]
    ends = torch.cat([bs, torch.full((1,), L, dtype=torch.int64,
                                     device=dev)])[:MB + 1]
    live = bidx <= npts
    blk_len = torch.where(live, torch.clamp(ends - starts, min=0), 0)
    ntiles_b = (blk_len + TILE - 1) // TILE
    tile_off = torch.cat([zero, torch.cumsum(ntiles_b, 0)])     # (MB+2,)
    nt0 = tile_off[MB + 1]

    lane = ar(NL)
    cmp = tile_off[None, :MB + 1] <= lane[:, None]           # (NL, MB+1)
    b_of = torch.clamp(cmp.long().sum(1) - 1, min=0)
    k = lane - tile_off[b_of]
    t_start_d = starts[b_of] + k * TILE
    t_nb_d = torch.clamp(ends[b_of] - t_start_d, 0, TILE)
    is_data = lane < nt0

    # Replica fill: `replicas` rounds over blocks sorted by tile count
    # descending (ties by block index -- the host's stable sort), a
    # block fitting where its tiles fit into the lanes still free.
    order = torch.sort((NL + 1 - ntiles_b) * (MB + 1) + bidx).indices
    R = max(replicas, 1)
    ord_r = order.repeat(R)                                  # (S,)
    rnd_s = torch.arange(1, R + 1, device=dev).repeat_interleave(MB + 1)
    nt_s = ntiles_b[ord_r]
    free = NL - nt0
    lane_cur = nt0
    rb_cur = npts + 1
    fits, lanes_s, rbs = [], [], []
    for s in range(len(ord_r)):
        nt_b = nt_s[s]
        fit = ((nt_b > 0) & (nt_b <= free) if replicas
               else torch.zeros((), dtype=torch.bool, device=dev))
        fits.append(fit)
        lanes_s.append(lane_cur)
        rbs.append(rb_cur)
        free = torch.where(fit, free - nt_b, free)
        lane_cur = torch.where(fit, lane_cur + nt_b, lane_cur)
        rb_cur = rb_cur + fit.long()
    nb_total = rb_cur
    fit_s = torch.stack(fits)
    lane_s = torch.stack(lanes_s)
    rb_s = torch.stack(rbs)
    b_s = ord_r

    in_seg = (fit_s[None, :] & (lane_s[None, :] <= lane[:, None])
              & (lane[:, None] < (lane_s + nt_s)[None, :]))  # (NL, S)
    has_rep = in_seg.any(1)

    def pick(v):
        return torch.where(in_seg, v[None, :], 0).sum(1)

    rb_lane = pick(rb_s)
    srcb = pick(b_s)
    k_r = lane - pick(lane_s)
    t_start_r = starts[srcb] + k_r * TILE
    t_nb_r = torch.clamp(ends[srcb] - t_start_r, 0, TILE)

    tile_start = torch.where(is_data, t_start_d,
                             torch.where(has_rep, t_start_r, 0))
    tile_nbytes = torch.where(is_data, t_nb_d,
                              torch.where(has_rep, t_nb_r, 0))
    tile_block = torch.where(is_data, b_of, torch.where(has_rep, rb_lane, 0))
    lane_k = torch.where(is_data, k, torch.where(has_rep, k_r, 0))

    rows = ar(nb_pad)
    oh = fit_s[None, :] & (rows[:, None] == rb_s[None, :])   # (nb_pad, S)
    replica_of = torch.where(oh.any(1),
                             torch.where(oh, b_s[None, :], 0).sum(1), rows)
    ordinal = torch.where(oh, rnd_s[None, :], 0).sum(1)
    return (tile_start, tile_nbytes, tile_block, nt0, nb_total,
            replica_of, ordinal, lane_k)


def _replica_seeds(ll_h1, d_hist, replica_of, ordinal, pmask_ll, ptake_ll,
                   pmask_d, ptake_d, nb_pad: int, chaos: bool):
    """Seed stats for all nb_pad rows (base + chaos/perturbed replicas).

    Bit-equal to FusedSqueeze.initial_stats: ordinal-1 replicas get the
    chaotic all-weight-on-top-literal seed, ordinal-2+ the rng-perturbed
    copy (tables from _perturb_tables).  Returns (sll, sd, rep_off).
    """
    dev = ll_h1.device
    MBp1 = ll_h1.shape[0]
    base_ll = torch.zeros((nb_pad, spec.NUM_LL), dtype=torch.int64,
                          device=dev)
    base_ll[:MBp1] = ll_h1
    base_d = torch.zeros((nb_pad, spec.NUM_D), dtype=torch.int64, device=dev)
    base_d[:MBp1] = d_hist
    src_ll = base_ll[replica_of]
    src_d = base_d[replica_of]

    pert_ll = torch.where(pmask_ll, torch.gather(src_ll, 1, ptake_ll), src_ll)
    pert_d = torch.where(pmask_d, torch.gather(src_d, 1, ptake_d), src_d)

    top = torch.argmax(src_ll[:, :256], dim=1)
    tot = torch.clamp(src_ll.sum(1), min=1)
    i288 = torch.arange(spec.NUM_LL, device=dev)
    chaos_ll = torch.where(i288[None, :] == top[:, None], tot[:, None], 0)

    is_r1 = ordinal == 1
    is_r2 = ordinal >= 2
    if not chaos:
        is_r2 = is_r2 | is_r1
        is_r1 = torch.zeros_like(is_r1)
    sll = torch.where(is_r1[:, None], chaos_ll,
                      torch.where(is_r2[:, None], pert_ll, base_ll))
    sd = torch.where(is_r1[:, None], 0,
                     torch.where(is_r2[:, None], pert_d, base_d))
    sll[:, 256] = torch.where(is_r1 | is_r2, 1, sll[:, 256])
    return sll, sd, 9 * ordinal


def _prepare_lanes(bp_len, bp_dist, data_block, tile_start, tile_nbytes,
                   cap: int, G: int):
    """The candidate tables sliced into block-aligned lanes, all G*LANES
    lanes at once, in the loop's layout: (bl, bd, dsym) (G*TILE, KBP,
    LANES), (lit, valid) (G*TILE, LANES)."""
    parts = fused_engine.prepare_group(bp_len, bp_dist, data_block,
                                       tile_start, tile_nbytes, cap)

    def grouped(x):   # (TILE, ..., G*LANES) -> (G*TILE, ..., LANES)
        y = x.reshape(*x.shape[:-1], G, LANES).movedim(-2, 0)
        return y.reshape(G * TILE, *y.shape[2:]).contiguous()

    return [grouped(x) for x in parts]


def stream_offsets(owner_c, tile_block, lane_k, nsym_eff):
    """Each lane's first row in the chosen parse's symbol stream: lanes in
    the order (owner block, lane block -- the owner or a replica --, tile
    index in the block), by one stable sort of a 64-bit key (21 bits a
    field); a lane's offset is the symbols of the lanes before it."""
    key = (owner_c << 42) | (tile_block << 21) | lane_k
    perm = torch.sort(key, stable=True).indices
    cnt = nsym_eff[perm]
    off = torch.empty_like(cnt)
    off[perm] = torch.cumsum(cnt, 0) - cnt
    return off


def _finish(state, lit_t, geo, npts, G: int, NL: int, nb_pad: int, MB: int,
            fetch_cap: int, DCAP: int):
    """Byte-carrying compaction + the second split attempt on the device.

    Completes the reference's deflate.c:872-893 without a host read:
    choose the best replica per block by exact cost, build the chosen
    parse's global symbol stream (block order), run the reference split
    search on it, and compute the exact auto-type cost totals of BOTH
    bound sets (first-pass costs with the per-block-store GetFixedCost
    gate, second-pass with the whole-store gate -- as the host does).
    """
    (tile_start, tile_nbytes, tile_block, nt0, nb_total,
     replica_of, ordinal, lane_k) = geo
    best_cost, best_pe = state[2], state[8][0]
    dev = best_cost.device
    LB, LEN_MASK = scan_kernel.LEN_BITS, scan_kernel.LEN_MASK

    litg = lit_t.reshape(G, TILE, LANES)
    empty = (best_pe == 0).to(torch.int32)
    order = torch.sort(empty, dim=1, stable=True).indices
    pe_c = torch.gather(best_pe, 1, order)
    lit_c = torch.gather(litg, 1, order)
    # Literal rows carry their byte above the length bits (the seed
    # program's packed-stream format); empty rows stay 0.
    pe_pk = torch.where((pe_c & LEN_MASK) == 1, (lit_c << LB) | 1, pe_c)
    nsym_lane = (1 - empty).sum(1)                        # (G, LANES)
    packed = pe_pk[:, :fetch_cap, :].contiguous()

    # Best replica per block: earliest strict minimum in rb order (the
    # host collect's scan) == lexicographic (cost, rb) minimum.
    rows = torch.arange(nb_pad, device=dev)
    mask = replica_of[None, :] == rows[:, None]           # (o, rb)
    costm = torch.where(mask, best_cost[None, :], fused_engine.LARGE_COST)
    minc = costm.min(1).values
    chosen = torch.where(mask & (costm == minc[:, None]), rows[None, :],
                         nb_pad).min(1).values

    owner_c = replica_of[tile_block]                      # (NL,)
    inc = (tile_nbytes > 0) & (chosen[owner_c] == tile_block)
    nsym_eff = torch.where(inc, nsym_lane.reshape(-1), 0)
    off_lane = stream_offsets(owner_c, tile_block, lane_k, nsym_eff)
    nsym_total = nsym_eff.sum()

    k_pos = torch.arange(TILE, device=dev)
    idx = off_lane.reshape(G, LANES)[:, None, :] + k_pos[None, :, None]
    ok = ((k_pos[None, :, None] < nsym_lane[:, None, :])
          & inc.reshape(G, LANES)[:, None, :])
    idx = torch.where(ok, idx, DCAP)
    stream = torch.zeros(DCAP + 1, dtype=torch.int32, device=dev)
    stream.scatter_(0, idx.reshape(-1), pe_pk.reshape(-1))
    stream = stream[:DCAP]
    pl_s = stream & LEN_MASK
    hi_s = stream >> LB
    lit_stream = torch.where(pl_s >= spec.MIN_MATCH, pl_s, hi_s)
    dist_stream = torch.where(pl_s >= spec.MIN_MATCH, hi_s, 0)

    sp2, npts2, ll_ck, d_ck, bcum, search2 = devsplit.split_lz77_resident(
        lit_stream, dist_stream, DCAP, MB, nsym_total, return_ck=True,
        return_state=True)
    ll_sym, d_sym, _nb = devsplit.stream_symbols(lit_stream, dist_stream,
                                                 DCAP, nsym_total)

    bidx = torch.arange(MB + 1, device=dev)
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    nsym_blk = torch.zeros(nb_pad, dtype=torch.int64, device=dev)
    nsym_blk.index_add_(0, owner_c, nsym_eff)
    nsym_blk = nsym_blk[:MB + 1]
    csum = torch.cumsum(nsym_blk, 0)
    starts1 = torch.cat([zero, csum])[:MB + 1]
    ends1 = csum
    live1 = (bidx <= npts) & (ends1 > starts1)
    c1 = devsplit.autotype_costs(ll_ck, d_ck, ll_sym, d_sym, bcum, starts1,
                                 ends1, DCAP, nsym_blk <= 1000)
    tc1 = torch.where(live1, c1, 0).sum()
    sp2c = torch.minimum(sp2, nsym_total)
    starts2 = torch.cat([zero, sp2c])[:MB + 1]
    ends2 = torch.cat([sp2c, nsym_total.reshape(1)])[:MB + 1]
    live2 = (bidx <= npts2) & (ends2 > starts2)
    c2 = devsplit.autotype_costs(
        ll_ck, d_ck, ll_sym, d_sym, bcum, starts2, ends2, DCAP,
        (nsym_total <= 1000).expand(MB + 1).contiguous())
    tc2 = torch.where(live2, c2, 0).sum()
    return nsym_lane, packed, sp2, npts2, tc1, tc2, search2


# The outputs MegaResult pulls at once, flattened into one int64 tensor:
# (name, shape) in order; shapes use MB, NL and nb_pad.
def _pull_layout(MB: int, NL: int, nb_pad: int):
    return (("byte_splits", (MB,)), ("npts", ()),
            ("block_costs", (MB + 1, 3)), ("ll_h1", (MB + 1, spec.NUM_LL)),
            ("d_hist", (MB + 1, spec.NUM_D)), ("best_cost", (nb_pad,)),
            ("best_sll", (nb_pad, spec.NUM_LL)),
            ("best_sd", (nb_pad, spec.NUM_D)), ("nsym", (NL,)),
            ("tile_start", (NL,)), ("tile_nbytes", (NL,)),
            ("tile_block", (NL,)), ("nb_total", ()),
            ("replica_of", (nb_pad,)), ("sp2", (MB,)), ("npts2", ()),
            ("tc1", ()), ("tc2", ()), ("search1", (2,)),
            ("search2", (2,)))


def mega_dispatch(data: np.ndarray, instart: int, inend: int,
                  maxblocks: int, numiterations: int, window_start: int = 0,
                  fetch_cap: int | None = None, device="cuda"):
    """Queue the megafused program for one master; returns a handle.

    Nothing here reads the device: the seed parse, both split searches
    (one split_search launch each), the geometry, the loop and the compaction all queue on
    `device`.  On a CUDA device a kernel that fails to build or launch
    raises; there is no host-controlled fallback.
    """
    if fetch_cap is None:
        fetch_cap = int(os.environ.get("ZT_FETCH_CAP", str(TILE // 2)))
    replicas = int(os.environ.get("ZT_REPLICAS", "2"))
    chaos = os.environ.get("ZT_REPLICA_CHAOS", "1") != "0"
    dev = torch.device(device)
    MB = maxblocks
    buf, cap, min_pos, inend_real = seed_mod.master_buffer(
        data, instart, inend, window_start)
    L = inend - instart
    G, nb_pad = lane_geometry(cap, MB, replicas)
    NL = G * LANES
    assert NL < 1 << 21 and nb_pad < 1 << 21, (NL, nb_pad)   # order key
    knobs = hashmatch.current_knobs()
    core = seed_mod.make_seed_core(cap, MB, tuple(sorted(knobs.items())))
    bufd = devsplit.upload(buf, dev)
    (_sp, npts, byte_splits, ll_h1, d_hist, block_costs, _nsym_seed, bp_len,
     bp_dist, search1) = core.finish_resident(
        core.parse(bufd, min_pos, inend_real))
    bump(seed_mod.PROGRAMS)

    geo = _geometry(byte_splits, npts, L, MB, NL, nb_pad, replicas)
    tile_start, tile_nbytes, tile_block = geo[0], geo[1], geo[2]
    tabs = [devsplit.table(f"mega_perturb_{nb_pad}_{i}", t, dev)
            for i, t in enumerate(_perturb_tables(nb_pad))]
    sll, sd, rep_off = _replica_seeds(ll_h1, d_hist, geo[5], geo[6], *tabs,
                                      nb_pad, chaos)
    data_block = bufd[hashmatch.PREFIX:hashmatch.PREFIX + cap].to(
        torch.int32)
    prepared = _prepare_lanes(bp_len, bp_dist, data_block, tile_start,
                              tile_nbytes, cap, G)
    loop = fused_engine.SqueezeLoop(*prepared, tile_block.reshape(G, LANES),
                                    tile_nbytes.reshape(G, LANES), nb_pad,
                                    dev)
    lit_t = prepared[3]
    del prepared
    ll_maps, d_maps = (devsplit.table(f"mega_maps_{i}", m, dev)
                       for i, m in enumerate(_maps()))
    state = loop.run(loop.init_state(sll, sd), numiterations, ll_maps,
                     d_maps, rep_off)
    nsym_lane, packed, sp2, npts2, tc1, tc2, search2 = _finish(
        state, lit_t, geo, npts, G, NL, nb_pad, MB, fetch_cap, core.DCAP)
    searches = [s[devsplit.S_OVERFLOW:devsplit.S_ROUNDS + 1]
                for s in (search1, search2)]
    pulled = (byte_splits, npts, block_costs, ll_h1, d_hist, state[2],
              state[3], state[4], nsym_lane, tile_start, tile_nbytes,
              tile_block, geo[4], geo[5], sp2, npts2, tc1, tc2, *searches)
    flat = torch.cat([t.reshape(-1).long() for t in pulled])
    layout = _pull_layout(MB, NL, nb_pad)
    return (data, instart, inend, window_start, fetch_cap, layout, flat,
            packed, state[8][0])


class MegaResult:
    """Host-side view of one master's megafused outputs.

    Exposes the same decode/verify surface squeeze_batched.fused_collect
    needs, plus the SeedResult-compatible stored-exit fields.  Building it
    is the one pull of the master's results; collect() pulls the
    compacted parses.
    """

    def __init__(self, data, instart, inend, window_start, fetch_cap,
                 layout, flat, packed, best_pe):
        self.data = data
        self.instart, self.inend = instart, inend
        self.fetch_cap = fetch_cap
        self.window_start = window_start
        with span("zt.collect_wait"):
            host = flat.cpu().numpy()
        out, at = {}, 0
        for name, shape in layout:
            n = int(np.prod(shape, dtype=np.int64))
            out[name] = host[at:at + n].reshape(shape)
            at += n
        for which in ("search1", "search2"):
            if out[which][0]:
                raise RuntimeError(f"mega: the split search ({which}) did "
                                   "not finish in its N_MAX steps")
        self.search_rounds = (int(out["search1"][1]),
                              int(out["search2"][1]))
        bump(devsplit.STATS, "rounds", sum(self.search_rounds))
        # Device-computed second-split attempt (deflate.c:872-893):
        # symbol indices into the concatenated chosen parse, plus the
        # exact auto-type cost totals of both bound sets.
        self.split2 = ([int(x) for x in out["sp2"][:int(out["npts2"])]],
                       int(out["tc1"]), int(out["tc2"]))
        npts = int(out["npts"])
        bsp = [int(b) for b in out["byte_splits"][:npts]]
        self.bounds = [instart] + [instart + b for b in bsp] + [inend]
        nb = npts + 1
        self.nb = nb
        self.block_bounds = list(zip(self.bounds[:-1], self.bounds[1:]))
        self.block_wstart = [window_start] * nb
        self.masters = [(instart, inend, self.bounds)]
        self.seed_ll = out["ll_h1"][:nb].astype(np.int64)
        self.seed_d = out["d_hist"][:nb].astype(np.int64)
        self.block_costs = out["block_costs"][:nb]
        self.nb_total = int(out["nb_total"])
        self.replica_of = out["replica_of"][:self.nb_total]
        self.tile_start = out["tile_start"]
        self.tile_nbytes = out["tile_nbytes"]
        self.tile_block = out["tile_block"]
        self.nt = int(np.sum(self.tile_nbytes > 0))
        self._nsym = out["nsym"]
        self._packed = packed       # device until needed
        self._best_pe = best_pe     # device; pulled only on overflow
        self._cost = out["best_cost"]
        self._sll = out["best_sll"]
        self._sd = out["best_sd"]
        # Stored-exit fields (ops.seed.SeedResult semantics).
        self.all_stored = _all_stored(self.block_costs, self.seed_ll,
                                      self.bounds)

    def collect(self, handle=None):
        """(parses, best_cost, best_sll, best_sd) per real block."""
        lanes_used = self.tile_nbytes > 0
        nsym = self._nsym
        over = (nsym[lanes_used] > self.fetch_cap).any()
        with span("zt.collect_wait"):
            if over:
                bump(fused_engine.FETCH_RETRIES)
                with span("zt.fetch_retry"):
                    pe = self._best_pe.cpu().numpy()     # (G, TILE, LANES)
            else:
                packed = self._packed.cpu().numpy()      # (G, cap, LANES)

        block_tiles: dict[int, list[int]] = {}
        for t in range(len(self.tile_block)):
            if self.tile_nbytes[t] > 0:
                block_tiles.setdefault(int(self.tile_block[t]), []).append(t)

        def decode(tiles):
            lit_parts, dist_parts = [], []
            for t in tiles:
                g, lane = divmod(t, LANES)
                if over:
                    # Overflow pull: raw path edges (no bytes) --
                    # literal bytes come from positions in the input.
                    rows = pe[g, :, lane]
                    rows = rows[rows != 0].astype(np.int64)
                    pl = rows & 0x1FF
                    pd = rows >> 9
                    pos = np.concatenate([[0], np.cumsum(pl[:-1])])
                    bytes_at = self.data[self.instart
                                         + self.tile_start[t] + pos]
                    lit = np.where(pl >= spec.MIN_MATCH, pl, bytes_at)
                else:
                    # Compact rows carry literal bytes in the high bits
                    # (byte << 9 | 1) -- no input gather needed.
                    k = int(nsym[t])
                    rows = packed[g, :k, lane].astype(np.int64)
                    pl = rows & 0x1FF
                    pd = np.where(pl >= spec.MIN_MATCH, rows >> 9, 0)
                    lit = np.where(pl >= spec.MIN_MATCH, pl, rows >> 9)
                lit_parts.append(lit.astype(np.uint16))
                dist_parts.append(np.where(pl >= spec.MIN_MATCH, pd,
                                           0).astype(np.uint16))
            if lit_parts:
                return (np.concatenate(lit_parts),
                        np.concatenate(dist_parts))
            return (np.zeros(0, np.uint16), np.zeros(0, np.uint16))

        chosen = list(range(self.nb))
        for rb in range(self.nb, self.nb_total):
            b = int(self.replica_of[rb])
            if self._cost[rb] < self._cost[chosen[b]]:
                chosen[b] = rb
        parses = [decode(block_tiles.get(chosen[b], []))
                  for b in range(self.nb)]
        return (parses, self._cost[chosen], self._sll[chosen],
                self._sd[chosen])

    # Hash-collision guard: the fused engine's (it only reads
    # block_bounds, data and block_wstart).
    verify_parse = fused_engine.FusedSqueeze.verify_parse


# The stored-exit gate (zopfli_tpu/ops/mega.py:574-585): the seed
# program's own.
_all_stored = seed_mod.all_stored


def mega_finish(handle) -> MegaResult:
    """Blocking half of mega_dispatch: the one pull of its results."""
    return MegaResult(*handle)
