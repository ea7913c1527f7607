"""Fused multi-master squeeze engine in PyTorch, on one or more devices.

Port of zopfli_tpu/ops/fused_engine.py.

Tiles from ALL masters of an input share fixed-size lane groups, and
the whole iteration loop of reference squeeze.c:446-526 runs on the
device: per iteration, cost expansion -> DP scan kernel -> traceback
kernel -> per-block histograms -> exact dynamic-block cost
(ops.costmodel, integer-identical to the native engine) -> keep-best
update -> stats feedback / blending / randomization.  The loop is an
eager Python loop of `numiterations` steps whose tensor work queues on
the device without a host round trip; the host pulls the chosen parses
once, compacted (paths are sparse; positions are implied by the symbol
sequence, so each row packs into one int32).

With `devices` (the counterpart of the reference's `mesh`), the lane
groups are split over the devices: each shard runs its groups' cost
expansion, K1, K2 and lane histogram on its own device, and the one
reduction per iteration sums the shards' int64 block histograms on the
control device, where the iteration control stays (the reference's psum,
fused_engine.py:171-175).  The per-block costs go back out to the shards
each iteration.  Histograms are integers, so any sharding gives the
unsharded parses bit for bit.
"""

from __future__ import annotations

import os
from types import SimpleNamespace

import numpy as np
import torch

from .. import spec
from ..utils.counters import bump
from ..utils.logging import span
from . import costmodel, hashmatch, scan_kernel

KBP = hashmatch.MAX_BP
TILE = int(os.environ.get("ZT_TILE", "8192"))
LANES = int(os.environ.get("ZT_LANES", "256"))
TIE_GRID = float(os.environ.get("ZT_TIE_GRID", "128"))  # 0 = off
MAX_EVENTS = 48          # randomization events cap; replicas start at
                         # staggered offsets into the same map stream
LARGE_COST = 1 << 30

_LSYM = np.asarray(spec.LENGTH_SYMBOL[3:259], dtype=np.int64)
_LEXTRA = np.asarray(spec.LENGTH_EXTRA_BITS[3:259], dtype=np.float32)
_DSYM_EXTRA = np.zeros(spec.NUM_D, dtype=np.float32)
_DSYM_EXTRA[:30] = spec.DIST_SYM_EXTRA_BITS

# Diagnostic counter: a fetch-cap overflow pulls the full (G, TILE,
# LANES) path tensor instead of the compact rows.
FETCH_RETRIES = [0]


def dist_symbol(dist: torch.Tensor) -> torch.Tensor:
    """DEFLATE distance symbol of distances >= 1 (exact integer ops)."""
    d1 = torch.clamp(dist - 1, min=1)
    lg = costmodel.floor_log2(d1)
    r = (d1 >> torch.clamp(lg - 1, min=0)) & 1
    return torch.where(dist < 5, dist - 1, 2 * lg + r)


def prepare_group(bp_len, bp_dist, data_block, tile_start, tile_nbytes,
                  cap_total: int):
    """Slice combined candidate tables into one lane group's layout.

    Returns (bl, bd, dsym) (TILE, KBP, LANES) and (lit, valid)
    (TILE, LANES), lanes last.
    """
    dev = bp_len.device
    pos_in_tile = torch.arange(TILE, device=dev)
    rows = tile_start[:, None] + pos_in_tile[None, :]        # (LANES, TILE)
    rows_c = rows.clamp(0, cap_total - 1)
    bl = bp_len[rows_c]
    bd = bp_dist[rows_c]
    lit = data_block[rows_c]
    maxlen = tile_nbytes[:, None] - pos_in_tile[None, :]
    bl = torch.minimum(bl, maxlen[:, :, None])
    bl = torch.where(bl >= spec.MIN_MATCH, bl, 0)
    valid = pos_in_tile[None, :] < tile_nbytes[:, None]
    bl = torch.where(valid[:, :, None], bl, 0)
    dsym = dist_symbol(torch.clamp(bd, min=1))
    return (bl.permute(1, 2, 0), bd.permute(1, 2, 0), dsym.permute(1, 2, 0),
            lit.permute(1, 0), valid.permute(1, 0))


def _filler(n: int) -> np.ndarray:
    return (np.arange(n, dtype=np.uint32) * 2654435761 >> 13).astype(np.uint8)


class SqueezeLoop:
    """The fused iteration loop over prepared lane-group tensors.

    The counterpart of the JAX package's _loop_pieces
    (zopfli_tpu/ops/fused_engine.py:101): the iteration body, its initial
    state and the end-of-loop compaction, built from device tensors.
    FusedSqueeze builds it from its host geometry, ops.mega from a
    geometry computed on the device.  bl_t, bd_t, dsym_t (G*TILE, KBP,
    LANES), lit_t, valid_t (G*TILE, LANES), tile_block and tile_nbytes
    (G, LANES): a lane's block (a row of the nb_pad per-block state) and
    its bytes (0 = unused).  With `devices`, the lane groups are split
    over them; `device` keeps the iteration control.
    """

    def __init__(self, bl_t, bd_t, dsym_t, lit_t, valid_t, tile_block,
                 tile_nbytes, nb_pad: int, device, devices=None):
        self.device = torch.device(device)
        self.nb_pad = nb_pad
        G = tile_block.shape[0]
        # Host table: the traceback wrapper reads it without a sync.
        self.symtab = scan_kernel.symbol_range_table()
        # Shards: groups [g0, g0 + n) of the lane-group tensors on their
        # device.  Only the shards keep them: unsharded, the one shard's
        # tensors are the full ones, without copies.
        full = SimpleNamespace(
            bl_t=bl_t.to(torch.int32), bd_t=bd_t.to(torch.int32),
            lit_t=lit_t.to(torch.int32), dsym_t=dsym_t,
            valid_t=valid_t.reshape(G, TILE, LANES),
            # Per-lane block of the histogram reduction (used lanes only).
            tile_block_d=tile_block.long(),
            tile_nbytes_d=tile_nbytes.to(torch.int32).contiguous())
        devs = devices or [self.device]
        per = G // len(devs)
        self.shards = [self._shard(full, torch.device(d), i * per, per)
                       for i, d in enumerate(devs)]

    @staticmethod
    def _shard(full, d, g0: int, n: int):
        """The lane-group tensors of groups [g0, g0 + n) on device d."""
        from .devsplit import table

        rows = slice(g0 * TILE, (g0 + n) * TILE)
        grp = slice(g0, g0 + n)
        sh = SimpleNamespace(
            device=d, groups=n,
            bl_t=full.bl_t[rows].to(d), bd_t=full.bd_t[rows].to(d),
            lit_t=full.lit_t[rows].to(d),
            valid_t=full.valid_t[grp].to(d),
            tile_block_d=full.tile_block_d[grp].to(d),
            tile_nbytes_d=full.tile_nbytes_d[grp].to(d),
            lsym=table("loop_lsym", _LSYM, d),
            lextra=table("loop_lextra", _LEXTRA, d),
            dsym_extra=table("loop_dsym_extra", _DSYM_EXTRA, d))
        sh.lane_used = (sh.tile_nbytes_d > 0).reshape(n * LANES, 1)
        # Flat gather indices of the per-lane cost tables (n, NSYM, LANES):
        # bp_dcost[g,t,k,l] = dplus[g, dsym, l]; litcost[g,t,l] = ll[g, lit, l].
        lane = torch.arange(LANES, device=d)
        gidx = torch.arange(n, device=d)
        sh.dsym_idx = ((gidx[:, None, None, None] * spec.NUM_D
                        + full.dsym_t[rows].to(d).reshape(n, TILE, KBP, LANES)
                        .long()) * LANES + lane)
        sh.lit_idx = ((gidx[:, None, None] * spec.NUM_LL
                       + sh.lit_t.reshape(n, TILE, LANES).long())
                      * LANES + lane)
        return sh

    # --- one iteration -----------------------------------------------------

    def _block_costs(self, stats_ll: torch.Tensor, stats_d: torch.Tensor):
        """Per-block model costs (nb_pad, 288), (nb_pad, 32) of the stats.

        Model costs are quantized to a 1/TIE_GRID-bit grid: per-tile path
        sums of grid multiples stay exact in f32, so cost ties are real
        ties and the kernel's relaxation order resolves them as the
        reference DP does (squeeze.c:288-302).
        """
        ll_cost_b = costmodel.calculate_entropy(stats_ll)
        d_cost_b = costmodel.calculate_entropy(stats_d)
        if TIE_GRID:
            # A fill, not a copy from the host: no sync on a CUDA device.
            grid = torch.full((), TIE_GRID, dtype=torch.float32,
                              device=self.device)
            ll_cost_b = torch.round(ll_cost_b * grid) / grid
            d_cost_b = torch.round(d_cost_b * grid) / grid
        return ll_cost_b, d_cost_b

    @staticmethod
    def _shard_inputs(sh, ll_cost_b, d_cost_b):
        """One shard's DP scan inputs from the per-block costs (on the
        shard's device): (bl_t, bd_t, bp_dcost, litcost, lcost_vec)."""
        G = sh.groups
        ll_t = ll_cost_b[sh.tile_block_d]              # (G, LANES, 288)
        d_t = d_cost_b[sh.tile_block_d]                # (G, LANES, 32)
        lcost_vec = (ll_t[:, :, sh.lsym] + sh.lextra).permute(
            0, 2, 1).reshape(G * scan_kernel.W, LANES).contiguous()
        dplus = (d_t + sh.dsym_extra).permute(0, 2, 1).reshape(-1)
        bp_dcost = dplus[sh.dsym_idx].reshape(G * TILE, KBP, LANES)
        litcost = ll_t.permute(0, 2, 1).reshape(-1)[sh.lit_idx]
        litcost = torch.where(sh.valid_t, litcost, scan_kernel.BIG)
        return (sh.bl_t, sh.bd_t, bp_dcost.contiguous(),
                litcost.reshape(G * TILE, LANES).contiguous(), lcost_vec)

    def scan_inputs(self, stats_ll: torch.Tensor, stats_d: torch.Tensor):
        """The DP scan's inputs of the first shard (all groups when
        unsharded) under the entropy model of the stats.
        Returns (bl_t, bd_t, bp_dcost, litcost, lcost_vec)."""
        sh = self.shards[0]
        return self._shard_inputs(sh, *(c.to(sh.device) for c in
                                        self._block_costs(stats_ll,
                                                          stats_d)))

    def _one_iteration(self, stats_ll, stats_d):
        costs = self._block_costs(stats_ll, stats_d)
        hist, peps = None, []
        for sh in self.shards:
            G = sh.groups
            ce, _ = scan_kernel.scan(*self._shard_inputs(
                sh, *(c.to(sh.device) for c in costs)), groups=G)
            hist_g, pep = scan_kernel.traceback(ce, sh.lit_t,
                                                sh.tile_nbytes_d,
                                                self.symtab, groups=G)
            # Per-block histograms: an integer index_add over the lanes'
            # blocks (counts are exact; no float matmul).
            lanes_h = hist_g.reshape(G, scan_kernel.HBINS, LANES).permute(
                0, 2, 1).reshape(G * LANES, scan_kernel.HBINS).long()
            lanes_h = lanes_h * sh.lane_used
            h = torch.zeros((self.nb_pad, scan_kernel.HBINS),
                            dtype=torch.int64, device=sh.device)
            h.index_add_(0, sh.tile_block_d.reshape(-1), lanes_h)
            # The one reduction across shards: their integer block
            # histograms summed on the control device.
            h = h.to(self.device)
            hist = h if hist is None else hist + h
            peps.append(pep.reshape(G, TILE, LANES))
        return hist[:, :spec.NUM_LL], hist[:, spec.NUM_LL:], peps

    def _body(self, i: int, state, ll_maps, d_maps, rep_off):
        (stats_ll, stats_d, best_cost, best_sll, best_sd,
         last_cost, last_rand, ec, best_pe) = state

        ll_hist, d_hist, peps = self._one_iteration(stats_ll, stats_d)

        # Exact dynamic-block bits incl. 3-bit header (squeeze.c:492).
        cost = 3 + costmodel.hist_dynamic_cost(ll_hist, d_hist)
        improved = cost < best_cost
        best_cost = torch.where(improved, cost, best_cost)
        best_sll = torch.where(improved[:, None], stats_ll, best_sll)
        best_sd = torch.where(improved[:, None], stats_d, best_sd)
        best_pe = [torch.where(improved.to(sh.device)[sh.tile_block_d]
                               [:, None, :], pep, bpe)
                   for sh, pep, bpe in zip(self.shards, peps, best_pe)]

        # Stats feedback (squeeze.c:503-517).  Counts are integers;
        # trunc(new + 0.5*last) == new + last // 2 exactly.
        new_ll = ll_hist.clone()
        new_ll[:, 256] = 1
        blended_ll = new_ll + stats_ll // 2
        blended_ll[:, 256] = 1
        blended_d = d_hist + stats_d // 2
        blend = (last_rand != -1)[:, None]
        next_ll = torch.where(blend, blended_ll, new_ll)
        next_d = torch.where(blend, blended_d, d_hist)

        stuck = (cost == last_cost) if i > 5 else torch.zeros_like(improved)
        # Replica rows draw from a staggered window of the map stream.
        ecc = torch.clamp(ec + rep_off, max=MAX_EVENTS - 1)
        rnd_ll = torch.gather(best_sll, 1, ll_maps[ecc])
        rnd_ll[:, 256] = 1
        rnd_d = torch.gather(best_sd, 1, d_maps[ecc])
        next_ll = torch.where(stuck[:, None], rnd_ll, next_ll)
        next_d = torch.where(stuck[:, None], rnd_d, next_d)
        ec = ec + stuck.long()
        last_rand = torch.where(stuck, i, last_rand)

        return (next_ll, next_d, best_cost, best_sll, best_sd,
                cost, last_rand, ec, best_pe)

    # --- the loop ----------------------------------------------------------

    def init_state(self, sll: torch.Tensor, sd: torch.Tensor):
        """The loop's state before iteration 0 from the seed stats (nb_pad,
        288) and (nb_pad, 32) int64 on the control device."""
        nbp, dev = self.nb_pad, self.device

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.int64, device=dev)

        return (sll, sd,
                torch.full((nbp,), LARGE_COST, dtype=torch.int64,
                           device=dev),
                zeros(nbp, spec.NUM_LL), zeros(nbp, spec.NUM_D), zeros(nbp),
                torch.full((nbp,), -1, dtype=torch.int64, device=dev),
                zeros(nbp),
                [torch.zeros((sh.groups, TILE, LANES), dtype=torch.int32,
                             device=sh.device) for sh in self.shards])

    def run(self, state, numiterations: int, ll_maps, d_maps, rep_off):
        """`numiterations` iterations from `state`, queued on the device
        without a host sync; returns the last state."""
        with span("zt.iterations"):
            for i in range(int(numiterations)):
                state = self._body(i, state, ll_maps, d_maps, rep_off)
        return state

    def compact(self, state, fetch_cap: int):
        """The end-of-loop compaction: each lane's sparse packed path rows
        to the front (a stable sort by emptiness keeps rows
        position-ordered), on each shard's device.  Returns (best_cost,
        best_sll, best_sd, nsym (G, LANES), packed (G, fetch_cap, LANES),
        best_pe): best_pe is also kept, a lane overflowing fetch_cap pulls
        it instead."""
        (_, _, best_cost, best_sll, best_sd, _, _, _, best_pe) = state
        nsym, packed = [], []
        with span("zt.squeeze.compact"):
            for bpe in best_pe:
                empty = (bpe == 0).to(torch.int32)
                order = torch.sort(empty, dim=1, stable=True).indices
                pe_c = torch.gather(bpe, 1, order)
                nsym.append((1 - empty).sum(dim=1).to(self.device))
                packed.append(pe_c[:, :fetch_cap, :].to(self.device))
            return (best_cost, best_sll, best_sd, torch.cat(nsym),
                    torch.cat(packed), best_pe)


class FusedSqueeze:
    """Device context for a batch of masters' fused squeeze.

    masters: list of (instart, inend, block_bounds) with block_bounds =
    [instart, b1, ..., inend] from a block split.  Block and tile
    bookkeeping is global across masters; candidate tables are built
    per master (32 KiB window halo) and concatenated.
    """

    def __init__(self, data: np.ndarray, masters, device="cuda",
                 cand=None, window_starts=None, devices=None):
        """cand: optional per-master [(bp_len, bp_dist)] arrays (numpy or
        torch) of shape (cap(master), KBP), used instead of building the
        candidate tables (they depend only on the input bytes; the seed
        program's stay on the device).  window_starts: per-master first
        byte the LZ77 window may reach back to (default 0 = all
        preceding bytes; multi-file batches concatenate independent
        inputs, so matches must not cross).  devices: optional list of
        torch devices to shard the lane groups over (the group count
        rounds up to a multiple of their number); `device` keeps the
        candidate tables and the iteration control."""
        with span("zt.squeeze.prep"):
            self._setup(data, masters, device, cand, window_starts, devices)

    def _setup(self, data, masters, device, cand, window_starts, devices):
        self.device = dev = torch.device(device)
        self.devices = (None if devices is None
                        else [torch.device(d) for d in devices])
        self.data = data
        self.masters = [(int(s), int(e), [int(b) for b in bb])
                        for (s, e, bb) in masters]
        for s, e, bb in self.masters:
            assert bb[0] == s and bb[-1] == e and e > s
        if window_starts is None:
            window_starts = [0] * len(self.masters)
        self.window_starts = [int(w) for w in window_starts]
        # Per-block window start (blocks are global across masters).
        self.block_wstart = []
        for (s, e, bb), w in zip(self.masters, self.window_starts):
            self.block_wstart.extend([w] * (len(bb) - 1))

        # --- global blocks & tiles ---
        self.block_bounds = []     # global list of (start, end)
        tile_start, tile_nbytes, tile_block, tile_abs = [], [], [], []
        caps = []
        row = 0                    # row offset in the combined tables
        for (instart, inend, bb) in self.masters:
            L = inend - instart
            cap = 16384
            while cap < L:
                cap *= 2
            caps.append(cap)
            for b in range(len(bb) - 1):
                gb = len(self.block_bounds)
                self.block_bounds.append((bb[b], bb[b + 1]))
                s, e = bb[b] - instart, bb[b + 1] - instart
                p = s
                while p < e:
                    n = min(TILE, e - p)
                    tile_start.append(row + p)
                    tile_nbytes.append(n)
                    tile_block.append(gb)
                    tile_abs.append(instart + p)
                    p += n
            row += cap
        self.nb = len(self.block_bounds)
        nt0 = len(tile_start)
        ngroups = max(1, -(-nt0 // LANES))
        # Power-of-two group counts: the geometry set stays log-bounded
        # (and matches the JAX package's, so both run the same shapes).
        g = 1
        while g < ngroups:
            g *= 2
        if self.devices is not None:
            # Also a device multiple: every shard holds whole groups.
            nd = len(self.devices)
            g = -(-g // nd) * nd
        self.ngroups = ngroups = g

        # Replica restarts: free lanes carry COPIES of blocks seeded
        # differently; collect() keeps the best parse per block by exact
        # cost.
        self.replica_of = list(range(self.nb))
        block_tiles = {}
        for t, b in enumerate(tile_block):
            block_tiles.setdefault(b, []).append(t)
        free = ngroups * LANES - nt0
        order = sorted(range(self.nb),
                       key=lambda b: -len(block_tiles.get(b, [])))
        for _round in range(int(os.environ.get("ZT_REPLICAS", "2"))):
            for b in order:
                ts = block_tiles.get(b, [])
                if not ts or len(ts) > free:
                    continue
                rb = len(self.replica_of)
                self.replica_of.append(b)
                for t in ts:
                    tile_start.append(tile_start[t])
                    tile_nbytes.append(tile_nbytes[t])
                    tile_block.append(rb)
                    tile_abs.append(tile_abs[t])
                free -= len(ts)
        self.nb_total = len(self.replica_of)
        self.nb_pad = 4
        while self.nb_pad < self.nb_total:
            self.nb_pad *= 2
        self.nt = len(tile_start)
        pad = self.ngroups * LANES - self.nt
        self.tile_start = np.array(tile_start + [0] * pad, np.int32)
        self.tile_nbytes = np.array(tile_nbytes + [0] * pad, np.int32)
        self.tile_block = np.array(tile_block + [0] * pad, np.int32)
        self.tile_abs = np.array(tile_abs + [0] * pad, np.int64)

        # --- combined candidate tables (bucketed total cap) ---
        cap_total = 16384
        while cap_total < row:
            cap_total *= 2
        self.cap_total = cap_total

        bp_len_parts, bp_dist_parts, data_parts = [], [], []
        for mi, ((instart, inend, _), cap) in enumerate(
                zip(self.masters, caps)):
            L = inend - instart
            if cand is not None and cand[mi] is not None:
                bl, bd = (a.to(dev, torch.int32)
                          if isinstance(a, torch.Tensor)
                          else torch.from_numpy(np.array(a, np.int32)).to(dev)
                          for a in cand[mi])
                assert tuple(bl.shape) == (cap, KBP), (bl.shape, cap, KBP)
            else:
                prefix_len = min(instart - self.window_starts[mi],
                                 spec.WINDOW_SIZE)
                total = hashmatch.PREFIX + cap + 264
                buf = np.empty(total, dtype=np.uint8)
                buf[:hashmatch.PREFIX] = _filler(hashmatch.PREFIX)
                if prefix_len:
                    buf[hashmatch.PREFIX - prefix_len:hashmatch.PREFIX] = \
                        data[instart - prefix_len:instart]
                buf[hashmatch.PREFIX:hashmatch.PREFIX + L] = \
                    data[instart:inend]
                buf[hashmatch.PREFIX + L:] = 0
                bl, bd, _ = hashmatch.build_candidates(
                    torch.from_numpy(buf).to(dev), cap,
                    hashmatch.PREFIX - prefix_len, hashmatch.PREFIX + L,
                    max_bp=KBP, **hashmatch.current_knobs())
            bp_len_parts.append(bl)
            bp_dist_parts.append(bd)
            dblock = np.zeros(cap, dtype=np.int32)
            dblock[:L] = data[instart:inend]
            data_parts.append(dblock)

        pad_rows = cap_total - row
        if pad_rows:
            zeros = torch.zeros((pad_rows, KBP), dtype=torch.int32,
                                device=dev)
            bp_len_parts.append(zeros)
            bp_dist_parts.append(zeros)
            data_parts.append(np.zeros(pad_rows, np.int32))
        bp_len = torch.cat(bp_len_parts, dim=0)
        bp_dist = torch.cat(bp_dist_parts, dim=0)
        data_block = torch.from_numpy(np.concatenate(data_parts)).to(dev)

        # --- prepared group tensors, group axis flattened into rows ---
        tile_start_d = torch.from_numpy(self.tile_start).to(dev).long()
        tile_nbytes_d = torch.from_numpy(self.tile_nbytes).to(dev)
        preps = [prepare_group(bp_len, bp_dist, data_block,
                               tile_start_d[g * LANES:(g + 1) * LANES],
                               tile_nbytes_d[g * LANES:(g + 1) * LANES],
                               cap_total)
                 for g in range(self.ngroups)]
        prepared = [torch.cat([p[i] for p in preps], dim=0).contiguous()
                    for i in range(5)]
        del preps
        self.loop = SqueezeLoop(
            *prepared,
            torch.from_numpy(self.tile_block.reshape(self.ngroups, LANES))
            .to(dev),
            tile_nbytes_d.reshape(self.ngroups, LANES),
            self.nb_pad, dev, self.devices)
        del prepared
        self.shards = self.loop.shards
        self.symtab = self.loop.symtab
        self.scan_inputs = self.loop.scan_inputs
        self.default_fetch_cap = TILE // 2

    # --- dispatch / collect ------------------------------------------------

    def run(self, seed_ll: np.ndarray, seed_d: np.ndarray,
            numiterations: int, fetch_cap: int | None = None):
        """Run the full squeeze; returns per-block parses + costs."""
        return self.collect(self.dispatch(seed_ll, seed_d, numiterations,
                                          fetch_cap))

    def initial_stats(self, seed_ll: np.ndarray, seed_d: np.ndarray):
        """Iteration-0 stats (nb_pad rows, replicas perturbed) + the
        per-row randomization offsets, as numpy arrays.

        Replica 0 of each block keeps the greedy seed; a block's FIRST
        replica gets a CHAOTIC seed (all weight on its most common
        literal; ZT_REPLICA_CHAOS=0 turns it off), later ones perturbed
        copies of the seed.
        """
        sll = np.zeros((self.nb_pad, spec.NUM_LL), np.int64)
        sd = np.zeros((self.nb_pad, spec.NUM_D), np.int64)
        sll[:self.nb] = seed_ll
        sd[:self.nb] = seed_d
        chaos = os.environ.get("ZT_REPLICA_CHAOS", "1") != "0"
        ordinal: dict[int, int] = {}
        for rb in range(self.nb, self.nb_total):
            b = self.replica_of[rb]
            ordinal[b] = ordinal.get(b, 0) + 1
            rng = np.random.default_rng(0xA5F00D + rb)
            if chaos and ordinal[b] == 1:
                top = int(np.argmax(seed_ll[b, :256]))
                sll[rb] = 0
                sll[rb, top] = max(int(seed_ll[b].sum()), 1)
                sd[rb] = 0
            else:
                for dst, src in ((sll, seed_ll), (sd, seed_d)):
                    row = src[b].astype(np.int32).copy()
                    mask = rng.random(row.shape[0]) < (1.0 / 3.0)
                    take = rng.integers(0, row.shape[0], row.shape[0])
                    row[mask] = src[b][take[mask]]
                    dst[rb] = row
            sll[rb, 256] = 1
        # Staggered randomization-stream offsets per replica ordinal.
        rep_off = np.zeros(self.nb_pad, np.int64)
        seen: dict[int, int] = {}
        for rb in range(self.nb, self.nb_total):
            b = self.replica_of[rb]
            seen[b] = seen.get(b, 0) + 1
            rep_off[rb] = 9 * seen[b]
        return sll, sd, rep_off

    def dispatch(self, seed_ll: np.ndarray, seed_d: np.ndarray,
                 numiterations: int, fetch_cap: int | None = None):
        """Queue the device loop; returns an opaque handle for collect().

        The loop's work queues on the device without host syncs, so the
        caller can do host work (emission of a previous batch) meanwhile.
        """
        if fetch_cap is None:
            fetch_cap = self.default_fetch_cap
        dev = self.device
        with span("zt.squeeze.prep"):
            sll, sd, rep_off = self.initial_stats(seed_ll, seed_d)
            ll_maps, d_maps = (torch.from_numpy(m).to(dev).long()
                               for m in costmodel.randomize_maps(MAX_EVENTS))
            state = self.loop.init_state(torch.from_numpy(sll).to(dev),
                                         torch.from_numpy(sd).to(dev))
            rep_off = torch.from_numpy(rep_off).to(dev)
        state = self.loop.run(state, numiterations, ll_maps, d_maps, rep_off)
        out = self.loop.compact(state, fetch_cap)
        return (out, seed_ll, seed_d, numiterations, fetch_cap)

    def collect(self, handle):
        """Block on a dispatch() handle and decode the parses."""
        ((best_cost, best_sll, best_sd, nsym, packed, best_pe),
         seed_ll, seed_d, numiterations, fetch_cap) = handle

        with span("zt.collect_wait"):
            nsym_h = nsym.cpu().numpy().reshape(-1)    # (G*LANES,)
            over = (nsym_h[:self.nt] > fetch_cap).any()
            if over:
                bump(FETCH_RETRIES)
                with span("zt.fetch_retry"):           # (G, TILE, LANES)
                    pe_h = np.concatenate([p.cpu().numpy()
                                           for p in best_pe])
            else:
                packed_h = packed.cpu().numpy()        # (G, cap, LANES)
            cost_all = best_cost.cpu().numpy()[:self.nb_total]
            best_sll = best_sll.cpu().numpy()
            best_sd = best_sd.cpu().numpy()

        def decode(tiles):
            lit_parts, dist_parts = [], []
            for t in tiles:
                g, lane = divmod(t, LANES)
                if over:
                    rows = pe_h[g, :, lane]
                    rows = rows[rows != 0].astype(np.int64)
                else:
                    k = int(nsym_h[t])
                    rows = packed_h[g, :k, lane].astype(np.int64)
                pl = rows & 0x1FF
                pd = rows >> 9
                # Positions are implied: literal rows step 1, match rows pl.
                pos = np.concatenate([[0], np.cumsum(pl[:-1])])
                bytes_at = self.data[self.tile_abs[t] + pos]
                lit_parts.append(np.where(pl >= spec.MIN_MATCH, pl,
                                          bytes_at).astype(np.uint16))
                dist_parts.append(np.where(pl >= spec.MIN_MATCH, pd,
                                           0).astype(np.uint16))
            if lit_parts:
                return (np.concatenate(lit_parts),
                        np.concatenate(dist_parts))
            return (np.zeros(0, np.uint16), np.zeros(0, np.uint16))

        block_tiles: dict[int, list[int]] = {}
        for t in range(self.nt):
            block_tiles.setdefault(int(self.tile_block[t]), []).append(t)

        # Best replica per original block by exact device cost.
        chosen = list(range(self.nb))
        for rb in range(self.nb, self.nb_total):
            b = self.replica_of[rb]
            if cost_all[rb] < cost_all[chosen[b]]:
                chosen[b] = rb
        parses = [decode(block_tiles.get(chosen[b], []))
                  for b in range(self.nb)]
        return (parses, cost_all[chosen], best_sll[chosen],
                best_sd[chosen])

    def verify_parse(self, b: int, litlens: np.ndarray,
                     dists: np.ndarray) -> bool:
        """Hash-collision guard: every match must reproduce its bytes."""
        instart, inend = self.block_bounds[b]
        if len(litlens) == 0:
            return inend == instart
        step = np.where(dists == 0, 1, litlens).astype(np.int64)
        if int(step.sum()) != inend - instart:
            return False
        pos = np.concatenate([[0], np.cumsum(step[:-1])]) + instart
        m = dists != 0
        if not m.any():
            return True
        mp = pos[m]
        md = dists[m].astype(np.int64)
        ml = litlens[m].astype(np.int64)
        # Matches must stay within this block's window (which starts at
        # the owning input's first byte in multi-file batches).
        if (md > mp - self.block_wstart[b]).any() \
                or (md > spec.WINDOW_SIZE).any():
            return False
        total = int(ml.sum())
        offs = np.arange(total) - np.repeat(np.cumsum(ml) - ml, ml)
        dsts = np.repeat(mp, ml) + offs
        srcs = np.repeat(mp - md, ml) + offs
        return bool(np.array_equal(self.data[dsts], self.data[srcs]))
