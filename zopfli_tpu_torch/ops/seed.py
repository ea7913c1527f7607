"""Device seed program: candidates + fixed-cost seed parse + split.

Port of zopfli_tpu/ops/seed.py.  Replaces the host greedy parse
(reference ZopfliLZ77Greedy, src/zopfli/lz77.c:544-630) on the device
path: one fixed-cost optimal parse (ZopfliLZ77OptimalFixed semantics,
squeeze.c:528-560) over a whole master, the reference block-split search
(ops.devsplit) on that parse, and per-block seed statistics:

  1. hashmatch.build_candidates -- per-position sublen tables
  2. fixed-cost DP scan + traceback (the scan and traceback kernels)
     over master-aligned TILE lanes
  3. per-lane path compaction -> one global LZ77 symbol stream
  4. devsplit.split_lz77_device on the stream (exact
     ZopfliBlockSplitLZ77 semantics: one split_search launch)
  5. per-block (ll, d) histograms of the seed parse (iteration-0 stats,
     squeeze.c:481-482 semantics with the end-symbol=1 convention)
  6. per-block exact auto-type costs of the seed parse (stored / fixed /
     dynamic) -- the host's stored-block early-exit signal for
     incompressible masters
  7. per-lane symbol counts (exact fetch_cap prediction for the fused
     engine's compact parse pull)

Steps 1-3 are SeedCore.parse and queue on the device without a host
sync (seed_dispatch); steps 4-7 are SeedCore.finish (seed_finish), which
reads the symbol count, runs the split search on the device and reads
its result once.  So a caller queues every master's parse before the
first sync.  SeedCore.finish_resident is steps 4-7 without a host read
(the megafused program's, ops.mega).  The candidate tables stay on the
device and are reused by the fused squeeze.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import spec
from ..utils.counters import bump
from ..utils.logging import span
from . import costmodel, devsplit, hashmatch, scan_kernel

_LSYM = np.asarray(spec.LENGTH_SYMBOL[3:259], dtype=np.int64)
_LEXTRA = np.asarray(spec.LENGTH_EXTRA_BITS[3:259], dtype=np.float32)

# Fixed-tree base costs (GetCostFixed, squeeze.c:125-140): litlen code
# lengths by symbol; every dist code is 5 bits; extra bits added by the
# DP itself.
_FIXED_LL = np.zeros(spec.NUM_LL, dtype=np.float32)
_FIXED_LL[0:144] = 8
_FIXED_LL[144:256] = 9
_FIXED_LL[256:280] = 7
_FIXED_LL[280:288] = 8
_FIXED_LCOST = (_FIXED_LL[_LSYM] + _LEXTRA).astype(np.float32)  # (256,)

# Cheap candidate knobs for masters a host probe already called
# incompressible: the parse only needs to confirm "stored wins", so
# neighbor quality is irrelevant (dyn cost is decided by literal
# entropy) -- one sort round + exact short distances.
CHEAP_KNOBS = {
    "sort_levels": (3,),
    "refine_plan": "",
    "short_dists": 4,
    "recent_k2_min": 0,
    "recent_levels": (3, 4, 6, 8, 12, 16, 24, 32),
}


def _dextra_f(dist: torch.Tensor) -> torch.Tensor:
    """DEFLATE distance extra bits, arithmetically (no table gather)."""
    d1 = torch.clamp(dist - 1, min=1)
    lg = costmodel.floor_log2(d1)
    return torch.clamp(lg - 1, min=0).to(torch.float32)


class SeedCore:
    """The seed computation for one master capacity, as plain functions
    over tensors (the tensors' device runs it).

    core(buf, min_pos, inend_real) ->
      (sp, npts, byte_splits, ll_hist, d_hist, block_costs, nsym_lane,
       bp_len, bp_dist)
    with sp (MB,) int64 symbol split points (sentinel-padded), npts an
    int, byte_splits (MB,) bytes-before-split (master-relative), ll_hist
    (MB+1, 288) / d_hist (MB+1, 32) seed stats per block, block_costs
    (MB+1, 3) exact [stored, fixed, dynamic] bits of the seed parse per
    block, nsym_lane (G*LANES,) path rows per tile lane, and the
    candidate tables (cap, KBP) for reuse.  core.parse is steps 1-3
    (no host sync), core.finish steps 4-7.
    """

    def __init__(self, cap: int, maxblocks: int, knobs_items: tuple = ()):
        from . import fused_engine as _fe
        self.TILE, self.LANES, self.KBP = _fe.TILE, _fe.LANES, _fe.KBP
        self.cap = cap
        self.MB = maxblocks
        ntiles = -(-cap // self.TILE)
        self.G = max(1, -(-ntiles // self.LANES))
        self.DCAP = cap + devsplit.CKPT   # stream capacity (multiple of CKPT)
        self.knobs = (dict(knobs_items) if knobs_items
                      else hashmatch.current_knobs())
        # Host table: the traceback wrapper reads it without a sync.
        self.symtab = scan_kernel.symbol_range_table()

    def __call__(self, buf, min_pos: int, inend_real: int):
        return self.finish(self.parse(buf, min_pos, inend_real))

    def scan_inputs(self, buf: torch.Tensor, min_pos: int,
                    inend_real: int):
        """Step 1 and the fixed-cost DP's inputs.

        Returns (scan_args, lit_t, tile_nbytes (G, LANES), bp_len,
        bp_dist): scan_args are the scan kernel's five inputs, lit_t and
        tile_nbytes the traceback's.
        """
        TILE, LANES, KBP, G, cap = (self.TILE, self.LANES, self.KBP, self.G,
                                    self.cap)
        dev = buf.device
        bp_len, bp_dist, _best = hashmatch.build_candidates(
            buf, cap, min_pos, inend_real, max_bp=KBP, **self.knobs)
        L_real = inend_real - hashmatch.PREFIX

        # ---- lane geometry: lane t covers master rows [t*TILE, ...) ----
        # Seed lanes tile the master CONTIGUOUSLY, so the per-lane tables
        # are reshapes of the flat tensors.
        tile_start = np.arange(G * LANES, dtype=np.int64) * TILE
        tile_nbytes = devsplit.upload(
            np.clip(L_real - tile_start, 0, TILE).astype(np.int32), dev)
        pos_in_tile = torch.arange(TILE, device=dev)
        total_rows = G * LANES * TILE

        def flat_rows(x):
            if total_rows > cap:
                pad = torch.zeros((total_rows - cap,) + tuple(x.shape[1:]),
                                  dtype=x.dtype, device=dev)
                x = torch.cat([x, pad])
            return x[:total_rows].reshape((G * LANES, TILE)
                                          + tuple(x.shape[1:]))

        bl = flat_rows(bp_len)                            # (GL, TILE, KBP)
        bd = flat_rows(bp_dist)
        data_block = buf[hashmatch.PREFIX:hashmatch.PREFIX + cap].to(
            torch.int32)
        lit = flat_rows(data_block)                       # (GL, TILE)
        maxlen = tile_nbytes[:, None] - pos_in_tile[None, :]
        bl = torch.minimum(bl, maxlen[:, :, None])
        bl = torch.where(bl >= spec.MIN_MATCH, bl, 0)
        valid = pos_in_tile[None, :] < tile_nbytes[:, None]

        # scan layout: (G*TILE, KBP, LANES) etc.
        def to_rows3(x):  # (GL, TILE, K) -> (G*TILE, K, LANES)
            y = x.reshape(G, LANES, TILE, -1).permute(0, 2, 3, 1)
            return y.reshape(G * TILE, -1, LANES).to(torch.int32) \
                .contiguous()

        def to_rows2(x):  # (GL, TILE) -> (G*TILE, LANES)
            y = x.reshape(G, LANES, TILE).permute(0, 2, 1)
            return y.reshape(G * TILE, LANES).contiguous()

        bl_t = to_rows3(bl)
        bd_t = to_rows3(bd)
        lit_t = to_rows2(lit)
        valid_t = to_rows2(valid)

        bp_dcost = (5.0 + _dextra_f(torch.clamp(bd_t, min=1))).contiguous()
        litcost = torch.where(
            valid_t, torch.where(lit_t < 144, 8.0, 9.0),
            scan_kernel.BIG).to(torch.float32).contiguous()
        lcost_vec = devsplit.upload(np.tile(
            np.repeat(_FIXED_LCOST[:, None], LANES, axis=1), (G, 1)), dev)

        return ((bl_t, bd_t, bp_dcost, litcost, lcost_vec), lit_t,
                tile_nbytes.reshape(G, LANES), bp_len, bp_dist)

    def parse(self, buf: torch.Tensor, min_pos: int, inend_real: int):
        """Steps 1-3: candidates, fixed-cost parse, symbol stream."""
        TILE, LANES, G, DCAP = self.TILE, self.LANES, self.G, self.DCAP
        dev = buf.device
        scan_args, lit_t, nbytes_g, bp_len, bp_dist = self.scan_inputs(
            buf, min_pos, inend_real)
        ce, _ = scan_kernel.scan(*scan_args, groups=G)
        _, pep = scan_kernel.traceback(ce, lit_t, nbytes_g, self.symtab,
                                       groups=G)

        # ---- per-lane compaction, carrying the literal byte ----
        nsym_lane, pe_c, lit_c = scan_kernel.compact_lanes(
            pep.reshape(G, TILE, LANES), lit_t.reshape(G, TILE, LANES))
        pl_c = pe_c & scan_kernel.LEN_MASK

        # ---- global symbol stream (position order = lane order) ----
        # ONE packed scatter (literal rows carry their byte above the
        # length bits); slots past a lane's count go to a dropped slot.
        nsym_flat = nsym_lane.reshape(-1)
        off = torch.cumsum(nsym_flat, 0) - nsym_flat
        k = torch.arange(TILE, device=dev)
        idx = off.reshape(G, LANES)[:, None, :] + k[None, :, None]
        slot_valid = k[None, :, None] < nsym_lane[:, None, :]
        idx = torch.where(slot_valid, idx, DCAP)
        LB = scan_kernel.LEN_BITS
        pe_packed = torch.where(pl_c >= spec.MIN_MATCH, pe_c,
                                (lit_c << LB) | 1)
        stream = torch.zeros(DCAP + 1, dtype=torch.int32, device=dev)
        stream.scatter_(0, idx.reshape(-1), pe_packed.reshape(-1))
        stream = stream[:DCAP]
        pl_s = stream & scan_kernel.LEN_MASK
        hi_s = stream >> LB
        lit_stream = torch.where(pl_s >= spec.MIN_MATCH, pl_s, hi_s)
        dist_stream = torch.where(pl_s >= spec.MIN_MATCH, hi_s, 0)
        return (lit_stream, dist_stream, nsym_flat, nsym_flat.sum(),
                bp_len, bp_dist)

    def finish(self, parsed):
        """Steps 4-7: split, per-block stats and costs (syncs)."""
        lit_stream, dist_stream, nsym_flat, nsym_t, bp_len, bp_dist = parsed
        with span("zt.seed_wait"):          # waits for the seed parse
            nsym_total = int(nsym_t)
        bump(devsplit.STATS, "syncs")

        # ---- reference split search on the seed parse ----
        sp, npts, ll_ck, d_ck, bcum = devsplit.split_lz77_device(
            lit_stream, dist_stream, self.DCAP, self.MB, nsym_total,
            return_ck=True)
        sp_t = devsplit.upload(np.asarray(sp, np.int64), lit_stream.device)
        return (sp_t, npts) + self._block_stats(
            lit_stream, dist_stream, nsym_total, sp_t, npts, ll_ck, d_ck,
            bcum) + (nsym_flat, bp_len, bp_dist)

    def finish_resident(self, parsed):
        """finish without reading the device (the megafused program's):
        the split under device control (devsplit.split_lz77_resident),
        then the same block bounds, stats and costs built from sp, npts
        and nsym as device tensors.  Bit-equal to finish on the same
        parse, with npts a 0-d tensor; also returns the split search's
        final state (its overflow flag and rounds)."""
        lit_stream, dist_stream, nsym_flat, nsym_t, bp_len, bp_dist = parsed
        sp, npts, ll_ck, d_ck, bcum, state = devsplit.split_lz77_resident(
            lit_stream, dist_stream, self.DCAP, self.MB, nsym_t,
            return_ck=True, return_state=True)
        return (sp, npts) + self._block_stats(
            lit_stream, dist_stream, nsym_t, sp, npts, ll_ck, d_ck,
            bcum) + (nsym_flat, bp_len, bp_dist, state)

    def _block_stats(self, lit_stream, dist_stream, nsym, sp_t, npts, ll_ck,
                     d_ck, bcum):
        """Steps 5-6 from the split points: (byte_splits, ll_h1, d_hist,
        block_costs).  nsym and npts are ints or 0-d tensors on the
        stream's device; nothing here reads the device."""
        MB, DCAP = self.MB, self.DCAP
        dev = lit_stream.device
        # Histograms come from the splitter's checkpointed cumulative
        # histograms differenced at the block boundaries.
        byte_splits = bcum[torch.clamp(sp_t, max=DCAP)]   # (MB,)
        ll_sym, d_sym, _nb = devsplit.stream_symbols(
            lit_stream, dist_stream, DCAP, nsym)
        zero = torch.zeros(1, dtype=torch.int64, device=dev)
        sentinel = torch.full((1,), DCAP + 1, dtype=torch.int64, device=dev)
        starts_sym = torch.clamp(torch.cat([zero, sp_t])[:MB + 1], max=nsym)
        ends_sym = torch.clamp(torch.cat([sp_t, sentinel])[:MB + 1],
                               max=nsym)
        pll, pd = devsplit.prefix_hist_at(
            ll_ck, d_ck, ll_sym, d_sym, torch.cat([starts_sym, ends_sym]),
            DCAP)
        ll_hist = pll[MB + 1:] - pll[:MB + 1]
        d_hist = pd[MB + 1:] - pd[:MB + 1]

        # Exact auto-type costs of the seed parse per block.  Sentinel
        # split points map to bcum[DCAP] == total bytes, so ends/starts
        # line up for the real blocks 0..npts and give 0 for the rest.
        ends = torch.cat([byte_splits, bcum[DCAP:]])[:MB + 1]
        starts = torch.cat([bcum[:1], byte_splits])[:MB + 1]
        bidx = torch.arange(MB + 1, device=dev)
        blk_bytes = torch.where(bidx <= npts, ends - starts, 0)
        rem = blk_bytes % 65535
        unc = (blk_bytes // 65535 + (rem != 0).long()) * 40 + blk_bytes * 8
        ll_h1 = ll_hist.clone()
        ll_h1[:, 256] = 1
        # deflate.c:615-616: no fixed cost for stores over 1000 symbols.
        fixed = devsplit.fixed_cost(ll_h1, d_hist)
        small = nsym <= 1000
        fx = (torch.where(small, fixed, unc)
              if isinstance(small, torch.Tensor) else fixed if small else unc)
        dyn = 3 + costmodel.hist_dynamic_cost(ll_h1, d_hist)
        block_costs = torch.stack([unc, fx, dyn], dim=1)  # (MB+1, 3)
        return byte_splits, ll_h1, d_hist, block_costs


@functools.lru_cache(maxsize=None)
def make_seed_core(cap: int, maxblocks: int,
                   knobs_items: tuple = ()) -> SeedCore:
    """The seed computation for one master capacity (cached)."""
    return SeedCore(cap, maxblocks, knobs_items)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class SeedResult:
    """Host-side view of one master's seed program outputs."""

    __slots__ = ("bounds", "seed_ll", "seed_d", "block_costs",
                 "max_lane_rows", "bp_len", "bp_dist", "all_stored")

    def __init__(self, instart, inend, sp, npts, byte_splits, ll_hist,
                 d_hist, block_costs, nsym_lane, bp_len, bp_dist):
        npts = int(npts)
        nb = npts + 1
        with span("zt.stats_wait"):
            bsp = [int(b) for b in _host(byte_splits)[:npts]]
            self.seed_ll = _host(ll_hist)[:nb].astype(np.int64)
            self.seed_d = _host(d_hist)[:nb].astype(np.int64)
            self.block_costs = _host(block_costs)[:nb]
            self.max_lane_rows = int(np.max(_host(nsym_lane)))
        self.bounds = [instart] + [instart + b for b in bsp] + [inend]
        self.bp_len = bp_len
        self.bp_dist = bp_dist
        self.all_stored = all_stored(self.block_costs, self.seed_ll,
                                     self.bounds)


def all_stored(block_costs, seed_ll, bounds) -> bool:
    """The stored-exit gate of a master's seed parse.

    Every block (a) already prefers stored over the seed parse's
    fixed/dynamic encodings with a small absolute margin, and (b) has
    near-zero match coverage under the FIXED cost model.  (b) is the
    load-bearing part: the fixed model charges any distance only 5 bits,
    so if even it finds <2% of bytes coverable by matches, the stat model
    (which charges the true distance entropy, ~25+ bits on random data)
    will use fewer matches still -- its dynamic cost cannot drop below the
    seed's by more than the margin, and the final auto-type choice is
    stored either way.  Skip the iteration loop and emit stored.
    """
    c = block_costs.astype(np.float64)
    nlit = seed_ll[:, :256].sum(axis=1).astype(np.float64)
    blk_bytes = np.diff(np.asarray(bounds, np.float64))
    cover = 1.0 - nlit / np.maximum(blk_bytes, 1)
    # Stored must beat DYNAMIC with margin.  The fixed column aliases the
    # uncompressed cost for stores over 1000 symbols (deflate.c:612-615
    # semantics), so compare against it only when it is a real fixed
    # cost.  The true stream symbol count (deflate.c:615 uses lz77->size)
    # excludes the forced per-block end-of-block symbol that seed_ll
    # counts.
    nsym_store = float(seed_ll.sum()) - (len(bounds) - 1)
    margin = 16.0 + c[:, 0] / 8192.0      # ~0.012% of the block
    dyn_ok = c[:, 0] + margin < c[:, 2]
    fx_ok = (c[:, 0] + margin < c[:, 1]) if nsym_store <= 1000 \
        else np.ones_like(dyn_ok)
    return bool(np.all(dyn_ok & fx_ok) and np.all(cover < 0.02))


def master_buffer(data: np.ndarray, instart: int, inend: int,
                  window_start: int = 0):
    """The seed program's padded input of one master
    (hashmatch.padded_row at its power-of-two cap).

    Returns (buf uint8 (PREFIX + cap + PAD_TAIL,), cap, min_pos,
    inend_real).
    """
    return hashmatch.padded_row(data, instart, inend, window_start)


# Seed programs queued (cheap probes and their redos included), for
# reports.
PROGRAMS = [0]


def seed_dispatch(data: np.ndarray, instart: int, inend: int,
                  maxblocks: int = 15, cheap: bool = False,
                  window_start: int = 0, device="cuda"):
    """Queue the seed parse for one master; returns a handle.

    Nothing here waits for the device.  cheap=True uses CHEAP_KNOBS (for
    masters the host probe already called incompressible -- candidate
    quality is irrelevant there).  window_start: first byte the halo may
    reach back to (file start in multi-file batches where `data`
    concatenates independent inputs).
    """
    with span("zt.seed.upload"):
        buf, cap, min_pos, inend_real = master_buffer(data, instart, inend,
                                                      window_start)
        bufd = devsplit.upload(buf, torch.device(device))
    knobs = CHEAP_KNOBS if cheap else hashmatch.current_knobs()
    core = make_seed_core(cap, maxblocks, tuple(sorted(knobs.items())))
    parsed = core.parse(bufd, min_pos, inend_real)
    bump(PROGRAMS)
    return (instart, inend, core, parsed)


def seed_finish(handle) -> SeedResult:
    """Blocking half of seed_dispatch: split, stats, host results."""
    instart, inend, core, parsed = handle
    return SeedResult(instart, inend, *core.finish(parsed))


def seed_master(data: np.ndarray, instart: int, inend: int,
                maxblocks: int = 15, cheap: bool = False,
                window_start: int = 0, device="cuda") -> SeedResult:
    """Run the seed program for one master; returns host-side results."""
    return seed_finish(seed_dispatch(data, instart, inend, maxblocks, cheap,
                                     window_start, device))


def probably_incompressible(data: np.ndarray, instart: int,
                            inend: int) -> bool:
    """Host pre-gate: zlib level-1 barely shrinks the master.

    Only selects CHEAP candidate knobs -- the stored-exit decision itself
    is made from exact seed-parse costs (SeedResult.all_stored).
    """
    import zlib
    blob = data[instart:inend].tobytes()
    return len(zlib.compress(blob, 1)) > 0.99 * len(blob)
