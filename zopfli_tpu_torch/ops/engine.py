"""Per-block squeeze engine on the device: the oracle block engine.

Port of zopfli_tpu/ops/engine.py (`TpuBlockEngine`, `tpu_greedy`).  It
presents the interface of native.BlockEngine (`squeeze_run(ll_cost,
d_cost)`, `close()`), so squeeze.lz77_optimal can drive either: pass
`engine_factory=DeviceBlockEngine` to deflate() with
Options(engine="native").  The match candidate table is built once per
block on the device (ops.hashmatch); each squeeze run reruns only the DP
scan (ops.dp, the dp_scan kernel on CUDA) with new cost vectors.

The candidate search is hash-based, so a chosen match could in principle
be a hash collision: every run is verified against the input bytes on
the host, with a fallback to the exact native engine -- the reference's
own semantics, counted in FALLBACKS.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import spec
from ..lz77 import LZ77Store
from ..utils.counters import bump
from . import dp, hashmatch

# Diagnostic counter: native fallbacks after a failed byte verification.
FALLBACKS = [0]


def _fixed_cost_vectors():
    """The fixed-tree cost model as (ll_cost[288], d_cost[32]) vectors.

    GetCostFixed (squeeze.c:125-140) decomposes exactly into this form:
    per-symbol base bits plus the extra bits the DP adds itself.
    """
    ll = np.zeros(spec.NUM_LL, dtype=np.float32)
    ll[0:144] = 8
    ll[144:256] = 9
    ll[256:280] = 7
    ll[280:288] = 8
    d = np.full(spec.NUM_D, 5, dtype=np.float32)
    return ll, d


_FIXED_LL, _FIXED_D = _fixed_cost_vectors()


class DeviceBlockEngine:
    """Per-block squeeze engine on a torch device ("cuda" by default)."""

    def __init__(self, data: np.ndarray, instart: int, inend: int,
                 device="cuda"):
        self.data = np.asarray(data, dtype=np.uint8)
        self.instart = instart
        self.inend = inend
        self.L = inend - instart
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # "cuda" is the current device of the thread that makes the
            # engine (a master's card under deflate's round-robin); the
            # engine stays there whatever thread runs it later.
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._prepared = False

    def _prepare(self):
        if self._prepared or self.L == 0:
            self._prepared = True
            return
        dev = self.device
        L = self.L
        # Padded to the JAX package's power-of-two buckets, so that both
        # packages see the same padding.
        buf, cap, min_pos, inend_real = hashmatch.padded_row(
            self.data, self.instart, self.inend)
        bp_len, bp_dist, _ = hashmatch.build_candidates(
            torch.from_numpy(buf).to(dev), cap, min_pos, inend_real)
        self._bp_len = bp_len.to(torch.int32)[None].contiguous()  # (1,cap,K)
        self._bp_dist = bp_dist.to(torch.int32)[None].contiguous()
        dsym = dp.dist_symbol(torch.clamp(self._bp_dist, min=1))
        self._bp_dsym = dsym
        self._bp_dextra = torch.from_numpy(dp.DSYM_EXTRA).to(dev)[dsym.long()]
        block = np.zeros(cap, dtype=np.int32)
        block[:L] = self.data[self.instart : self.inend]
        self._data_block = torch.from_numpy(block).to(dev)[None]
        mask = np.zeros(cap, dtype=bool)
        mask[:L] = True
        self._mask = torch.from_numpy(mask).to(dev)[None]
        self._cap = cap
        self._prepared = True

    def close(self):
        pass

    def squeeze_run(self, ll_cost=None, d_cost=None):
        """One optimal-parse run; None cost arrays select the fixed model."""
        if self.L == 0:
            return (np.zeros(0, np.uint16), np.zeros(0, np.uint16))
        self._prepare()
        if ll_cost is None:
            ll_cost, d_cost = _FIXED_LL, _FIXED_D
        dev = self.device
        ll = torch.from_numpy(np.asarray(ll_cost, np.float32)).to(dev)[None]
        dd = torch.from_numpy(np.asarray(d_cost, np.float32)).to(dev)[None]
        lcost_vec, bp_dcost, litcost = dp.edge_cost_tables(
            ll, dd, self._bp_dsym, self._bp_dextra, self._data_block)
        choice_len, choice_dist, _ = dp.squeeze_scan(
            self._bp_len, self._bp_dist, bp_dcost.contiguous(),
            litcost.contiguous(), lcost_vec.contiguous(), self._mask)
        cl = choice_len[0, : self.L + 1].cpu().numpy()
        cd = choice_dist[0, : self.L + 1].cpu().numpy()
        block = self.data[self.instart : self.inend]
        litlens, dists = dp.traceback(cl, cd, self.L, block)
        if not self._verify(litlens, dists):
            # Hash collision produced a bogus match: exact fallback.
            bump(FALLBACKS)
            from .. import native
            eng = native.BlockEngine(self.data, self.instart, self.inend)
            try:
                return eng.squeeze_run(
                    None if ll_cost is _FIXED_LL else ll_cost, d_cost)
            finally:
                eng.close()
        return litlens, dists

    def _verify(self, litlens: np.ndarray, dists: np.ndarray) -> bool:
        """Every chosen match must literally reproduce its bytes: the
        fused loop's native check (lz77.LZ77Store.checked), with the
        window starting at the buffer's first byte."""
        return LZ77Store.checked(self.data, litlens, dists, self.instart,
                                 self.inend, 0)[0] is not None


def device_greedy(data: np.ndarray, instart: int, inend: int):
    """Greedy seed parse.

    The greedy pass only seeds iteration-0 statistics and the
    pre-splitting; it is a serial scan, so it runs on the native host
    engine, as in the reference package.
    """
    from .. import native
    return native.greedy(data, instart, inend)
