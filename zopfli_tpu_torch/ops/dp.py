"""Batched min-plus forward DP for the squeeze parse, with distances.

Port of zopfli_tpu/ops/dp.py.  The relaxation of reference
GetBestLengths (src/zopfli/squeeze.c:217-309) over the literal edge and
the match edges at lengths 3..258 (each at its breakpoint's distance)
runs over B independent blocks; distances are recorded during the
relaxation, so the reference's FollowPath re-search
(squeeze.c:338-389) disappears.  The chosen (length, dist) per position
is traced back on the host.

`squeeze_scan` takes the plain version (`squeeze_scan_plain`, a loop
over positions vectorised over blocks) for CPU tensors and launches the
hand-written CUDA kernel csrc/dp_scan.cu for CUDA tensors; it raises for
anything else.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import spec
from ..utils.counters import bump
from . import scan_kernel
from .costmodel import dist_symbol  # the reference's dist_symbol_jax

BIG = scan_kernel.BIG
W = 256          # match lengths 3..258
_WIN = 259       # window: the current position and the reach of matches
MAX_KBP = 16     # breakpoints per position the CUDA kernel supports

_LSYM = np.asarray(spec.LENGTH_SYMBOL[3:259], dtype=np.int64)
_LEXTRA = np.asarray(spec.LENGTH_EXTRA_BITS[3:259], dtype=np.float32)
DSYM_EXTRA = np.asarray(spec.DIST_SYM_EXTRA_BITS, dtype=np.float32)

__all__ = ["dist_symbol", "edge_cost_tables", "squeeze_scan",
           "squeeze_scan_plain", "traceback", "DSYM_EXTRA"]


def edge_cost_tables(ll_cost: torch.Tensor, d_cost: torch.Tensor,
                     bp_dsym: torch.Tensor, bp_dextra: torch.Tensor,
                     data_block: torch.Tensor):
    """Per-iteration cost arrays for the scan.

    ll_cost (B,288), d_cost (B,32): the statistical model in bits.
    bp_dsym/bp_dextra (B,L,MAX_BP): dist symbol / extra bits per breakpoint.
    data_block (B,L): input bytes per block position.

    Returns (lcost_vec (B,256), bp_dcost (B,L,MAX_BP), litcost (B,L)),
    float32.
    """
    dev = ll_cost.device
    ll_cost = ll_cost.to(torch.float32)
    d_cost = d_cost.to(torch.float32)
    lcost_vec = (ll_cost[:, torch.from_numpy(_LSYM).to(dev)]
                 + torch.from_numpy(_LEXTRA).to(dev)[None, :])
    B = bp_dsym.shape[0]
    bp_dcost = torch.gather(d_cost, 1, bp_dsym.reshape(B, -1).long()
                            ).reshape(bp_dsym.shape) + bp_dextra
    litcost = torch.gather(ll_cost, 1, data_block.long())
    return lcost_vec, bp_dcost, litcost


_CHUNK = 64  # positions whose edge tables the plain scan expands at once


def squeeze_scan_plain(bp_len, bp_dist, bp_dcost, litcost, lcost_vec,
                       length_mask):
    """Plain version of the dp_scan kernel; contract of squeeze_scan.

    The edge of length l at a position costs
    where(real, lcost_vec[l] + dcost(l), BIG), where dcost(l) is the
    distance cost of the lowest breakpoint k with 0 < l <= bp_len[k]
    (BIG if none): it does not depend on the DP state, so it is expanded
    for a chunk of positions at once; the loop over positions then
    relaxes the literal and the 256 match edges of each position.
    """
    dev = bp_len.device
    B, L, K = bp_len.shape
    lengths = torch.arange(3, 259, dtype=torch.int32, device=dev)
    # cost[:, p] / cl / cd: position p's cost and chosen edge, p = 0..L
    # plus the reach of the last position's matches.
    cost = torch.full((B, L + _WIN), BIG, dtype=torch.float32, device=dev)
    cost[:, 0] = 0.0
    cl = torch.zeros((B, L + _WIN), dtype=torch.int32, device=dev)
    cd = torch.zeros((B, L + _WIN), dtype=torch.int32, device=dev)
    big = torch.tensor(BIG, dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    real_all = length_mask.to(torch.bool)
    lit_all = torch.where(real_all, litcost.to(torch.float32), big)
    # A position that no row holds relaxes nothing (every edge costs
    # cost_j + BIG >= BIG, never < a window value): skip its step.
    live = real_all.any(dim=0).tolist()
    for c0 in range(0, L, _CHUNK):
        if not any(live[c0:c0 + _CHUNK]):
            continue
        c1 = min(c0 + _CHUNK, L)
        bl = bp_len[:, c0:c1]                             # (B, n, K)
        edge_dcost = torch.full((B, c1 - c0, W), BIG, dtype=torch.float32,
                                device=dev)
        edge_dist = torch.zeros((B, c1 - c0, W), dtype=torch.int32,
                                device=dev)
        for k in range(K - 1, -1, -1):
            blk = bl[:, :, k:k + 1]
            sel = (lengths <= blk) & (blk > 0)
            edge_dcost = torch.where(sel, bp_dcost[:, c0:c1, k:k + 1],
                                     edge_dcost)
            edge_dist = torch.where(sel, bp_dist[:, c0:c1, k:k + 1],
                                    edge_dist)
        edge = lcost_vec[:, None, :] + edge_dcost
        edge = torch.where(real_all[:, c0:c1, None], edge, big)
        for j in range(c0, c1):
            if not live[j]:
                continue
            cj = cost[:, j]
            lit_new = cj + lit_all[:, j]
            upd = lit_new < cost[:, j + 1]
            cost[:, j + 1] = torch.where(upd, lit_new, cost[:, j + 1])
            cl[:, j + 1] = torch.where(upd, one, cl[:, j + 1])
            cd[:, j + 1] = torch.where(upd, zero, cd[:, j + 1])
            new = cj[:, None] + edge[:, j - c0]
            old = cost[:, j + 3:j + _WIN]
            upd = new < old
            cost[:, j + 3:j + _WIN] = torch.where(upd, new, old)
            cl[:, j + 3:j + _WIN] = torch.where(upd, lengths,
                                                cl[:, j + 3:j + _WIN])
            cd[:, j + 3:j + _WIN] = torch.where(upd, edge_dist[:, j - c0],
                                                cd[:, j + 3:j + _WIN])
    # Column p of choice_len/choice_dist is the edge into position p
    # (column 0 stays 0); final_cost[:, j] is position j+1's cost.
    return (cl[:, :L + 1].contiguous(), cd[:, :L + 1].contiguous(),
            cost[:, 1:L + 1].contiguous())


def squeeze_scan(bp_len, bp_dist, bp_dcost, litcost, lcost_vec, length_mask):
    """Forward DP over all positions of B blocks.

    bp_len, bp_dist: (B, L, MAX_BP) int32 breakpoints (0 = unused slot)
    bp_dcost: (B, L, MAX_BP) float32 distance cost per breakpoint
    litcost: (B, L) float32 literal cost per position
    lcost_vec: (B, 256) float32 length-symbol cost for lengths 3..258
    length_mask: (B, L) bool -- True for real (non padding) positions

    Returns (choice_len, choice_dist): (B, L+1) int32 -- the edge chosen
    to *reach* each position (length 1 = literal) -- and the cost of
    each position (B, L) float32 (column j = position j+1).  CPU tensors
    take the plain version; CUDA tensors launch csrc/dp_scan.cu.
    """
    if scan_kernel.device_kind(bp_len) == "cpu":
        return squeeze_scan_plain(bp_len, bp_dist, bp_dcost, litcost,
                                  lcost_vec, length_mask)
    B, L, K = bp_len.shape
    if K > MAX_KBP or L <= 0 or B <= 0:
        raise ValueError(f"squeeze_scan: B={B} L={L} kbp={K}")
    chk = scan_kernel.check
    chk(bp_len, torch.int32, (B, L, K), "bp_len")
    chk(bp_dist, torch.int32, (B, L, K), "bp_dist")
    chk(bp_dcost, torch.float32, (B, L, K), "bp_dcost")
    chk(litcost, torch.float32, (B, L), "litcost")
    chk(lcost_vec, torch.float32, (B, W), "lcost_vec")
    chk(length_mask, torch.bool, (B, L), "length_mask")
    for t in (bp_dist, bp_dcost, litcost, lcost_vec, length_mask):
        if t.device != bp_len.device:
            raise ValueError("squeeze_scan: inputs on different devices")
    lib = scan_kernel.build_kernels()["dp_scan"]
    dev = bp_len.device
    # The kernel writes every element of the three outputs.
    choice_len = torch.empty((B, L + 1), dtype=torch.int32, device=dev)
    choice_dist = torch.empty((B, L + 1), dtype=torch.int32, device=dev)
    cost = torch.empty((B, L), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        scan_kernel.raise_on(lib.zt_dp_scan(
            bp_len.data_ptr(), bp_dist.data_ptr(), bp_dcost.data_ptr(),
            litcost.data_ptr(), lcost_vec.data_ptr(),
            length_mask.data_ptr(), choice_len.data_ptr(),
            choice_dist.data_ptr(), cost.data_ptr(), B, L, K, stream),
            "dp_scan")
    bump(scan_kernel.LAUNCHES, "dp_scan")
    return choice_len, choice_dist, cost


def traceback(choice_len: np.ndarray, choice_dist: np.ndarray, L: int,
              data_block: np.ndarray):
    """Host traceback: walk back from position L (squeeze.c:317-336)."""
    lens = []
    dists = []
    idx = L
    while idx > 0:
        l = int(choice_len[idx])
        assert 1 <= l <= idx, (l, idx)
        if l >= spec.MIN_MATCH:
            lens.append(l)
            dists.append(int(choice_dist[idx]))
        else:
            lens.append(int(data_block[idx - 1]))
            dists.append(0)
        idx -= l
    lens.reverse()
    dists.reverse()
    return (np.array(lens, dtype=np.uint16), np.array(dists, dtype=np.uint16))
