"""Data-parallel block pipeline over a list of torch devices.

Port of zopfli_tpu/parallel/dist.py.  Independent deflate blocks become
one batched block axis; `sharded_pipeline` splits the rows over the
devices, each device runs the full per-block compute (candidate search +
min-plus squeeze DP, ops.dp) on its rows, and the only collective is the
sum of the per-shard cost totals (compression is data-parallel: the
ragged bitstream gather happens on the host, parallel.multihost).

Block layout (one row per block, fixed shape):

    [ filler | window prefix (halo) | block bytes | padding ]
      ^PREFIX-prefix_len            ^PREFIX       ^PREFIX+len

The 32 KiB halo of preceding bytes restores cross-block matches at shard
boundaries (reference semantics: deflate.c:802-810 warmup), while every
block stays independent.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import dp, hashmatch

PREFIX = hashmatch.PREFIX
PAD_TAIL = hashmatch.PAD_TAIL


def total_row_len(cap: int) -> int:
    """Padded row length for a block capacity."""
    return PREFIX + cap + PAD_TAIL


def make_devices(n: int | None = None, device: str = "cuda"
                 ) -> list[torch.device]:
    """The devices of the batched-block axis (the reference's make_mesh):
    the first n CUDA devices (all by default), or n CPU entries."""
    if torch.device(device).type == "cpu":
        return [torch.device("cpu")] * (n or 1)
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("make_devices: CUDA is not available")
    n = count if n is None else n
    if not 1 <= n <= count:
        raise ValueError(f"make_devices: {n} of {count} CUDA devices")
    return [torch.device("cuda", i) for i in range(n)]


def _as_tensor(x, device, dtype):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device=device,
                                                       dtype=dtype)


def block_pipeline(bufs, cap: int, min_pos, inend_real, ll_cost, d_cost,
                   device="cuda"):
    """Full squeeze DP for a batch of blocks on one device.

    bufs: (B, total_row_len(cap)) uint8 padded block rows
    min_pos: (B,) int32 -- first row index holding a real (halo) byte
    inend_real: (B,) int32 -- PREFIX + real block length
    ll_cost: (B, 288) float32, d_cost: (B, 32) float32 -- cost model
    Numpy inputs go to `device`; tensors keep theirs.

    Returns (choice_len, choice_dist, final_cost):
      choice_len/choice_dist (B, cap+1) int32 -- edge chosen to reach
      each position; final_cost (B,) float32 -- DP cost of each block.
    """
    dev = bufs.device if isinstance(bufs, torch.Tensor) else \
        torch.device(device)
    bufs = _as_tensor(bufs, dev, torch.uint8)
    min_pos_h = [int(v) for v in np.asarray(
        min_pos.cpu() if isinstance(min_pos, torch.Tensor) else min_pos)]
    inend_h = [int(v) for v in np.asarray(
        inend_real.cpu() if isinstance(inend_real, torch.Tensor)
        else inend_real)]
    # The candidate search takes one row at a time (the reference vmaps
    # it over the rows).
    rows = [hashmatch.build_candidates(bufs[i], cap, mp, ie)
            for i, (mp, ie) in enumerate(zip(min_pos_h, inend_h))]
    bp_len = torch.stack([r[0] for r in rows]).to(torch.int32)
    bp_dist = torch.stack([r[1] for r in rows]).to(torch.int32)
    del rows

    dsym = dp.dist_symbol(torch.clamp(bp_dist, min=1))
    dextra = torch.from_numpy(dp.DSYM_EXTRA).to(dev)[dsym.long()]
    data_block = bufs[:, PREFIX:PREFIX + cap].to(torch.int32)
    real_len = torch.tensor(inend_h, dtype=torch.int64, device=dev) - PREFIX
    mask = (torch.arange(cap, device=dev)[None, :] < real_len[:, None])

    lcost_vec, bp_dcost, litcost = dp.edge_cost_tables(
        _as_tensor(ll_cost, dev, torch.float32),
        _as_tensor(d_cost, dev, torch.float32), dsym, dextra, data_block)
    choice_len, choice_dist, costs = dp.squeeze_scan(
        bp_len.contiguous(), bp_dist.contiguous(), bp_dcost.contiguous(),
        litcost.contiguous(), lcost_vec.contiguous(), mask.contiguous())
    # costs[:, j] is the cost of position j+1; block cost is at real_len-1.
    idx = torch.clamp(real_len - 1, 0, cap - 1)
    final_cost = torch.gather(costs, 1, idx[:, None])[:, 0]
    final_cost = torch.where(real_len > 0, final_cost,
                             torch.zeros_like(final_cost))
    return choice_len, choice_dist, final_cost


def sharded_pipeline(devices, cap: int):
    """The block pipeline with its rows split over `devices`.

    Returns fn(bufs, min_pos, inend_real, ll_cost, d_cost) ->
    (choice_len, choice_dist, final_cost, total): the first three as
    block_pipeline's, gathered on devices[0], and the sum of the shard
    cost totals (the one collective).  The row count must be a multiple
    of the device count, as the reference's shard_map requires.
    """
    devices = [torch.device(d) for d in devices]

    def fn(bufs, min_pos, inend_real, ll_cost, d_cost):
        B = len(bufs)
        nd = len(devices)
        if B % nd:
            raise ValueError(f"sharded_pipeline: {B} rows over {nd} devices")
        per = B // nd
        outs, totals = [], []
        for i, d in enumerate(devices):
            sl = slice(i * per, (i + 1) * per)
            cl, cd, cost = block_pipeline(
                _as_tensor(bufs[sl], d, torch.uint8), cap, min_pos[sl],
                inend_real[sl], _as_tensor(ll_cost[sl], d, torch.float32),
                _as_tensor(d_cost[sl], d, torch.float32))
            outs.append((cl, cd, cost))
            totals.append(cost.sum().to(devices[0]))
        home = devices[0]
        cl, cd, cost = (torch.cat([o[k].to(home) for o in outs])
                        for k in range(3))
        return cl, cd, cost, torch.stack(totals).sum()

    return fn


def pack_blocks(data: np.ndarray, ranges: list[tuple[int, int]], cap: int):
    """Pack (instart, inend) block ranges of `data` into padded rows.

    Returns (bufs (B,total) uint8, min_pos (B,) i32, inend_real (B,) i32).
    Every range must satisfy inend - instart <= cap.
    """
    B = len(ranges)
    bufs = np.empty((B, total_row_len(cap)), dtype=np.uint8)
    min_pos = np.empty(B, dtype=np.int32)
    inend_real = np.empty(B, dtype=np.int32)
    for i, (instart, inend) in enumerate(ranges):
        if not 0 <= inend - instart <= cap:
            raise ValueError(f"pack_blocks: range {instart, inend} over "
                             f"cap {cap}")
        _, _, min_pos[i], inend_real[i] = hashmatch.padded_row(
            data, instart, inend, cap=cap, out=bufs[i])
    return bufs, min_pos, inend_real
