"""Data-parallel match candidate search, in PyTorch.

Port of zopfli_tpu/ops/hashmatch.py.  Replaces the reference's serial
hash-chain walk (lz77.c:407-542, hash.c) with a sort-based formulation:

1. A *fingerprint ladder*: rolling polynomial hashes, modulo 2^32, of
   prefixes at 26 lengths between 3 and 258 at every position.
2. An exact suffix order by prefix doubling on ranks; sorted neighbors
   share the longest prefixes, and the shared-prefix length of any pair
   is the running minimum of adjacent-pair lengths.
3. Per-rung most-recent occurrences (a stable sort per ladder length)
   give minimal distances for short and mid matches.
4. The min-distance-per-length step function ("sublen", lz77.h:115-118)
   as a skyline over (distance, length) pairs, condensed to MAX_BP
   breakpoints per position.

The hashes are unsigned 32-bit products in the reference; here they are
int64 tensors holding the same 32-bit patterns (products split in
16-bit halves so nothing overflows).  Multi-operand stable sorts become
one stable sort of a packed int64 key.  Outputs equal the JAX
package's bit for bit.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import spec
from .costmodel import floor_log2

LEVELS = (3, 4, 5, 6, 7, 8, 10, 12, 14, 16, 20, 24, 28, 32, 40, 48,
          56, 64, 80, 96, 112, 128, 160, 192, 224, 256)
# Sort-level presets are accepted for knob compatibility; the suffix
# order is the exact doubling order whatever they say.
_SORT_PRESETS = {
    "all": LEVELS,
    "coarse": (3, 5, 7, 10, 14, 20, 28, 40, 56, 80, 112, 160, 224),
    "short": (3, 4, 6, 8, 12, 16, 24, 40, 64),
    "short12": (3, 4, 5, 6, 8, 10, 14, 20, 28, 40, 64, 128),
}
SORT_LEVELS = _SORT_PRESETS[os.environ.get("ZT_SORT_LEVELS", "all")]
NEIGHBORS = 8
_RECENT_PRESETS = {
    "base": (3, 4, 5, 6, 7, 8, 10, 12, 14, 16, 20, 24, 28, 32, 48, 64),
    "dense": (3, 4, 5, 6, 7, 8, 10, 12, 14, 16, 20, 24, 28, 32, 36, 40,
              44, 48, 52, 56, 60, 64),
}
RECENT_LEVELS = _RECENT_PRESETS[os.environ.get("ZT_RECENT_LEVELS", "dense")]
MAX_BP = int(os.environ.get("ZT_MAX_BP", "12"))
_refine_env = os.environ.get("ZT_REFINE", "LD2")
if _refine_env.isdigit():
    _n = int(_refine_env)
    REFINE_PLAN = "L" * min(_n, 2) + "D" * max(_n - 2, 0)
else:
    REFINE_PLAN = _refine_env.upper()
SHORT_DISTS = int(os.environ.get("ZT_SHORT_DISTS", "16"))
RECENT_K2_MIN = int(os.environ.get("ZT_RECENT_K2", "16"))

KNOBS = {
    "sort_levels": SORT_LEVELS,
    "refine_plan": REFINE_PLAN,
    "short_dists": SHORT_DISTS,
    "recent_k2_min": RECENT_K2_MIN,
    "recent_levels": RECENT_LEVELS,
    "sort_group": 0,
}


def current_knobs() -> dict:
    return dict(KNOBS)


# Polynomial rolling-hash bases (odd): _P for sorts and grouping, _P2 to
# confirm every equality decision.
_P = 0x01000193
_P2 = 0xCC9E2D51
_M32 = 0xFFFFFFFF

# The block's bytes start at row PREFIX of the padded array; rows
# [PREFIX - prefix_len, PREFIX) hold real preceding bytes.
PREFIX = spec.WINDOW_SIZE
PAD_TAIL = 264  # rows after the block's capacity: >= MAX_MATCH + ladder slack


def _filler(n: int) -> np.ndarray:
    """Deterministic filler of the rows before the real prefix (min_pos
    rejects them; the pattern only avoids runs of equal hashes)."""
    return (np.arange(n, dtype=np.uint32) * 2654435761 >> 13).astype(np.uint8)


def pow2_cap(n: int) -> int:
    """Padded capacity of an n-byte block: a power of two >= 16384, so
    the set of shapes stays log-bounded (the JAX package's buckets)."""
    cap = 16384
    while cap < n:
        cap *= 2
    return cap


def padded_row(data: np.ndarray, instart: int, inend: int,
               window_start: int = 0, cap: int | None = None, out=None):
    """The padded input row of build_candidates for data[instart:inend].

    Filler, then up to a window of real preceding bytes (none before
    window_start), the block's bytes at PREFIX, zeros up to
    PREFIX + cap + PAD_TAIL.  cap defaults to pow2_cap of the block's
    length; `out`, a uint8 row of that length, is written in place of a
    new one.  Returns (row, cap, min_pos, inend_real).
    """
    L = inend - instart
    if cap is None:
        cap = pow2_cap(L)
    row = np.empty(PREFIX + cap + PAD_TAIL, np.uint8) if out is None else out
    prefix_len = min(instart - window_start, spec.WINDOW_SIZE)
    row[:PREFIX] = _filler(PREFIX)
    if prefix_len:
        row[PREFIX - prefix_len:PREFIX] = data[instart - prefix_len:instart]
    row[PREFIX:PREFIX + L] = data[instart:inend]
    row[PREFIX + L:] = 0
    return row, cap, PREFIX - prefix_len, PREFIX + L


def _pow_mod(e: int, base: int = _P) -> int:
    return pow(base, e, 1 << 32)


def _mulmod32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for a in [0, 2^32), without int64 overflow."""
    lo = a & 0xFFFF
    hi = a >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def _shifted(arr: torch.Tensor, by: int) -> torch.Tensor:
    return torch.cat([arr[by:], arr.new_zeros(by)])


def _ladder(x: torch.Tensor, base: int = _P) -> dict[int, torch.Tensor]:
    """32-bit prefix hashes for every LEVELS entry (+ pow2 scaffolding).

    H(s) = sum b[k] * P^(L-1-k); composition H_{a+b}[i] = H_a[i] * P^b +
    H_b[i+a] builds any length from power-of-two pieces.
    """
    h = {1: x}
    for lvl in (2, 4, 8, 16, 32, 64, 128, 256):
        half = lvl // 2
        h[lvl] = (_mulmod32(h[half], _pow_mod(half, base))
                  + _shifted(h[half], half)) & _M32

    def compose(parts):
        acc = None
        off = 0
        for p in parts:
            piece = _shifted(h[p], off) if off else h[p]
            acc = piece if acc is None else \
                (_mulmod32(acc, _pow_mod(p, base)) + piece) & _M32
            off += p
        return acc

    decomp = {3: (2, 1), 5: (4, 1), 6: (4, 2), 7: (4, 2, 1),
              10: (8, 2), 12: (8, 4), 14: (8, 4, 2), 20: (16, 4),
              24: (16, 8), 28: (16, 8, 4), 36: (32, 4), 40: (32, 8),
              44: (32, 8, 4), 48: (32, 16), 52: (32, 16, 4),
              56: (32, 16, 8), 60: (32, 16, 8, 4), 80: (64, 16),
              96: (64, 32), 112: (64, 32, 16), 160: (128, 32),
              192: (128, 64), 224: (128, 64, 32)}
    for lvl, parts in decomp.items():
        h[lvl] = compose(parts)

    # Exact 3-byte key (24 bits, collision-free) replaces the hashed 3.
    h[3] = (x << 16) | (_shifted(x, 1) << 8) | _shifted(x, 2)
    return h


def _ranks_of(sorted_changed: torch.Tensor, sidx: torch.Tensor):
    rank = torch.empty_like(sidx)
    rank[sidx] = torch.cumsum(sorted_changed.long(), dim=0) - 1
    return rank


def build_candidates(data_padded: torch.Tensor, block_cap: int,
                     min_pos: int, inend_real: int, *,
                     sort_levels: tuple = SORT_LEVELS,
                     refine_plan: str = REFINE_PLAN,
                     max_bp: int = MAX_BP,
                     short_dists: int = SHORT_DISTS,
                     recent_k2_min: int = RECENT_K2_MIN,
                     recent_levels: tuple = RECENT_LEVELS,
                     sort_group: int = 0):
    """Per-position condensed sublen tables for a block.

    data_padded: uint8 tensor of length PREFIX + block_cap + >=258; the
    block occupies rows [PREFIX, PREFIX + real_len).  min_pos: first row
    holding a real byte; inend_real: PREFIX + real block length.
    Returns (bp_len, bp_dist, best_len) int32 tensors on the input's
    device: (block_cap, max_bp), (block_cap, max_bp), (block_cap,).
    """
    from .devsplit import table

    del sort_levels, sort_group
    dev = data_padded.device
    x = data_padded.long()
    h = _ladder(x)
    h2 = _ladder(x, _P2)
    n = x.shape[0]
    instart = PREFIX
    L = block_cap
    nl = len(LEVELS)
    WS = spec.WINDOW_SIZE
    MM = spec.MAX_MATCH

    def full(shape, v):
        return torch.full(shape, v, dtype=torch.int64, device=dev)

    # EXACT suffix order by prefix doubling on ranks (Manber-Myers).
    sk3, sidx = torch.sort(h[3], stable=True)
    changed = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                         sk3[1:] != sk3[:-1]])
    rank = _ranks_of(changed, sidx)
    p = 3
    while p < MM:
        rs = torch.cat([rank[p:], full((p,), -1)])
        key = rank * (n + 1) + (rs + 1)         # (rank, rs) lexicographic
        k_s, sidx = torch.sort(key, stable=True)
        changed = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                             k_s[1:] != k_s[:-1]])
        rank = _ranks_of(changed, sidx)
        p *= 2
    skeys = torch.stack([h[lvl] for lvl in LEVELS])[:, sidx]

    # Adjacent-pair shared-prefix LENGTH (0 = not even 3 bytes).
    all_eq = torch.ones(n, dtype=torch.bool, device=dev)
    adj_lvl = full((n,), 0)
    adj_idx = full((n,), 0)
    for li in range(nl):
        sk = skeys[li]
        eq = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                        sk[1:] == sk[:-1]])
        all_eq = all_eq & eq
        adj_lvl = torch.where(all_eq, LEVELS[li], adj_lvl)
        adj_idx = torch.where(all_eq, li, adj_idx)
    del skeys

    # Confirm each pair's claimed level with the second hash family.
    h2flat = torch.stack([h2[lvl] for lvl in LEVELS]).reshape(-1)
    sidx_prev = torch.cat([sidx[:1], sidx[:-1]])
    vcur = h2flat[adj_idx * n + sidx]
    vprev = h2flat[adj_idx * n + sidx_prev]
    adj_lvl = torch.where(vcur == vprev, adj_lvl, 0)
    del h2flat, vcur, vprev, adj_idx

    # Extend every confirmed rung to the exact shared-prefix length.
    ln_adj = adj_lvl
    for lvl in (32, 16, 8, 4, 2, 1):
        fits = ln_adj >= spec.MIN_MATCH
        a = h[lvl][torch.where(fits, sidx + ln_adj, 0).clamp(0, n - 1)]
        b = h[lvl][torch.where(fits, sidx_prev + ln_adj, 0).clamp(0, n - 1)]
        ln_adj = torch.where(fits & (a == b), ln_adj + lvl, ln_adj)
    adj_lvl = torch.clamp(ln_adj, max=MM)

    # Neighbor candidates: positions j slots away in suffix order, with
    # pairwise length = running min of adjacent lengths.
    cand_list, lvl_list = [], []
    run_prev = run_next = None
    for j in range(1, NEIGHBORS + 1):
        if run_prev is None:
            run_prev = adj_lvl
        else:
            sh = torch.cat([full((j - 1,), 0), adj_lvl[:-(j - 1)]])
            run_prev = torch.minimum(run_prev, sh)
        cand_list.append(torch.cat([full((j,), -1), sidx[:-j]]))
        lvl_list.append(run_prev)
        nshift = torch.cat([adj_lvl[j:], full((j,), 0)])
        run_next = nshift if run_next is None else \
            torch.minimum(run_next, nshift)
        cand_list.append(torch.cat([sidx[j:], full((j,), -1)]))
        lvl_list.append(run_next)

    # Back to position order, block rows only.
    cand_pos = full((n, 2 * NEIGHBORS), -1)
    cand_pos[sidx] = torch.stack(cand_list, dim=1)
    cand_lvl = full((n, 2 * NEIGHBORS), 0)
    cand_lvl[sidx] = torch.stack(lvl_list, dim=1)
    cand_pos = cand_pos[instart:instart + L]
    cand_lvl = cand_lvl[instart:instart + L]
    del cand_list, lvl_list, run_prev, run_next

    pos = torch.arange(L, device=dev)[:, None] + instart
    cap = torch.clamp(inend_real - pos, 0, MM)               # (L, 1)

    # Suffix-neighbor candidates.
    valid_n = (cand_pos >= 0) & (cand_pos >= min_pos) & (cand_pos < pos)
    dist_n32 = torch.where(valid_n, pos - cand_pos, WS + 1)
    ok_n = valid_n & (dist_n32 <= WS)
    dist_n = torch.where(ok_n, dist_n32, WS + 1)
    ln_n = torch.minimum(torch.where(ok_n, cand_lvl, 0), cap)
    del cand_pos, cand_lvl, valid_n, dist_n32, ok_n

    # Per-level most-recent candidates, one batched stable sort.
    nr = len(recent_levels)
    keys = torch.stack([h[lvl] for lvl in recent_levels])    # (R, n)
    keys2 = torch.stack([h2[lvl] for lvl in recent_levels])
    sk, si = torch.sort(keys, dim=1, stable=True)
    sk2 = torch.gather(keys2, 1, si)
    del keys, keys2
    prev_i = torch.cat([full((nr, 1), -1), si[:, :-1]], dim=1)
    prev_k = torch.cat([full((nr, 1), 0), sk[:, :-1]], dim=1)
    prev_k2 = torch.cat([full((nr, 1), 0), sk2[:, :-1]], dim=1)
    same = (prev_k == sk) & (prev_k2 == sk2) & (prev_i >= min_pos)
    dist_sr = si - prev_i
    ok = same & (dist_sr >= 1) & (dist_sr <= WS)
    recent_all = full((nr, n), -1)
    recent_all.scatter_(1, si, torch.where(ok, prev_i, -1))
    recent_all = recent_all[:, instart:instart + L]           # (R, L)
    del prev_k, prev_k2, same, dist_sr, ok

    lvl_arr = table(f"recent_levels{tuple(recent_levels)}",
                    np.asarray(recent_levels, np.int64), dev)
    valid_r = recent_all >= 0
    dist_r = torch.where(valid_r, pos.T - recent_all, WS + 1)
    ln_r = torch.where(valid_r, lvl_arr[:, None], 0)
    ln_parts = [ln_n, torch.minimum(ln_r, cap.T).T]
    dist_parts = [dist_n, dist_r.T]
    del recent_all, valid_r, dist_r, ln_r

    # k=2 recents: the SECOND most-recent occurrence per rung.
    n_k2 = 0
    if recent_k2_min:
        k2_rows = [i for i, lvl in enumerate(recent_levels)
                   if lvl >= recent_k2_min]
        n_k2 = len(k2_rows)
        rows_a = table(f"k2_rows{tuple(k2_rows)}",
                       np.asarray(k2_rows, np.int64), dev)
        prev2_i = torch.cat([full((nr, 2), -1), si[:, :-2]], dim=1)
        same2 = torch.cat(
            [torch.zeros((nr, 2), dtype=torch.bool, device=dev),
             (sk[:, 2:] == sk[:, :-2]) & (sk2[:, 2:] == sk2[:, :-2])],
            dim=1) & (prev2_i >= min_pos)
        d2 = si - prev2_i
        ok2 = same2 & (d2 >= 1) & (d2 <= WS)
        recent2 = full((nr, n), -1)
        recent2.scatter_(1, si, torch.where(ok2, prev2_i, -1))
        recent2 = recent2[rows_a][:, instart:instart + L]     # (K2, L)
        valid2 = recent2 >= 0
        dist2 = torch.where(valid2, pos.T - recent2, WS + 1)
        ln2 = torch.where(valid2, lvl_arr[rows_a][:, None], 0)
        ln_parts.append(torch.minimum(ln2, cap.T).T)
        dist_parts.append(dist2.T)
        del prev2_i, same2, d2, ok2, recent2, valid2, dist2, ln2
    del sk, si, sk2

    # Exact short-distance candidates: run lengths of x[i] == x[i-d] by
    # doubling (after step s, r = min(true_run, 2s)).
    if short_dists:
        eq_rows = torch.stack([
            torch.cat([torch.zeros(d, dtype=torch.bool, device=dev),
                       x[d:] == x[:-d]])
            for d in range(1, short_dists + 1)])              # (D, n)
        r = eq_rows.long()
        for s in (1, 2, 4, 8, 16, 32, 64, 128, 256):
            sh = torch.cat([r[:, s:], full((short_dists, s), 0)], dim=1)
            r = torch.where(r == s, r + sh, r)
        iota_n = torch.arange(n, device=dev)
        dvec = torch.arange(1, short_dists + 1, device=dev)
        ok = (iota_n[None, :] - dvec[:, None]) >= min_pos
        ln_sd = torch.where(ok, r, 0)[:, instart:instart + L].T
        ln_parts.append(torch.minimum(ln_sd, cap))
        dist_parts.append(dvec[None, :].expand(L, short_dists))
        del eq_rows, r

    lcp = torch.cat(ln_parts, dim=1)
    dist = torch.cat(dist_parts, dim=1)
    C = lcp.shape[1]
    del ln_parts, dist_parts

    # Exact refinement: each round resolves one claim's TRUE length with
    # a sparse-table range-min over the exact adjacent lcps in suffix
    # order (lcp(a, b) = min of adjacent lcps between their ranks).
    p1 = pos[:, 0]
    cap1 = cap[:, 0]
    rank = torch.empty_like(sidx)
    rank[sidx] = torch.arange(n, device=dev)
    rank_blk = rank[instart:instart + L]
    nlev = max(1, (n - 1).bit_length())
    t_levels = [adj_lvl]
    tcur = adj_lvl
    for k in range(1, nlev + 1):
        sh = 1 << (k - 1)
        tcur = torch.minimum(tcur, torch.cat([tcur[sh:], full((sh,), MM)]))
        t_levels.append(tcur)
    t_flat = torch.cat(t_levels)
    nflat = t_flat.shape[0]

    def rmq_lcp(c_other):
        rb = rank[c_other.clamp(0, n - 1)]
        lo = torch.minimum(rank_blk, rb) + 1
        hi = torch.maximum(rank_blk, rb)
        width = hi - lo + 1
        k = torch.where(width >= 1, floor_log2(width.clamp(min=1)), 0)
        pk = torch.ones_like(k) << k
        v1 = t_flat[(k * n + lo).clamp(0, nflat - 1)]
        v2 = t_flat[(k * n + hi - pk + 1).clamp(0, nflat - 1)]
        return torch.minimum(v1, v2)

    # Short-distance columns are exact already: never selected.
    lcp_work = lcp
    if short_dists:
        selectable = torch.ones(C, dtype=torch.bool, device=dev)
        selectable[C - short_dists:] = False
        lcp_work = torch.where(selectable[None, :], lcp, 0)
    n_neigh = 2 * NEIGHBORS
    iota_c = torch.arange(C, device=dev)
    extra_ln, extra_dist = [], []
    for kind in refine_plan:
        if kind == "L":
            bestk = torch.argmax(lcp_work, dim=1)
        elif kind in "R2":
            rsel = torch.zeros(C, dtype=torch.bool, device=dev)
            if kind == "R":
                rsel[n_neigh:n_neigh + nr] = True
            else:
                rsel[n_neigh + nr:n_neigh + nr + n_k2] = True
            bestk = torch.argmax(torch.where(rsel[None, :], lcp_work, 0),
                                 dim=1)
        else:
            dist_work = torch.where(lcp_work >= spec.MIN_MATCH, dist, 65535)
            bestk = torch.argmin(dist_work, dim=1)
        sel = iota_c[None, :] == bestk[:, None]               # (L, C)
        bdist = torch.where(sel, dist, 0).amax(dim=1)
        claim = torch.where(sel, lcp_work, 0).amax(dim=1)
        has = claim >= spec.MIN_MATCH
        c1 = torch.where(has, p1 - bdist, 0)
        ln = torch.minimum(rmq_lcp(c1), cap1)
        refined = torch.maximum(claim, torch.where(has, ln, 0))
        extra_ln.append(torch.where(has, refined, 0))
        extra_dist.append(torch.where(has, bdist, WS + 1))
        lcp = torch.where(sel & has[:, None], 0, lcp)
        lcp_work = torch.where(sel, 0, lcp_work)
    if extra_ln:
        lcp = torch.cat([lcp] + [e[:, None] for e in extra_ln], dim=1)
        dist = torch.cat([dist] + [e[:, None] for e in extra_dist], dim=1)
        C = lcp.shape[1]
    del lcp_work, t_flat, t_levels

    # Skyline: sort rows by ONE packed key, dist << 9 | (258 - len) ==
    # (distance asc, length desc); keep candidates whose length strictly
    # exceeds every smaller-distance length.
    packed_s = torch.sort((dist << 9) | (MM - lcp), dim=1).values
    enc_s = packed_s & 511                                    # 258 - len
    run_min = torch.cummin(torch.cat(
        [full((L, 1), MM - spec.MIN_MATCH + 1), enc_s[:, :-1]], dim=1),
        dim=1).values
    keep = (enc_s < run_min) & (enc_s <= MM - spec.MIN_MATCH) & \
        (packed_s < ((WS + 1) << 9))
    best_len = MM - torch.where(keep, enc_s, MM).amin(dim=1)

    # Condense to max_bp slots (first max_bp-1 kept plus the final,
    # longest one) via one more single-key sort: rank | len | dist.
    assert C < 128, C
    slot = torch.cumsum(keep.long(), dim=1) - 1
    slot = torch.where(keep, slot, C)
    last_slot = keep.sum(dim=1) - 1
    is_last = keep & (slot == last_slot[:, None])
    rank_c = torch.where(
        slot < max_bp - 1, slot,
        torch.where(is_last, torch.clamp(last_slot, max=max_bp - 1)[:, None],
                    C))
    lenbits = torch.where(keep, MM - enc_s, 0)
    distbits = torch.where(keep, packed_s >> 9, 0)
    v = (rank_c << 25) | (lenbits << 16) | distbits
    v_s = torch.sort(v, dim=1).values[:, :max_bp]
    bp_len = ((v_s >> 16) & 511).to(torch.int32)
    bp_dist = (v_s & 65535).to(torch.int32)
    return (bp_len.contiguous(), bp_dist.contiguous(),
            best_len.to(torch.int32))
