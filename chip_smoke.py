#!/usr/bin/env python3
"""Smoke run of zopfli_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py                # every phase
    python3 chip_smoke.py --only kernels # build + kernel checks only

Phases, each printed as one JSON line:
  1. environment: the card's name and power limit, the kernels' build.
  2. kernels: each CUDA kernel against its plain PyTorch version on the
     card, on real inputs at production shapes (TILE=8192, LANES=256,
     KBP=12) for the phase-3 input:
       - scan and traceback on the first squeeze iteration's inputs
         (the port's candidate tables, costs from the greedy seed stats)
         and on the device seed program's fixed-cost inputs;
       - hist_cost on the seed's per-block histograms, on one batch of
         split-probe histograms, and on seeded random batches of 1, 18
         and 2048 rows with edge rows;
       - autotype_cost on the first probe rounds of the seed's device
         split and its largest round, and on seeded random ranges with
         edge cases (ends on and beside checkpoints, ends at ncap, empty
         and reversed ranges, ranges inside one checkpoint) under each
         fixed-cost gate (the whole store's, true and false, and one
         per range); one probe round under torch.profiler must be
         one kernel and two copies;
       - where a K3 row's cycles go, phase by phase, in the first design
         and in this one (experiments/exp_hist_cost_phases.py);
       - then the CASES shapes on seeded random inputs (ties, unsorted
         breakpoints, odd tiles and lane counts, cut paths).
     Outputs must be bit-equal, and one warm scan + traceback pair must
     not sync the stream.  The device split of the seed parse must equal
     the host splitter on the same stream.  Times are CUDA-event means
     over warm launches (for the two cost kernels, `ms` is of launches
     captured in a CUDA graph, so that their Python wrapper is out of
     the time, and `ms_eager` of eager calls back to back).
  3. main path: zopfli_tpu_torch.compress(1 MiB, "gzip", --i15) on the
     card at the defaults (device seed): it must round-trip through
     zlib, launch scan and traceback 15 + (seed programs) times,
     hist_cost at least once and autotype_cost once per split probe
     round, call no host greedy parse, fall back to
     the host engine for no block, and stay within 2% of the native
     engine's size.  One warm ZT_SEED=greedy run is timed beside it.
  4. profile: one more default compress under torch.profiler -- host
     time per pipeline stage, device time per kernel, the device's idle
     share.  It fails only if the profiler fails or sees no device time.
  5. many: compress_many on the corpus files as separate inputs and on
     two identical adjacent inputs; each output must round-trip alone.
Then a `kernels` JSON line, and last {"ok": true, "device": {...}}.
Exits non-zero, printing no result, if any phase fails or no GPU is
present.  Imports nothing of JAX.
"""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys
import time
import traceback
import zlib

HERE = os.path.dirname(os.path.abspath(__file__))
MIB = 1 << 20
ITERATIONS = 15
# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s
# outside the tensor cores.  int32 operations: 64 INT32 lanes per SM
# (Hopper architecture white paper) x 132 SMs x 1.98 GHz.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
INT32_OPS = 64 * 132 * 1.98e9


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def corpus_paths() -> list[str]:
    """The repo's own text: zopfli_tpu/**/*.py and the root *.md files,
    sorted by path."""
    return sorted(glob.glob(os.path.join(HERE, "zopfli_tpu", "**", "*.py"),
                            recursive=True)
                  + glob.glob(os.path.join(HERE, "*.md")))


def corpus_1mib() -> bytes:
    """2^20 bytes of the corpus files, concatenated, repeated or cut."""
    blob = b"".join(open(p, "rb").read() for p in corpus_paths())
    if not blob:
        raise RuntimeError("no repo text found beside chip_smoke.py")
    return (blob * (MIB // len(blob) + 1))[:MIB]


def cuda_time_ms(fn, reps: int, warm: int = 1) -> float:
    import torch
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_env(zt_scan):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi failed: {smi.stderr.strip()}", flush=True)
    t0 = time.time()
    zt_scan.build_kernels()
    secs = time.time() - t0
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln or "smem" in ln]
             for name, log in zt_scan.BUILD_LOG.items()}
    emit({"phase": "build", "ok": True, "seconds": round(secs, 3),
          "ptxas": ptxas})


def bytes_bound(nbytes: float, ops: float,
                int_ops: float = 0) -> tuple[float, str]:
    """(least ms, what bounds it) for the bytes a kernel must move, its
    f32 operations and its int32 operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / F32_FLOPS + int_ops / INT32_OPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def graph_time_ms(fn, reps: int) -> float:
    """Device ms per call of fn: `reps` calls captured in one CUDA graph,
    replayed between CUDA events, so the host's launch cost is out of
    the time (for kernels shorter than their Python wrapper)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernels(data, dev="cuda"):
    """Each kernel against its plain version at production shapes."""
    import numpy as np
    import torch

    from zopfli_tpu_torch import native
    from zopfli_tpu_torch.deflate import Options, split_master
    from zopfli_tpu_torch.ops import fused_engine, scan_kernel as sk
    from zopfli_tpu_torch.squeeze_batched import greedy_seed_stats

    dev = torch.device(dev)
    n = len(data)
    bounds = split_master(Options(numiterations=ITERATIONS, engine="native"),
                          data, 0, n, native.greedy)
    fs = fused_engine.FusedSqueeze(data, [(0, n, bounds)], device=dev)
    seed_ll, seed_d = greedy_seed_stats(data, fs.block_bounds, native.greedy)
    sll, sd, _ = fs.initial_stats(seed_ll, seed_d)
    inputs = fs.scan_inputs(torch.from_numpy(sll).to(dev),
                            torch.from_numpy(sd).to(dev))
    G = fs.ngroups
    rows, kbp, nt = inputs[0].shape
    tile = rows // G
    symtab = fs.symtab

    ce_k, cost_k = sk.scan(*inputs, groups=G)
    ce_p, cost_p = sk.scan_plain(*inputs, groups=G)
    hist_k, pe_k = sk.traceback(ce_k, fs.lit_t, fs.tile_nbytes_d, symtab,
                                groups=G)
    hist_p, pe_p = sk.traceback_plain(ce_k, fs.lit_t, fs.tile_nbytes_d,
                                      symtab, groups=G)
    torch.cuda.synchronize()
    checks = {
        "ce": torch.equal(ce_k, ce_p),
        "cost": torch.equal(cost_k.view(torch.int32),
                            cost_p.view(torch.int32)),
        "hist": torch.equal(hist_k, hist_p),
        "pe": torch.equal(pe_k, pe_p),
    }
    scan_err = max(float((cost_k.double() - cost_p.double()).abs().max()),
                   float((ce_k.long() - ce_p.long()).abs().max()))
    tb_err = max(float((hist_k - hist_p).abs().max()),
                 float((pe_k.long() - pe_p.long()).abs().max()))

    scan_ms = cuda_time_ms(lambda: sk.scan(*inputs, groups=G), reps=10)
    tb_ms = cuda_time_ms(lambda: sk.traceback(
        ce_k, fs.lit_t, fs.tile_nbytes_d, symtab, groups=G), reps=20)
    scan_plain_ms = cuda_time_ms(lambda: sk.scan_plain(*inputs, groups=G),
                                 reps=2, warm=0)
    tb_plain_ms = cuda_time_ms(lambda: sk.traceback_plain(
        ce_k, fs.lit_t, fs.tile_nbytes_d, symtab, groups=G), reps=2, warm=0)

    # Least time for the same work.  Scan: every input read once and both
    # outputs written once; its operations are 2 f32 adds + 1 compare per
    # relaxation that lands inside the tile, and 2 per literal.
    in_bytes = sum(t.numel() * t.element_size() for t in inputs)
    scan_bytes = in_bytes + ce_k.numel() * 4 + cost_k.numel() * 4
    steps = np.arange(tile)
    relax = int(np.clip(tile - steps - 2, 0, sk.W).sum())
    scan_ops = G * nt * (3 * relax + 2 * tile)
    scan_bound, scan_by = bytes_bound(scan_bytes, scan_ops)
    # Traceback: the path rows it must read (ce, and lit at literals),
    # tile_nbytes and the symbol tables, and both outputs written once.
    path = pe_k != 0
    nlit = int(((pe_k & sk.LEN_MASK) == 1).sum())
    npath = int(path.sum())
    npath_max = int(path.sum(dim=0).max())  # the longest walk of a lane
    tb_bytes = (4 * npath + 4 * nlit + 4 * G * nt + symtab.nbytes
                + hist_k.numel() * 4 + pe_k.numel() * 4)
    tb_ops = 4 * npath
    tb_bound, tb_by = bytes_bound(tb_bytes, tb_ops)

    # One warm scan + traceback pair, with symtab as FusedSqueeze holds
    # it, must not sync the stream.
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ce_s, _ = sk.scan(*inputs, groups=G)
        sk.traceback(ce_s, fs.lit_t, fs.tile_nbytes_d, symtab, groups=G)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    checks["no_sync"] = True

    checks.update(_case_checks(dev))
    seed_report, seed_checks, k3s = _seed_checks(data, dev)
    checks.update(seed_checks)
    ok = all(checks.values())
    emit({"phase": "kernels", "ok": ok, "bit_equal": checks,
          "shape": {"groups": G, "tile": tile, "lanes": nt, "kbp": kbp},
          "smem_bytes": {
              "scan": sk.build_kernels()["scan"].zt_scan_smem_bytes(kbp),
              "traceback": sk.build_kernels()[
                  "traceback"].zt_traceback_smem_bytes(tile),
              "hist_cost": sk.build_kernels()[
                  "hist_cost"].zt_hist_cost_smem_bytes()},
          "path_rows": npath, "path_rows_max_lane": npath_max,
          "scan_ms": scan_ms,
          "scan_plain_ms": scan_plain_ms, "traceback_ms": tb_ms,
          "traceback_plain_ms": tb_plain_ms, "seed": seed_report})
    if not ok:
        raise RuntimeError(f"kernel disagrees with its plain version: "
                           f"{checks}")
    return {
        "scan": {"name": "scan", "route": "cuda",
                 "source": "zopfli_tpu_torch/csrc/scan.cu",
                 "replaces": sk.REPLACES["scan"], "max_abs_err": scan_err,
                 "ms": scan_ms, "plain_ms": scan_plain_ms,
                 "bound_ms": scan_bound, "bound_by": scan_by,
                 "library_ms": None},
        "traceback": {"name": "traceback", "route": "cuda",
                      "source": "zopfli_tpu_torch/csrc/traceback.cu",
                      "replaces": sk.REPLACES["traceback"],
                      "max_abs_err": tb_err, "ms": tb_ms,
                      "plain_ms": tb_plain_ms, "bound_ms": tb_bound,
                      "bound_by": tb_by, "library_ms": None},
        **k3s,
    }


def _hist_edge_batch(rng, B):
    """Seeded random (B, 288) / (B, 32) counts with edge rows: all zero,
    one symbol, two symbols, all 288 nonzero, long equal runs (the RLE
    path), counts near 2^24."""
    import numpy as np

    ll = rng.integers(0, 3000, (B, 288)) * (rng.random((B, 288)) < 0.5)
    d = rng.integers(0, 500, (B, 32)) * (rng.random((B, 32)) < 0.6)
    edges = [(np.zeros(288, np.int64), np.zeros(32, np.int64))]  # zero
    one = np.zeros(288, np.int64)
    one[65] = 9
    edges.append((one, np.eye(32, dtype=np.int64)[3]))     # one symbol
    two = np.zeros(288, np.int64)
    two[[1, 270]] = [4, 5]
    edges.append((two, np.zeros(32, np.int64)))            # two symbols
    edges.append((rng.integers(1, 100, 288),
                  rng.integers(1, 100, 32)))               # all nonzero
    runs = np.full(288, 7)
    runs[100:140] = 0
    runs[200:230] = 12
    edges.append((runs, np.full(32, 3)))                   # long runs
    edges.append((rng.integers((1 << 24) - 1000, 1 << 24, 288),
                  rng.integers((1 << 24) - 100, 1 << 24, 32)))  # ~2^24
    for i, (a, b) in enumerate(edges[:B]):
        ll[i], d[i] = a, b
    ll[:, 286:] = 0
    d[:, 30:] = 0
    return ll, d


def _seed_checks(data, dev):
    """The seed program's kernels on its real inputs, hist_cost, and the
    device split against the host splitter on the seed parse."""
    import numpy as np
    import torch

    from zopfli_tpu_torch import blocks
    from zopfli_tpu_torch.deflate import Options, scaled_maxblocks
    from zopfli_tpu_torch.lz77 import LZ77Store
    from zopfli_tpu_torch.ops import costmodel as cm
    from zopfli_tpu_torch.ops import devsplit, hashmatch, seed
    from zopfli_tpu_torch.ops import scan_kernel as sk

    n = len(data)
    mb = scaled_maxblocks(Options(), n)
    buf, cap, min_pos, inend_real = seed.master_buffer(data, 0, n)
    core = seed.make_seed_core(
        cap, mb, tuple(sorted(hashmatch.current_knobs().items())))
    bufd = torch.from_numpy(buf).to(dev)
    scan_args, lit_t, nbytes_g, _bl, _bd = core.scan_inputs(
        bufd, min_pos, inend_real)
    G = core.G
    checks, report = {}, {"groups": G, "lanes_used": int(
        (nbytes_g > 0).sum())}

    # K1 / K2 on the fixed-cost inputs (integer costs, many exact ties).
    ce, cost = sk.scan(*scan_args, groups=G)
    pce, pcost = sk.scan_plain(*scan_args, groups=G)
    hist, pe = sk.traceback(ce, lit_t, nbytes_g, core.symtab, groups=G)
    phist, ppe = sk.traceback_plain(ce, lit_t, nbytes_g, core.symtab,
                                    groups=G)
    checks["seed_scan"] = torch.equal(ce, pce) and torch.equal(
        cost.view(torch.int32), pcost.view(torch.int32))
    checks["seed_traceback"] = torch.equal(hist, phist) and torch.equal(
        pe, ppe)
    report["scan_ms"] = cuda_time_ms(lambda: sk.scan(*scan_args, groups=G),
                                     reps=10)
    report["traceback_ms"] = cuda_time_ms(lambda: sk.traceback(
        ce, lit_t, nbytes_g, core.symtab, groups=G), reps=20)
    report["scan_plain_ms"] = cuda_time_ms(
        lambda: sk.scan_plain(*scan_args, groups=G), reps=1, warm=0)
    report["traceback_plain_ms"] = cuda_time_ms(lambda: sk.traceback_plain(
        ce, lit_t, nbytes_g, core.symtab, groups=G), reps=1, warm=0)

    # The whole parse, then the device split against the host splitter
    # on the same symbol stream.
    t0 = time.time()
    parsed = core.parse(bufd, min_pos, inend_real)
    nsym = int(parsed[3])
    report["parse_s"] = time.time() - t0
    lit_s, dist_s = (t[:nsym].cpu().numpy().astype(np.uint16)
                     for t in parsed[:2])
    # The device split; its probe rounds are recorded for the checks of
    # the autotype_cost kernel below.
    rounds = []
    probe_round = devsplit.probe_round

    def recording(tabs, pa, pb, ncap, small):
        rounds.append((pa.copy(), pb.copy(), small))
        return probe_round(tabs, pa, pb, ncap, small)

    before = dict(devsplit.STATS)
    devsplit.probe_round = recording
    try:
        t0 = time.time()
        sp, npts = devsplit.split_lz77_device(parsed[0], parsed[1],
                                              core.DCAP, mb, nsym)
        report["device_split_s"] = time.time() - t0
    finally:
        devsplit.probe_round = probe_round
    report["device_split_rounds"] = (devsplit.STATS["rounds"]
                                     - before["rounds"])
    report["device_split_syncs"] = devsplit.STATS["syncs"] - before["syncs"]
    t0 = time.time()
    host = blocks.block_split_lz77(LZ77Store(data, lit_s, dist_s, 0), mb)
    report["host_split_s"] = time.time() - t0
    report["symbols"] = nsym
    report["split_points"] = sp[:npts]
    checks["device_split_vs_host"] = sp[:npts] == host

    # K3 on the seed's per-block histograms, one batch of split-probe
    # histograms (FindMinimum's first round over the whole stream, with
    # the segment's own cost), and seeded random batches.
    out = core.finish(parsed)
    k3_sets = {"seed_blocks": (out[3], out[4])}
    ll_sym, d_sym, nbytes = devsplit.stream_symbols(
        parsed[0], parsed[1], core.DCAP, nsym)
    ll_ck, d_ck, bcum = devsplit.checkpoints(ll_sym, d_sym, nbytes,
                                             core.DCAP, nsym)
    tabs = (ll_ck, d_ck, ll_sym, d_sym, bcum)
    step = (nsym - 1) // (devsplit.NUM + 1)
    p = [1 + (k + 1) * step for k in range(devsplit.NUM)]
    a = [0] * devsplit.NUM + p + [0]
    b = p + [nsym] * devsplit.NUM + [nsym]
    k3_sets["probe_batch"] = _range_hists(devsplit, tabs, a, b, core.DCAP)
    rng = np.random.default_rng(11)
    for rows in (1, 18, 2048):
        ll, d = _hist_edge_batch(rng, rows)
        k3_sets[f"random_{rows}"] = (torch.from_numpy(ll).to(dev),
                                     torch.from_numpy(d).to(dev))
    k3_err = 0.0
    for name, (ll, d) in k3_sets.items():
        got = cm.hist_dynamic_cost(ll, d)
        want = cm.hist_dynamic_cost_plain(ll, d)
        checks[f"hist_cost_{name}"] = torch.equal(got, want)
        k3_err = max(k3_err, float((got - want).abs().max()))
    ll, d = k3_sets["probe_batch"]
    B = ll.shape[0]
    k3_ms = graph_time_ms(lambda: cm.hist_dynamic_cost(ll, d), reps=50)
    k3_plain = cuda_time_ms(lambda: cm.hist_dynamic_cost_plain(ll, d),
                            reps=2)
    report["hist_cost_ms_by_rows"] = {
        str(ll_.shape[0]): graph_time_ms(
            lambda: cm.hist_dynamic_cost(ll_, d_),
            reps=50 if ll_.shape[0] < 100 else 10)
        for ll_, d_ in (k3_sets["probe_batch"], k3_sets["seed_blocks"],
                        k3_sets["random_2048"])}
    k3_eager = cuda_time_ms(lambda: cm.hist_dynamic_cost(ll, d), reps=50)
    # Least time: each row's 320 int64 counts read once, one int64
    # written; the integer operations of the algorithm on these rows.
    bound, by = bytes_bound(B * (320 + 1) * 8, 0, _k3_ops(ll, d))
    k3 = {"name": "hist_cost", "route": "cuda",
          "source": "zopfli_tpu_torch/csrc/hist_cost.cu",
          "replaces": sk.REPLACES["hist_cost"], "max_abs_err": k3_err,
          "ms": k3_ms, "ms_eager": k3_eager, "plain_ms": k3_plain,
          "bound_ms": bound, "bound_by": by, "library_ms": None, "rows": B}
    at, at_checks, at_report = _autotype_checks(
        devsplit, sk, tabs, rounds, core.DCAP, nsym, dev)
    checks.update(at_checks)
    report["autotype_cost"] = at_report
    report["hist_cost_phases"] = _phase_breakdowns(
        {"probe_19": k3_sets["probe_batch"],
         "seed_blocks": k3_sets["seed_blocks"],
         "random_2048": k3_sets["random_2048"]}, sk, checks)
    return report, checks, {"hist_cost": k3, "autotype_cost": at}


def _range_hists(devsplit, tabs, a, b, ncap):
    """(ll, d) histograms of the ranges [a[i], b[i]) of a stream."""
    import torch

    ll_ck, d_ck, ll_sym, d_sym, _ = tabs
    pts = torch.tensor(list(a) + list(b), dtype=torch.int64,
                       device=ll_ck.device)
    pll, pd = devsplit.prefix_hist_at(ll_ck, d_ck, ll_sym, d_sym, pts, ncap)
    B = len(a)
    return pll[B:] - pll[:B], pd[B:] - pd[:B]


def _k3_ops(ll, d) -> int:
    """Integer operations of the exact dynamic cost on these rows, counted
    from the algorithm, not from a kernel: for each of the two code-length
    sets and both alphabets a sort of the m used symbols (m log2 m
    compares) and one compare per item of every package-merge level;
    RleOptimize's pass (4 per symbol); 8 tree-header variants (2 per code
    length) per set; the payload (2 per symbol) per set."""
    import numpy as np

    ops = 0
    for m in np.concatenate([
            (ll.cpu().numpy() != 0).sum(axis=1) + (ll.cpu().numpy()[:, 256]
                                                   == 0),
            (d.cpu().numpy() != 0).sum(axis=1)]):
        m = int(m)
        size, merged = m, 0
        for _ in range(1, min(m - 1, 15)):
            size = size // 2 + m
            merged += size
        ops += 2 * (m * max(1, int(np.ceil(np.log2(max(m, 2))))) + merged)
    return ops + ll.shape[0] * (4 * 320 + 2 * 8 * 2 * 316 + 2 * 2 * 320)


def _autotype_checks(devsplit, sk, tabs, rounds, ncap, nsym, dev):
    """The autotype_cost kernel against autotype_costs_plain on the
    split's first probe rounds and its largest one, and on seeded random
    ranges with edge cases under each fixed-cost gate; its time, bound,
    and the device work of one probe round under torch.profiler."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    checks, report = {}, {}
    big = max(range(len(rounds)), key=lambda i: len(rounds[i][0]))
    sets = {f"round_{i}": rounds[i] for i in sorted({0, 1, 2, 3, big})
            if i < len(rounds)}
    edges = [0, 1, 255, 256, 257, 511, 512, 513, nsym - 1, nsym,
             ncap - 1, ncap]
    rng = np.random.default_rng(13)
    ea = np.repeat(edges, len(edges))
    eb = np.tile(edges, len(edges))
    ra = rng.integers(0, nsym + 1, 400)
    rb = np.minimum(ra + rng.integers(-50, 4000, 400), ncap)
    inside = rng.integers(0, nsym // 256, 20) * 256 + 3   # one checkpoint
    pa = np.concatenate([ea, ra, inside])
    pb = np.concatenate([eb, rb, inside + rng.integers(1, 250, 20)])
    for small in (True, False):
        sets[f"random_small_{small}"] = (pa, pb, small)
    sets["random_per_block"] = (pa, pb, torch.from_numpy(
        rng.random(len(pa)) < 0.5).to(dev))     # the per-block-store rule
    err = 0.0
    for name, (a, b, small) in sets.items():
        ab = torch.from_numpy(np.stack([a, b]).astype(np.int64)).to(dev)
        got = devsplit.autotype_costs(*tabs, ab[0], ab[1], ncap, small)
        want = devsplit.autotype_costs_plain(*tabs, ab[0], ab[1], ncap,
                                             small)
        checks[f"autotype_cost_{name}"] = torch.equal(got, want)
        err = max(err, float((got - want).abs().max()))

    a, b, small = rounds[0]
    ab = torch.from_numpy(np.stack([a, b]).astype(np.int64)).to(dev)
    call = lambda: devsplit.autotype_costs(*tabs, ab[0], ab[1], ncap, small)
    ms = graph_time_ms(call, reps=50)
    plain_ms = cuda_time_ms(lambda: devsplit.autotype_costs_plain(
        *tabs, ab[0], ab[1], ncap, small), reps=2)
    a2, b2, small2 = rounds[big]
    ab2 = torch.from_numpy(np.stack([a2, b2]).astype(np.int64)).to(dev)
    abr = torch.from_numpy(np.stack([pa, pb]).astype(np.int64)).to(dev)
    report["ms_by_rows"] = {
        str(len(a)): ms,
        str(len(a2)): graph_time_ms(lambda: devsplit.autotype_costs(
            *tabs, ab2[0], ab2[1], ncap, small2), reps=10),
        str(len(pa)): graph_time_ms(lambda: devsplit.autotype_costs(
            *tabs, abr[0], abr[1], ncap, False), reps=10)}
    ms_eager = cuda_time_ms(call, reps=50)
    bound, by = _autotype_bound(devsplit, tabs, a, b, ncap)

    # One probe round = one pinned upload, one kernel, one pull.
    devsplit.probe_round(tabs, a, b, ncap, small)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        devsplit.probe_round(tabs, a, b, ncap, small)
        torch.cuda.synchronize()
    dev_events = [e.name for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
    copies = [n for n in dev_events if "Memcpy" in n or "memcpy" in n]
    kernels = [n for n in dev_events if n not in copies]
    report["probe_round_device_work"] = dev_events
    checks["probe_round_one_kernel"] = (
        len(kernels) == 1 and "autotype_cost" in kernels[0]
        and len(copies) == 2)
    report["rows"] = len(a)
    report["rounds_checked"] = [k for k in sets if k.startswith("round_")]
    entry = {"name": "autotype_cost", "route": "cuda",
             "source": "zopfli_tpu_torch/csrc/hist_cost.cu",
             "replaces": sk.REPLACES["autotype_cost"], "max_abs_err": err,
             "ms": ms, "ms_eager": ms_eager, "plain_ms": plain_ms,
             "bound_ms": bound, "bound_by": by, "library_ms": None,
             "rows": len(a)}
    return entry, checks, report


def _autotype_bound(devsplit, tabs, a, b, ncap) -> tuple[float, str]:
    """Least time of one probe round [a[i], b[i]).  Bytes: each distinct
    checkpoint row (288 + 32 int64) and each distinct stream symbol
    (ll_sym and d_sym) read once -- the ranges of a round share their
    ends -- plus a range's two ends, two byte offsets and its int64 out.
    Operations, per range: the histogram (320 differences and one add per
    stream symbol), the fixed cost (2 per symbol) and the dynamic cost."""
    import numpy as np

    ck = devsplit.CKPT
    live = b > a
    a, b = a[live], b[live]
    ends = np.concatenate([a, b])
    rows = np.unique(ends // ck)
    # The symbols [j*ck, e) of every end e in checkpoint j, as a union.
    last = {}
    for e in ends:
        j = int(e) // ck
        last[j] = max(last.get(j, 0), int(e) - j * ck)
    nbytes_ = (len(rows) * 320 * 8 + sum(last.values()) * 16
               + len(a) * 40)
    part = (a - (a // ck) * ck) + (b - (b // ck) * ck)
    ll_h, d_h = _range_hists(devsplit, tabs, a, b, ncap)
    ops = int((320 * 3 + part).sum()) + _k3_ops(ll_h, d_h)
    return bytes_bound(float(nbytes_), 0, ops)


def _phase_breakdowns(sets, sk, checks) -> dict:
    """Where a K3 row's cycles go, in the first design and in this one
    (experiments/exp_hist_cost_phases.py: debug builds that stamp
    clock64() around each phase)."""
    sys.path.insert(0, os.path.join(HERE, "experiments"))
    import exp_hist_cost_phases as ehp

    res = ehp.breakdowns(sets, sk)
    out = {}
    for variant, per in res.items():
        for batch, r in per.items():
            checks[f"phases_{variant}_{batch}_equal"] = r["equal_to_plain"]
            out[f"{variant}/{batch}"] = {
                k: r[k] for k in ("rows", "ms", "row_cycles_mean",
                                  "row_cycles_max", "categories_cycles")}
            if batch == "probe_19":
                out[f"{variant}/{batch}"]["phases"] = r["phases"]
    return out


# Card checks beside the production shapes: (groups, tile, lanes, kbp,
# unsorted breakpoints, costs on the 1/128-bit grid).  The scan works in
# 32-row chunks of 8 lanes and the traceback in blocks of 4 lanes (2 past
# a tile of ~14k rows), so tiles and lane counts that divide neither are
# here.
CASES = {
    "groups2": (2, 2048, 64, 12, False, False),
    "grid_ties": (1, 2048, 64, 12, False, True),
    "unsorted": (1, 2048, 64, 12, True, False),
    "kbp1": (1, 1024, 32, 1, True, True),
    "kbp16": (1, 1024, 32, 16, True, True),
    "lanes60_tile1000": (2, 1000, 60, 12, True, True),
    "lanes13_tile333": (1, 333, 13, 5, False, True),
}
TRACEBACK_ONLY_TILE = 15000   # two lanes per traceback block


def _case_inputs(rng, G, T, L, K, unsorted, grid):
    import numpy as np

    def costs(shape, lo, hi):
        if grid:
            return (rng.integers(lo * 4, hi * 4, shape) * 32 / 128).astype(
                np.float32)
        return rng.uniform(lo, hi, shape).astype(np.float32)

    if unsorted:
        bl = rng.integers(0, 300, (G * T, K, L))
        bl = np.where(rng.random(bl.shape) < 0.3, 0, bl)
        bl = np.where(rng.random(bl.shape) < 0.2, bl[:, :1], bl)
    else:
        bl = np.sort(rng.integers(0, 200, (G * T, K, L)), axis=1)
        bl = np.where(bl < 3, 0, bl)
    return [bl.astype(np.int32),
            rng.integers(1, 32769, (G * T, K, L)).astype(np.int32),
            costs((G * T, K, L), 1, 15), costs((G * T, L), 1, 12),
            costs((G * 256, L), 1, 10)]


def _traceback_cases(sk, ce, lit, tile, rng, G):
    """Both traceback versions on ce, then on ce with its paths cut: rows
    of length 0 and 2 on the path, tile_nbytes of 0, of tile and past it."""
    import numpy as np
    import torch

    L = ce.shape[1]
    symtab = sk.symbol_range_table()
    nbytes = rng.integers(0, tile + 1, (G, L)).astype(np.int32)
    nbytes[:, 0], nbytes[:, 1] = tile, 0
    if L > 2:
        nbytes[:, 2] = tile + 5
    nbytes = torch.from_numpy(nbytes).to(ce.device)
    ok = True
    for cut in (False, True):
        if cut:
            pe_h = pe.cpu().numpy()
            ce_h = ce.cpu().numpy()
            for g in range(G):
                for lane in range(3, L):
                    on = np.nonzero(pe_h[g * tile:(g + 1) * tile, lane])[0]
                    if len(on):
                        ce_h[g * tile + on[len(on) // 2], lane] = (
                            0 if lane % 2 else sk.pack_edge(2, 9))
            ce = torch.from_numpy(ce_h).to(ce.device)
        hist, pe = sk.traceback(ce, lit, nbytes, symtab, groups=G)
        phist, ppe = sk.traceback_plain(ce, lit, nbytes, symtab, groups=G)
        ok = ok and torch.equal(hist, phist) and torch.equal(pe, ppe)
    return ok


def _case_checks(dev) -> dict:
    """Both kernels against their plain versions on seeded random inputs
    at the CASES shapes (the main path at 1 MiB runs one group of 256
    lanes; larger inputs run several groups)."""
    import numpy as np
    import torch

    from zopfli_tpu_torch.ops import scan_kernel as sk

    checks = {}
    rng = np.random.default_rng(7)
    for name, (G, T, L, K, unsorted, grid) in CASES.items():
        ins = [torch.from_numpy(a).to(dev)
               for a in _case_inputs(rng, G, T, L, K, unsorted, grid)]
        lit = torch.from_numpy(rng.integers(0, 256, (G * T, L)).astype(
            np.int32)).to(dev)
        ce, cost = sk.scan(*ins, groups=G)
        pce, pcost = sk.scan_plain(*ins, groups=G)
        checks[f"{name}_scan"] = torch.equal(ce, pce) and torch.equal(
            cost.view(torch.int32), pcost.view(torch.int32))
        checks[f"{name}_traceback"] = _traceback_cases(sk, ce, lit, T, rng,
                                                       G)
    # A large tile for the traceback alone: random edges that fit.
    T, L = TRACEBACK_ONLY_TILE, 6
    pos = np.arange(1, T + 1)[:, None]
    ln = rng.integers(3, 259, (T, L))
    ce = np.where((rng.random((T, L)) < 0.7) | (ln > pos), 1,
                  ln | (rng.integers(1, 32769, (T, L)) << 9))
    lit = rng.integers(0, 256, (T, L)).astype(np.int32)
    checks[f"tile{T}_traceback"] = _traceback_cases(
        sk, torch.from_numpy(ce.astype(np.int32)).to(dev),
        torch.from_numpy(lit).to(dev), T, rng, 1)
    return checks


def _reset_counters():
    from zopfli_tpu_torch import squeeze_batched
    from zopfli_tpu_torch.ops import devsplit, fused_engine, seed
    from zopfli_tpu_torch.ops import scan_kernel as sk

    for k in sk.LAUNCHES:
        sk.LAUNCHES[k] = 0
    for k in devsplit.STATS:
        devsplit.STATS[k] = 0
    squeeze_batched.VERIFY_FAILS[0] = 0
    fused_engine.FETCH_RETRIES[0] = 0
    seed.PROGRAMS[0] = 0


def _counters() -> dict:
    from zopfli_tpu_torch import squeeze_batched
    from zopfli_tpu_torch.ops import devsplit, fused_engine, seed
    from zopfli_tpu_torch.ops import scan_kernel as sk

    return {"launches": dict(sk.LAUNCHES), "split": dict(devsplit.STATS),
            "seed_programs": seed.PROGRAMS[0],
            "verify_fails": squeeze_batched.VERIFY_FAILS[0],
            "fetch_retries": fused_engine.FETCH_RETRIES[0]}


def _compress_run(raw: bytes, label: str, dev) -> tuple[dict, bytes]:
    """One compress with every count set to 0 just before it and read
    just after; host greedy parses are counted."""
    import torch

    import zopfli_tpu_torch as zt
    from zopfli_tpu_torch import native

    greedy = native.greedy
    calls = [0]

    def counted(*a, **k):
        calls[0] += 1
        return greedy(*a, **k)

    _reset_counters()
    native.greedy = counted
    try:
        t0 = time.time()
        out = zt.compress(raw, "gzip", zt.Options(numiterations=ITERATIONS,
                                                  device=dev))
        torch.cuda.synchronize()
        secs = time.time() - t0
    finally:
        native.greedy = greedy
    run = {"run": label, "seconds": secs, "bytes": len(out),
           "greedy_calls": calls[0], **_counters(),
           "roundtrip": zlib.decompress(out, 31) == raw}
    return run, out


def phase_main(data, dev="cuda"):
    """compress() on the card at the defaults, and one greedy-seeded
    run: round trip, launches, greedy calls, fallbacks, size."""
    import torch

    import zopfli_tpu_torch as zt

    raw = data.tobytes()
    runs, outs = [], []
    for label in ("cold", "warm"):
        run, out = _compress_run(raw, label, dev)
        runs.append(run)
        outs.append(out)
    old = os.environ.get("ZT_SEED")
    os.environ["ZT_SEED"] = "greedy"
    try:
        greedy_run, greedy_out = _compress_run(raw, "greedy_warm", dev)
    finally:
        if old is None:
            del os.environ["ZT_SEED"]
        else:
            os.environ["ZT_SEED"] = old
    t0 = time.time()
    native_out = zt.compress(raw, "gzip", zt.Options(
        engine="native", numiterations=ITERATIONS))
    native_secs = time.time() - t0
    ratio = len(outs[0]) / len(native_out)

    def launches_ok(r, seeds):
        # One autotype_cost launch per probe round of the device splits.
        ln = r["launches"]
        return (ln["scan"] == ln["traceback"] == ITERATIONS + seeds
                and ln["hist_cost"] > 0
                and ln["autotype_cost"] == r["split"]["rounds"] > 0)

    ok = (all(r["roundtrip"] and r["verify_fails"] == 0
              and r["greedy_calls"] == 0 and r["seed_programs"] == 1
              and launches_ok(r, r["seed_programs"]) for r in runs)
          and greedy_run["roundtrip"] and greedy_run["verify_fails"] == 0
          and launches_ok(greedy_run, 0)
          and outs[1] == outs[0] and ratio <= 1.02
          and len(greedy_out) / len(native_out) <= 1.02
          and zlib.decompress(native_out, 31) == raw)
    emit({"phase": "main", "ok": ok, "input_bytes": len(raw),
          "iterations": ITERATIONS, "runs": runs + [greedy_run],
          "cold_seconds": runs[0]["seconds"],
          "warm_seconds": runs[1]["seconds"],
          "greedy_warm_seconds": greedy_run["seconds"],
          "output_bytes": len(outs[0]), "native_bytes": len(native_out),
          "greedy_bytes": len(greedy_out),
          "native_seconds": native_secs, "size_vs_native": ratio,
          "greedy_size_vs_native": len(greedy_out) / len(native_out),
          "fetch_retries": runs[0]["fetch_retries"],
          "peak_mem_bytes": torch.cuda.max_memory_allocated()})
    if not ok:
        raise RuntimeError("main path check failed")
    return runs[1]["launches"]


def phase_many(dev="cuda") -> None:
    """compress_many on the corpus files as separate inputs, then on two
    identical adjacent inputs: every output must round-trip alone."""
    import torch

    import zopfli_tpu_torch as zt

    blobs = [open(p, "rb").read() for p in corpus_paths()]
    base = max(blobs, key=len)
    results = {}
    for label, batch in (("corpus_files", blobs), ("identical_pair",
                                                   [base, base])):
        _reset_counters()
        t0 = time.time()
        outs = zt.compress_many(batch, "gzip", zt.Options(
            numiterations=ITERATIONS, device=dev))
        torch.cuda.synchronize()
        secs = time.time() - t0
        results[label] = {
            "inputs": len(batch), "input_bytes": sum(map(len, batch)),
            "output_bytes": sum(map(len, outs)), "seconds": secs,
            **_counters(),
            "roundtrip": all(zlib.decompress(o, 31) == b
                             for b, o in zip(batch, outs))}
    ok = all(r["roundtrip"] and r["verify_fails"] == 0
             and r["launches"]["scan"] > 0 and r["launches"]["traceback"] > 0
             and r["launches"]["hist_cost"] > 0
             and r["launches"]["autotype_cost"] > 0
             for r in results.values())
    emit({"phase": "many", "ok": ok, **results})
    if not ok:
        raise RuntimeError("compress_many check failed")


def phase_profile(data) -> None:
    """One more compress under torch.profiler: where the time goes.

    It checks only that the profiler saw the device: the host time inside
    each of the pipeline's named ranges (zopfli_tpu_torch.utils.logging
    .span), the device time by kernel, and the device's busy share of the
    wall time.
    """
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import zopfli_tpu_torch as zt

    raw = data.tobytes()
    _reset_counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        zt.compress(raw, "gzip", zt.Options(numiterations=ITERATIONS))
        torch.cuda.synchronize()
        wall = time.time() - t0
    ranges, kernels = {}, []
    for evt in prof.key_averages():
        # A named range shows twice: as a host range and as its
        # projection on the device timeline, which is no kernel.
        if evt.key.startswith("zt."):
            if evt.device_type == DeviceType.CPU:
                ranges[evt.key] = evt.cpu_time_total / 1e3
        elif evt.device_type == DeviceType.CUDA:
            kernels.append((evt.self_device_time_total / 1e3, evt.count,
                            evt.key))
    kernels.sort(reverse=True)
    busy = sum(k[0] for k in kernels)
    if not kernels:
        raise RuntimeError("the profiler saw no device time")
    emit({"phase": "profile", "ok": True, "wall_ms": wall * 1e3,
          "device_busy_ms": busy,
          "device_idle_share": 1.0 - busy / (wall * 1e3),
          "device_launches": sum(k[1] for k in kernels),
          "ranges_ms": ranges, **_counters(),
          "top_device_ms": [{"ms": ms, "count": n, "name": name[:80]}
                            for ms, n, name in kernels[:12]]})


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    only = argv[argv.index("--only") + 1] if "--only" in argv else None
    sys.path.insert(0, HERE)
    try:
        import numpy as np

        from zopfli_tpu_torch.ops import scan_kernel as zt_scan

        phase_env(zt_scan)
        data = np.frombuffer(corpus_1mib(), dtype=np.uint8)
        kernels = phase_kernels(data)
        if only == "kernels":
            return 0
        launches = phase_main(data)
        phase_profile(data)
        phase_many()
        for k, entry in kernels.items():
            entry["launches"] = launches[k]
        emit({"kernels": list(kernels.values())})
    except Exception:
        traceback.print_exc()
        return 1
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
