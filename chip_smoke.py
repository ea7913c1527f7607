#!/usr/bin/env python3
"""Smoke run of zopfli_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py                # every phase
    python3 chip_smoke.py --only kernels # build + kernel checks only

Phases, each printed as one JSON line:
  1. environment: the card's name and power limit, the kernels' build.
  2. kernels: each CUDA kernel against its plain PyTorch version on the
     card, at production shapes (TILE=8192, LANES=256, KBP=12), on real
     inputs: the port's candidate tables for the phase-3 input and the
     first squeeze iteration's costs from its greedy seed stats; then at
     the CASES shapes on seeded random inputs (ties, unsorted
     breakpoints, odd tiles and lane counts, cut paths).  Outputs must be
     bit-equal, and one warm scan + traceback pair must not sync the
     stream.  Times are CUDA-event means over warm launches.
  3. main path: zopfli_tpu_torch.compress(1 MiB, "gzip", --i15) on the
     card; the output must round-trip through zlib, every kernel must
     have launched 15 times, no block may fall back to the host engine,
     and the size must be within 2% of the native engine's.
  4. profile: one more compress under torch.profiler -- host time per
     pipeline stage, device time per kernel, the device's idle share.
     It fails only if the profiler fails or sees no device time.
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
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def corpus_1mib() -> bytes:
    """2^20 bytes of the repo's own text: zopfli_tpu/**/*.py and the
    root *.md files, sorted by path, concatenated, repeated or cut."""
    paths = sorted(glob.glob(os.path.join(HERE, "zopfli_tpu", "**", "*.py"),
                             recursive=True)
                   + glob.glob(os.path.join(HERE, "*.md")))
    blob = b"".join(open(p, "rb").read() for p in paths)
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
    bounds = split_master(Options(numiterations=ITERATIONS), data, 0, n,
                          native.greedy)
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
    scan_bound = max(scan_bytes / HBM_BYTES_PER_S,
                     scan_ops / F32_FLOPS) * 1e3
    # Traceback: the path rows it must read (ce, and lit at literals),
    # tile_nbytes and the symbol tables, and both outputs written once.
    path = pe_k != 0
    nlit = int(((pe_k & sk.LEN_MASK) == 1).sum())
    npath = int(path.sum())
    npath_max = int(path.sum(dim=0).max())  # the longest walk of a lane
    tb_bytes = (4 * npath + 4 * nlit + 4 * G * nt + symtab.nbytes
                + hist_k.numel() * 4 + pe_k.numel() * 4)
    tb_ops = 4 * npath
    tb_bound = max(tb_bytes / HBM_BYTES_PER_S, tb_ops / F32_FLOPS) * 1e3

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
    ok = all(checks.values())
    emit({"phase": "kernels", "ok": ok, "bit_equal": checks,
          "shape": {"groups": G, "tile": tile, "lanes": nt, "kbp": kbp},
          "smem_bytes": {
              "scan": sk.build_kernels()["scan"].zt_scan_smem_bytes(kbp),
              "traceback": sk.build_kernels()[
                  "traceback"].zt_traceback_smem_bytes(tile)},
          "path_rows": npath, "path_rows_max_lane": npath_max,
          "scan_ms": scan_ms,
          "scan_plain_ms": scan_plain_ms, "traceback_ms": tb_ms,
          "traceback_plain_ms": tb_plain_ms})
    if not ok:
        raise RuntimeError(f"kernel disagrees with its plain version: "
                           f"{checks}")
    return {
        "scan": {"name": "scan", "route": "cuda",
                 "source": "zopfli_tpu_torch/csrc/scan.cu",
                 "replaces": sk.REPLACES["scan"], "max_abs_err": scan_err,
                 "ms": scan_ms, "plain_ms": scan_plain_ms,
                 "bound_ms": scan_bound,
                 "bound_by": ("bytes" if scan_bytes / HBM_BYTES_PER_S
                              >= scan_ops / F32_FLOPS else "operations"),
                 "library_ms": None},
        "traceback": {"name": "traceback", "route": "cuda",
                      "source": "zopfli_tpu_torch/csrc/traceback.cu",
                      "replaces": sk.REPLACES["traceback"],
                      "max_abs_err": tb_err, "ms": tb_ms,
                      "plain_ms": tb_plain_ms, "bound_ms": tb_bound,
                      "bound_by": ("bytes" if tb_bytes / HBM_BYTES_PER_S
                                   >= tb_ops / F32_FLOPS
                                   else "operations"),
                      "library_ms": None},
    }


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


def phase_main(data, dev="cuda"):
    """compress() on the card: round trip, launches, fallbacks, size."""
    import numpy as np
    import torch

    import zopfli_tpu_torch as zt
    from zopfli_tpu_torch import squeeze_batched
    from zopfli_tpu_torch.ops import fused_engine, scan_kernel as sk

    raw = data.tobytes()
    runs = []
    for label in ("cold", "warm"):
        for k in sk.LAUNCHES:
            sk.LAUNCHES[k] = 0
        squeeze_batched.VERIFY_FAILS[0] = 0
        fused_engine.FETCH_RETRIES[0] = 0
        t0 = time.time()
        out = zt.compress(raw, "gzip", zt.Options(numiterations=ITERATIONS,
                                                  device=dev))
        torch.cuda.synchronize()
        secs = time.time() - t0
        runs.append({"run": label, "seconds": secs, "bytes": len(out),
                     "launches": dict(sk.LAUNCHES),
                     "verify_fails": squeeze_batched.VERIFY_FAILS[0],
                     "fetch_retries": fused_engine.FETCH_RETRIES[0],
                     "roundtrip": zlib.decompress(out, 31) == raw})
        if label == "cold":
            first = out
    t0 = time.time()
    native_out = zt.compress(raw, "gzip", zt.Options(
        engine="native", numiterations=ITERATIONS))
    native_secs = time.time() - t0
    ratio = len(first) / len(native_out)
    ok = (all(r["roundtrip"] and r["verify_fails"] == 0
              and all(v == ITERATIONS for v in r["launches"].values())
              for r in runs)
          and out == first and ratio <= 1.02
          and zlib.decompress(native_out, 31) == raw)
    emit({"phase": "main", "ok": ok, "input_bytes": len(raw),
          "iterations": ITERATIONS, "runs": runs,
          "cold_seconds": runs[0]["seconds"],
          "warm_seconds": runs[1]["seconds"],
          "output_bytes": len(first), "native_bytes": len(native_out),
          "native_seconds": native_secs, "size_vs_native": ratio,
          "fetch_retries": runs[0]["fetch_retries"],
          "peak_mem_bytes": torch.cuda.max_memory_allocated()})
    if not ok:
        raise RuntimeError("main path check failed")
    return runs[0]["launches"]


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
          "ranges_ms": ranges,
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
