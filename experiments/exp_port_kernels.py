#!/usr/bin/env python3
"""Where the time of the port's two CUDA kernels goes, on one CUDA GPU.

    python3 experiments/exp_port_kernels.py

Builds variants of zopfli_tpu_torch/csrc/{scan,traceback}.cu (small
source edits, into zopfli_tpu_torch/_build/exp/) and times each with CUDA
events on the real inputs of chip_smoke.py phase 2 (1 MiB of repo text,
TILE 8192, LANES 256, KBP 12).  Prints one JSON line per measurement.

scan (K1):
  - the share of rows whose longest match passes 34 bytes (the steps
    that take the kernel's general path), overall and in the worst lane.
  - as built; and with the loads forced to 4-byte copies, one lane at a
    time, on row-major inputs (the contract's layout) and on the same
    inputs transposed lane-major (each lane's rows contiguous).  The
    outputs must agree.
  - every 8-lane group alone, the full 256 lanes, and the slowest group
    copied to all 256 lanes: how much of the full-width time is data and
    how much is the memory system.
traceback (K2): as built, without the walk (start at 0), and without
  the sweep.  These two give wrong outputs; only their times matter.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

SCALAR = ("    if (vec) {\n      for (int k = 0; k < kbp; ++k) {",
          "    if (false) {\n      for (int k = 0; k < kbp; ++k) {")
LANE_MAJOR = [
    ("          const size_t ok = o + (size_t)k * lanes + p;",
     "          const size_t ok =\n"
     "              ((size_t)(lane0 + p) * ZT_ROWS + grow) * kbp + k;"),
    ("        cp4(sl + p, litcost + ol + p);",
     "        cp4(sl + p, litcost + (size_t)(lane0 + p) * ZT_ROWS + grow);"),
]
NO_WALK = [("    if (p > tile) p = 0;  // the Pallas cursor would never match "
            "a row", "    p = 0;")]
NO_SWEEP = [("  for (int base = tid; base < n; base += THREADS * BATCH) {",
             "  for (int base = tid; base < 0; base += THREADS * BATCH) {")]


def build(sk, name: str, src: str, edits, flags=()):
    text = open(os.path.join(ROOT, "zopfli_tpu_torch", "csrc", src)).read()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"{name}: source edit no longer applies")
        text = text.replace(old, new)
    out_dir = os.path.join(ROOT, "zopfli_tpu_torch", "_build", "exp")
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, f"{name}.cu")
    so = os.path.join(out_dir, f"lib{name}.so")
    with open(cu, "w") as f:
        f.write(text)
    proc = subprocess.run([sk._nvcc()] + sk.NVCC_FLAGS + list(flags)
                          + ["-o", so, cu], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}"
                           f"{proc.stderr}")
    lib = ctypes.CDLL(so)
    fn = lib.zt_scan if src == "scan.cu" else lib.zt_traceback
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    return fn


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke
    from zopfli_tpu_torch import native
    from zopfli_tpu_torch.deflate import Options, split_master
    from zopfli_tpu_torch.ops import fused_engine, scan_kernel as sk
    from zopfli_tpu_torch.squeeze_batched import greedy_seed_stats

    if not torch.cuda.is_available():
        print("exp_port_kernels: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)

    data = np.frombuffer(chip_smoke.corpus_1mib(), dtype=np.uint8)
    n = len(data)
    bounds = split_master(Options(numiterations=chip_smoke.ITERATIONS),
                          data, 0, n, native.greedy)
    fs = fused_engine.FusedSqueeze(data, [(0, n, bounds)], device=dev)
    seed_ll, seed_d = greedy_seed_stats(data, fs.block_bounds,
                                        native.greedy)
    sll, sd, _ = fs.initial_stats(seed_ll, seed_d)
    real = fs.scan_inputs(torch.from_numpy(sll).to(dev),
                          torch.from_numpy(sd).to(dev))
    rows, kbp, lanes = real[0].shape
    if fs.ngroups != 1:
        raise RuntimeError("expected one lane group at 1 MiB")
    # Rows whose longest covered length passes 34: K1's out-of-line path.
    longest = real[0].max(dim=1).values.clamp(max=258)
    long_rows = (longest > 34).float()
    print(json.dumps({"long_rows_share": float(long_rows.mean()),
                      "long_rows_share_max_lane":
                          float(long_rows.mean(dim=0).max())}), flush=True)

    scan = {
        "as_built": build(sk, "scan_as_built", "scan.cu", []),
        "scalar_row_major": build(sk, "scan_scalar", "scan.cu", [SCALAR]),
        "scalar_lane_major": build(sk, "scan_lane_major", "scan.cu",
                                   [SCALAR] + LANE_MAJOR,
                                   [f"-DZT_ROWS={rows}"]),
    }

    def run_scan(fn, ins, lane_major=False):
        r, k, nl = ins[0].shape
        feed = ins
        if lane_major:
            feed = [t.permute(2, 0, 1).contiguous() for t in ins[:3]] + [
                ins[3].T.contiguous(), ins[4]]
        ce = torch.empty((r, nl), dtype=torch.int32, device=dev)
        cost = torch.empty((r, nl), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream

        def call():
            rc = fn(*(t.data_ptr() for t in feed), ce.data_ptr(),
                    cost.data_ptr(), 1, r, k, nl, stream)
            if rc:
                raise RuntimeError(f"scan launch failed: CUDA error {rc}")
        ms = chip_smoke.cuda_time_ms(call, reps=5)
        return ms, ce, cost

    def lanes_of(ins, lo, hi, copies=1):
        return [t[..., lo:hi].repeat(*([1] * (t.dim() - 1)), copies)
                .contiguous() for t in ins]

    ref = None
    for name, fn in scan.items():
        ms, ce, cost = run_scan(fn, real, name == "scalar_lane_major")
        if ref is None:
            ref = (ce.clone(), cost.clone())
        same = bool(torch.equal(ce, ref[0]) and torch.equal(
            cost.view(torch.int32), ref[1].view(torch.int32)))
        groups = [run_scan(fn, lanes_of(real, g, g + 8),
                           name == "scalar_lane_major")[0]
                  for g in range(0, lanes, 8)]
        slow = int(np.argmax(groups)) * 8
        wide = run_scan(fn, lanes_of(real, slow, slow + 8, lanes // 8),
                        name == "scalar_lane_major")[0]
        print(json.dumps({
            "kernel": "scan", "variant": name, "ms_256_lanes": ms,
            "same_output": same, "ms_8_lane_group_max": max(groups),
            "ms_8_lane_group_min": min(groups),
            "ms_slowest_group_on_256_lanes": wide}), flush=True)

    ce, _ = sk.scan(*real)
    sh = fs.shards[0]
    hist_ref, pe_ref = sk.traceback(ce, sh.lit_t, sh.tile_nbytes_d,
                                    fs.symtab)
    walk = (pe_ref != 0).sum(dim=0)
    len_bin, dist_bin = sk._device_bin_tables(fs.symtab, dev)
    tb = {"as_built": build(sk, "tb_as_built", "traceback.cu", []),
          "no_walk": build(sk, "tb_no_walk", "traceback.cu", NO_WALK),
          "no_sweep": build(sk, "tb_no_sweep", "traceback.cu", NO_SWEEP)}
    for name, fn in tb.items():
        hist = torch.empty_like(hist_ref)
        pe = torch.empty_like(pe_ref)
        stream = torch.cuda.current_stream().cuda_stream

        def call():
            rc = fn(ce.data_ptr(), sh.lit_t.data_ptr(),
                    sh.tile_nbytes_d.data_ptr(), len_bin.data_ptr(),
                    dist_bin.data_ptr(), hist.data_ptr(), pe.data_ptr(), 1,
                    rows, lanes, sk.DIST_TABLE, stream)
            if rc:
                raise RuntimeError(f"traceback launch failed: CUDA error "
                                   f"{rc}")
        ms = chip_smoke.cuda_time_ms(call, reps=20)
        print(json.dumps({
            "kernel": "traceback", "variant": name, "ms": ms,
            "path_rows_max_lane": int(walk.max()),
            "path_rows_mean_lane": float(walk.float().mean()),
            "same_output": bool(torch.equal(hist, hist_ref)
                                and torch.equal(pe, pe_ref))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
