#!/usr/bin/env python3
"""Where the time of the two oracle-path kernels goes, and build variants.

    python3 experiments/exp_oracle_kernels.py [--only NAME,...] [--sass DIR]

dp_scan (zopfli_tpu_torch/csrc/dp_scan.cu) and K2's large-tile entry
(zt_traceback_large in zopfli_tpu_torch/csrc/traceback.cu) are built in
the variants of VARIANTS (nvcc -D flags: the phase clocks) into
zopfli_tpu_torch/_build/exp/, all in parallel, and run on real inputs:

- dp_scan on the oracle engine's rows of chip_smoke.py's 1 MiB corpus:
  the 16 KiB bucket, the largest block of the native split in its bucket,
  and 8 rows of 2^17 with different cuts (chip_smoke phase `oracle`);
- the large-tile entry on the fused loop's own K2 inputs of compress() at
  ZT_TILE=32768 (the script re-runs itself with that variable set).

Each variant's outputs must equal the port's build of the same kernel,
and on the 16 KiB bucket the port's build must equal the plain version;
its time is a CUDA-event mean over warm launches.  With -DZT_PHASE_CLOCKS
a variant also reports clock64() cycles: dp_scan per warp, from the
set-up's end to the warp's end and the part spent waiting on another
warp, for warp 0 its merges of bands 7..1 and its steps, and how often
each other warp was late at warp 0's merges (row 0, and the slowest row
of the 8); the large-tile entry per
block (mean and max over blocks): the block's cycles, warp 0's walks,
warp 1's writes, the barriers, and the path rows lane 0 walked.  One JSON
line per variant and input, then the card's name and power limit.
--sass DIR also writes the port builds' SASS to DIR/{dp_scan,
traceback}.sass.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CSRC = os.path.join(ROOT, "zopfli_tpu_torch", "csrc")
TILE = "32768"

# name -> (kernel, nvcc -D flags).  The designs' tuning (prep warps,
# merge batch, table layout, threads and lanes a block, chunk rows) was
# settled with variants like these; PERF.md §6 has the path.
VARIANTS = {
    "dp_clocks": ("dp_scan", ["-DZT_PHASE_CLOCKS"]),
    "tb_clocks": ("traceback", ["-DZT_PHASE_CLOCKS"]),
}


def build(sk, names) -> dict:
    out_dir = os.path.join(ROOT, "zopfli_tpu_torch", "_build", "exp")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in names:
        kernel, flags = VARIANTS[name]
        so = os.path.join(out_dir, f"libzt_{name}.so")
        procs[name] = (subprocess.Popen(
            [sk._nvcc()] + sk.NVCC_FLAGS + flags
            + ["-o", so, os.path.join(CSRC, f"{kernel}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(so)
        if VARIANTS[name][0] == "dp_scan":
            lib.zt_dp_scan.restype = ci
            lib.zt_dp_scan.argtypes = [vp] * 9 + [ci] * 3 + [vp]
        else:
            lib.zt_traceback_large.restype = ci
            lib.zt_traceback_large.argtypes = [vp] * 7 + [ci] * 4 + [vp]
        libs[name] = lib
    return libs


def dp_launch(lib, ins):
    import torch

    bl, bd, bc, lit, lc, mask = ins
    B, L, K = bl.shape
    outs = (torch.empty((B, L + 1), dtype=torch.int32, device=bl.device),
            torch.empty((B, L + 1), dtype=torch.int32, device=bl.device),
            torch.empty((B, L), dtype=torch.float32, device=bl.device))
    stream = torch.cuda.current_stream().cuda_stream
    rc = lib.zt_dp_scan(*(t.data_ptr() for t in ins),
                        *(t.data_ptr() for t in outs), B, L, K, stream)
    if rc:
        raise RuntimeError(f"dp_scan variant: CUDA error {rc}")
    return outs


def tb_launch(lib, sk, ce, lit, nbytes, symtab, G):
    import torch

    len_bin, dist_bin = sk._device_bin_tables(symtab, ce.device)
    rows, nt = ce.shape
    hist = torch.empty((G * sk.HBINS, nt), dtype=torch.float32,
                       device=ce.device)
    pe = torch.empty_like(ce)
    stream = torch.cuda.current_stream().cuda_stream
    rc = lib.zt_traceback_large(
        ce.data_ptr(), lit.data_ptr(), nbytes.data_ptr(), len_bin.data_ptr(),
        dist_bin.data_ptr(), hist.data_ptr(), pe.data_ptr(), G, rows // G,
        nt, sk.DIST_TABLE, stream)
    if rc:
        raise RuntimeError(f"traceback variant: CUDA error {rc}")
    return hist, pe


def dp_clocks(lib, B):
    import numpy as np

    n = min(B, 64)
    buf = np.zeros((n, 32), np.uint64)
    lib.zt_dp_scan_debug_read.restype = ctypes.c_int
    lib.zt_dp_scan_debug_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    if lib.zt_dp_scan_debug_read(buf.ctypes.data, n):
        raise RuntimeError("dp_scan clocks: read failed")
    names = ["chain_band0"] + [f"band{w}" for w in range(1, 8)] + [
        "writer", "prep0", "prep1", "prep2", "prep3"]

    def row(r):
        out = {nm: {"cycles": int(buf[r, 2 * w]),
                    "waiting": int(buf[r, 2 * w + 1])}
               for w, nm in enumerate(names)}
        out["chain_band0"].update(merges=int(buf[r, 28]),
                                  steps=int(buf[r, 29]))
        out["prep0_lane0"] = {"raising": int(buf[r, 30]),
                              "table": int(buf[r, 31])}
        out["gates"] = {"rereads": int(buf[r, 27]),
                        "band1_late": int(buf[r, 24]),
                        "any_band_late": int(buf[r, 25]),
                        "prep_late": int(buf[r, 26])}
        return out
    slow = int(np.argmax(buf[:, 0]))
    return {"row0": row(0), "slowest_row": slow, "slowest": row(slow)}


def tb_clocks(lib, nblocks):
    import numpy as np

    n = min(nblocks, 1024)
    buf = np.zeros((n, 8), np.uint64)
    lib.zt_traceback_debug_read.restype = ctypes.c_int
    lib.zt_traceback_debug_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    if lib.zt_traceback_debug_read(buf.ctypes.data, n):
        raise RuntimeError("traceback clocks: read failed")
    cols = {"block": 0, "walk_warp0": 1, "write_warp1": 2,
            "steps_lane0": 3, "barriers_warp0": 4, "barriers_warp1": 5}
    return {k: {"mean": float(buf[:, c].mean()), "max": int(buf[:, c].max())}
            for k, c in cols.items()}


def main(argv) -> int:
    if os.environ.get("ZT_TILE") != TILE:
        # The fused loop reads its tile when its module is imported.
        os.execve(sys.executable, [sys.executable] + sys.argv,
                  dict(os.environ, ZT_TILE=TILE))
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import zopfli_tpu_torch as zt
    from zopfli_tpu_torch import native
    from zopfli_tpu_torch.deflate import Options, split_master
    from zopfli_tpu_torch.ops import dp, engine
    from zopfli_tpu_torch.ops import scan_kernel as sk

    if not torch.cuda.is_available():
        print("exp_oracle_kernels: CUDA is not available", file=sys.stderr)
        return 1
    names = (argv[argv.index("--only") + 1].split(",") if "--only" in argv
             else list(VARIANTS))
    sk.build_kernels()
    libs = build(sk, names)
    dev = torch.device("cuda")
    raw = cs.corpus_1mib()
    data = np.frombuffer(raw, np.uint8)

    sets = {}
    if any(VARIANTS[n][0] == "dp_scan" for n in names):
        sets["16k"] = cs._dp_inputs(engine, data, 0, 16384, dev)
        bounds = split_master(Options(engine="native"), data, 0, len(data),
                              native.greedy)
        b = int(np.argmax(np.diff(bounds)))
        sets["largest"] = cs._dp_inputs(engine, data, int(bounds[b]),
                                        int(bounds[b + 1]), dev)
        rng = np.random.default_rng(5)
        rows8 = []
        for i, cut in enumerate((cs.PIPELINE_ROW, cs.PIPELINE_ROW - 1,
                                 126_000, 110_000, 97_000, 80_000, 70_000,
                                 65_537)):
            model = (() if i % 2 == 0 else
                     (rng.uniform(1, 15, 288).astype(np.float32),
                      rng.uniform(1, 12, 32).astype(np.float32)))
            rows8.append(cs._dp_inputs(engine, data, i * cs.PIPELINE_ROW,
                                       i * cs.PIPELINE_ROW + cut, dev,
                                       *model))
        sets["b8"] = [torch.cat([r[i] for r in rows8]) for i in range(6)]
    if any(VARIANTS[n][0] == "traceback" for n in names):
        kept, restore = cs._capture_fused_k1k2()
        try:
            zt.compress(raw, "gzip", zt.Options(numiterations=cs.ITERATIONS))
        finally:
            restore()
        G = kept["groups"]
        lit, nbytes, symtab = kept["traceback"]
        ce, _ = sk.scan(*kept["scan"], groups=G)
        k2 = (ce, lit, nbytes, symtab, G)

    for name in names:
        kernel, flags = VARIANTS[name]
        lib = libs[name]
        if kernel == "dp_scan":
            for key, ins in sets.items():
                want = dp.squeeze_scan(*ins)
                got = dp_launch(lib, ins)
                torch.cuda.synchronize()
                equal = all(torch.equal(g.view(torch.int32),
                                        w.view(torch.int32))
                            for g, w in zip(got, want))
                r = {"variant": name, "flags": flags, "input": key,
                     "shape": list(ins[0].shape[:2]), "equal": equal}
                if key == "16k":
                    # The port's build against the plain version, on the
                    # host (the other inputs: chip_smoke.py --only oracle).
                    plain = dp.squeeze_scan_plain(*(t.cpu() for t in ins))
                    r["port_equal_plain"] = all(
                        torch.equal(w.cpu().view(torch.int32),
                                    q.view(torch.int32))
                        for w, q in zip(want, plain))
                if "-DZT_PHASE_CLOCKS" in flags:
                    r["clocks"] = dp_clocks(lib, ins[0].shape[0])
                r["ms"] = cs.cuda_time_ms(lambda: dp_launch(lib, ins), 3)
                r["ms_port"] = cs.cuda_time_ms(
                    lambda: dp.squeeze_scan(*ins), 3)
                print(json.dumps(r), flush=True)
        else:
            ce, lit, nbytes, symtab, G = k2
            want = sk.traceback(ce, lit, nbytes, symtab, groups=G)
            got = tb_launch(lib, sk, *k2)
            torch.cuda.synchronize()
            r = {"variant": name, "flags": flags, "input": "zt_tile_32768",
                 "shape": [G, ce.shape[0] // G, ce.shape[1]],
                 "equal": all(torch.equal(g, w) for g, w in zip(got, want))}
            if "-DZT_PHASE_CLOCKS" in flags:
                r["clocks"] = tb_clocks(lib, G * ((ce.shape[1] + 3) // 4))
            r["ms"] = cs.cuda_time_ms(lambda: tb_launch(lib, sk, *k2), 10)
            r["ms_port"] = cs.cuda_time_ms(
                lambda: sk.traceback(ce, lit, nbytes, symtab, groups=G), 10)
            print(json.dumps(r), flush=True)
    # Each build's SASS size: instruction-cache pressure of warp roles.
    for name in names:
        so = os.path.join(ROOT, "zopfli_tpu_torch", "_build", "exp",
                          f"libzt_{name}.so")
        dump = subprocess.run(
            [os.path.join(os.path.dirname(sk._nvcc()), "cuobjdump"),
             "-sass", so], capture_output=True, text=True)
        kernels, cur = {}, None
        for line in dump.stdout.splitlines():
            if "Function :" in line:
                cur = line.split("Function :")[1].strip()
                kernels[cur] = 0
            elif cur and line.strip().startswith("/*") and "*/" in line:
                kernels[cur] += 1
        print(json.dumps({"variant": name, "sass_lines": kernels}),
              flush=True)
    if "--sass" in argv:
        # The port's builds, disassembled, for reading off the card.
        out = argv[argv.index("--sass") + 1]
        os.makedirs(out, exist_ok=True)
        for kernel in ("dp_scan", "traceback"):
            so = os.path.join(ROOT, "zopfli_tpu_torch", "_build",
                              f"libzt_{kernel}.so")
            with open(os.path.join(out, f"{kernel}.sass"), "w") as f:
                subprocess.run(
                    [os.path.join(os.path.dirname(sk._nvcc()), "cuobjdump"),
                     "-sass", so], stdout=f, text=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
