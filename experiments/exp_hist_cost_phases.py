#!/usr/bin/env python3
"""Where the time of the hist_cost kernel (K3) goes, phase by phase.

    python3 experiments/exp_hist_cost_phases.py [--variants first,new]

Builds two variants with -DZT_PHASE_CLOCKS (into zopfli_tpu_torch/_build/
exp/): the first design (experiments/hist_cost_first.cu: one 512-thread
block per row, phases one after another) and the kernel the port runs
(zopfli_tpu_torch/csrc/hist_cost.cu).  In both, the threads that lead a
phase stamp clock64() where it begins and ends; the stamps of every row
are copied out after one launch.  On the histograms of a split-probe
round (19 rows), of 16 blocks of the stream and of 2048 seeded random
rows, it prints one JSON line per variant and batch: each phase's mean
cycles per row and its offsets from the row's start, the row's total
(first begin to last end), and the kernel's CUDA-event time per launch.
Phases of the new design overlap (they run on different warps and
blocks), so their cycles add up to more than the row's total.  Clocks
compare only within a block: the new design's stamps are per block (two
per row, one per code-length set), each offset from its own block's
start, and a row's total is its slower block's.

chip_smoke.py phase 2 calls breakdowns() on its own batches.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
VARIANTS = {"first": os.path.join(HERE, "hist_cost_first.cu"),
            "new": os.path.join(ROOT, "zopfli_tpu_torch", "csrc",
                                "hist_cost.cu")}

# Phase-name prefixes -> the categories PERF.md reports.
CATEGORIES = (("rank", "leaf_ranking"), ("levels", "merge_levels"),
              ("topdown", "top_down"), ("rle", "rle_optimize"),
              ("tree", "tree_headers"), ("payload", "payload_and_sum"),
              ("final", "payload_and_sum"), ("load", "load"))


def _category(name: str) -> str:
    for key, cat in CATEGORIES:
        if key in name:
            return cat
    return "other"


def build_all(sk, variants=None) -> dict:
    """The debug variants, compiled in parallel; name -> ctypes lib."""
    out_dir = os.path.join(ROOT, "zopfli_tpu_torch", "_build", "exp")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, src in VARIANTS.items():
        if variants is not None and name not in variants:
            continue
        so = os.path.join(out_dir, f"libzt_hist_cost_{name}_clocks.so")
        procs[name] = (subprocess.Popen(
            [sk._nvcc()] + sk.NVCC_FLAGS + ["-DZT_PHASE_CLOCKS", "-o", so,
                                            src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(so)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.zt_hist_cost.restype = ci
        lib.zt_hist_cost.argtypes = [vp] * 3 + [ci, vp]
        lib.zt_hist_cost_phase_names.restype = ctypes.c_char_p
        lib.zt_hist_cost_debug_read.restype = ci
        lib.zt_hist_cost_debug_read.argtypes = [vp, ci,
                                                ctypes.POINTER(ci)]
        libs[name] = lib
    return libs


def _launch(lib, ll, d, out):
    import torch
    rc = lib.zt_hist_cost(ll.data_ptr(), d.data_ptr(), out.data_ptr(),
                          ll.shape[0], torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"hist_cost launch failed: CUDA error {rc}")


def breakdown(lib, ll, d, reps: int = 20) -> dict:
    """One variant on one (B, 288) / (B, 32) int64 CUDA batch."""
    import numpy as np
    import torch

    import chip_smoke

    ll = ll.to(torch.int64).contiguous()
    d = d.to(torch.int64).contiguous()
    rows = ll.shape[0]
    out = torch.empty(rows, dtype=torch.int64, device=ll.device)
    ms = chip_smoke.cuda_time_ms(lambda: _launch(lib, ll, d, out), reps=reps)
    _launch(lib, ll, d, out)        # the stamps of one launch
    torch.cuda.synchronize()
    names = lib.zt_hist_cost_phase_names().decode().split(",")
    bpr = (lib.zt_hist_cost_blocks_per_row()
           if hasattr(lib, "zt_hist_cost_blocks_per_row") else 1)
    nph = ctypes.c_int(0)
    nblk = rows * bpr
    buf = np.zeros(nblk * 64 * 2, np.int64)
    rc = lib.zt_hist_cost_debug_read(buf.ctypes.data, nblk,
                                     ctypes.byref(nph))
    if rc:
        raise RuntimeError(f"debug read failed: CUDA error {rc}")
    # (blocks, phases, begin/end); clocks compare only within a block.
    st = buf[:nblk * nph.value * 2].reshape(nblk, nph.value, 2)
    st = st[:, :len(names)].astype(np.float64)
    used = (st[:, :, 1] > 0) & (st[:, :, 0] > 0)
    t0 = np.where(used, st[:, :, 0], np.inf).min(axis=1)
    t1 = np.where(used, st[:, :, 1], -np.inf).max(axis=1)
    row_total = (t1 - t0).reshape(rows, bpr).max(axis=1)
    phases, cats = {}, {}
    for k, name in enumerate(names):
        u = used[:, k]
        if not u.any():
            continue
        dur = (st[u, k, 1] - st[u, k, 0])
        phases[name] = {"cycles": float(dur.mean()),
                        "begin": float((st[u, k, 0] - t0[u]).mean()),
                        "end": float((st[u, k, 1] - t0[u]).mean())}
        cat = _category(name)
        cats[cat] = cats.get(cat, 0.0) + float(dur.mean())
    return {"rows": rows, "ms": ms,
            "blocks_per_row": bpr,
            "row_cycles_mean": float(row_total.mean()),
            "row_cycles_max": float(row_total.max()),
            "categories_cycles": cats, "phases": phases,
            "out": out}


def breakdowns(sets: dict, sk=None, variants=None) -> dict:
    """{variant: {batch: breakdown}} for batches {name: (ll, d)}; each
    variant's outputs must equal the port's kernel's."""
    import torch

    from zopfli_tpu_torch.ops import costmodel as cm
    if sk is None:
        from zopfli_tpu_torch.ops import scan_kernel as sk
    libs = build_all(sk, variants)
    res = {}
    for vname, lib in libs.items():
        res[vname] = {}
        for bname, (ll, d) in sets.items():
            r = breakdown(lib, ll, d)
            want = cm.hist_dynamic_cost_plain(ll, d)
            r["equal_to_plain"] = bool(torch.equal(r.pop("out"), want))
            res[vname][bname] = r
    return res


def _batches(dev):
    """The probe round, 16 blocks and 2048 random rows, from a greedy
    parse of chip_smoke.py's 1 MiB."""
    import numpy as np
    import torch

    import chip_smoke
    from zopfli_tpu_torch import native
    from zopfli_tpu_torch.ops import devsplit

    data = np.frombuffer(chip_smoke.corpus_1mib(), dtype=np.uint8)
    lit, dist = native.greedy(data, 0, len(data))
    nsym = len(lit)
    ncap = devsplit.CKPT
    while ncap < nsym + 1:
        ncap *= 2
    ll = np.zeros(ncap, np.int32)
    dd = np.zeros(ncap, np.int32)
    ll[:nsym], dd[:nsym] = lit, dist
    ll_sym, d_sym, nbytes = devsplit.stream_symbols(
        torch.from_numpy(ll).to(dev), torch.from_numpy(dd).to(dev), ncap,
        nsym)
    ll_ck, d_ck, _ = devsplit.checkpoints(ll_sym, d_sym, nbytes, ncap, nsym)

    def hists(a, b):
        pts = torch.tensor(a + b, dtype=torch.int64, device=dev)
        pll, pd = devsplit.prefix_hist_at(ll_ck, d_ck, ll_sym, d_sym, pts,
                                          ncap)
        return pll[len(a):] - pll[:len(a)], pd[len(a):] - pd[:len(a)]

    step = (nsym - 1) // (devsplit.NUM + 1)
    p = [1 + (k + 1) * step for k in range(devsplit.NUM)]
    edges = [nsym * k // 16 for k in range(17)]
    rng = np.random.default_rng(11)
    rl, rd = chip_smoke._hist_edge_batch(rng, 2048)
    return {"probe_19": hists([0] * devsplit.NUM + p + [0],
                              p + [nsym] * devsplit.NUM + [nsym]),
            "blocks_16": hists(edges[:-1], edges[1:]),
            "random_2048": (torch.from_numpy(rl).to(dev),
                            torch.from_numpy(rd).to(dev))}


def main(argv) -> int:
    import torch

    sys.path.insert(0, ROOT)
    if not torch.cuda.is_available():
        print("exp_hist_cost_phases: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    variants = (argv[argv.index("--variants") + 1].split(",")
                if "--variants" in argv else None)
    res = breakdowns(_batches(torch.device("cuda")), variants=variants)
    ok = True
    for vname, per in res.items():
        for bname, r in per.items():
            ok = ok and r["equal_to_plain"]
            print(json.dumps({"variant": vname, "batch": bname, **r}),
                  flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main(sys.argv[1:]))
