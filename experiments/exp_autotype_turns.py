#!/usr/bin/env python3
"""autotype_cost's host-count entry in two checkouts, in turns on one card.

    python3 experiments/exp_autotype_turns.py PARENT_ROOT

Builds csrc/hist_cost.cu of the checkout at PARENT_ROOT and of this one
(normal flags, into zopfli_tpu_torch/_build/exp/), and times
zt_autotype_cost of each on the same ranges of the 1 MiB corpus's seed
parse: the split's first probe round (19 ranges) and chip_smoke.py's 564
seeded random ranges, as launches captured in a CUDA graph, in the order
parent, this, this, parent.  Both libraries' outputs must be equal.
Prints one JSON line.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _build(sk, src: str, name: str):
    out_dir = os.path.join(ROOT, "zopfli_tpu_torch", "_build", "exp")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, f"libzt_hist_cost_{name}.so")
    return subprocess.Popen([sk._nvcc()] + sk.NVCC_FLAGS + ["-o", so, src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), so


def main(argv) -> int:
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke
    from zopfli_tpu_torch.ops import devsplit, hashmatch, seed
    from zopfli_tpu_torch.ops import scan_kernel as sk

    parent = os.path.abspath(argv[0])
    procs = {name: _build(sk, os.path.join(root, "zopfli_tpu_torch", "csrc",
                                           "hist_cost.cu"), name)
             for name, root in (("parent", parent), ("this", ROOT))}
    libs = {}
    vp, ci, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(so)
        lib.zt_autotype_cost.restype = ci
        lib.zt_autotype_cost.argtypes = [vp] * 9 + [ci, i64, ci, vp]
        libs[name] = lib
    sk.build_kernels()

    dev = torch.device("cuda")
    data = np.frombuffer(chip_smoke.corpus_1mib(), np.uint8)
    buf, cap, min_pos, inend_real = seed.master_buffer(data, 0, len(data))
    core = seed.make_seed_core(
        cap, 16, tuple(sorted(hashmatch.current_knobs().items())))
    parsed = core.parse(torch.from_numpy(buf).to(dev), min_pos, inend_real)
    nsym = int(parsed[3])
    ncap = core.DCAP
    tabs = chip_smoke._split_tabs(devsplit, parsed[0], parsed[1], ncap,
                                  torch.tensor(nsym, device=dev))
    step = (nsym - 1) // (devsplit.NUM + 1)
    p = [1 + (k + 1) * step for k in range(devsplit.NUM)]
    rng = np.random.default_rng(13)
    ra = rng.integers(0, nsym + 1, 564)
    sets = {"19": ([0] * 9 + p + [0], p + [nsym] * 9 + [nsym]),
            "564": (ra, np.minimum(ra + rng.integers(-50, 4000, 564),
                                   ncap))}
    report, equal = {}, True
    for rows, (a, b) in sets.items():
        n = len(a)
        ab = torch.tensor(np.stack([a, b]), dtype=torch.int64, device=dev)
        outs = {k: torch.empty(n, dtype=torch.int64, device=dev)
                for k in libs}

        def call(name):
            rc = libs[name].zt_autotype_cost(
                *(t.data_ptr() for t in tabs), ab[0].data_ptr(),
                ab[1].data_ptr(), None, outs[name].data_ptr(), n, ncap, 0,
                torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"{name}: CUDA error {rc}")

        ms = {k: [] for k in libs}
        for name in ("parent", "this", "this", "parent"):
            ms[name].append(chip_smoke.graph_time_ms(
                lambda name=name: call(name), reps=50))
        torch.cuda.synchronize()
        equal &= torch.equal(outs["parent"], outs["this"])
        report[rows] = {"parent_ms": ms["parent"], "this_ms": ms["this"]}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"card": smi, "equal": bool(equal),
                      "ms_by_ranges": report}), flush=True)
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
