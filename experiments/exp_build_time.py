#!/usr/bin/env python3
"""Seconds of one nvcc build of each CUDA source, with the port's flags.

    python3 experiments/exp_build_time.py [--reps N] SRC [SRC ...]

Builds each source alone (one nvcc at a time, never two at once) with
zopfli_tpu_torch.ops.scan_kernel.NVCC_FLAGS into zopfli_tpu_torch/_build/
exp/, the sources in turn, N rounds (default 3), so that two versions of
one kernel are compared within one machine and one call.  Prints one JSON
line: each source's seconds per round, and its fastest.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv) -> int:
    sys.path.insert(0, ROOT)
    from zopfli_tpu_torch.ops import scan_kernel as sk

    reps = 3
    if "--reps" in argv:
        i = argv.index("--reps")
        reps = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    out_dir = os.path.join(ROOT, "zopfli_tpu_torch", "_build", "exp")
    os.makedirs(out_dir, exist_ok=True)
    secs = {src: [] for src in argv}
    for _ in range(reps):
        for k, src in enumerate(argv):
            so = os.path.join(out_dir, f"libbuild_time_{k}.so")
            t0 = time.time()
            proc = subprocess.run([sk._nvcc()] + sk.NVCC_FLAGS
                                  + ["-o", so, src],
                                  capture_output=True, text=True)
            secs[src].append(time.time() - t0)
            if proc.returncode:
                print(proc.stdout + proc.stderr, file=sys.stderr)
                return 1
    print(json.dumps({"exp": "build_time", "reps": reps, "seconds": secs,
                      "fastest": {s: min(t) for s, t in secs.items()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
