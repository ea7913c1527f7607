#!/usr/bin/env python3
"""Warm compress time of two checkouts of the port, in turns, on one GPU.

    python3 experiments/exp_port_wall.py PARENT_ROOT [ROUNDS]

Compresses chip_smoke.py's 1 MiB corpus (gzip, --i15, the port's
defaults) with the zopfli_tpu_torch of PARENT_ROOT and of this checkout,
each in its own process, in the order parent, change, change, parent
(repeated ROUNDS times, default 1).  Each process builds its kernels,
compresses once cold, then 3 times warm, and prints one JSON line: the
warm seconds, the output size, kernel launches and split rounds of the
last run.  Both must give the same bytes.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

CHILD = r"""
import hashlib, json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
import zopfli_tpu_torch as zt
from zopfli_tpu_torch.ops import devsplit, scan_kernel as sk
raw = open(sys.argv[2], "rb").read()
opts = zt.Options(numiterations=15)
sk.build_kernels()
t0 = time.time()
zt.compress(raw, "gzip", opts)
torch.cuda.synchronize()
cold = time.time() - t0
warm = []
for _ in range(3):
    for k in sk.LAUNCHES:
        sk.LAUNCHES[k] = 0
    for k in devsplit.STATS:
        devsplit.STATS[k] = 0
    t0 = time.time()
    out = zt.compress(raw, "gzip", opts)
    torch.cuda.synchronize()
    warm.append(time.time() - t0)
print(json.dumps({"cold_s": cold, "warm_s": warm, "bytes": len(out),
                  "sha1": hashlib.sha1(out).hexdigest(),
                  "launches": dict(sk.LAUNCHES),
                  "split": dict(devsplit.STATS)}))
"""


def main(argv) -> int:
    sys.path.insert(0, ROOT)
    import chip_smoke

    parent = os.path.abspath(argv[0])
    rounds = int(argv[1]) if len(argv) > 1 else 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    with tempfile.NamedTemporaryFile(suffix=".bin", delete=False) as f:
        f.write(chip_smoke.corpus_1mib())
        data = f.name
    digests = set()
    try:
        for _ in range(rounds):
            for label, root in (("parent", parent), ("change", ROOT),
                                ("change", ROOT), ("parent", parent)):
                proc = subprocess.run([sys.executable, "-c", CHILD, root,
                                       data], capture_output=True,
                                      text=True)
                if proc.returncode:
                    print(proc.stderr[-3000:], file=sys.stderr)
                    return 1
                res = json.loads(proc.stdout.strip().splitlines()[-1])
                digests.add(res["sha1"])
                print(json.dumps({"run": label, **res}), flush=True)
    finally:
        os.unlink(data)
    if len(digests) != 1:
        print("exp_port_wall: the two checkouts gave different bytes",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
