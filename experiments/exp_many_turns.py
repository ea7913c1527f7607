#!/usr/bin/env python3
"""compress_many of two checkouts of the port, in turns, on one GPU.

    python3 experiments/exp_many_turns.py PARENT_ROOT

Runs chip_smoke.py's phase-5 batches outside any process group with the
zopfli_tpu_torch of PARENT_ROOT and of this checkout, each in its own
process, in the order parent, change, change, parent.  The batches are
the same for every process:
  - "md_corpus": the files PARENT_ROOT's phase 5 read before the corpus
    was pinned (zopfli_tpu/**/*.py and the root *.md files of
    PARENT_ROOT, sorted), one input each;
  - "pinned": this checkout's chip_smoke.corpus_paths(), one input each;
  - "identical_pair": two copies of the largest pinned file.
Each process builds its kernels, then compresses each batch once at
--i15 with every count set to 0 just before and read just after
(that checkout's chip_smoke._reset_counters and _counters).  It prints
one JSON line per batch: seconds, bytes, a digest of the outputs and
the counts.  Every run must give the same outputs and counts per batch.
Imports nothing of JAX.
"""

from __future__ import annotations

import glob
import json
import os
import pickle
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

CHILD = r"""
import hashlib, json, pickle, sys, time, zlib
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
import zopfli_tpu_torch as zt
from zopfli_tpu_torch.ops import scan_kernel as sk
batches = pickle.load(open(sys.argv[2], "rb"))
sk.build_kernels()
for name, blobs in batches:
    cs._reset_counters()
    t0 = time.time()
    outs = zt.compress_many(blobs, "gzip", zt.Options(numiterations=15))
    torch.cuda.synchronize()
    secs = time.time() - t0
    print(json.dumps({"batch": name, "inputs": len(blobs),
                      "input_bytes": sum(map(len, blobs)), "seconds": secs,
                      "output_bytes": sum(map(len, outs)),
                      "sha1": hashlib.sha1(b"".join(outs)).hexdigest(),
                      "roundtrip": all(zlib.decompress(o, 31) == b
                                       for b, o in zip(blobs, outs)),
                      **cs._counters()}), flush=True)
"""


def _read(paths: list[str]) -> list[bytes]:
    return [open(p, "rb").read() for p in paths]


def main(argv) -> int:
    sys.path.insert(0, ROOT)
    import chip_smoke

    parent = os.path.abspath(argv[0])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    py = sorted(glob.glob(os.path.join(parent, "zopfli_tpu", "**", "*.py"),
                          recursive=True))
    md = sorted(py + glob.glob(os.path.join(parent, "*.md")))
    pinned = _read(chip_smoke.corpus_paths())
    base = max(pinned, key=len)
    batches = [("md_corpus", _read(md)), ("pinned", pinned),
               ("identical_pair", [base, base])]
    with tempfile.NamedTemporaryFile(suffix=".pkl", delete=False) as f:
        pickle.dump(batches, f)
        data = f.name
    seen: dict[str, set] = {}
    try:
        for label, root in (("parent", parent), ("change", ROOT),
                            ("change", ROOT), ("parent", parent)):
            proc = subprocess.run([sys.executable, "-c", CHILD, root, data],
                                  capture_output=True, text=True)
            if proc.returncode:
                print(proc.stderr[-3000:], file=sys.stderr)
                return 1
            for line in proc.stdout.strip().splitlines():
                res = json.loads(line)
                key = json.dumps({k: res[k] for k in ("sha1", "launches",
                                                      "split",
                                                      "seed_programs")},
                                 sort_keys=True)
                seen.setdefault(res["batch"], set()).add(key)
                print(json.dumps({"run": label, **res}), flush=True)
    finally:
        os.unlink(data)
    if any(len(v) != 1 for v in seen.values()):
        print("exp_many_turns: the checkouts differ in outputs or counts",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
