#!/usr/bin/env python3
"""The oracle-path kernels and walls of two checkouts, in turns, on one input.

    python3 experiments/exp_oracle_turns.py PARENT_ROOT [ROUNDS]

Writes chip_smoke.py's 1 MiB corpus of this checkout to a file, then runs,
for each checkout in the order parent, this, this, parent (ROUNDS times,
default 1), a fresh process with that checkout's zopfli_tpu_torch and
chip_smoke on the path (each builds its own kernels) which measures:

- dp_scan: CUDA-event ms at the 16 KiB bucket (B=1), at the bucket of the
  largest block of the native split (B=1) and at 8 rows of 2^17 with
  different cuts (chip_smoke phase `oracle`'s shapes);
- deflate of the file through ops.engine.DeviceBlockEngine at 8
  iterations (Options(engine="native"), engine_factory=): seconds, bytes,
  dp_scan launches, verify fallbacks;
- and, in a second process at ZT_TILE=32768, compress() of the file at
  --i15 (bytes, seconds, launches) with K2's large-tile entry timed on
  that run's own K2 inputs (the fused loop's K1 output).

Both checkouts see the same bytes, so their outputs must be equal.  One
JSON line per run and checkout, then the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
ITERATIONS = 8
TILE = "32768"


def measure_dp(path: str) -> dict:
    """dp_scan times and the oracle deflate, in this process."""
    import functools
    import importlib

    import numpy as np
    import torch

    import chip_smoke as cs
    from zopfli_tpu_torch import native
    from zopfli_tpu_torch.deflate import Options, split_master
    from zopfli_tpu_torch.emit import BitStream
    from zopfli_tpu_torch.ops import dp, engine
    from zopfli_tpu_torch.ops import scan_kernel as sk

    tdeflate = importlib.import_module("zopfli_tpu_torch.deflate")
    dev = torch.device("cuda")
    data = np.frombuffer(open(path, "rb").read(), np.uint8)
    sk.build_kernels()
    r = {}
    ins16 = cs._dp_inputs(engine, data, 0, 16384, dev)
    r["dp_ms_16k"] = cs.cuda_time_ms(lambda: dp.squeeze_scan(*ins16), 5)
    bounds = split_master(Options(engine="native"), data, 0, len(data),
                          native.greedy)
    b = int(np.argmax(np.diff(bounds)))
    insb = cs._dp_inputs(engine, data, int(bounds[b]), int(bounds[b + 1]),
                         dev)
    r["largest_block"] = int(bounds[b + 1] - bounds[b])
    r["dp_ms_largest"] = cs.cuda_time_ms(lambda: dp.squeeze_scan(*insb), 3)
    rng = np.random.default_rng(5)
    rows8 = []
    row = 1 << 17
    for i, cut in enumerate((row, row - 1, 126_000, 110_000, 97_000,
                             80_000, 70_000, 65_537)):
        model = (() if i % 2 == 0 else
                 (rng.uniform(1, 15, 288).astype(np.float32),
                  rng.uniform(1, 12, 32).astype(np.float32)))
        rows8.append(cs._dp_inputs(engine, data, i * row, i * row + cut, dev,
                                   *model))
    ins8 = [torch.cat([x[i] for x in rows8]) for i in range(6)]
    r["dp_ms_b8"] = cs.cuda_time_ms(lambda: dp.squeeze_scan(*ins8), 3)
    del rows8, ins8, insb, ins16
    for k in sk.LAUNCHES:
        sk.LAUNCHES[k] = 0
    engine.FALLBACKS[0] = 0
    out = BitStream()
    torch.cuda.synchronize()
    t0 = time.time()
    tdeflate.deflate(Options(engine="native", numiterations=ITERATIONS), 2,
                     True, data, out, engine_factory=functools.partial(
                         engine.DeviceBlockEngine, device=dev),
                     greedy_fn=engine.device_greedy)
    torch.cuda.synchronize()
    r["oracle_seconds"] = time.time() - t0
    payload = out.getvalue()
    r["oracle_bytes"] = len(payload)
    r["oracle_crc32"] = __import__("zlib").crc32(payload)
    r["oracle_dp_launches"] = sk.LAUNCHES["dp_scan"]
    r["oracle_fallbacks"] = engine.FALLBACKS[0]
    return r


def measure_large_tile(path: str) -> dict:
    """compress() at ZT_TILE=32768 and the large-tile K2 entry on that
    run's own inputs, in this process (started with ZT_TILE set)."""
    import zlib

    import torch

    import chip_smoke as cs
    import zopfli_tpu_torch as zt
    from zopfli_tpu_torch.ops import scan_kernel as sk

    raw = open(path, "rb").read()
    sk.build_kernels()
    for k in sk.LAUNCHES:
        sk.LAUNCHES[k] = 0
    kept, restore = cs._capture_fused_k1k2()
    t0 = time.time()
    try:
        out = zt.compress(raw, "gzip", zt.Options(numiterations=15))
    finally:
        restore()
    r = {"tile_seconds": time.time() - t0, "tile_bytes": len(out),
         "tile_crc32": zlib.crc32(out),
         "tile_roundtrip": zlib.decompress(out, 31) == raw,
         "tile_launches": dict(sk.LAUNCHES)}
    G = kept["groups"]
    lit, nbytes, symtab = kept["traceback"]
    ce, _ = sk.scan(*kept["scan"], groups=G)
    torch.cuda.synchronize()
    r["k2_large_ms"] = cs.cuda_time_ms(
        lambda: sk.traceback(ce, lit, nbytes, symtab, groups=G), 10)
    r["k2_shape"] = [G, ce.shape[0] // G, ce.shape[1]]
    return r


def run(root: str, path: str, what: str) -> dict:
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {root!r})\n"
        f"sys.path.insert(1, {HERE!r})\n"
        "import exp_oracle_turns as t\n"
        f"print(json.dumps(t.{what}({path!r})))\n")
    env = dict(os.environ)
    if what == "measure_large_tile":
        env["ZT_TILE"] = TILE
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise RuntimeError(f"{root} {what} failed:\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv) -> int:
    import torch

    if len(argv) < 1 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    parent = os.path.abspath(argv[0])
    rounds = int(argv[1]) if len(argv) > 1 else 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    with tempfile.NamedTemporaryFile(suffix=".bin", delete=False) as f:
        f.write(cs.corpus_1mib())
        path = f.name
    try:
        for _ in range(rounds):
            for name, root in (("parent", parent), ("this", ROOT),
                               ("this", ROOT), ("parent", parent)):
                r = {"checkout": name, **run(root, path, "measure_dp"),
                     **run(root, path, "measure_large_tile")}
                print(json.dumps(r), flush=True)
    finally:
        os.unlink(path)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
