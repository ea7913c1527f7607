"""Run one cell of BENCHMARK.json once and print one JSON line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  Set-up (imports, the CUDA context, the
port's kernels loaded or built into its checkout, the seed's inputs, one
warm pass of the pool, which holds every call shape of the mix) is
`setup_s`.  The window then calls the cell's entry back to back, one
client, cycling the pool, until `--seconds` have passed and the pass in
flight has ended.  With `--trace 1` torch.profiler covers whole passes
of the window, at most the mix's `trace_calls` calls, and the line
carries the per-layer metrics, the device's busy and window seconds and
a breakdown; with `--trace 0` it carries the end-to-end metrics, and
any pool input the window did not reach is compressed after it, untimed,
so that the bits per byte cover the whole pool.  After the window the
reference judges every output; the compared numbers and their limits
end standard error and the line.  There is no fallback: without CUDA,
or with fewer cards than the cell asks for, the run fails and prints no
result.
"""

from __future__ import annotations

import argparse
import functools
import gc
import json
import os
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import calls, gen, tracing  # noqa: E402
from portbench.manifest import Manifest  # noqa: E402

CACHE = os.path.join(ROOT, ".portbench_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "zopfli_tpu")
LIMITS = {"bad_outputs": 0, "missing_outputs": 0,
          "not_smaller_than_zlib9": 0}
T_IMPORT = time.perf_counter()


def process_age_s() -> float:
    """Seconds since this process started (the kernel's clock, 10 ms
    ticks), or since this module was loaded where /proc is missing."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_IMPORT


@dataclass
class Record:
    items: list
    outs: list | None
    t0: float
    t1: float
    error: str | None = None
    after: bool = False          # made after the window, untimed


@dataclass
class Window:
    """What the end-to-end metric readers read.  `pool_outs` maps each
    distinct input of the pool to (its bytes, its output sizes): those
    of the window's calls, or of the call after the window that reached
    it."""
    records: list
    window_s: float
    setup_s: float
    pool_outs: dict = field(default_factory=dict)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_info(chips: int) -> dict:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    limits = smi.stdout.strip().splitlines()
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(d)
                                     for d in range(chips)),
            "power_limit": limits[0].strip() if limits else "not read"}


def sync() -> None:
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def steady_host() -> None:
    """Set-up's objects out of the collector's way: a full collection
    in the window then walks only what the window made."""
    gc.collect()
    gc.freeze()


def call_once(entry, items, around=None, after=False) -> Record:
    """One call of the entry, timed; a failed call is recorded, not
    fatal."""
    t0 = time.perf_counter()
    try:
        if around is None:
            outs = entry(items)
        else:
            with around():
                outs = entry(items)
        err = None
    except Exception as e:
        traceback.print_exc()
        outs, err = None, repr(e)
    return Record(items, outs, t0, time.perf_counter(), err, after)


def drive(entry, pool, seconds: float, cap: int | None = None,
          around=None) -> tuple[list, float]:
    """Closed loop, one client: calls back to back until `seconds` have
    passed (or `cap` calls), the pass in flight finishing.  Returns the
    records and the window's length."""
    recs = []
    t_open = time.perf_counter()
    while True:
        recs.append(call_once(entry, pool.calls[len(recs) % len(pool.calls)],
                              around))
        t1 = recs[-1].t1
        if len(recs) % pool.cycle == 0 and (
                t1 - t_open >= seconds or (cap is not None
                                           and len(recs) >= cap)):
            return recs, t1 - t_open


def traced(entry, pool, seconds: float, mix: dict, config: dict):
    """Profile whole calls of the window; (records, window_s, View)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        recs, window_s = drive(
            entry, pool, seconds, cap=int(mix["trace_calls"]),
            around=lambda: record_function(tracing.CALL_SPAN))
        sync()
    nbytes = sum(i.nbytes for r in recs for i in r.items)
    view = tracing.view_of(prof, config, mix, nbytes,
                           sum(r.t1 - r.t0 for r in recs))
    return recs, window_s, view


def finish_pool(entry, pool, recs) -> list:
    """Records, marked `after`, of the pool's calls that the window did
    not reach, made once it has closed."""
    reached = {id(r.items) for r in recs}
    return [call_once(entry, items, after=True) for items in pool.calls
            if id(items) not in reached]


def pool_outs(recs) -> dict:
    """{item key: (input bytes, [output sizes])} over every record that
    returned its outputs."""
    out: dict = {}
    for r in recs:
        if r.outs is None or len(r.outs) != len(r.items):
            continue
        for item, o in zip(r.items, r.outs):
            out.setdefault(item.key, (item.nbytes, []))[1].append(len(o))
    return out


def run_cell(man: Manifest, name: str, seed: int, seconds: float,
             trace: bool, make_entry=None, device_info=card_info) -> dict:
    """One run of cell `name`: the result line as a dict.  `make_entry
    (call, config)` gives the timed path; by default the program's
    entry, `calls.program_entry`, found under `man`'s bench dir."""
    cell = man.cell(name)
    config = man.config(cell["config"])
    mix = man.traffic(cell["traffic"])
    make_entry = make_entry or functools.partial(calls.program_entry,
                                                 man=man)
    entry = make_entry(mix["call"], config)
    fmt = man.module("reference/formats", config["format"])
    pool = gen.make_pool(mix, seed, man)
    for items in pool.calls[:pool.cycle]:
        entry(items)
    sync()
    steady_host()
    setup_s = process_age_s()

    view = None
    if trace:
        recs, window_s, view = traced(entry, pool, seconds, mix, config)
    else:
        recs, window_s = drive(entry, pool, seconds)
    after = [] if trace else finish_pool(entry, pool, recs)
    sync()
    device = device_info(cell["chips"])

    checker = calls.Checker(fmt)
    missing = 0
    for r in recs + after:
        if r.outs is None or len(r.outs) != len(r.items):
            missing += len(r.items)
            continue
        for item, out in zip(r.items, r.outs):
            checker(item, out)
    attempted = sum(len(r.items) for r in recs + after)
    failed = missing + checker.bad
    check = {"bad_outputs": checker.bad, "missing_outputs": missing,
             "not_smaller_than_zlib9": checker.not_smaller}

    metrics = {}
    if trace:
        kind, source = "per_layer", view
        if view is not None:
            device["busy_s"] = view.busy_s()
            device["window_s"] = view.window_s
    else:
        kind, source = "end_to_end", Window(recs, window_s, setup_s,
                                            pool_outs(recs + after))
    for m in man.metrics(name, kind):
        v = man.reader(m["name"])(source) if source is not None else None
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    for why, n in sorted(checker.reasons.items()):
        print(f"reference rejected {n} outputs: {why}", file=sys.stderr)
    for r in recs + after:
        if r.error:
            print(f"call failed: {r.error}", file=sys.stderr)
            break
    print(f"largest output over zlib level 9's: {checker.worst_ratio:.6f}",
          file=sys.stderr)
    for k, v in check.items():
        print(f"check {k} = {v} (limit {LIMITS[k]}; outputs checked "
              f"{checker.checked}, distinct {len(checker.seen)})",
              file=sys.stderr)
    out = {"correct": attempted > 0 and all(
               v <= LIMITS[k] for k, v in check.items()),
           "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": device}
    if trace and view is not None:
        out["breakdown"] = tracing.breakdown(view)
    out["check"] = {k: {"value": v, "limit": LIMITS[k]}
                    for k, v in check.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # Every build and kernel cache of the run inside the checkout, at
    # fixed paths (the port builds its kernels into its own _build/).
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE, sub)
    man = Manifest()
    cell = man.cell(args.workload)

    # One host thread in PyTorch's pool: the card's host is shared, and
    # runs with the default eight were slower and no steadier (PERF.md).
    os.environ["OMP_NUM_THREADS"] = "1"
    import torch
    torch.set_num_threads(1)
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); torch sees {seen}", file=sys.stderr)
        return 2

    result = run_cell(man, args.workload, args.seed, args.seconds,
                      bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded {', '.join(found)}; the run measures "
              "zopfli_tpu_torch alone", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
