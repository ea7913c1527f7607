"""Run a cell's controls in the program's place, and print what the
reference reads of each: each compared number beside its limit, and the
end-to-end metrics.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds <s> [--controls i5,i1]

One process; a set-up and one short window a seed and control, at the
cell's own sizes and load, the pool's unreached inputs compressed after
it.  `--controls` names entries of the configuration's `controls` (all
of them by default), and `program` runs the program as configured.  The
benchmark's own runs never run this; it is how the limits in PERF.md
were shown to fail a control.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import calls, run  # noqa: E402
from portbench.manifest import Manifest  # noqa: E402
from portbench.reference import control  # noqa: E402


def control_entry(name: str, man: Manifest):
    program = functools.partial(calls.program_entry, man=man)
    if name == "program":
        return program
    return lambda call, config: control.entry(call, config, program, name,
                                              man)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--controls", default="")
    args = ap.parse_args(argv)
    man = Manifest()
    config = man.config(man.cell(args.workload)["config"])
    names = [c for c in args.controls.split(",") if c] \
        or list(config["controls"])
    no_card = lambda chips: {}  # noqa: E731
    for seed in (int(s) for s in args.seeds.split(",")):
        for name in names:
            r = run.run_cell(man, args.workload, seed, args.seconds, False,
                             make_entry=control_entry(name, man),
                             device_info=no_card)
            print(json.dumps({"side": name, "seed": seed,
                              "correct": r["correct"],
                              "attempted": r["attempted"],
                              "failed": r["failed"],
                              "metrics": {k: v["value"] for k, v in
                                          r["metrics"].items()},
                              "check": r["check"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
