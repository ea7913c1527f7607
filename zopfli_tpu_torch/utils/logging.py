"""Structured tracing for the encoder pipeline.

The reference's observability is stderr prints gated on verbose flags
(reference: squeeze.c:493-495, deflate.c:721-744, blocksplitter.c:148-180).
Here the equivalent events flow through a Tracer that can print and
collect structured records.

`span(name)` marks a stage of the host's work as a named range on
torch.profiler's timeline, beside the device's operations; the
benchmark (`portbench/`) reads the ranges to say where a call's wall
and the device's idle time go.  Names:

- `zt.<stage>` covers one stage of a call (`zt.call` the whole call);
- `zt.<stage>.<part>` covers one part of that stage's work;
- a name ending in `_wait` covers nothing but a blocking read of device
  results: the host waiting for the device.

No span goes inside a loop that runs per iteration, lane group or tile.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from dataclasses import dataclass, field

_OFF = contextlib.nullcontext()


def span(name: str):
    """A named range in torch.profiler traces while a profiler records;
    otherwise one shared null context, so that a span costs a lookup
    and no RecordFunction.  The profiler can only be on once
    torch.autograd.profiler is loaded, so this never imports torch."""
    profiler = sys.modules.get("torch.autograd.profiler")
    if profiler is None or not profiler._is_profiler_enabled:
        return _OFF
    return profiler.record_function(name)


@dataclass
class Tracer:
    """Collects per-block / per-iteration encoder metrics."""

    verbose: bool = False
    verbose_more: bool = False
    records: list = field(default_factory=list)

    def event(self, kind: str, **fields) -> None:
        rec = {"kind": kind, "t": time.time(), **fields}
        self.records.append(rec)
        if self.verbose_more or (self.verbose and kind in ("block", "summary")):
            print(json.dumps(rec), file=sys.stderr)

    def block_iteration_hook(self, instart: int, inend: int):
        best = [float("inf")]

        def hook(iteration: int, cost_bits: float) -> None:
            improved = cost_bits < best[0]
            if improved:
                best[0] = cost_bits
            if self.verbose_more or (self.verbose and improved):
                print(f"Iteration {iteration}: {int(cost_bits)} bit",
                      file=sys.stderr)
            self.event("iteration", instart=instart, inend=inend,
                       iteration=iteration, cost_bits=cost_bits)

        return hook

    def block_done(self, lstart: int, lend: int, out_bits: int) -> None:
        self.event("block", lstart=lstart, lend=lend, out_bits=out_bits)

    def summary(self, insize: int, outsize: int, fmt: str) -> None:
        removed = 100.0 * (insize - outsize) / insize if insize else 0.0
        if self.verbose:
            print(f"Original Size: {insize}, {fmt}: {outsize}, "
                  f"Compression: {removed:f}% Removed", file=sys.stderr)
        self.event("summary", insize=insize, outsize=outsize, format=fmt)
