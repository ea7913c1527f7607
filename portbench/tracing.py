"""The traced run's view of its profiled calls, read from torch.profiler.

The benchmark wraps each profiled call in a `portbench.call` range.  The
profiler (CPU and CUDA activities) gives the program's own host ranges,
the `[zt.*]` spans of `zopfli_tpu_torch.utils.logging.span`, and every
operation that ran on the device.  The traced window runs from the
first profiled call's start to the last one's end; every metric reader
(`metrics/<name>.py`) reads a `View` of it and returns a number, or
None where it finds nothing to read.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

from . import stats

CALL_SPAN = "portbench.call"
TOP = 10


@dataclass
class View:
    calls: int                 # profiled calls
    window_s: float            # first profiled call's start to last's end
    input_bytes: int           # input bytes of the profiled calls
    call_s: float              # their wall, by the benchmark's clock
    config: dict
    mix: dict
    device: list = field(default_factory=list)   # (start_s, end_s, name)
    spans: list = field(default_factory=list)    # (name, start_s, end_s)

    def intervals(self, name: str) -> list[tuple[float, float]]:
        return [(s, e) for n, s, e in self.spans if n == name]

    def span_s(self, name: str) -> float:
        return sum(e - s for s, e in self.intervals(name))

    def busy_s(self) -> float:
        return stats.covered([(s, e) for s, e, _ in self.device], 0.0,
                             self.window_s)

    def device_s(self, match) -> float:
        return sum(e - s for s, e, n in self.device if match(n))


def _is_annotation(ev) -> bool:
    """A range of record_function mirrored on the device's timeline,
    not work the device did."""
    kind = getattr(ev, "activity_type", None)
    return (bool(ev.is_user_annotation())
            or (kind is not None and "annotation" in str(kind()).lower())
            or ev.name() == CALL_SPAN or ev.name().startswith("zt."))


def view_of(prof, config: dict, mix: dict, input_bytes: int,
            call_s: float) -> View | None:
    """The View of a finished torch.profiler.profile, or None if it
    holds no profiled call."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    evs = prof.profiler.kineto_results.events()
    calls = [(ev.start_ns(), ev.start_ns() + ev.duration_ns())
             for ev in evs if ev.name() == CALL_SPAN
             and ev.device_type() != cuda]
    if not calls:
        return None
    lo = min(s for s, _ in calls)
    hi = max(e for _, e in calls)
    sec = 1e-9
    device, spans = [], []
    for ev in evs:
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if ev.device_type() == cuda:
            if _is_annotation(ev) or e <= lo or s >= hi:
                continue
            device.append(((max(s, lo) - lo) * sec, (min(e, hi) - lo) * sec,
                           ev.name()))
        elif ev.name().startswith("zt."):
            spans.append((ev.name(), (s - lo) * sec, (e - lo) * sec))
    return View(len(calls), (hi - lo) * sec, input_bytes, call_s, config,
                mix, device, spans)


def short(name: str) -> str:
    """A kernel's name without `(anonymous namespace)::` and without its
    argument list (the first parenthesis outside template brackets)."""
    name = name.replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            name = name[:i]
            break
    return name[:160]


def breakdown(view: View) -> dict:
    """The device operations that took most time, by name, and the idle
    gaps of the device summed by the innermost [zt.*] span the host was
    in at each gap's middle."""
    by_op: dict = defaultdict(float)
    for s, e, n in view.device:
        by_op[short(n)] += e - s
    by_span: dict = defaultdict(float)
    spans = sorted(view.spans, key=lambda t: t[1])
    nxt, active = 0, []
    for s, e in stats.gaps([(a, b) for a, b, _ in view.device], 0.0,
                           view.window_s):
        mid = (s + e) / 2            # gaps come in order: sweep the spans
        while nxt < len(spans) and spans[nxt][1] <= mid:
            active.append(spans[nxt])
            nxt += 1
        active = [t for t in active if t[2] > mid]
        label = max(active, key=lambda t: t[1])[0] if active \
            else "no zt span"
        by_span[label] += e - s
    top = lambda d: [[k, v] for k, v in sorted(d.items(),  # noqa: E731
                                               key=lambda kv: -kv[1])[:TOP]]
    return {"device_ops": top(by_op), "idle_gaps": top(by_span)}
