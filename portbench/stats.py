"""Arithmetic of the trace: interval unions, gaps and overlaps."""

from __future__ import annotations


def union(intervals) -> list[tuple[float, float]]:
    """Disjoint, sorted cover of [start, end) intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(intervals, lo: float, hi: float) -> float:
    """Length of [lo, hi) that the union of `intervals` covers."""
    return sum(max(0.0, min(e, hi) - max(s, lo))
               for s, e in union(intervals))


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The parts of [lo, hi) that no interval covers, in order."""
    out = []
    cur = lo
    for s, e in union(intervals):
        if e <= lo or s >= hi:
            continue
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
    if cur < hi:
        out.append((cur, hi))
    return out


def overlap(a, b) -> float:
    """Length that the union of interval list `a` shares with that of
    `b`."""
    ua, ub = union(a), union(b)
    i = j = 0
    tot = 0.0
    while i < len(ua) and j < len(ub):
        lo = max(ua[i][0], ub[j][0])
        hi = min(ua[i][1], ub[j][1])
        if hi > lo:
            tot += hi - lo
        if ua[i][1] < ub[j][1]:
            i += 1
        else:
            j += 1
    return tot
