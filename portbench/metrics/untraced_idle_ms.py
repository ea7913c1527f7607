"""Device-idle ms per call that no span names: the gaps between the
device's operations, where they overlap the host's [zt.call] and no
other [zt.*] span, by interval overlap.  What the spans still miss;
time between calls is not counted.  None without [zt.call]."""

from portbench import stats


def read(view):
    calls = stats.union(view.intervals("zt.call"))
    if not calls:
        return None
    inner = [(s, e) for n, s, e in view.spans if n != "zt.call"]
    bare = [g for s, e in calls for g in stats.gaps(inner, s, e)]
    idle = stats.gaps([(s, e) for s, e, _ in view.device], 0.0,
                      view.window_s)
    return 1e3 * stats.overlap(idle, bare) / view.calls
