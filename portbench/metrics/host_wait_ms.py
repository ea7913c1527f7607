"""Host ms per call blocked on the device: the union of every [zt.*_wait]
span, each a blocking read of device results, so overlapping waits count
once.  None without [zt.call] (a program without these spans)."""

from portbench import stats


def read(view):
    if not view.intervals("zt.call"):
        return None
    waits = [(s, e) for n, s, e in view.spans if n.endswith("_wait")]
    return 1e3 * stats.covered(waits, 0.0, view.window_s) / view.calls
