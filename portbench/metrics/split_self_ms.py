"""Host ms per call in [zt.split] less the [zt.seed_wait] inside it:
the split's own time, without the wait for the seed programs."""

from portbench import stats


def read(view):
    split = view.intervals("zt.split")
    if not split:
        return None
    inner = stats.overlap(split, view.intervals("zt.seed_wait"))
    return 1e3 * (view.span_s("zt.split") - inner) / view.calls
