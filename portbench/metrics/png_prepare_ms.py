"""Host ms per call in [zt.png.prepare] less the [zt.png.probe] inside
it: each image's decode, colour choice, packing, filtering and the
filtered stream of its chosen strategy.  None without [zt.png.prepare]
(a program without these spans)."""

from portbench import stats


def read(view):
    prep = view.intervals("zt.png.prepare")
    if not prep:
        return None
    inner = stats.overlap(prep, view.intervals("zt.png.probe"))
    return 1e3 * (view.span_s("zt.png.prepare") - inner) / view.calls
