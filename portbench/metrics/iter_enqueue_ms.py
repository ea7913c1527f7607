"""Host ms per call in [zt.iterations]: the fused loop's eager enqueue of
its iterations."""


def read(view):
    if not view.intervals("zt.iterations"):
        return None
    return 1e3 * view.span_s("zt.iterations") / view.calls
