"""Host ms per call in [zt.seed]: the enqueue of the seed programs."""


def read(view):
    if not view.intervals("zt.seed"):
        return None
    return 1e3 * view.span_s("zt.seed") / view.calls
