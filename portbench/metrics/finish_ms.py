"""Host ms per call in [zt.finish]: the second split and the host's
emission of the bitstream."""


def read(view):
    if not view.intervals("zt.finish"):
        return None
    return 1e3 * view.span_s("zt.finish") / view.calls
