"""Host ms per call in [zt.collect]: the pull and decode of the compacted
parses, which includes the host's wait for the device."""


def read(view):
    if not view.intervals("zt.collect"):
        return None
    return 1e3 * view.span_s("zt.collect") / view.calls
