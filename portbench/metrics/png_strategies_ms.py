"""Host ms per call in [zt.png.strategies]: each image's explicit filter
strategies, from the filter choice to the serialized streams, brute
force's per-line trials among them.  None where the span never ran (a
program without it, or the automatic strategy)."""


def read(view):
    if not view.intervals("zt.png.strategies"):
        return None
    return 1e3 * view.span_s("zt.png.strategies") / view.calls
