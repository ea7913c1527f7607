"""Host ms per call in [zt.png.verify]: each image's chunk assembly,
the decode of the result and the pixel comparison.  None without
[zt.png.prepare] (a program without these spans)."""


def read(view):
    if not view.intervals("zt.png.prepare"):
        return None
    return 1e3 * view.span_s("zt.png.verify") / view.calls
