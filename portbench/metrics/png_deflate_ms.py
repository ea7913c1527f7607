"""Host ms per call in [zt.png.deflate]: the compress_many calls that
deflate every image's IDAT, the port's whole deflate ([zt.call]) inside
them.  None without [zt.png.prepare] (a program without these spans)."""


def read(view):
    if not view.intervals("zt.png.prepare"):
        return None
    return 1e3 * view.span_s("zt.png.deflate") / view.calls
