"""Host ms per call in [zt.png.probe]: the automatic filter strategy's
trial deflates of each image, the brute-force strategy's per-line
trials among them.  None without [zt.png.prepare] (a program without
these spans); 0 where no probe ran."""


def read(view):
    if not view.intervals("zt.png.prepare"):
        return None
    return 1e3 * view.span_s("zt.png.probe") / view.calls
