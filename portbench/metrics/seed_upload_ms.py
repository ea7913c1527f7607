"""Host ms per call in [zt.seed.upload]: each seed program's padded buffer
and its pinned upload, inside [zt.seed]. None without [zt.call] (a
program without these spans); 0 where the span did not run."""


def read(view):
    if not view.intervals("zt.call"):
        return None
    return 1e3 * view.span_s("zt.seed.upload") / view.calls
