"""Host ms per call in [zt.seed.probe]: the zlib level-1 probe of each
master on the host, inside [zt.seed]. None without [zt.call] (a program
without these spans); 0 where the span did not run."""


def read(view):
    if not view.intervals("zt.call"):
        return None
    return 1e3 * view.span_s("zt.seed.probe") / view.calls
