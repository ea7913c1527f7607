"""Host ms per call in [zt.finish.fixed]: the fixed-tree re-parse probes of
the blocks that take one, inside [zt.finish]. None without [zt.call] (a
program without these spans); 0 where the span did not run."""


def read(view):
    if not view.intervals("zt.call"):
        return None
    return 1e3 * view.span_s("zt.finish.fixed") / view.calls
