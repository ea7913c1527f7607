"""Host ms per call in [zt.presplit]: each master's concatenated store and
the queueing of its second split. None without [zt.call] (a program
without these spans); 0 where the span did not run."""


def read(view):
    if not view.intervals("zt.call"):
        return None
    return 1e3 * view.span_s("zt.presplit") / view.calls
