"""Host ms per call in [zt.verify]: the hash-collision check of every
block's parse and the building of its LZ77 store, after [zt.collect].
None without [zt.call] (a program without these spans); 0 where the span
did not run."""


def read(view):
    if not view.intervals("zt.call"):
        return None
    return 1e3 * view.span_s("zt.verify") / view.calls
