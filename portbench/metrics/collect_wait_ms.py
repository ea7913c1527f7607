"""Host ms per call in [zt.collect_wait]: the blocking pulls of the fused
loop's results; [zt.collect] less this is the decode. None without
[zt.call] (a program without these spans); 0 where the span did not run."""


def read(view):
    if not view.intervals("zt.call"):
        return None
    return 1e3 * view.span_s("zt.collect_wait") / view.calls
