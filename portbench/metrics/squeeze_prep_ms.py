"""Host ms per call in [zt.squeeze.prep]: the fused loop's lane-group
tensors (FusedSqueeze's construction) and its initial state, before
[zt.iterations]. None without [zt.call] (a program without these spans);
0 where the span did not run."""


def read(view):
    if not view.intervals("zt.call"):
        return None
    return 1e3 * view.span_s("zt.squeeze.prep") / view.calls
