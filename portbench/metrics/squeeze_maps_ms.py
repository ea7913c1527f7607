"""Host ms per call in [zt.squeeze.maps]: getting the fused loop's
randomization maps, built and uploaded only when the device holds too
few events; about 0 once warm.  None where the span never ran (a
program without it)."""


def read(view):
    if not view.intervals("zt.squeeze.maps"):
        return None
    return 1e3 * view.span_s("zt.squeeze.maps") / view.calls
