"""Host ms per call in [zt.seed_wait]: the host's wait for the seed
programs' device work."""


def read(view):
    if not view.intervals("zt.seed_wait"):
        return None
    return 1e3 * view.span_s("zt.seed_wait") / view.calls
