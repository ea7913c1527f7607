"""Host ms per call in [zt.png.bruteforce]: the brute-force strategy's
per-line trial deflates on the explicit-strategy path.  None where the
span never ran (a program without it, or no brute-force strategy)."""


def read(view):
    if not view.intervals("zt.png.bruteforce"):
        return None
    return 1e3 * view.span_s("zt.png.bruteforce") / view.calls
