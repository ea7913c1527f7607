"""[zt.png.trial] spans per call: the filter strategies the automatic
choice tried, each once over its image (the brute-force strategy once,
not once a line).  None without [zt.png.prepare] (a program without
these spans)."""


def read(view):
    if not view.intervals("zt.png.prepare"):
        return None
    return sum(n == "zt.png.trial" for n, _, _ in view.spans) / view.calls
