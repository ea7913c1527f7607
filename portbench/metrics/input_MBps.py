"""Uncompressed input bytes of every call completed in the window over
the window's length, in 10^6 B/s."""


def read(window):
    if window.window_s <= 0:
        return None
    nbytes = sum(i.nbytes for r in window.records for i in r.items)
    return nbytes / window.window_s / 1e6
