"""8 x output bytes over input bytes, over the pool's distinct inputs,
each once: an input's output is the mean of its outputs' sizes in the
window (the same bytes each time from a deterministic program), or the
size of its output after the window where the window did not reach it.
So the number covers the whole pool, and two runs of one seed read
alike however far their windows got."""


def read(window):
    outs = window.pool_outs
    nin = sum(n for n, _ in outs.values())
    if not nin:
        return None
    return 8.0 * sum(sum(s) / len(s) for _, s in outs.values()) / nin
