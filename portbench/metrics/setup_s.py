"""Process start to the first timed call: imports, the CUDA context, the
port's kernels, the seed's inputs and one warm call."""


def read(window):
    return window.setup_s
