"""ZopfliPNG-equivalent PNG recompression (reference src/zopflipng/).

    from zopfli_tpu_torch.png import optimize, PNGOptions
    better = optimize(open("in.png", "rb").read())

The IDAT deflates run on PNGOptions.device ("cuda" unless the caller
asks for "cpu") through zopfli_tpu_torch.compress_many.
"""

from .optimize import PNGOptions, optimize  # noqa: F401
from . import chunks, codec, filters  # noqa: F401
