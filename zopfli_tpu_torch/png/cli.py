"""zopflipng-compatible command line interface.

Flags per the reference CLI (src/zopflipng/zopflipng_bin.cc:72-264):
prefix mode, -m more iterations, -q quick probe deflate,
--lossy_transparent, --lossy_8bit, --filters=..., --keepchunks=...,
-y overwrite, -d dry run; and --device=cuda|cpu, the torch device of
the IDAT deflates (PNGOptions.device).

Errors.  The device is resolved once, before any file is read, so a
run at the default device without CUDA fails and writes nothing.  As in
the reference, a bad image keeps its original: one that the codec cannot
decode (ValueError, zlib.error, and the KeyError, IndexError or
StopIteration of a malformed header or palette: a colortype or bit
depth that PNG does not define raises KeyError) or whose result fails
the pixel verification (AssertionError).  Nothing else is caught: a
failed kernel build or launch ends the run with its traceback and a
non-zero exit instead of passing as "keeping original".

Usage: python -m zopfli_tpu_torch.png.cli [OPTIONS] infile.png outfile.png
       python -m zopfli_tpu_torch.png.cli --prefix=zopfli_ file1.png ...
"""

from __future__ import annotations

import os
import sys
import zlib

from ..deflate import Options, resolve_device
from . import codec
from .optimize import PNGOptions, optimize, optimize_many

# What codec.decode raises on a malformed PNG.
DECODE_ERRORS = (ValueError, zlib.error, KeyError, IndexError,
                 StopIteration)

USAGE = """Usage: zopfli_tpu_torch_png [options] infile.png outfile.png
       zopfli_tpu_torch_png [options] [--prefix=pre_] file1.png file2.png ...
Options:
-m           compress more: use more iterations (depending on file size)
--prefix=P   output filename prefix for multiple files
-y           do not ask about overwriting files
-d           dry run: don't save any files, just see the console output
-q           use quick, but not very good, compression
--lossy_transparent   remove colors behind alpha channel 0
--lossy_8bit          convert 16-bit per channel image to 8-bit
--filters=TYPES       filter strategies to try: 0-4, m(insum), e(ntropy),
                      p(redefined), b(rute force)
--keepchunks=A,B,...  keep metadata chunks, e.g. tEXt,zTXt
--iterations=N        number of iterations (overrides -m / -q)
--device=D            device of the IDAT deflates: cuda (default) or cpu
"""

_FILTER_MAP = {"0": "zero", "1": "one", "2": "two", "3": "three",
               "4": "four", "m": "minsum", "e": "entropy",
               "p": "predefined", "b": "bruteforce"}


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    opts = PNGOptions()
    files = []
    prefix = None
    yes = False
    dryrun = False
    more = False
    quick = False
    iterations = None
    always_zopflify = False
    verbose = False

    for arg in argv:
        if arg == "-m":
            more = True
        elif arg == "-q":
            quick = True
        elif arg == "-y":
            yes = True
        elif arg == "-d":
            dryrun = True
        elif arg.startswith("--prefix="):
            prefix = arg[len("--prefix="):]
        elif arg == "--prefix":
            prefix = "zopfli_"
        elif arg == "--lossy_transparent":
            opts.lossy_transparent = True
        elif arg == "--lossy_8bit":
            opts.lossy_8bit = True
        elif arg == "--keepcolortype":
            opts.keep_colortype = True
        elif arg == "--always_zopflify":
            always_zopflify = True
        elif arg == "--verbose":
            verbose = True
        elif arg.startswith("--filters="):
            names = []
            for chs in arg[len("--filters="):]:
                if chs in _FILTER_MAP:
                    names.append(_FILTER_MAP[chs])
            opts.filter_strategies = names
            opts.auto_filter_strategy = False
        elif arg.startswith("--keepchunks="):
            opts.keepchunks = arg[len("--keepchunks="):].split(",")
        elif arg.startswith("--iterations="):
            iterations = int(arg[len("--iterations="):])
        elif arg.startswith("--device="):
            opts.device = arg[len("--device="):]
        elif arg.startswith("--splitting"):
            pass  # kept but ignored (zopflipng_bin.cc:212-213)
        elif arg in ("-h", "--help"):
            print(USAGE)
            return 0
        elif arg.startswith("-") and len(arg) > 1:
            print(f"Unknown flag: {arg}", file=sys.stderr)
            print(USAGE)
            return 1
        else:
            files.append(arg)

    if more:
        opts.num_iterations, opts.num_iterations_large = 60, 20
    if quick:
        opts.num_iterations, opts.num_iterations_large = 1, 1
        opts.use_zopfli = False
    if iterations is not None:
        opts.num_iterations = opts.num_iterations_large = iterations

    if prefix is None:
        if len(files) != 2:
            print(USAGE)
            return 1
        pairs = [(files[0], files[1])]
    else:
        pairs = [(f, os.path.join(os.path.dirname(f),
                                  prefix + os.path.basename(f)))
                 for f in files]

    if opts.use_zopfli and opts.engine == "device":
        try:
            resolve_device(Options(device=opts.device))
        except (RuntimeError, ValueError) as e:
            print(f"Error: {e}", file=sys.stderr)
            return 1

    origs = [open(infile, "rb").read() for infile, _ in pairs]
    outs = list(origs)
    good = []
    for i, (infile, _) in enumerate(pairs):
        try:
            codec.decode(origs[i])
            good.append(i)
        except DECODE_ERRORS as e:
            print(f"{infile}: decoding failed ({e}); keeping original",
                  file=sys.stderr)
    # Batched path: all files' strategy x IDAT deflates share the
    # device's lane groups (the reference loops files serially,
    # zopflipng_bin.cc:291-460).  A failed verification demotes to the
    # per-file loop, so one image keeps its original without sinking
    # the rest.
    try:
        for i, out in zip(good, optimize_many([origs[i] for i in good],
                                              opts, verbose=verbose)):
            outs[i] = out
    except AssertionError:
        for i in good:
            try:
                outs[i] = optimize(origs[i], opts, verbose=verbose)
            except AssertionError as e:
                print(f"{pairs[i][0]}: optimization failed ({e}); "
                      "keeping original", file=sys.stderr)
                outs[i] = origs[i]

    total_in = total_out = 0
    for i, (infile, outfile) in enumerate(pairs):
        orig, out = origs[i], outs[i]
        if len(out) >= len(orig) and not always_zopflify:
            out = orig  # keep original if not smaller (zopflipng_bin.cc:404)
        total_in += len(orig)
        total_out += len(out)
        pct = 100.0 * len(out) / max(len(orig), 1)
        print(f"{infile}: {len(orig)} -> {len(out)} bytes ({pct:.2f}%)")
        if dryrun:
            continue
        if os.path.exists(outfile) and not yes and prefix is None:
            r = input(f"File {outfile} exists, overwrite? (y/N) ")
            if r.strip().lower() != "y":
                continue
        with open(outfile, "wb") as f:
            f.write(out)
    if len(pairs) > 1:
        print(f"Total: {total_in} -> {total_out} bytes "
              f"({100.0 * total_out / max(total_in, 1):.2f}%)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
