"""zopfli-compatible command line interface.

Flag-for-flag equivalent of the reference CLI (src/zopfli/zopfli_bin.c:
144-219): per-file compression to FILE.gz/.zlib/.deflate or stdout,
`--i#` iteration count, format selection, verbosity.  Framework
extensions: `--engine` picks the batched device pipeline or the native
host engine, `--device` the torch device of the device engine ("cuda"
unless asked for "cpu").  The device is resolved once, before any file
is read: without CUDA at the default device the run fails and writes
nothing.

Usage: python -m zopfli_tpu_torch.cli [OPTIONS] FILE...
"""

from __future__ import annotations

import sys

from . import compress
from .deflate import ENGINES, Options, resolve_device
from .utils.logging import Tracer

USAGE = """Usage: zopfli_tpu_torch [OPTION]... FILE...
  -h    gives this help
  -c    write the result on standard output, instead of disk filename + '.gz'
  -v    verbose mode
  --i#  perform # iterations (default 15). More gives more compression but is
        slower. Examples: --i10, --i50, --i1000
  --gzip        output to gzip format (default)
  --zlib        output to zlib format instead of gzip
  --deflate     output to deflate format instead of gzip
  --splitlast   ignored, left for backwards compatibility
  --engine=E    compute engine: device (batched, default) or native (host C++)
  --device=D    device of the device engine: cuda (default) or cpu
"""


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    options = Options()
    fmt = "gzip"
    output_to_stdout = False
    files = []

    for arg in argv:
        if arg == "-v":
            options.verbose = True
        elif arg == "-c":
            output_to_stdout = True
        elif arg == "--deflate":
            fmt = "deflate"
        elif arg == "--zlib":
            fmt = "zlib"
        elif arg == "--gzip":
            fmt = "gzip"
        elif arg == "--splitlast":
            pass  # kept for backwards compatibility (zopfli_bin.c:162)
        elif arg.startswith("--i") and arg[3:].isdigit():
            options.numiterations = int(arg[3:])
        elif arg.startswith("--engine="):
            options.engine = arg[len("--engine="):]
        elif arg.startswith("--device="):
            options.device = arg[len("--device="):]
        elif arg in ("-h", "--help"):
            print(USAGE)
            return 0
        elif arg.startswith("-") and len(arg) > 1:
            print(f"Unknown option: {arg}", file=sys.stderr)
            print(USAGE)
            return 1
        else:
            files.append(arg)

    if options.numiterations < 1:
        print("Error: must have 1 or more iterations", file=sys.stderr)
        return 1
    if not files:
        print("Please provide filename(s) to compress", file=sys.stderr)
        if output_to_stdout:
            print("(use - for standard input)", file=sys.stderr)
        print(USAGE)
        return 1
    if options.engine not in ENGINES:
        print(f"Error: unknown engine {options.engine!r}; expected one of "
              f"{', '.join(ENGINES)}", file=sys.stderr)
        return 1
    if options.engine == "device":
        try:
            resolve_device(options)
        except (RuntimeError, ValueError) as e:
            print(f"Error: {e}", file=sys.stderr)
            return 1

    ext = {"gzip": ".gz", "zlib": ".zlib", "deflate": ".deflate"}[fmt]
    for filename in files:
        if filename == "-":
            data = sys.stdin.buffer.read()
        else:
            try:
                with open(filename, "rb") as f:
                    data = f.read()
            except OSError as e:
                print(f"Invalid filename: {filename} ({e})", file=sys.stderr)
                continue
        if len(data) >= (1 << 31):
            # Reference cap: "Files larger than 2GB are not supported"
            # (zopfli_bin.c:56-59).
            print(f"Files larger than 2GB are not supported: {filename}",
                  file=sys.stderr)
            continue
        if options.verbose:
            options.tracer = Tracer(verbose=True)
        out = compress(data, fmt, options)
        if output_to_stdout:
            sys.stdout.buffer.write(out)
        else:
            outname = filename + ext
            with open(outname, "wb") as f:
                f.write(out)
            if options.verbose:
                ratio = 100.0 * len(out) / max(len(data), 1)
                print(f"{filename}: {len(data)} -> {len(out)} "
                      f"({ratio:.2f}%) -> {outname}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
