"""zopfli_tpu_torch: a Zopfli-class DEFLATE/zlib/gzip encoder on PyTorch.

The PyTorch/CUDA port of zopfli_tpu.  Public API (the analogue of the
reference's ZopfliCompress, src/zopfli/zopfli.h:66-88):

    import zopfli_tpu_torch
    out = zopfli_tpu_torch.compress(data, fmt="gzip", options=...)

Formats: "gzip" (RFC 1952), "zlib" (RFC 1950), "deflate" (raw RFC 1951).
Every output decompresses bit-for-bit to the input with stock zlib.

    outs = zopfli_tpu_torch.compress_many([a, b, c], fmt="gzip")

The default engine ("device") runs the seed parse, the block splits and
the squeeze on Options.device, "cuda" unless the caller asks for "cpu";
it raises when that device is missing.  engine="native" is the C++ host
engine.
"""

from __future__ import annotations

import numpy as np

from . import containers
from .deflate import Options, deflate
from .emit import BitStream
from .utils.logging import span

__version__ = "0.1.0"

FORMATS = ("gzip", "zlib", "deflate")


def _as_u8(data) -> np.ndarray:
    if isinstance(data, np.ndarray) and data.dtype == np.uint8:
        return np.ascontiguousarray(data)
    return np.frombuffer(bytes(data), dtype=np.uint8)


def deflate_raw(data, options: Options | None = None) -> bytes:
    options = options or Options()
    data = _as_u8(data)
    out = BitStream()
    deflate(options, 2, True, data, out)
    return out.getvalue()


def compress(data, fmt: str = "gzip", options: Options | None = None) -> bytes:
    """Compress `data` into the requested container format.

    Inside a torch.distributed process group of more than one process
    this routes to `parallel.multihost.compress_multihost` (master blocks
    sharded over the processes; bytes on rank 0, None elsewhere): every
    process must call it with identical data.
    """
    with span("zt.call"):
        return _compress(data, fmt, options)


def _compress(data, fmt: str, options: Options | None) -> bytes:
    options = options or Options()
    data = _as_u8(data)
    from .parallel import multihost
    if multihost.active():
        return multihost.compress_multihost(data, fmt, options)
    if fmt not in FORMATS:
        raise ValueError(f"unknown format {fmt!r}; expected one of {FORMATS}")
    payload = deflate_raw(data, options)
    with span("zt.container"):
        result = _frame(fmt, payload, data)
    if options.tracer is not None:
        options.tracer.summary(len(data), len(result), fmt)
    return result


def _frame(fmt: str, payload: bytes, data: np.ndarray) -> bytes:
    """`payload` in its container, with the checksum of `data`."""
    if fmt == "gzip":
        return containers.gzip_frame(payload, containers.crc32(data),
                                     len(data))
    if fmt == "zlib":
        return containers.zlib_frame(payload, containers.adler32(data))
    return payload


def compress_many(blobs, fmt: str = "gzip",
                  options: Options | None = None) -> list[bytes]:
    """Compress many independent inputs, batched on the device.

    With the device engine, all inputs' master blocks share the fused
    engine's lane groups -- one device loop serves many small files
    (the reference's only analog is the CLI's sequential file loop,
    zopfli_bin.c:191-211).  The native engine compresses sequentially,
    and so does every engine inside a process group of more than one
    process, where each blob goes through compress() and so through
    compress_multihost (bytes on rank 0, None elsewhere).  Returns one
    container per input, same semantics as compress().
    """
    with span("zt.call"):
        return _compress_many(blobs, fmt, options)


def _compress_many(blobs, fmt: str, options: Options | None) -> list[bytes]:
    options = options or Options()
    if fmt not in FORMATS:
        raise ValueError(f"unknown format {fmt!r}; expected one of {FORMATS}")
    blobs = [_as_u8(b) for b in blobs]
    from .parallel import multihost
    if options.engine != "device" or multihost.active():
        return [_compress(b, fmt, options) for b in blobs]

    from .deflate import deflate_many

    # Empty inputs take the scalar path (fixed empty block rules).
    idx = [i for i, b in enumerate(blobs) if len(b)]
    results: list[bytes | None] = [None] * len(blobs)
    for i, b in enumerate(blobs):
        if not len(b):
            results[i] = _compress(b, fmt, options)
    if idx:
        data = np.concatenate([blobs[i] for i in idx])
        ranges = []
        pos = 0
        for i in idx:
            ranges.append((pos, pos + len(blobs[i])))
            pos += len(blobs[i])
        outs = [BitStream() for _ in idx]
        deflate_many(options, data, ranges, outs)
        payloads = [out.getvalue() for out in outs]
        with span("zt.container"):
            for i, payload in zip(idx, payloads):
                results[i] = _frame(fmt, payload, blobs[i])
    return results


_WARMED: set = set()


def warmup(sizes=(1 << 20,), options: Options | None = None,
           background: bool = False):
    """Build the kernels and run the pipeline once per input size.

    The first call in a process compiles the CUDA kernels (nvcc) and the
    native engine (g++); warmup() pays that up front, or on a thread
    with background=True (returns the Thread; join() it before timing).
    """
    options = options or Options()
    rng = np.random.default_rng(12345)
    words = [b"the ", b"warm ", b"up ", b"corpus ", b"for ", b"kernel ",
             b"shapes ", b"only "]

    def run():
        for size in sizes:
            key = (size, options.numiterations, options.engine,
                   options.device)
            if key in _WARMED:
                continue
            blob = b"".join(
                words[i] for i in rng.integers(0, len(words),
                                               size // 5 + 2))[:size]
            compress(blob, "gzip", options)
            _WARMED.add(key)

    if background:
        import threading
        t = threading.Thread(target=run, name="zopfli-torch-warmup",
                             daemon=True)
        t.start()
        return t
    run()
    return None


def gzip_compress(data, options: Options | None = None) -> bytes:
    return compress(data, "gzip", options)


def zlib_compress(data, options: Options | None = None) -> bytes:
    return compress(data, "zlib", options)
