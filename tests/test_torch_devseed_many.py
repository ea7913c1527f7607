"""The port's default path on inputs of several masters and on many
inputs at once (compress_many), against the JAX package's.

As tests/test_torch_devseed.py: both packages at their defaults, the
reference on one device (_LOCAL_MESH pinned to [None]), the port on the
CPU, and no host greedy parse on the port's path."""

import importlib
import zlib

import numpy as np
import pytest
import torch

import zopfli_tpu
import zopfli_tpu_torch as zt
from zopfli_tpu import containers as ref_containers
from zopfli_tpu_torch import native

# The tensors here are tiny: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

ITERATIONS = 2
MASTER = 16384
FORMATS = ("gzip", "zlib", "deflate")


def _multimaster() -> bytes:
    rng = np.random.default_rng(6)
    n = 17500
    words = [b"compress ", b"every ", b"block ", b"of ", b"the ",
             b"input\n", b"{\"key\": ", b"42}, "]
    text = b"".join(words[i] for i in rng.integers(0, len(words), n // 5))
    noise = rng.integers(0, 256, n // 6, dtype=np.uint8).tobytes()
    runs = b"\x00" * (n // 10) + bytes(range(256)) * 4
    third = n // 3
    return (text[:third] + noise + runs + text[third:])[:n]


DATA = _multimaster()


@pytest.fixture(autouse=True)
def defaults(monkeypatch):
    """Both packages at their defaults, the reference on one device."""
    for var in ("ZT_SEED", "ZT_DEVICE_SPLIT", "ZT_MEGA", "ZT_MASTER_SIZE"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(importlib.import_module("zopfli_tpu.deflate"),
                        "_LOCAL_MESH", [None])


@pytest.fixture()
def no_greedy(monkeypatch):
    """Fail the test if anything calls the port's native greedy parse."""
    def boom(*a, **k):
        raise AssertionError("native.greedy called on the device path")
    monkeypatch.setattr(native, "greedy", boom)


@pytest.fixture(scope="module")
def reference():
    """Raw DEFLATE payload of DATA from the JAX package, 16 KiB masters."""
    with pytest.MonkeyPatch.context() as mp:
        for var in ("ZT_SEED", "ZT_DEVICE_SPLIT", "ZT_MEGA"):
            mp.delenv(var, raising=False)
        mp.setenv("ZT_MASTER_SIZE", str(MASTER))
        mp.setattr(importlib.import_module("zopfli_tpu.deflate"),
                   "_LOCAL_MESH", [None])
        return zopfli_tpu.compress(DATA, "deflate", zopfli_tpu.Options(
            engine="tpu", numiterations=ITERATIONS))


@pytest.mark.parametrize("fmt", FORMATS)
def test_multimaster_bytes_identical_to_reference(reference, fmt,
                                                  monkeypatch, no_greedy):
    monkeypatch.setenv("ZT_MASTER_SIZE", str(MASTER))
    assert len(DATA) > MASTER
    got = zt.compress(DATA, fmt, zt.Options(device="cpu",
                                            numiterations=ITERATIONS))
    arr = np.frombuffer(DATA, np.uint8)
    want = {"gzip": lambda p: ref_containers.gzip_frame(
                p, ref_containers.crc32(arr), len(DATA)),
            "zlib": lambda p: ref_containers.zlib_frame(
                p, ref_containers.adler32(arr)),
            "deflate": lambda p: p}[fmt](reference)
    assert got == want
    assert zlib.decompress(got, {"gzip": 31, "zlib": 15,
                                 "deflate": -15}[fmt]) == DATA


def _blobs():
    # tests/test_batched.py's compress_many blobs: identical adjacent
    # blobs (a window leak across them WOULD be exploited), an empty
    # one, tiny ones, text.
    rng = np.random.default_rng(3)
    base = bytes(rng.integers(97, 123, 6000, dtype=np.uint8))
    text = b"The quick brown fox jumps over the lazy dog. " * 200
    return [base, base, b"", base[:100], b"x", text]


def test_compress_many_identical_to_reference(no_greedy):
    blobs = _blobs()
    ours = zt.compress_many(blobs, "zlib", zt.Options(
        device="cpu", numiterations=ITERATIONS))
    ref = zopfli_tpu.compress_many(blobs, "zlib", zopfli_tpu.Options(
        engine="tpu", numiterations=ITERATIONS))
    assert ours == ref
    for i, (b, o) in enumerate(zip(blobs, ours)):
        assert zlib.decompress(o) == b, f"blob {i}"


def test_compress_many_native_engine_is_sequential():
    blobs = [b"native " * 50, b"", b"engine"]
    outs = zt.compress_many(blobs, "gzip", zt.Options(engine="native",
                                                      numiterations=2))
    assert outs == [zt.compress(b, "gzip", zt.Options(
        engine="native", numiterations=2)) for b in blobs]
    with pytest.raises(ValueError):
        zt.compress_many(blobs, "bz2", zt.Options(device="cpu"))
