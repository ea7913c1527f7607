"""The port's default path against the JAX package's, end to end, on the
empty input, one text master, a multi-block master and 16 KiB masters.

Reference: zopfli_tpu.compress(..., Options(engine="tpu")) at its
defaults (ZT_SEED unset: the device seed program, the device splits) on
one device (_LOCAL_MESH pinned to [None]: the conftest's 8 virtual
devices would otherwise round the group count up to 8 and change the
replica fill).  The port: zopfli_tpu_torch.compress at its defaults on
the CPU, through deflate.deflate_device.  gzip, zlib and raw
deflate bytes must be identical.  tests/test_torch_devseed.py and
tests/test_torch_devseed_many.py hold the same path on other inputs."""

import importlib
import zlib

import numpy as np
import pytest
import torch

import zopfli_tpu
import zopfli_tpu_torch as zt
from zopfli_tpu import containers as ref_containers
from zopfli_tpu_torch import native
from zopfli_tpu_torch.deflate import Options, split_master

# The tensors here are tiny: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

ITERATIONS = 3
MASTER = 16384


def _mixed(seed: int, n: int) -> bytes:
    rng = np.random.default_rng(seed)
    words = [b"compress ", b"every ", b"block ", b"of ", b"the ",
             b"input\n", b"{\"key\": ", b"42}, "]
    text = b"".join(words[i] for i in rng.integers(0, len(words), n // 5))
    noise = rng.integers(0, 256, n // 6, dtype=np.uint8).tobytes()
    runs = b"\x00" * (n // 10) + bytes(range(256)) * 4
    third = n // 3
    return (text[:third] + noise + runs + text[third:])[:n]


# name -> (data, master size or None for the default)
CASES = {
    "empty": (b"", None),
    "text": ((b"The quick brown fox jumps over the lazy dog. " * 200), None),
    "multiblock": (_mixed(5, 20000), None),
    "multimaster": (_mixed(6, 30000), MASTER),
}
FORMATS = ("gzip", "zlib", "deflate")


@pytest.fixture(autouse=True)
def defaults(monkeypatch):
    """Both packages at their defaults."""
    monkeypatch.delenv("ZT_SEED", raising=False)
    monkeypatch.delenv("ZT_DEVICE_SPLIT", raising=False)
    monkeypatch.delenv("ZT_MEGA", raising=False)


@pytest.fixture(scope="module")
def reference():
    """Raw DEFLATE payload of every case from the JAX package, on one
    device."""
    ref_deflate = importlib.import_module("zopfli_tpu.deflate")
    payloads = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("ZT_SEED", raising=False)
        mp.delenv("ZT_DEVICE_SPLIT", raising=False)
        mp.delenv("ZT_MEGA", raising=False)
        mp.setattr(ref_deflate, "_LOCAL_MESH", [None])
        for name, (data, master) in CASES.items():
            if master:
                mp.setenv("ZT_MASTER_SIZE", str(master))
            else:
                mp.delenv("ZT_MASTER_SIZE", raising=False)
            payloads[name] = zopfli_tpu.compress(
                data, "deflate", zopfli_tpu.Options(
                    engine="tpu", numiterations=ITERATIONS))
    return payloads


def _expected(name: str, fmt: str, payload: bytes) -> bytes:
    data = CASES[name][0]
    arr = np.frombuffer(data, np.uint8)
    if fmt == "gzip":
        return ref_containers.gzip_frame(
            payload, ref_containers.crc32(arr), len(data))
    if fmt == "zlib":
        return ref_containers.zlib_frame(payload,
                                         ref_containers.adler32(arr))
    return payload


_OURS: dict = {}


def _ours(name: str, fmt: str, monkeypatch) -> bytes:
    if (name, fmt) not in _OURS:
        data, master = CASES[name]
        if master:
            monkeypatch.setenv("ZT_MASTER_SIZE", str(master))
        else:
            monkeypatch.delenv("ZT_MASTER_SIZE", raising=False)
        _OURS[name, fmt] = zt.compress(
            data, fmt, Options(device="cpu", numiterations=ITERATIONS))
    return _OURS[name, fmt]


def test_cases_cover_blocks_and_masters():
    data = np.frombuffer(CASES["multiblock"][0], np.uint8)
    assert len(split_master(Options(engine="native"), data, 0, len(data),
                            native.greedy)) > 2
    assert len(CASES["multimaster"][0]) > MASTER


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_bytes_identical_to_reference(reference, name, fmt, monkeypatch):
    got = _ours(name, fmt, monkeypatch)
    assert got == _expected(name, fmt, reference[name])


@pytest.mark.parametrize("name", sorted(CASES))
def test_zlib_round_trip(name, monkeypatch):
    out = _ours(name, "zlib", monkeypatch)
    assert zlib.decompress(out) == CASES[name][0]
