"""The port's default (device-seeded) path against the JAX package's.

Reference: zopfli_tpu.compress(..., Options(engine="tpu")) at its
defaults (ZT_SEED unset: the device seed program, the device splits) on
one device (_LOCAL_MESH pinned to [None]: the conftest's 8 virtual
devices would otherwise round the group count up to 8 and change the
replica fill).  The port: zopfli_tpu_torch.compress at its defaults on
the CPU.  gzip, zlib and raw deflate bytes must be identical and no host
greedy parse may run.  Inputs of several masters and compress_many are
in tests/test_torch_devseed_many.py."""

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


def _mixed(seed: int, n: int) -> bytes:
    rng = np.random.default_rng(seed)
    words = [b"compress ", b"every ", b"block ", b"of ", b"the ",
             b"input\n", b"{\"key\": ", b"42}, "]
    text = b"".join(words[i] for i in rng.integers(0, len(words), n // 5))
    noise = rng.integers(0, 256, n // 6, dtype=np.uint8).tobytes()
    runs = b"\x00" * (n // 10) + bytes(range(256)) * 4
    third = n // 3
    return (text[:third] + noise + runs + text[third:])[:n]


CASES = {
    "text": b"The quick brown fox jumps over the lazy dog. " * 200,
    "multiblock": _mixed(5, 12000),
    "random": np.random.default_rng(11).integers(
        0, 256, 14000, dtype=np.uint8).tobytes(),
}
FORMATS = ("gzip", "zlib", "deflate")


@pytest.fixture(autouse=True)
def defaults(monkeypatch):
    """Both packages at their defaults, the reference on one device."""
    monkeypatch.delenv("ZT_SEED", raising=False)
    monkeypatch.delenv("ZT_DEVICE_SPLIT", raising=False)
    monkeypatch.delenv("ZT_MEGA", raising=False)
    monkeypatch.delenv("ZT_MASTER_SIZE", raising=False)
    monkeypatch.setattr(importlib.import_module("zopfli_tpu.deflate"),
                        "_LOCAL_MESH", [None])


@pytest.fixture()
def no_greedy(monkeypatch):
    """Fail the test if anything calls the port's native greedy parse."""
    def boom(*a, **k):
        raise AssertionError("native.greedy called on the device path")
    monkeypatch.setattr(native, "greedy", boom)


_REF: dict = {}
_OURS: dict = {}


def _reference(name: str) -> bytes:
    """Raw DEFLATE payload of a case from the JAX package."""
    if name not in _REF:
        _REF[name] = zopfli_tpu.compress(
            CASES[name], "deflate",
            zopfli_tpu.Options(engine="tpu", numiterations=ITERATIONS))
    return _REF[name]


def _expected(name: str, fmt: str, payload: bytes) -> bytes:
    data = CASES[name]
    arr = np.frombuffer(data, np.uint8)
    if fmt == "gzip":
        return ref_containers.gzip_frame(
            payload, ref_containers.crc32(arr), len(data))
    if fmt == "zlib":
        return ref_containers.zlib_frame(payload,
                                         ref_containers.adler32(arr))
    return payload


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("name", list(CASES))
def test_default_bytes_identical_to_reference(name, fmt, no_greedy):
    got = zt.compress(CASES[name], fmt,
                      zt.Options(device="cpu", numiterations=ITERATIONS))
    _OURS[name, fmt] = got
    assert got == _expected(name, fmt, _reference(name))


@pytest.mark.parametrize("knob,value", [("ZT_SEED", "greedy"),
                                        ("ZT_DEVICE_SPLIT", "0")])
def test_seed_settings_leave_the_default_path(knob, value, no_greedy,
                                              monkeypatch):
    """ZT_SEED and ZT_DEVICE_SPLIT, which the JAX package reads, change
    nothing in the port: deflate.deflate_device is its one device route,
    and it runs no host greedy parse."""
    want = _expected("multiblock", "gzip", _reference("multiblock"))
    monkeypatch.setenv(knob, value)
    assert zt.compress(CASES["multiblock"], "gzip", zt.Options(
        device="cpu", numiterations=ITERATIONS)) == want


def test_cases_reach_blocks_and_stored_exit():
    from zopfli_tpu_torch.ops import seed

    data = np.frombuffer(CASES["multiblock"], np.uint8)
    sr = seed.seed_master(data, 0, len(data), 15, device="cpu")
    assert len(sr.bounds) > 2 and not sr.all_stored
    rand = np.frombuffer(CASES["random"], np.uint8)
    assert seed.seed_master(rand, 0, len(rand), 15, cheap=True,
                            device="cpu").all_stored


def test_default_output_round_trips():
    for name, data in CASES.items():
        out = _OURS.get((name, "gzip"))
        if out is None:
            out = zt.compress(data, "gzip", zt.Options(
                device="cpu", numiterations=ITERATIONS))
        assert zlib.decompress(out, 31) == data, name
