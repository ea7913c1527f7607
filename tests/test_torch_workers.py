"""Masters on host threads (Options.workers) in the port's deflate.deflate,
against the JAX package's, all exact.

zopfli_tpu_torch.deflate.deflate at forced btype 0 and 1 and workers 1,
2 and 0 (the device engine on the CPU, DeviceBlockEngine for btype 1)
must give the bytes of zopfli_tpu.deflate.deflate at the same workers
(engine="tpu", TpuBlockEngine; under the conftest's 8 virtual CPU
devices the JAX side takes its round-robin of masters over devices).
The port's counterparts of tests/test_parallel.py's threaded cases and
of tests/test_deflate_modes.py's forced blocks are held byte-equal to
the JAX package.  Then the round-robin itself: with local_devices
patched to n devices, master i's engine is made while devices[i % n]
is its thread's current CUDA device (torch.cuda.device, recorded here
since this machine has no card).  Last, the counters' helper counts
exactly under 8 threads.

Masters are cut to 16 KiB (ZT_MASTER_SIZE, the device engines') and
to 50,000 bytes (spec.MASTER_BLOCK_SIZE, the native engines'), so that
a few masters cost seconds."""

import functools
import importlib
import sys
import threading
import time
import zlib

import numpy as np
import pytest
import torch

import zopfli_tpu
import zopfli_tpu_torch as zt
from zopfli_tpu import spec as ref_spec
from zopfli_tpu.emit import BitStream as RefBitStream
from zopfli_tpu.ops.engine import TpuBlockEngine
from zopfli_tpu_torch import native, spec
from zopfli_tpu_torch.emit import BitStream
from zopfli_tpu_torch.ops import engine
from zopfli_tpu_torch.utils.counters import bump

# The tensors here are tiny: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

ref_deflate = importlib.import_module("zopfli_tpu.deflate")
tdeflate = importlib.import_module("zopfli_tpu_torch.deflate")

CPU_ENGINE = functools.partial(engine.DeviceBlockEngine, device="cpu")
DEVICE_MASTER = 16384
NATIVE_MASTER = 50_000


def _words(seed: int, n: int) -> bytes:
    rng = np.random.default_rng(seed)
    words = [b"alpha ", b"beta ", b"gamma ", b"delta ", b"epsilon "]
    return b"".join(words[i] for i in rng.integers(0, 5, n // 5))[:n]


@pytest.fixture
def device_masters(monkeypatch):
    monkeypatch.setenv("ZT_MASTER_SIZE", str(DEVICE_MASTER))


@pytest.fixture
def native_masters(monkeypatch):
    monkeypatch.setattr(spec, "MASTER_BLOCK_SIZE", NATIVE_MASTER)
    monkeypatch.setattr(ref_spec, "MASTER_BLOCK_SIZE", NATIVE_MASTER)


def _port(options, btype, data, engine_factory=None) -> bytes:
    out = BitStream()
    tdeflate.deflate(options, btype, True, np.frombuffer(data, np.uint8),
                     out, engine_factory=engine_factory)
    return out.getvalue()


def _ref(options, btype, data, engine_factory=None) -> bytes:
    out = RefBitStream()
    ref_deflate.deflate(options, btype, True, np.frombuffer(data, np.uint8),
                        out, engine_factory=engine_factory)
    return out.getvalue()


# --- (a) forced btype 0 and 1 on the device engines, threaded ---------------

# Two full masters and a short third: three threads' worth of work, every
# master in the 16 KiB bucket of both block engines.
THREE_MASTERS = _words(7, 2 * DEVICE_MASTER + 5000)


@pytest.mark.parametrize("workers", [1, 2, 0])
@pytest.mark.parametrize("btype", [0, 1])
def test_forced_btype_workers_equal_jax(btype, workers, device_masters):
    data = THREE_MASTERS
    before = engine.FALLBACKS[0]
    ours = _port(zt.Options(engine="device", device="cpu", numiterations=3,
                            workers=workers), btype, data,
                 CPU_ENGINE if btype == 1 else None)
    want = _ref(zopfli_tpu.Options(engine="tpu", numiterations=3,
                                   workers=workers), btype, data,
                TpuBlockEngine if btype == 1 else None)
    assert ours == want
    assert zlib.decompress(ours, -15) == data
    assert engine.FALLBACKS[0] == before


def test_device_btype2_masters_take_fused_loop(device_masters, monkeypatch):
    """btype 2 on the device engine over several masters goes to the
    fused loop (deflate_device) whatever workers says; the threads are
    not reached."""
    calls = []
    monkeypatch.setattr(tdeflate, "deflate_device",
                        lambda options, data, masters, *a, **k: calls.append(
                            (options.workers, masters)))
    _port(zt.Options(engine="device", device="cpu", workers=4), 2,
          THREE_MASTERS)
    assert [(w, len(m)) for w, m in calls] == [(4, 3)]


# --- (b) tests/test_parallel.py and tests/test_deflate_modes.py -----------


def test_parallel_masters_match_serial(native_masters):
    data = _words(11, 4 * NATIVE_MASTER + 12_345)
    opts = dict(engine="native", numiterations=2)
    serial = zt.compress(data, "gzip", zt.Options(**opts))
    par = zt.compress(data, "gzip", zt.Options(workers=0, **opts))
    assert zlib.decompress(par, 16 + 15) == data
    assert par == serial  # same per-master streams, same splice order
    assert par == zopfli_tpu.compress(data, "gzip", zopfli_tpu.Options(
        workers=0, **opts))


def test_parallel_stored_blocks_splice(native_masters):
    # Random data -> stored blocks; alignment must re-resolve at splice.
    data = np.random.default_rng(12).integers(
        0, 256, 4 * NATIVE_MASTER + 3, dtype=np.uint8).tobytes()
    opts = dict(engine="native", numiterations=1, workers=0)
    out = zt.compress(data, "gzip", zt.Options(**opts))
    assert zlib.decompress(out, 16 + 15) == data
    assert out == zopfli_tpu.compress(data, "gzip",
                                      zopfli_tpu.Options(**opts))


# The port's engine names beside the JAX package's, with the device
# engine on the CPU.
ENGINES = [({"engine": "native"}, {"engine": "native"}),
           ({"engine": "device", "device": "cpu"}, {"engine": "tpu"})]


@pytest.mark.parametrize("ours,theirs", ENGINES, ids=["native", "device"])
@pytest.mark.parametrize("btype,data", [
    (0, b"stored block path " * 100),
    (1, b"fixed tree path " * 200),
    (0, np.random.default_rng(0).integers(0, 256, 70_000,
                                          dtype=np.uint8).tobytes()),
], ids=["stored", "fixed", "stored_over_65535"])
def test_forced_blocks_equal_jax(btype, data, ours, theirs):
    payload = _port(zt.Options(numiterations=3, **ours), btype, data)
    assert payload == _ref(zopfli_tpu.Options(numiterations=3, **theirs),
                           btype, data)
    assert zlib.decompress(payload, -15) == data
    if btype == 0:
        # Stored encoding: 5-byte headers + raw bytes.
        assert len(payload) >= len(data)
    else:
        assert len(payload) < len(data)


# --- (c) the round-robin of masters over local devices --------------------


class _RecordedDevice:
    """Stands in for torch.cuda.device: the thread's current device for
    the block of a with, kept per thread as CUDA keeps it."""

    current = threading.local()
    entered = []

    def __init__(self, dev):
        self.dev = dev

    def __enter__(self):
        self.prev = getattr(self.current, "dev", None)
        self.current.dev = self.dev
        self.entered.append(self.dev)

    def __exit__(self, *exc):
        self.current.dev = self.prev


@pytest.mark.parametrize("n", [None, 2])
def test_masters_round_robin_over_devices(n, monkeypatch):
    monkeypatch.setenv("ZT_MASTER_SIZE", "4096")
    devices = None if n is None else [torch.device("cuda", i)
                                      for i in range(n)]
    monkeypatch.setattr(tdeflate, "local_devices", lambda options: devices)
    monkeypatch.setattr(torch.cuda, "device", _RecordedDevice)
    _RecordedDevice.entered = []
    made, lock = {}, threading.Lock()

    def factory(data, instart, inend):
        with lock:
            made[instart] = getattr(_RecordedDevice.current, "dev", None)
        return native.BlockEngine(data, instart, inend)

    data = _words(13, 5 * 4096 - 100)   # 5 masters
    opts = zt.Options(engine="device", device="cpu", workers=3)
    out = _port(opts, 1, data, factory)
    starts = sorted(made)
    assert starts == [i * 4096 for i in range(5)]
    if n is not None:
        assert [made[s] for s in starts] == [devices[i % n]
                                             for i in range(5)]
        assert sorted(_RecordedDevice.entered, key=str) == sorted(
            (devices[i % n] for i in range(5)), key=str)
    else:
        assert set(made.values()) == {None}
        assert _RecordedDevice.entered == []
    # The threads and their pins change no byte.
    assert out == _port(zt.Options(engine="device", device="cpu"), 1, data,
                        native.BlockEngine)
    assert zlib.decompress(out, -15) == data


@pytest.mark.parametrize("count", [1, 4])
def test_local_devices_gate(count, monkeypatch):
    """Masters are pinned only for the device engine on CUDA with more
    than one device; the native engine and the CPU pin nothing."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    assert tdeflate.local_devices(zt.Options(engine="native")) is None
    assert tdeflate.local_devices(zt.Options(device="cpu")) is None
    want = ([torch.device("cuda", i) for i in range(count)] if count > 1
            else None)
    assert tdeflate.local_devices(zt.Options()) == want


@pytest.mark.parametrize("device,index", [("cuda", 3), ("cuda:1", 1),
                                          (torch.device("cuda", 2), 2)])
def test_engine_resolves_cuda_to_current_device(device, index, monkeypatch):
    """A "cuda" engine is pinned to the current device of the thread that
    makes it; an explicit index is kept."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    eng = engine.DeviceBlockEngine(np.zeros(10, np.uint8), 0, 10,
                                   device=device)
    assert eng.device == torch.device("cuda", index)
    assert CPU_ENGINE(np.zeros(10, np.uint8), 0, 10).device == \
        torch.device("cpu")


# --- (d) counters under threads --------------------------------------------


class _Yielding(dict):
    """A counter whose read gives up the interpreter lock, so that
    another thread runs between a bump's read and its write."""

    def __getitem__(self, key):
        value = super().__getitem__(key)
        time.sleep(0)
        return value


def test_counters_exact_under_threads():
    threads, per = 8, 10_000
    counts = {"scan": 0, "rounds": 0}
    single = [0]
    yielding = _Yielding({0: 0})
    start = threading.Barrier(threads)

    def worker():
        start.wait()
        for i in range(per):
            bump(counts, "scan")
            bump(counts, "rounds", 2)
            bump(single)
            if i % 10 == 0:
                bump(yielding)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=worker) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    assert counts == {"scan": threads * per, "rounds": 2 * threads * per}
    assert single == [threads * per]
    assert yielding == {0: threads * per // 10}
