"""The port's multi-process layer (zopfli_tpu_torch.parallel.multihost)
against the JAX package's (zopfli_tpu.parallel.multihost), all exact.

Single process: compress_multihost equals the JAX compress_multihost
run in this one CPU process and the port's own compress (the native
engine over several masters, as tests/test_parallel.py runs the JAX
package's; the device engine on the CPU at one master against the JAX
engine="tpu" on one device).  Then real process groups: 2 and 4 OS
processes join a gloo group over localhost TCP, call
zopfli_tpu_torch.compress (which routes to compress_multihost), and rank
0's bytes must equal the JAX compress_multihost's and the port's serial
bytes (4 processes: 5 masters, one rank gets two and one idles on the
ragged gather), as tests/test_multihost_procs.py checks the JAX
package's.  Ranks that pass different data all raise ValueError.
compress_many inside a 2-process group follows compress blob by blob
(the reference's gate, zopfli_tpu/__init__.py): rank 0 gets both
packages' compress_multihost bytes, the empty blob included, and rank 1
gets None for every blob.

The master size is cut from 1,000,000 to 250,000 bytes in both packages
(4,000 in the compress_many case, whose reference runs the device
engine), so that a few masters cost seconds, not minutes."""

import importlib
import os
import pickle
import socket
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

import zopfli_tpu
import zopfli_tpu_torch as zt
from zopfli_tpu import spec as ref_spec
from zopfli_tpu.parallel import multihost as ref_multihost
from zopfli_tpu_torch import spec
from zopfli_tpu_torch.parallel import multihost
from zopfli_tpu_torch.parallel.multihost import compress_multihost

# The tensors here are tiny: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = zt.Options(engine="native", numiterations=2)
MASTER = 250_000


REF_NATIVE = zopfli_tpu.Options(engine="native", numiterations=2)


@pytest.fixture
def small_masters(monkeypatch):
    monkeypatch.setattr(spec, "MASTER_BLOCK_SIZE", MASTER)
    monkeypatch.setattr(ref_spec, "MASTER_BLOCK_SIZE", MASTER)


def _big(seed: int, n: int) -> bytes:
    rng = np.random.default_rng(seed)
    words = [b"alpha ", b"beta ", b"gamma ", b"delta ", b"eps "]
    return b"".join(words[i] for i in rng.integers(0, 5, n // 4))[:n]


@pytest.mark.parametrize("fmt,wbits", [("gzip", 31), ("zlib", 15),
                                       ("deflate", -15)])
def test_single_process_equals_compress(fmt, wbits, small_masters):
    data = _big(3, 3 * MASTER + 12_345)
    assert not multihost.active()
    out = compress_multihost(data, fmt, NATIVE)
    assert out == ref_multihost.compress_multihost(data, fmt, REF_NATIVE)
    assert out == zt.compress(data, fmt, NATIVE)
    assert zlib.decompress(out, wbits) == data


def test_single_process_device_engine_and_empty(monkeypatch):
    # The reference on one device: the conftest's 8 virtual devices
    # would round its group count up to 8 and change the replica fill.
    monkeypatch.setattr(importlib.import_module("zopfli_tpu.deflate"),
                        "_LOCAL_MESH", [None])
    data = _big(4, 30_000)
    opts = zt.Options(device="cpu", numiterations=2)
    out = compress_multihost(data, "zlib", opts)
    assert out == ref_multihost.compress_multihost(
        data, "zlib", zopfli_tpu.Options(engine="tpu", numiterations=2))
    assert out == zt.compress(data, "zlib", opts)
    assert zlib.decompress(out) == data
    empty = compress_multihost(b"", "gzip", zt.Options(device="cpu"))
    assert zlib.decompress(empty, 31) == b"" and len(empty) == 20
    with pytest.raises(ValueError):
        compress_multihost(data, "bz2", NATIVE)


_WORKER = r"""
import os, sys
sys.path.insert(0, {repo!r})
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank = int(sys.argv[1])
dist.init_process_group("gloo", init_method={addr!r}, world_size={n},
                        rank=rank)
try:
    import numpy as np
    import zopfli_tpu_torch as zt
    from zopfli_tpu_torch import spec
    spec.MASTER_BLOCK_SIZE = {master}
    rng = np.random.default_rng(77)
    words = [b"alpha ", b"beta ", b"gamma ", b"delta ", b"eps "]
    data = b"".join(words[i] for i in rng.integers(0, 5, {nbytes} // 4))
    data = data[:{nbytes}]
    # compress routes to compress_multihost inside the group.
    out = zt.compress(data, "gzip",
                      zt.Options(engine="native", numiterations=2))
    if rank == 0:
        with open({outpath!r}, "wb") as f:
            f.write(out)
    else:
        assert out is None
finally:
    dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(script: str, n: int) -> list[int]:
    """Run `script` as ranks 0..n-1 of one group; their exit codes."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", script, str(i)],
                              env=env, cwd=REPO) for i in range(n)]
    try:
        return [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _run_group(tmp_path, n: int, nbytes: int) -> None:
    outpath = str(tmp_path / f"mh{n}.gz")
    script = _WORKER.format(repo=REPO, addr=f"tcp://127.0.0.1:{_free_port()}",
                            n=n, nbytes=nbytes, outpath=outpath,
                            master=MASTER)
    assert _spawn(script, n) == [0] * n
    out = open(outpath, "rb").read()

    rng = np.random.default_rng(77)
    words = [b"alpha ", b"beta ", b"gamma ", b"delta ", b"eps "]
    data = b"".join(words[i] for i in rng.integers(0, 5, nbytes // 4))
    data = data[:nbytes]
    assert zlib.decompress(out, 31) == data
    assert out == ref_multihost.compress_multihost(data, "gzip", REF_NATIVE)
    assert out == zt.compress(data, "gzip", NATIVE)


_MISMATCH_WORKER = r"""
import sys
sys.path.insert(0, {repo!r})
import torch.distributed as dist
rank = int(sys.argv[1])
dist.init_process_group("gloo", init_method={addr!r}, world_size=2,
                        rank=rank)
try:
    import zopfli_tpu_torch as zt
    # Same length, one byte apart: only the CRC-32 tells them apart.
    data = bytearray(b"the same length on every rank " * 40)
    data[100] = 65 + rank
    try:
        zt.compress(bytes(data), "gzip",
                    zt.Options(engine="native", numiterations=2))
    except ValueError as e:
        assert "different data" in str(e), e
    else:
        raise SystemExit(3)
finally:
    dist.destroy_process_group()
"""


def test_two_processes_different_data_raise():
    script = _MISMATCH_WORKER.format(
        repo=REPO, addr=f"tcp://127.0.0.1:{_free_port()}")
    assert _spawn(script, 2) == [0, 0]


def test_two_processes(tmp_path, small_masters):
    _run_group(tmp_path, 2, 2 * MASTER + 25_000)


def test_four_processes_ragged(tmp_path, small_masters):
    # 5 masters over 4 processes: rank 0 gets two, the ragged in-order
    # splice must still give the serial bytes.
    _run_group(tmp_path, 4, 4 * MASTER + 50_000)


# The JAX reference in interpret mode takes ~10 s a master at the
# conftest geometry whatever its size: keep the masters few.  The first
# blob's three masters give both ranks work.
MANY_MASTER = 4_000

_MANY_WORKER = r"""
import pickle, sys
sys.path.insert(0, {repo!r})
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank = int(sys.argv[1])
dist.init_process_group("gloo", init_method={addr!r}, world_size=2,
                        rank=rank)
try:
    import zopfli_tpu_torch as zt
    from zopfli_tpu_torch import spec
    spec.MASTER_BLOCK_SIZE = {master}
    blobs = pickle.load(open({inpath!r}, "rb"))
    outs = zt.compress_many(blobs, "gzip",
                            zt.Options(device="cpu", numiterations=2))
    with open({outpath!r} + str(rank), "wb") as f:
        pickle.dump(outs, f)
finally:
    dist.destroy_process_group()
"""


def test_two_processes_compress_many_device_engine(tmp_path, monkeypatch):
    monkeypatch.setattr(spec, "MASTER_BLOCK_SIZE", MANY_MASTER)
    monkeypatch.setattr(ref_spec, "MASTER_BLOCK_SIZE", MANY_MASTER)
    # The reference on one device, as in the single-process case above.
    monkeypatch.setattr(importlib.import_module("zopfli_tpu.deflate"),
                        "_LOCAL_MESH", [None])
    blobs = [_big(5, 2 * MANY_MASTER + 1_000), _big(6, 1_500), b""]
    inpath = str(tmp_path / "many.in")
    outpath = str(tmp_path / "many.out")
    with open(inpath, "wb") as f:
        pickle.dump(blobs, f)
    script = _MANY_WORKER.format(
        repo=REPO, addr=f"tcp://127.0.0.1:{_free_port()}",
        master=MANY_MASTER, inpath=inpath, outpath=outpath)
    assert _spawn(script, 2) == [0, 0]
    rank0 = pickle.load(open(outpath + "0", "rb"))
    rank1 = pickle.load(open(outpath + "1", "rb"))

    assert rank1 == [None, None, None]
    assert len(rank0) == len(blobs)
    opts = zt.Options(device="cpu", numiterations=2)
    ref_opts = zopfli_tpu.Options(engine="tpu", numiterations=2)
    for blob, out in zip(blobs, rank0):
        assert zlib.decompress(out, 31) == blob
        assert out == compress_multihost(blob, "gzip", opts)
        assert out == ref_multihost.compress_multihost(blob, "gzip",
                                                       ref_opts)
