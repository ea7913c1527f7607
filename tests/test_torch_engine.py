"""The port's oracle block engine (ops/engine.py) against the JAX
package's TpuBlockEngine.

DeviceBlockEngine on the CPU (the plain DP scan) and TpuBlockEngine get
the same block of the same input; their parses must be identical under
the fixed cost model and under a statistical one, on the cases of
tests/test_tpu_engine.py.  Then deflate() with each engine as the
engine_factory of Options(engine="native") must give the same bytes."""

import functools
import importlib
import zlib

import numpy as np
import pytest
import torch

import zopfli_tpu_torch as zt
from zopfli_tpu.ops.engine import TpuBlockEngine
from zopfli_tpu_torch.emit import BitStream
from zopfli_tpu_torch.lz77 import LZ77Store, verify_store
from zopfli_tpu_torch.ops import engine

# The tensors here are tiny: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

CPU_ENGINE = functools.partial(engine.DeviceBlockEngine, device="cpu")


@pytest.mark.parametrize("name", ["foobar", "text", "runs", "random_3000",
                                  "long_run", "tiny_repeat", "three"])
def test_squeeze_run_equals_jax_engine(corpus, name):
    data = corpus[name]
    arr = np.frombuffer(data, np.uint8)
    ours = CPU_ENGINE(arr, 0, len(arr))
    ref = TpuBlockEngine(arr, 0, len(arr))
    before = engine.FALLBACKS[0]
    for model in ("fixed", "stat"):
        if model == "fixed":
            args = (None, None)
        else:
            args = (np.full(288, 8.0), np.full(32, 5.0))
        lit, dist = ours.squeeze_run(*args)
        want_lit, want_dist = ref.squeeze_run(*args)
        np.testing.assert_array_equal(lit, want_lit)
        np.testing.assert_array_equal(dist, want_dist)
        assert lit.dtype == np.uint16 and dist.dtype == np.uint16
        store = LZ77Store(arr, lit, dist)
        verify_store(store)
        assert np.where(dist == 0, 1, lit).sum() == len(data)
    assert engine.FALLBACKS[0] == before
    ours.close()


def test_squeeze_run_with_window_prefix():
    """A block in the middle of its input reaches back into the preceding
    32 KiB window; an entropy model with unequal costs."""
    rng = np.random.default_rng(5)
    words = [b"alpha ", b"beta ", b"gamma ", b"delta ", b"epsilon "]
    data = b"".join(words[i] for i in rng.integers(0, 5, 3000))
    arr = np.frombuffer(data, np.uint8)
    s, e = 6000, 11000
    ll = rng.uniform(4, 14, 288)
    dd = rng.uniform(3, 10, 32)
    lit, dist = CPU_ENGINE(arr, s, e).squeeze_run(ll, dd)
    want = TpuBlockEngine(arr, s, e).squeeze_run(ll, dd)
    np.testing.assert_array_equal(lit, want[0])
    np.testing.assert_array_equal(dist, want[1])
    assert (dist > 0).any()


def test_deflate_with_engine_factory_equals_jax(corpus):
    """The engine drives squeeze.lz77_optimal through deflate(): bytes
    equal to the JAX package's deflate with TpuBlockEngine."""
    jdeflate = importlib.import_module("zopfli_tpu.deflate")
    tdeflate = importlib.import_module("zopfli_tpu_torch.deflate")
    from zopfli_tpu.emit import BitStream as JBitStream

    data = np.frombuffer(corpus["text"] + corpus["runs"], np.uint8)
    jout = JBitStream()
    jdeflate.deflate(jdeflate.Options(engine="native", numiterations=2), 2,
                     True, data, jout, engine_factory=TpuBlockEngine)
    tout = BitStream()
    before = engine.FALLBACKS[0]
    tdeflate.deflate(zt.Options(engine="native", numiterations=2), 2, True,
                     data, tout, engine_factory=CPU_ENGINE,
                     greedy_fn=engine.device_greedy)
    assert tout.getvalue() == jout.getvalue()
    assert zlib.decompress(tout.getvalue(), -15) == data.tobytes()
    assert engine.FALLBACKS[0] == before


def test_verify_rejects_a_bogus_match_and_falls_back():
    """A parse whose match does not reproduce its bytes fails the host
    verification; the run then takes the exact native engine's parse
    and counts one fallback."""
    from zopfli_tpu_torch import native

    data = np.frombuffer(b"abcdefgh" * 64 + b"zyxwvuts" * 64, np.uint8)
    eng = CPU_ENGINE(data, 0, len(data))
    good = eng.squeeze_run(None, None)
    assert eng._verify(*good)
    lit = np.full(3, 8, np.uint16)
    bogus_lit = np.concatenate([np.frombuffer(b"abcdefgh", np.uint8)
                                .astype(np.uint16), lit])
    bogus_dist = np.concatenate([np.zeros(8, np.uint16),
                                 np.array([3, 8, 8], np.uint16)])
    assert not eng._verify(bogus_lit, bogus_dist)

    traceback = engine.dp.traceback
    engine.dp.traceback = lambda *a: (bogus_lit, bogus_dist)
    before = engine.FALLBACKS[0]
    try:
        got = eng.squeeze_run(None, None)
    finally:
        engine.dp.traceback = traceback
    ref = native.BlockEngine(data, 0, len(data))
    want = ref.squeeze_run(None, None)
    ref.close()
    assert engine.FALLBACKS[0] == before + 1
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_empty_block_and_greedy():
    data = np.frombuffer(b"xyz" * 50, np.uint8)
    lit, dist = CPU_ENGINE(data, 10, 10).squeeze_run(None, None)
    assert len(lit) == len(dist) == 0
    from zopfli_tpu.ops.engine import tpu_greedy
    got = engine.device_greedy(data, 0, len(data))
    want = tpu_greedy(data, 0, len(data))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
