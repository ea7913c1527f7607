"""The port's candidate build against the JAX package's, bit-equal, at
the default knobs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zopfli_tpu.ops import hashmatch as jhm
from zopfli_tpu_torch.ops import hashmatch as hm

# The tensors here are tiny: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

CAP = 16384


def _text(seed, n):
    words = [b"alpha ", b"beta ", b"gamma ", b"delta ", b"epsilon ",
             b"zeta\n", b"<tag>", b"</tag>"]
    rng = np.random.default_rng(seed)
    return b"".join(words[i] for i in rng.integers(0, len(words),
                                                   n // 4))[:n]


CASES = {
    "text": (_text(1, 12000), 0),
    "runs": (b"\x00" * 2000 + b"a" * 1500 + bytes(range(256)) * 4, 0),
    "random": (np.random.default_rng(2).integers(
        0, 256, 5000, dtype=np.uint8).tobytes(), 0),
    "window_prefix": (_text(3, 9000) + _text(4, 6000), 9000),
}


def _padded(data: bytes, prefix_len: int) -> np.ndarray:
    L = len(data) - prefix_len
    buf = np.zeros(hm.PREFIX + CAP + 264, np.uint8)
    buf[:hm.PREFIX] = hm._filler(hm.PREFIX)
    buf[hm.PREFIX - prefix_len:hm.PREFIX + L] = np.frombuffer(data, np.uint8)
    return buf


def test_knobs_match_reference():
    assert hm.current_knobs() == jhm.current_knobs()
    assert (hm.MAX_BP, hm.PREFIX, hm.LEVELS) == \
        (jhm.MAX_BP, jhm.PREFIX, jhm.LEVELS)


@pytest.mark.parametrize("name", sorted(CASES))
def test_build_candidates_bit_equal(name):
    data, prefix_len = CASES[name]
    buf = _padded(data, prefix_len)
    prefix_len = min(prefix_len, hm.PREFIX)
    L = len(data) - prefix_len
    got = hm.build_candidates(torch.from_numpy(buf), CAP,
                              hm.PREFIX - prefix_len, hm.PREFIX + L,
                              max_bp=hm.MAX_BP, **hm.current_knobs())
    want = jhm.build_candidates(jnp.asarray(buf), CAP,
                                jnp.int32(hm.PREFIX - prefix_len),
                                jnp.int32(hm.PREFIX + L),
                                max_bp=jhm.MAX_BP, **jhm.current_knobs())
    for ours, ref, what in zip(got, want, ("bp_len", "bp_dist",
                                           "best_len")):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref),
                                      err_msg=what)
    assert int(got[2].max()) >= 3 or name == "random"
