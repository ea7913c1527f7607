"""The port's fused squeeze engine against the JAX package's.

Both engines get the same candidate tables (the JAX package's
build_candidates, through cand=), the same block bounds and the same
greedy seed stats; the JAX engine runs on one device (mesh=None) with
its Pallas kernels in interpret mode.  Eight iterations reach the
randomization branch (i > 5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zopfli_tpu.ops import fused_engine as jfe
from zopfli_tpu.ops import hashmatch as jhm
from zopfli_tpu_torch import native
from zopfli_tpu_torch.deflate import Options, split_master
from zopfli_tpu_torch.ops import fused_engine as fe
from zopfli_tpu_torch.ops import hashmatch as hm
from zopfli_tpu_torch.squeeze_batched import greedy_seed_stats

# The tensors here are tiny: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

ITERATIONS = 8


def _input() -> np.ndarray:
    rng = np.random.default_rng(21)
    words = [b"the ", b"fused ", b"squeeze ", b"engine ", b"runs ",
             b"every ", b"iteration\n"]
    text = b"".join(words[i] for i in rng.integers(0, len(words), 2600))
    blob = text[:6000] + rng.integers(0, 256, 1500, dtype=np.uint8).tobytes() \
        + b"abc" * 400 + text[6000:10000]
    return np.frombuffer(blob, np.uint8)


def _jax_candidates(data: np.ndarray, cap: int):
    L = len(data)
    buf = np.zeros(jhm.PREFIX + cap + 264, np.uint8)
    buf[:jhm.PREFIX] = hm._filler(jhm.PREFIX)
    buf[jhm.PREFIX:jhm.PREFIX + L] = data
    bl, bd, _ = jhm.build_candidates(
        jnp.asarray(buf), cap, jnp.int32(jhm.PREFIX),
        jnp.int32(jhm.PREFIX + L), max_bp=jfe.KBP, **jhm.current_knobs())
    return bl, bd


@pytest.fixture(scope="module")
def runs():
    data = _input()
    n = len(data)
    bounds = split_master(Options(engine="native"), data, 0, n,
                          native.greedy)
    assert len(bounds) > 2, "want a multi-block master"
    masters = [(0, n, bounds)]
    cap = 16384
    bl, bd = _jax_candidates(data, cap)
    ours = fe.FusedSqueeze(data, masters, device="cpu",
                           cand=[(np.asarray(bl), np.asarray(bd))])
    ref = jfe.FusedSqueeze(data, masters, interpret=True, mesh=None,
                           cand=[(bl, bd)])
    seed_ll, seed_d = greedy_seed_stats(data, ours.block_bounds,
                                        native.greedy)
    assert (ours.ngroups, ours.nb_pad, ours.nt) == \
        (ref.ngroups, ref.nb_pad, ref.nt)
    return (ours, ours.run(seed_ll, seed_d, ITERATIONS),
            ref.run(seed_ll, seed_d, ITERATIONS))


def test_geometry_matches(runs):
    ours, _, _ = runs
    assert ours.nb_total > ours.nb, "free lanes should carry replicas"


def test_best_costs_equal(runs):
    _, (_, cost, _, _), (_, jcost, _, _) = runs
    np.testing.assert_array_equal(np.asarray(cost, np.int64),
                                  np.asarray(jcost, np.int64))


def test_best_stats_equal(runs):
    _, (_, _, sll, sd), (_, _, jsll, jsd) = runs
    np.testing.assert_array_equal(sll, np.asarray(jsll))
    np.testing.assert_array_equal(sd, np.asarray(jsd))


def test_parses_equal_and_verify(runs):
    ours, (parses, _, _, _), (jparses, _, _, _) = runs
    assert len(parses) == len(jparses) == ours.nb
    for b, ((lit, dst), (jlit, jdst)) in enumerate(zip(parses, jparses)):
        np.testing.assert_array_equal(lit, jlit)
        np.testing.assert_array_equal(dst, jdst)
        assert ours.verify_parse(b, lit, dst)
