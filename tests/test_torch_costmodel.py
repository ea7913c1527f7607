"""The port's exact cost stack against the JAX package and the native
engine: entropies bit-equal, dynamic-block costs exact integers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zopfli_tpu.ops import costmodel as jcm
from zopfli_tpu_torch import native
from zopfli_tpu_torch.ops import costmodel as cm

# The tensors here are tiny: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)


def _hists(seed, B=12):
    rng = np.random.default_rng(seed)
    ll = rng.integers(0, 3000, (B, 288)) * (rng.random((B, 288)) < 0.5)
    d = rng.integers(0, 500, (B, 32)) * (rng.random((B, 32)) < 0.6)
    ll[:3] = rng.integers(0, 2, (3, 288))     # tiny / flat histograms
    ll[3] = 0                                 # empty block
    ll[4] = 0
    ll[4, 65] = 9                             # one literal
    ll[5] = rng.integers(0, 1 << 18, 288)     # large counts
    d[3] = 0
    d[6] = 0
    d[6, 5] = 3                               # one distance code
    ll[:, 286:] = 0
    d[:, 30:] = 0
    return ll.astype(np.int32), d.astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1])
def test_hist_dynamic_cost_matches_jax_and_native(seed):
    ll, d = _hists(seed)
    got = cm.hist_dynamic_cost(torch.from_numpy(ll),
                               torch.from_numpy(d)).numpy()
    want = np.asarray(jcm.hist_dynamic_cost(jnp.asarray(ll), jnp.asarray(d)))
    nat = np.array([native.hist_dynamic_cost(ll[b], d[b])
                    for b in range(len(ll))])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, nat.astype(np.int64))


def test_package_merge_and_rle_match_jax():
    ll, _ = _hists(2)
    for maxbits in (7, 15):
        np.testing.assert_array_equal(
            cm.package_merge(torch.from_numpy(ll), maxbits).numpy(),
            np.asarray(jcm.package_merge(jnp.asarray(ll), maxbits)))
    np.testing.assert_array_equal(
        cm.rle_optimize(torch.from_numpy(ll)).numpy(),
        np.asarray(jcm.rle_optimize(jnp.asarray(ll))))


@pytest.mark.parametrize("which", ["hists", "ramp", "large"])
def test_calculate_entropy_bit_equal(which):
    rng = np.random.default_rng(4)
    if which == "hists":
        counts = np.concatenate(_hists(3), axis=1)
    elif which == "ramp":
        counts = np.arange(1, 1 + 64 * 288, dtype=np.int32).reshape(64, 288)
    else:
        # Counts whose int32 -> f32 cast rounds: the exponent must come
        # from exact integer ops, not from the rounded float.
        counts = rng.integers((1 << 24) - 64, (1 << 24) + 64, (4, 32))
        counts[:, ::3] = rng.integers(0, 5, (4, 11))
        counts = counts.astype(np.int32)
    got = cm.calculate_entropy(torch.from_numpy(counts)).numpy()
    want = np.asarray(jcm.calculate_entropy(jnp.asarray(counts)))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_log2_int_exponent_exact():
    c = np.array([[1, 2, 3, (1 << 24) - 1, (1 << 24) + 1, (1 << 31) - 1]],
                 np.int32)
    got = cm._log2_int(torch.from_numpy(c)).numpy()
    want = np.asarray(jcm._log2_int(jnp.asarray(c)))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(
        cm.floor_log2(torch.from_numpy(c.astype(np.int64))).numpy()[0],
        [0, 1, 1, 23, 24, 30])


def test_randomize_maps_equal():
    for ours, ref in zip(cm.randomize_maps(48), jcm.randomize_maps(48)):
        np.testing.assert_array_equal(ours, ref)
