"""The port's multi-device layer against the JAX package's 8-device
virtual CPU mesh.

pack_blocks, block_pipeline and sharded_pipeline over eight CPU entries
(zopfli_tpu_torch.parallel.dist) against zopfli_tpu.parallel.dist on
make_mesh(8), at cap 2048 as tests/test_dist.py runs them; then the fused
squeeze sharded over eight CPU entries against the JAX mesh run and
against the port unsharded.  Every comparison is exact: integers equal,
float32 bit-equal (the cost totals are sums of integer-valued costs)."""

import jax
import numpy as np
import pytest
import torch

from zopfli_tpu.parallel import dist as jdist
from zopfli_tpu_torch.ops import hashmatch
from zopfli_tpu_torch.parallel import dist

# The tensors here are tiny: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

CAP = 2048
CPU8 = [torch.device("cpu")] * 8


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


@pytest.fixture(scope="module")
def blocks():
    rng = np.random.default_rng(2)
    words = [b"alpha ", b"beta ", b"gamma ", b"delta "]
    text = b"".join(words[i] for i in rng.integers(0, 4, 6000))
    data = np.frombuffer(text[: 8 * CAP - 700], dtype=np.uint8)
    # Eight rows: full blocks with their halo, one short, one empty.
    ranges = [(i * CAP, (i + 1) * CAP) for i in range(6)]
    ranges += [(6 * CAP, 7 * CAP - 700), (100, 100)]
    ll = np.full((8, 288), 8.0, dtype=np.float32)
    dd = np.full((8, 32), 5.0, dtype=np.float32)
    ll[3] = rng.integers(4, 14, 288)   # integer costs: exact totals
    dd[3] = rng.integers(3, 9, 32)
    return data, ranges, ll, dd


def test_pack_blocks_equals_jax(blocks):
    data, ranges, _, _ = blocks
    want = jdist.pack_blocks(data, ranges, CAP)
    got = dist.pack_blocks(data, ranges, CAP)
    for w, g in zip(want, got):
        assert w.dtype == g.dtype
        np.testing.assert_array_equal(g, w)
    assert dist.total_row_len(CAP) == jdist.total_row_len(CAP)
    np.testing.assert_array_equal(hashmatch._filler(5000),
                                  jdist.hashmatch_filler(5000))
    with pytest.raises(ValueError):
        dist.pack_blocks(data, [(0, CAP + 1)], CAP)


def test_block_and_sharded_pipeline_equal_jax_mesh(blocks):
    if len(jax.devices()) < 8:
        pytest.skip("the JAX reference needs its 8-device virtual mesh")
    data, ranges, ll, dd = blocks
    bufs, min_pos, inend = dist.pack_blocks(data, ranges, CAP)
    want = [np.asarray(x) for x in jdist.block_pipeline(
        bufs, CAP, min_pos, inend, ll, dd)]
    fn = jdist.sharded_pipeline(jdist.make_mesh(8), CAP)
    want_sh = [np.asarray(x) for x in fn(bufs, min_pos, inend, ll, dd)]

    got = [x.numpy() for x in dist.block_pipeline(
        bufs, CAP, min_pos, inend, ll, dd, device="cpu")]
    got_sh = [x.numpy() for x in dist.sharded_pipeline(CPU8, CAP)(
        bufs, min_pos, inend, ll, dd)]
    for w, g, gs in zip(want, got, got_sh):
        assert w.shape == g.shape == gs.shape
        np.testing.assert_array_equal(_bits(g) if g.dtype == np.float32
                                      else g, _bits(w) if w.dtype ==
                                      np.float32 else w)
        np.testing.assert_array_equal(gs, g)
    np.testing.assert_array_equal(_bits(got_sh[2]), _bits(want_sh[2]))
    assert got[2][7] == 0.0 and got[2][6] > 0
    assert _bits(got_sh[3]) == _bits(want_sh[3])
    assert float(got_sh[3]) == float(got[2].astype(np.float64).sum())


def test_make_devices_and_uneven_rows(blocks):
    assert dist.make_devices(3, device="cpu") == [torch.device("cpu")] * 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            dist.make_devices()
    data, ranges, ll, dd = blocks
    bufs, min_pos, inend = dist.pack_blocks(data, ranges[:3], CAP)
    with pytest.raises(ValueError, match="rows over"):
        dist.sharded_pipeline(CPU8[:2], CAP)(bufs, min_pos, inend, ll[:3],
                                             dd[:3])


def _fused_input():
    rng = np.random.default_rng(11)
    words = [b"alpha ", b"beta ", b"gamma ", b"delta ", b"epsilon "]
    data = b"".join(words[i] for i in rng.integers(0, len(words), 6000))
    return np.frombuffer(data, dtype=np.uint8)


def test_sharded_fused_loop_equals_jax_mesh_and_unsharded():
    """The fused squeeze with its lane groups over eight CPU entries ==
    the JAX package's 8-device mesh run (tests/test_dist.py:38-62) ==
    the port unsharded, parse for parse."""
    from zopfli_tpu.deflate import Options as JOptions
    from zopfli_tpu.deflate import default_greedy, split_master
    from zopfli_tpu.squeeze_batched import lz77_optimal_fused as jfused
    from zopfli_tpu_torch import native
    from zopfli_tpu_torch.ops import fused_engine
    from zopfli_tpu_torch.squeeze_batched import (fused_collect,
                                                  greedy_seed_stats)

    if len(jax.devices()) < 8:
        pytest.skip("the JAX reference needs its 8-device virtual mesh")
    arr = _fused_input()
    n = len(arr)
    jopts = JOptions(engine="tpu")
    bounds = split_master(jopts, arr, 0, n, default_greedy(jopts))
    spec_m = [(0, n, bounds)]
    want = jfused(arr, spec_m, 4, default_greedy(jopts),
                  mesh=jdist.make_mesh(8))[0]

    def fused(fs):
        seed_ll, seed_d = greedy_seed_stats(arr, fs.block_bounds,
                                            native.greedy)
        return fused_collect(fs, fs.dispatch(seed_ll, seed_d, 4), 4)[0]

    fs = fused_engine.FusedSqueeze(arr, spec_m, device="cpu", devices=CPU8)
    assert fs.ngroups % 8 == 0 and len(fs.shards) == 8
    assert all(sh.groups == fs.ngroups // 8 for sh in fs.shards)
    sharded = fused(fs)
    single = fused(fused_engine.FusedSqueeze(arr, spec_m, device="cpu"))
    assert len(want) == len(sharded) == len(single) == len(bounds) - 1
    for w, a, b in zip(want, sharded, single):
        np.testing.assert_array_equal(a.litlens, w.litlens)
        np.testing.assert_array_equal(a.dists, w.dists)
        np.testing.assert_array_equal(b.litlens, a.litlens)
        np.testing.assert_array_equal(b.dists, a.dists)


def test_sharded_geometry_rounds_groups_to_the_device_count():
    """Three shards: the pow2 group count rounds up to a multiple of 3,
    the free lanes (and so the replicas) follow the JAX package's sharded
    geometry, and the parses still reproduce their bytes."""
    from zopfli_tpu.ops import fused_engine as jfe
    from zopfli_tpu_torch import native
    from zopfli_tpu_torch.deflate import Options, split_master
    from zopfli_tpu_torch.ops import fused_engine
    from zopfli_tpu_torch.squeeze_batched import greedy_seed_stats

    arr = _fused_input()
    n = len(arr)
    bounds = split_master(Options(engine="native"), arr, 0, n,
                          native.greedy)
    fs = fused_engine.FusedSqueeze(arr, [(0, n, bounds)], device="cpu",
                                   devices=[torch.device("cpu")] * 3)
    plain = fused_engine.FusedSqueeze(arr, [(0, n, bounds)], device="cpu")
    want_g = plain.ngroups
    assert fs.ngroups == -(-want_g // 3) * 3 and fs.ngroups % 3 == 0
    jfs = jfe.FusedSqueeze(arr, [(0, n, bounds)],
                           mesh=jdist.make_mesh(3))
    assert (fs.ngroups, fs.nb_total, fs.nb_pad, fs.nt) == \
        (jfs.ngroups, jfs.nb_total, jfs.nb_pad, jfs.nt)
    np.testing.assert_array_equal(fs.tile_block, jfs.tile_block)
    seed_ll, seed_d = greedy_seed_stats(arr, fs.block_bounds, native.greedy)
    parses, cost, _, _ = fs.run(seed_ll, seed_d, 2)
    for b, (lit, dst) in enumerate(parses):
        assert fs.verify_parse(b, lit, dst)
