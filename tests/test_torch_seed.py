"""The port's device seed program against the JAX package's.

seed_master on the same master of the same bytes, in both packages: the
JAX program with its Pallas kernels in interpret mode, the port on the
CPU (plain scan, traceback and cost stack).  Every output must be equal:
block bounds, seed histograms, exact per-block costs, the lane-row count,
the stored-exit decision and the candidate tables."""

import numpy as np
import pytest
import torch

from zopfli_tpu.ops import seed as jseed
from zopfli_tpu_torch.ops import seed as seed

# The tensors here are tiny: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)


def _text(rng, n):
    words = [b"compress ", b"every ", b"block ", b"of ", b"the ",
             b"input\n", b"{\"key\": ", b"42}, "]
    return b"".join(words[i] for i in rng.integers(0, len(words), n // 5))[:n]


def _data():
    rng = np.random.default_rng(17)
    text = _text(rng, 9000)
    noise = rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()
    rand = rng.integers(0, 256, 9000, dtype=np.uint8).tobytes()
    # [0, 9000) text, [9000, 15000) mixed, [15000, 24000) random.
    return np.frombuffer(text + noise + b"\x00" * 1500 + text[:1500] + rand,
                         np.uint8)


DATA = _data()

# name -> (instart, inend, cheap, window_start)
CASES = {
    "text": (0, 9000, False, 0),
    "mixed": (9000, 15000, False, 0),
    "random_stored": (15000, 24000, False, 0),
    "cheap_knobs": (15000, 24000, True, 0),
    "window_start": (12000, 20000, False, 9000),
}
FIELDS = ("bounds", "seed_ll", "seed_d", "block_costs", "max_lane_rows",
          "all_stored", "bp_len", "bp_dist")


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("name", list(CASES))
def test_seed_master_bit_equal(name):
    instart, inend, cheap, ws = CASES[name]
    ours = seed.seed_master(DATA, instart, inend, 15, cheap=cheap,
                            window_start=ws, device="cpu")
    ref = jseed.seed_master(DATA, instart, inend, 15, interpret=True,
                            cheap=cheap, window_start=ws)
    for field in FIELDS:
        np.testing.assert_array_equal(
            _host(getattr(ours, field)), _host(getattr(ref, field)),
            err_msg=f"{name}: {field}")
    if name == "random_stored":
        assert ours.all_stored
    if name in ("text", "mixed"):
        assert not ours.all_stored and len(ours.bounds) > 2


def test_dispatch_queues_without_finishing():
    """seed_dispatch stops before the split: no split search runs until
    seed_finish."""
    from zopfli_tpu_torch.ops import devsplit
    before = dict(devsplit.STATS)
    h = seed.seed_dispatch(DATA, 0, 4000, 15, device="cpu")
    assert devsplit.STATS == before
    sr = seed.seed_finish(h)
    assert devsplit.STATS["searches"] == before["searches"] + 1
    assert sr.bounds[0] == 0 and sr.bounds[-1] == 4000


def test_probably_incompressible():
    assert seed.probably_incompressible(DATA, 15000, 24000)
    assert not seed.probably_incompressible(DATA, 0, 9000)
