"""The fused loop's randomization stream, sized to the run.

After iteration 5 a block row whose cost repeats draws the next event of
Zopfli's MWC stream (squeeze.c RandomizeStatFreqs); replica rows start 9
events apart.  The loop's gather maps must hold every event a row can
draw, event e the map of the host loop's e-th randomize_stat_freqs,
however many iterations run.  The JAX package's host loop draws the
stream without limit, so it is the reference past event 48 too."""

import numpy as np
import pytest
import torch

from zopfli_tpu.ops import costmodel as jcm
from zopfli_tpu.squeeze import MwcRng, SymbolStats, randomize_stat_freqs
from zopfli_tpu_torch import native
from zopfli_tpu_torch.deflate import Options, split_master
from zopfli_tpu_torch.ops import costmodel as cm
from zopfli_tpu_torch.ops import fused_engine as fe
from zopfli_tpu_torch.squeeze_batched import greedy_seed_stats

torch.set_num_threads(1)

# Enough iterations that a row of the input below draws more than 48
# events (at 64 the most any row draws is 37).
ITERATIONS = 96


@pytest.mark.parametrize("events", [1, 48, 49, 600])
def test_maps_are_the_host_streams_events(events):
    """Event e of randomize_maps(E) gathers what the e-th
    randomize_stat_freqs of one continuing MwcRng of the JAX package's
    host loop writes into a probe of distinct counts, for every e < E."""
    ll_maps, d_maps = cm.randomize_maps(events)
    assert ll_maps.shape == (events, 288) and d_maps.shape == (events, 32)
    probe_ll = np.arange(288, dtype=np.int64) + 1000
    probe_d = np.arange(32, dtype=np.int64) + 5000
    rng = MwcRng()
    for e in range(events):
        st = SymbolStats()
        st.litlens, st.dists = probe_ll.copy(), probe_d.copy()
        randomize_stat_freqs(rng, st)
        got = probe_ll[ll_maps[e]]
        got[256] = 1
        assert np.array_equal(st.litlens, got), e
        assert np.array_equal(st.dists, probe_d[d_maps[e]]), e


def test_first_48_events_are_todays_table_and_a_longer_run_extends_them():
    want = jcm.randomize_maps(48)
    short = cm.randomize_maps(48)
    longer = cm.randomize_maps(600)
    again = cm.randomize_maps(48)
    for k in range(2):
        assert np.array_equal(short[k], np.asarray(want[k]))
        assert np.array_equal(longer[k][:48], short[k])
        assert np.array_equal(again[k], short[k])


@pytest.mark.parametrize("iterations,rep_off,want", [
    (1, 0, 48), (15, 18, 48), (54, 0, 48), (55, 0, 49), (64, 18, 76),
    (500, 18, 512), (1000, 27, 1021)])
def test_events_needed(iterations, rep_off, want):
    assert fe.events_needed(iterations, rep_off) == want


def test_device_maps_are_uploaded_once_and_grow_only_when_asked(monkeypatch):
    monkeypatch.setattr(fe, "_MAPS", {})
    built = fe.RANDOM["maps_built"]
    ll, d = fe.random_maps("cpu", 50)
    assert ll.dtype == d.dtype == torch.int64
    assert ll.shape == (50, 288) and d.shape == (50, 32)
    assert fe.random_maps("cpu", 20)[0] is ll
    assert fe.RANDOM["maps_built"] == built + 1
    ll2, _ = fe.random_maps("cpu", 80)
    assert ll2.shape[0] == 80 and torch.equal(ll2[:50], ll)
    assert fe.RANDOM["maps_built"] == built + 2


def _input() -> np.ndarray:
    """tests/test_torch_fused.py's input: words, random bytes, a run."""
    rng = np.random.default_rng(21)
    words = [b"the ", b"fused ", b"squeeze ", b"engine ", b"runs ",
             b"every ", b"iteration\n"]
    text = b"".join(words[i] for i in rng.integers(0, len(words), 2600))
    blob = text[:6000] + rng.integers(0, 256, 1500, dtype=np.uint8).tobytes() \
        + b"abc" * 400 + text[6000:10000]
    return np.frombuffer(blob, np.uint8)


@pytest.fixture(scope="module")
def runs():
    """Two runs of ITERATIONS on the CPU from an empty map cache: the
    first builds the maps, the second reuses them.  Each run's per-row
    event counts come from the dispatch handle."""
    data = _input()
    n = len(data)
    bounds = split_master(Options(engine="native"), data, 0, n,
                          native.greedy)
    fs = fe.FusedSqueeze(data, [(0, n, bounds)], device="cpu")
    seed_ll, seed_d = greedy_seed_stats(data, fs.block_bounds, native.greedy)
    saved = fe._MAPS.copy()
    fe._MAPS.clear()
    out = []
    try:
        for _ in range(2):
            fe.RANDOM["events_max"] = 0
            built = fe.RANDOM["maps_built"]
            handle = fs.dispatch(seed_ll, seed_d, ITERATIONS)
            events = handle[0][3].numpy()[fs.ngroups * fe.LANES:]
            held = fe._MAPS["cpu"][0].shape[0]
            out.append({"result": fs.collect(handle), "events": events,
                        "held": held, "events_max": fe.RANDOM["events_max"],
                        "built": fe.RANDOM["maps_built"] - built})
    finally:
        fe._MAPS.clear()
        fe._MAPS.update(saved)
    return fs, fs.initial_stats(seed_ll, seed_d)[2], out


def test_a_row_draws_past_48_events(runs):
    fs, _, out = runs
    for r in out:
        assert r["events_max"] > 48
        assert r["events_max"] == r["events"][:fs.nb_total].max()


def test_the_held_maps_cover_every_index_a_row_drew(runs):
    """Row r's e-th event reads map ec + rep_off[r] for ec < its events:
    the highest index of every row, block, replica and padding alike,
    lies inside the maps, and some row reads past map 47."""
    fs, rep_off, out = runs
    for r in out:
        top = r["events"] - 1 + rep_off
        assert r["held"] == fe.events_needed(ITERATIONS, rep_off.max())
        assert top.max() < r["held"]
        assert top[:fs.nb_total].max() > 47
        assert r["events_max"] + rep_off.max() <= r["held"]


def test_two_runs_give_identical_parses(runs):
    _, _, (a, b) = runs
    assert (a["built"], b["built"]) == (1, 0)
    (pa, ca, sa, da), (pb, cb, sb, db) = a["result"], b["result"]
    np.testing.assert_array_equal(ca, cb)
    np.testing.assert_array_equal(sa, sb)
    np.testing.assert_array_equal(da, db)
    assert len(pa) == len(pb)
    for (la, xa), (lb, xb) in zip(pa, pb):
        np.testing.assert_array_equal(la, lb)
        np.testing.assert_array_equal(xa, xb)
