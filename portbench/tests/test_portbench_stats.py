import pytest

from portbench import run, stats, tracing
from portbench.manifest import Manifest
from portbench.run import Record, Window


class It:
    def __init__(self, n, key="k"):
        self.nbytes, self.key = n, key


def test_union_gaps_overlap():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7)]
    assert stats.union(iv) == [(0, 3), (5, 6)]
    assert stats.covered(iv, 0, 10) == 4
    assert stats.gaps(iv, 0, 10) == [(3, 5), (6, 10)]
    assert stats.overlap([(0, 4)], [(1, 2), (3, 6)]) == 2


def _view(device, window_s=10.0, spans=()):
    return tracing.View(calls=2, window_s=window_s, input_bytes=1000,
                        call_s=9.0, config={}, mix={}, device=list(device),
                        spans=list(spans))


def test_idle_share_takes_the_union_not_the_sum():
    m = Manifest()
    v = _view([(0, 4, "a"), (2, 6, "b"), (8, 9, "c")])
    # busy 0-6 and 8-9: 7 of 10 s, though the times sum to 9
    assert m.reader("device_idle_pct")(v) == pytest.approx(30.0)
    assert m.reader("launches_per_call")(v) == 1.5
    assert m.reader("device_idle_pct")(_view([])) is None


def test_span_metrics_and_split_self_time():
    m = Manifest()
    spans = [("zt.split", 0, 5), ("zt.seed_wait", 1, 3),
             ("zt.seed_wait", 6, 7), ("zt.iterations", 5, 6),
             ("zt.split", 8, 9)]
    v = _view([(0, 1, "k")], spans=spans)
    # split 6 s, of which 2 s wait for the seed inside it: 4 s / 2 calls
    assert m.reader("split_self_ms")(v) == pytest.approx(2000.0)
    assert m.reader("seed_wait_ms")(v) == pytest.approx(1500.0)
    assert m.reader("iter_enqueue_ms")(v) == pytest.approx(500.0)
    assert m.reader("finish_ms")(v) is None


def test_window_rate_and_bits_over_the_pool():
    m = Manifest()
    a, b, c = It(1_000_000, "a"), It(3_000_000, "b"), It(2_000_000, "c")
    recs = [Record([a], [b"x" * 250_000], 0.0, 0.5),
            Record([b], [b"x" * 500_000], 0.5, 2.0),
            Record([a], [b"x" * 250_000], 2.0, 2.5)]
    after = [Record([c], [b"x" * 1_000_000], 2.6, 3.0, after=True)]
    w = Window(recs, 2.5, 7.5, run.pool_outs(recs + after))
    # the window's calls alone: 5 MB in 2.5 s
    assert m.reader("input_MBps")(w) == pytest.approx(2.0)
    # each distinct input once, c from after the window: 14 Mbit / 6 MB
    assert m.reader("out_bits_per_byte")(w) == pytest.approx(14 / 6)
    assert m.reader("setup_s")(w) == 7.5


def test_breakdown_names_the_span_over_each_gap():
    v = _view([(0, 1, "(anonymous namespace)::scan_kernel(int const*)"),
               (3, 4, "void f<1, g<(h)2> >(int)")],
              window_s=5.0,
              spans=[("zt.iterations", 0.5, 2.5), ("zt.finish", 4, 5)])
    b = tracing.breakdown(v)
    assert b["device_ops"] == [["scan_kernel", 1],
                               ["void f<1, g<(h)2> >", 1]]
    assert dict(b["idle_gaps"]) == {"zt.iterations": 2, "zt.finish": 1}
