"""The readers of the port's finer spans on synthetic Views: unions of
waits, idle that no span names, counts, and the zero and None cases."""

import pytest

from portbench import tracing
from portbench.manifest import Manifest

SPAN_MS = {"seed_probe_ms": "zt.seed.probe",
           "seed_upload_ms": "zt.seed.upload",
           "squeeze_prep_ms": "zt.squeeze.prep",
           "collect_wait_ms": "zt.collect_wait",
           "verify_ms": "zt.verify",
           "presplit_ms": "zt.presplit",
           "finish_cost_ms": "zt.finish.cost",
           "finish_fixed_ms": "zt.finish.fixed"}
NEW = sorted(SPAN_MS) + ["host_wait_ms", "syncs_per_call",
                         "untraced_idle_ms", "retries_per_call"]


def _view(spans, device=(), window_s=10.0, calls=2):
    return tracing.View(calls=calls, window_s=window_s, input_bytes=1000,
                        call_s=9.0, config={}, mix={}, device=list(device),
                        spans=list(spans))


def test_host_wait_takes_the_union_of_nested_and_overlapping_waits():
    m = Manifest()
    spans = [("zt.call", 0, 10), ("zt.split", 0, 4),
             ("zt.seed_wait", 1, 3), ("zt.split_wait", 2, 4),
             ("zt.stats_wait", 2.5, 3.5), ("zt.collect_wait", 6, 7)]
    v = _view(spans)
    # waits cover 1-4 and 6-7: 4 s over 2 calls, though they sum to 6 s
    assert m.reader("host_wait_ms")(v) == pytest.approx(2000.0)
    assert m.reader("syncs_per_call")(v) == 2.0


def test_untraced_idle_counts_idle_inside_a_call_and_outside_every_span():
    m = Manifest()
    spans = [("zt.call", 1, 5), ("zt.call", 6, 9),
             ("zt.seed", 1, 2), ("zt.finish", 7, 8),
             ("zt.finish.fixed", 7.2, 7.4)]
    # busy 0-1.5 and 3-4; idle 1.5-3, 4-10
    device = [(0, 1.5, "k"), (3, 4, "k")]
    v = _view(spans, device)
    # idle in a call, outside the other spans: 2-3, 4-5, 6-7, 8-9 = 4 s;
    # 1.5-2 lies under [zt.seed], 5-6 and 9-10 between calls
    assert m.reader("untraced_idle_ms")(v) == pytest.approx(2000.0)
    # a nested [zt.call] adds nothing
    v2 = _view(spans + [("zt.call", 6.5, 7)], device)
    assert m.reader("untraced_idle_ms")(v2) == pytest.approx(2000.0)


def test_span_times_and_retry_counts_per_call():
    m = Manifest()
    spans = [("zt.call", 0, 10)] + [(s, 1, 1.5) for s in SPAN_MS.values()]
    spans += [("zt.verify_fallback", 2, 3), ("zt.verify_fallback", 4, 5),
              ("zt.fetch_retry", 6, 7), ("zt.finish.cost", 8, 9)]
    v = _view(spans)
    for name, span in SPAN_MS.items():
        want = 750.0 if span == "zt.finish.cost" else 250.0
        assert m.reader(name)(v) == pytest.approx(want), name
    assert m.reader("retries_per_call")(v) == 1.5


def test_zero_where_a_span_did_not_run_none_without_a_call():
    m = Manifest()
    bare = _view([("zt.call", 0, 4)], [(0, 4, "k")])
    for name in NEW:
        assert m.reader(name)(bare) == 0, name
    parent = _view([("zt.seed", 0, 1), ("zt.seed_wait", 1, 2),
                    ("zt.finish", 2, 3)], [(0, 1, "k")])
    for name in NEW:
        assert m.reader(name)(parent) is None, name
