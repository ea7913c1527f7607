"""The port's host spans (`utils.logging.span`) under torch.profiler on
the CPU: each appears where its stage runs, inside the span that holds
its stage, every one inside [zt.call]; the outputs do not change under
the profiler; and with no profiler running a span is one shared null
context."""

import zlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import zopfli_tpu_torch as zt
from zopfli_tpu_torch.ops import fused_engine
from zopfli_tpu_torch.squeeze_batched import VERIFY_FAILS
from zopfli_tpu_torch.utils.logging import span

OLD = ("zt.seed", "zt.seed_wait", "zt.split", "zt.iterations",
       "zt.collect", "zt.finish")
# Each new span and the spans one of which holds it on this path.
PARENTS = {
    "zt.container": ("zt.call",),
    "zt.pack": ("zt.call",),
    "zt.seed.probe": ("zt.seed",),
    "zt.seed.upload": ("zt.seed",),
    "zt.squeeze.prep": ("zt.call",),
    "zt.squeeze.compact": ("zt.call",),
    "zt.collect_wait": ("zt.collect", "zt.call"),
    "zt.verify": ("zt.call",),
    "zt.split_wait": ("zt.split", "zt.finish"),
    "zt.stats_wait": ("zt.split",),
    "zt.presplit": ("zt.call", "zt.finish"),
    "zt.finish.cost": ("zt.finish",),
    "zt.finish.fixed": ("zt.finish",),
}
RETRIES = {"zt.fetch_retry": ("zt.collect_wait",),
           "zt.verify_fallback": ("zt.verify",)}


def _text(n: int, seed: int) -> bytes:
    """Words of a seeded 300-word vocabulary: text-like matches."""
    rng = np.random.default_rng(seed)
    vocab = [bytes(rng.integers(97, 123, rng.integers(2, 9))) + b" "
             for _ in range(300)]
    return b"".join(vocab[i] for i in rng.integers(0, 300, n // 3))[:n]


# One master for compress; three for compress_many, the smallest under
# 1,000 symbols so that its block takes the fixed-tree re-parse probe.
ONE = _text(5000, 1)
MANY = [_text(400, 2), _text(2000, 3), _text(6000, 4)]
OPTS = zt.Options(device="cpu", numiterations=2)


def _calls():
    return zt.compress(ONE, "gzip", OPTS), zt.compress_many(MANY, "gzip",
                                                            OPTS)


def _spans(prof):
    """(name, start, end, thread) of each span, from the raw events (the
    profiler's event tree over every operator takes minutes here)."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
             e.start_thread_id())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("zt.")]


def _inside(child, spans, parents) -> bool:
    _, s, e, th = child
    return any(n in parents and ps <= s and e <= pe and pth == th
               for n, ps, pe, pth in spans)


@pytest.fixture(scope="module")
def traced():
    plain = _calls()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        outs = _calls()
    return plain, outs, _spans(prof)


def test_outputs_equal_with_and_without_the_profiler(traced):
    plain, outs, _ = traced
    assert outs == plain
    assert zlib.decompress(outs[0], 31) == ONE
    assert [zlib.decompress(o, 31) for o in outs[1]] == MANY


def test_every_span_appears_inside_its_parent_and_its_call(traced):
    _, _, spans = traced
    names = {n for n, *_ in spans}
    assert set(OLD) <= names
    assert set(PARENTS) <= names
    assert not set(RETRIES) & names
    assert sum(n == "zt.call" for n in names) == 1
    assert sum(n == "zt.call" for n, *_ in spans) == 2
    for sp in spans:
        if sp[0] in PARENTS:
            assert _inside(sp, spans, PARENTS[sp[0]]), sp
        if sp[0] != "zt.call":
            assert _inside(sp, spans, ("zt.call",)), sp


def test_retry_spans_count_what_the_counters_count(monkeypatch):
    """A fetch cap of one row overflows every lane; a verify that always
    fails sends every block to the host re-squeeze.  The bytes stay a
    sound gzip member of the input."""
    dispatch = fused_engine.FusedSqueeze.dispatch
    monkeypatch.setattr(
        fused_engine.FusedSqueeze, "dispatch",
        lambda self, ll, d, n, fetch_cap=None: dispatch(self, ll, d, n, 1))
    monkeypatch.setattr(fused_engine.FusedSqueeze, "verify_parse",
                        lambda self, b, lit, dst: False)
    retries, fails = fused_engine.FETCH_RETRIES[0], VERIFY_FAILS[0]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = zt.compress(ONE, "gzip", zt.Options(device="cpu",
                                                  numiterations=1))
    assert zlib.decompress(out, 31) == ONE
    spans = _spans(prof)
    count = {n: sum(s[0] == n for s in spans) for n in RETRIES}
    assert count["zt.fetch_retry"] == fused_engine.FETCH_RETRIES[0] - retries
    assert count["zt.verify_fallback"] == VERIFY_FAILS[0] - fails
    assert min(count.values()) >= 1
    for sp in spans:
        if sp[0] in RETRIES:
            assert _inside(sp, spans, RETRIES[sp[0]]), sp


def test_span_without_a_profiler_is_one_shared_null_context(monkeypatch):
    def refuse(name):
        raise AssertionError("a RecordFunction was made")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    a, b = span("zt.a"), span("zt.b")
    assert a is b
    with a:
        pass


def test_span_under_a_profiler_is_a_record_function():
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(span("zt.a"),
                          torch.autograd.profiler.record_function)
    assert not isinstance(span("zt.a"),
                          torch.autograd.profiler.record_function)
