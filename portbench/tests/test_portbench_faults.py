"""The harness's run, with the look for a card skipped, on the port at
a size a CPU test holds: sound, it comes out correct; with the timed
path broken underneath, or the control in its place, not correct."""

import functools

import pytest
from helpers import BATCH_MIX, TEXT_MIX, make_manifest, no_card, zlib_gzip

from portbench import calls, run
from portbench.reference import control

CPU_OPTS = {"numiterations": 2, "device": "cpu"}


@pytest.fixture(scope="module")
def man(tmp_path_factory):
    real = make_manifest(str(tmp_path_factory.mktemp("real")), [])
    gz = dict(real.config("zopfli-i15-gzip"), options=CPU_OPTS)
    cells = [{"name": n, "config": c, "traffic": t, "chips": 1, "why": "t"}
             for n, c, t in (("gz.one", "cpu-gz", "tiny"),
                             ("gz.many", "cpu-gz", "tiny-batch"))]
    return make_manifest(str(tmp_path_factory.mktemp("m")), cells,
                         configs={"cpu-gz": gz},
                         mixes={"tiny": TEXT_MIX, "tiny-batch": BATCH_MIX})


def one(man, cell, make=calls.program_entry):
    return run.run_cell(man, cell, 2 ** 31 + 9, 0.01, False,
                        make_entry=make, device_info=no_card)


@pytest.mark.parametrize("cell", ["gz.one", "gz.many"])
def test_sound_port_is_correct(man, cell):
    r = one(man, cell)
    assert r["correct"], r["check"]
    assert r["failed"] == 0 and r["attempted"] >= 1


def _altered(frame):
    """The gzip frame with one payload bit flipped where it is made."""
    def alt(payload, crc, n):
        out = bytearray(frame(payload, crc, n))
        out[len(out) // 2] ^= 1
        return bytes(out)
    return alt


@pytest.mark.parametrize("cell", ["gz.one", "gz.many"])
def test_answer_altered_where_produced(man, cell, monkeypatch):
    import zopfli_tpu_torch as zt
    monkeypatch.setattr(zt.containers, "gzip_frame",
                        _altered(zt.containers.gzip_frame))
    r = one(man, cell)
    assert not r["correct"] and r["check"]["bad_outputs"]["value"] > 0


def test_state_returned_unchanged(man, monkeypatch):
    import zopfli_tpu_torch as zt
    monkeypatch.setattr(zt, "compress", lambda data, fmt, o: bytes(data))
    assert not one(man, "gz.one")["correct"]


def test_half_the_batch_left_out(man, monkeypatch):
    import zopfli_tpu_torch as zt
    orig = zt.compress_many
    monkeypatch.setattr(zt, "compress_many",
                        lambda blobs, fmt, o: orig(blobs[:len(blobs) // 2],
                                                   fmt, o))
    r = one(man, "gz.many")
    assert not r["correct"] and r["check"]["missing_outputs"]["value"] > 0


@pytest.mark.parametrize("cell,name", [("gz.one", "gzip_crc_dropped"),
                                       ("gz.many", "gzip_crc_dropped"),
                                       ("gz.one", "zlib9")])
def test_control_is_not_correct(man, cell, name):
    make = functools.partial(control.entry,
                             program_entry=calls.program_entry, name=name)
    r = one(man, cell, make=lambda call, cfg: make(call, cfg))
    assert not r["correct"]
    assert all(v["value"] == r["attempted"] for k, v in r["check"].items()
               if k != "missing_outputs" and (k, name) != ("bad_outputs",
                                                          "zlib9"))


@pytest.mark.parametrize("cell", ["gz.one", "gz.many"])
def test_stock_zlib_in_the_programs_place_is_not_correct(man, cell):
    """Sound gzip from zlib at level 9: every output decodes, and none
    is smaller than zlib level 9's."""
    r = one(man, cell,
            make=lambda call, cfg: lambda items: [zlib_gzip(i.raw)
                                                  for i in items])
    assert not r["correct"] and r["check"]["bad_outputs"]["value"] == 0
    assert r["check"]["not_smaller_than_zlib9"]["value"] == r["attempted"]


def test_sound_port_beats_zlib9_and_covers_the_pool(man):
    """The window of 0.01 s reaches one pass of two; the run compresses
    the rest after it, and every output is smaller than zlib 9's."""
    r = one(man, "gz.one")
    assert r["attempted"] == 8
    assert r["check"]["not_smaller_than_zlib9"]["value"] == 0
