"""A configuration, a traffic mix, a per-layer metric, a cell, an input
kind, an entry, a format and a control encoder added as new files and
entries are found by name, with no file edited."""

import functools
import os

import pytest
from helpers import TEXT_MIX, make_manifest, no_card, stand_in

from portbench import calls, gen, run
from portbench.reference import control

NEW_METRIC = '''
def read(view):
    return float(view.calls)
'''


def test_new_files_are_found_by_name(tmp_path):
    cfg = {"format": "gzip", "options": {"numiterations": 1}}
    cells = [{"name": "new.cell", "config": "new-config",
              "traffic": "new-mix", "chips": 1, "why": "test"}]
    man = make_manifest(str(tmp_path), cells, configs={"new-config": cfg},
                        mixes={"new-mix": TEXT_MIX},
                        metrics={"calls_seen": NEW_METRIC})
    assert man.config("new-config") == cfg
    assert man.traffic("new-mix") == TEXT_MIX
    r = run.run_cell(man, "new.cell", 5, 0.05, False, make_entry=stand_in,
                     device_info=no_card)
    assert r["correct"]
    assert {"input_MBps", "out_bits_per_byte", "setup_s"} <= set(r["metrics"])
    t = run.run_cell(man, "new.cell", 5, 0.05, True, make_entry=stand_in,
                     device_info=no_card)
    assert t["metrics"]["calls_seen"]["value"] >= 1
    assert list(t)[-1] == "check"


# A toy input whose `raw` is a seeded 64-byte header and a payload, as
# an image file wraps its pixels: `expect` and `nbytes` are the payload.
TOY_KIND = '''
from portbench.gen import Item, rng_for


def items(mix, seed):
    rng = rng_for(seed, 0)
    out = []
    for k in range(int(mix["passes"]) * len(mix["sizes"])):
        size = mix["sizes"][k % len(mix["sizes"])]
        payload = bytes(rng.integers(0, 4, size, dtype="uint8"))
        raw = rng.bytes(64) + payload
        out.append(Item(f"toy{k}", raw, len(payload), payload))
    return out
'''
TOY_ENTRY = '''
import zlib


def entry(config):
    level = config["options"]["level"]
    return lambda items: [zlib.compress(i.raw[64:], level) for i in items]
'''
# The toy format: a zlib stream of the payload; its yardstick, zlib at
# level 9 on the whole input as handed over, header and all.
TOY_FORMAT = '''
import zlib


def judge(out, item):
    try:
        got = zlib.decompress(out)
    except zlib.error as e:
        return f"inflate: {e}"
    return None if got == item.expect else "decodes to other bytes"


def zlib9_size(item):
    return len(zlib.compress(item.raw, 9))
'''
TOY_ENCODER = '''
import zlib


def encode(item):
    return zlib.compress(item.raw, 9)
'''
TOY_FILES = {"inputs/toy.py": TOY_KIND, "entries/toy_entry.py": TOY_ENTRY,
             "reference/formats/toy.py": TOY_FORMAT,
             "reference/encoders/toy_whole.py": TOY_ENCODER}
TOY_CONFIG = {"format": "toy", "options": {"level": 9},
              "controls": {"whole": {"kind": "reference",
                                     "encoder": "toy_whole"}}}
TOY_MIX = {"inputs": "toy", "call": "toy_entry", "per_call": 2,
           "sizes": [3000, 500, 1200, 40], "passes": 2, "trace_calls": 2}


def _toy(tmp_path, files=TOY_FILES, config=TOY_CONFIG, mix=TOY_MIX):
    cells = [{"name": "toy.cell", "config": "toy-config",
              "traffic": "toy-mix", "chips": 1, "why": "test"}]
    return make_manifest(str(tmp_path), cells,
                         configs={"toy-config": config},
                         mixes={"toy-mix": mix}, files=files)


def test_new_kind_entry_format_and_encoder_are_found_by_name(tmp_path):
    man = _toy(tmp_path)
    pool = gen.make_pool(man.traffic("toy-mix"), 7, man)
    items = pool.items()
    assert len(pool.calls) == 4 and pool.cycle == 2
    assert all(i.expect != i.raw and i.nbytes == len(i.raw) - 64
               for i in items)
    r = run.run_cell(man, "toy.cell", 7, 0.05, False, device_info=no_card)
    assert r["correct"], r["check"]
    assert r["attempted"] >= len(items)
    bits = r["metrics"]["out_bits_per_byte"]["value"]
    assert 0 < bits < 8
    make = functools.partial(control.entry,
                             program_entry=calls.program_entry,
                             name="whole", man=man)
    c = run.run_cell(man, "toy.cell", 7, 0.05, False, make_entry=make,
                     device_info=no_card)
    assert not c["correct"]
    assert c["check"]["bad_outputs"]["value"] == c["attempted"]
    assert c["check"]["not_smaller_than_zlib9"]["value"] == c["attempted"]


@pytest.mark.parametrize("part", ["inputs", "entries", "reference/formats",
                                  "reference/encoders"])
def test_an_unknown_name_raises_naming_the_missing_path(tmp_path, part):
    missing = {"inputs": "inputs/toy.py", "entries": "entries/toy_entry.py",
               "reference/formats": "reference/formats/toy.py",
               "reference/encoders": "reference/encoders/toy_whole.py"}[part]
    man = _toy(tmp_path, files={k: v for k, v in TOY_FILES.items()
                                if k != missing})
    with pytest.raises(FileNotFoundError) as e:
        if part == "inputs":
            gen.make_pool(man.traffic("toy-mix"), 7, man)
        elif part == "entries":
            calls.program_entry("toy_entry", TOY_CONFIG, man)
        elif part == "reference/formats":
            run.run_cell(man, "toy.cell", 7, 0.05, False,
                         device_info=no_card)
        else:
            control.entry("toy_entry", TOY_CONFIG, calls.program_entry,
                          "whole", man)
    assert os.path.join(man.bench_dir, missing) in str(e.value)
