"""BENCHMARK.json against the benchmark contract's static rules, and
every file it names present."""

import json
import os
import re

import pytest

from portbench.manifest import ROOT, Manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(bench)) <= 64 * 1024


def test_configs(bench):
    names = [c["name"] for c in bench["configs"]]
    assert len(set(names)) == len(names)
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"])
        assert _line(c["why"]) and c["name"] in used
        assert c["file"].startswith("portbench/")
        assert os.path.isfile(os.path.join(ROOT, c["file"]))


def test_cells(bench):
    m = Manifest()
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert _line(w["why"]) and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        mix = m.traffic(w["traffic"])
        assert os.path.isfile(os.path.join(m.bench_dir, "entries",
                                           mix["call"] + ".py"))
        e2e = {x["name"] for x in m.metrics(w["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert m.metrics(w["name"], "per_layer")
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= 1


def test_metrics(bench):
    m = Manifest()
    cells = {w["name"] for w in bench["workloads"]}
    seen = set()
    for kind in ("end_to_end", "per_layer"):
        for x in bench[kind]:
            assert NAME.match(x["name"]) and x["name"] not in seen
            seen.add(x["name"])
            assert UNIT.match(x["unit"]) and x["better"] in ("lower",
                                                             "higher")
            assert set(x.get("workloads", [])) <= cells
            assert callable(m.reader(x["name"]))
            if kind == "end_to_end":
                assert set(x) - {"workloads"} == {"name", "unit", "better",
                                                  "bound", "source"}
                assert x["source"] in ("host_clock", "device_trace")
                assert 0.01 <= x["bound"] <= 0.25
            else:
                assert set(x) - {"workloads"} == {
                    "name", "unit", "better", "source", "layer", "moves"}
                assert _line(x["layer"]) and x["moves"] == "input_MBps"
                assert x["source"] in ("device_trace", "program_span",
                                       "program_counter", "host_clock")
                if x["name"].endswith("_roofline"):
                    assert x["unit"] == "%"
    assert "setup_s" in seen
    setup = [x for x in bench["end_to_end"] if x["name"] == "setup_s"][0]
    assert setup["bound"] == 0.25


def test_files_under_paths_are_named_from_name_characters():
    bad = []
    for d, _, files in os.walk(os.path.join(ROOT, "portbench")):
        if "__pycache__" in d:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), ROOT)
            if not re.match(r"^[A-Za-z0-9_./-]+$", rel):
                bad.append(rel)
    assert bad == []
