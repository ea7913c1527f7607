"""A manifest of the benchmark's own files in a temporary directory,
with cells at sizes a CPU test holds."""

import json
import os
import shutil
import zlib

from portbench.manifest import HERE, ROOT, Manifest

TEXT_MIX = {"inputs": "text", "call": "compress", "per_call": 1,
            "sizes": [3000, 1200, 2100, 1500], "passes": 2,
            "trace_calls": 4}
BATCH_MIX = dict(TEXT_MIX, call="compress_many", per_call=4)


COPIED = ("metrics", "configs", "data", "inputs", "entries",
          "reference/formats", "reference/encoders")


def make_manifest(tmp, cells, configs=None, mixes=None, metrics=None,
                  files=None):
    """A root `tmp` with BENCHMARK.json (the real one's metrics, and
    `cells`) and a bench dir holding copies of the real `COPIED`
    directories and the given extra configs {name: dict}, mixes
    {name: dict}, metric sources {name: str} and other files
    {path under the bench dir: source}."""
    bench = os.path.join(tmp, "pb")
    for d in COPIED:
        shutil.copytree(os.path.join(HERE, d), os.path.join(bench, d),
                        ignore=shutil.ignore_patterns("__pycache__"))
    os.makedirs(os.path.join(bench, "traffic"))
    for rel, src in (files or {}).items():
        with open(os.path.join(bench, rel), "x") as f:
            f.write(src)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        man = json.load(f)
    man["configs"] = [dict(c, file=c["file"].replace("portbench/", "pb/"))
                      for c in man["configs"]]
    for name, cfg in (configs or {}).items():
        path = os.path.join(bench, "configs", name + ".json")
        with open(path, "w") as f:
            json.dump(cfg, f)
        man["configs"].append({"name": name, "source": "test",
                               "file": f"pb/configs/{name}.json",
                               "reduced": [], "why": "test"})
    for name, mix in (mixes or {}).items():
        with open(os.path.join(bench, "traffic", name + ".json"), "w") as f:
            json.dump(mix, f)
    for name, src in (metrics or {}).items():
        with open(os.path.join(bench, "metrics", name + ".py"), "w") as f:
            f.write(src)
        man["per_layer"].append({"name": name, "unit": "x",
                                 "better": "lower", "source": "host_clock",
                                 "layer": "test", "moves": "input_MBps"})
    man["workloads"] = cells
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(man, f)
    return Manifest(root=tmp, bench_dir=bench)


def zlib_gzip(raw: bytes) -> bytes:
    c = zlib.compressobj(9, zlib.DEFLATED, 31)
    return c.compress(raw) + c.flush()


def stand_in(call, config):
    """A sound encoder in the program's place: the port's host engine at
    one iteration, on the CPU."""
    import zopfli_tpu_torch as zt
    o = zt.Options(numiterations=1, engine="native", device="cpu")
    return lambda items: [zt.compress(i.raw, "gzip", o) for i in items]


def no_card(chips):
    return {}
