"""A configuration, a traffic mix, a per-layer metric and a cell added
as new files and entries are found by name, with no file edited."""

from helpers import TEXT_MIX, make_manifest, no_card, stand_in

from portbench import run

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
