"""On the card: one short run of the first cell, as the driver calls it
(`python -m pytest portbench/tests -m card` on a machine with a CUDA
card)."""

import json
import subprocess
import sys

import pytest

from portbench.manifest import ROOT


@pytest.mark.card
def test_first_cell_runs_correct_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "zopfli-i15.canterbury-large", "--seed", "4294967311", "--seconds", "2",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"


def test_no_card_no_result():
    """Without CUDA the run fails and prints no result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "zopfli-i15.canterbury-large", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
