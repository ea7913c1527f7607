"""CPU tests of the benchmark harness (`python -m pytest portbench/tests`
from the repository root).  The repository's own test run does not
collect them.  Tests that need a CUDA card are marked `card` and skip,
deciding inside the test, where there is none."""

import os
import sys

# The port's small CPU geometry, as the repository's tests use it.
os.environ.setdefault("ZT_TILE", "1024")
os.environ.setdefault("ZT_LANES", "8")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where there is none")
