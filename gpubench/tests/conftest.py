"""CPU tests of the benchmark harness.  Tests that need a CUDA card
carry the ``card`` marker and skip inside the test where there is none;
run them on a card with ``python3 -m pytest gpubench/tests -m card``."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips inside the test "
        "without one)")
