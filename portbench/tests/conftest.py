"""CPU tests of the benchmark (``python -m pytest portbench/tests``).

Tests that need the card carry the ``card`` marker and skip inside the
test where no card is present."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card (skips without one)")
