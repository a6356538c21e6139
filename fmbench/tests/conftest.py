"""The benchmark's CPU tests.  Tests marked `card` need an NVIDIA card;
each decides inside the test whether one is there and skips without."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")
