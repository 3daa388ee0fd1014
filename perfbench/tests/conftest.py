"""The benchmark's own tests: ``python -m pytest perfbench/tests -q`` from
the repo root. Tests marked ``card`` run the harness on a CUDA card and
skip where there is none; whether there is one is decided inside each
test."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.dirname(os.path.dirname(HERE))]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")
