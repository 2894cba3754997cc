"""Tests of the benchmark: CPU tests of its counts, manifest, comparison and
control at a tiny size; tests marked ``cuda`` run a cell on the card and
skip without one.  ``python -m pytest perfbench/tests`` from the root."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card (skips without one)")
