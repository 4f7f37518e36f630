"""The benchmark's own tests, on the CPU at tiny sizes: the harness, its
frozen counters and reference, the faults it must catch, and its data.

    python -m pytest benchmark/tests -q

Tests marked `cuda` run the cells on a card and skip here.  They decide
inside the test whether a card is present, never at import.
"""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0:0] = [BENCH, os.path.dirname(BENCH)]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (the benchmark's runs); skips "
        "where torch.cuda.is_available() is False")
