"""The harness's own tests: ``python -m pytest portbench/tests -q`` from
the root of the repository. Tests marked ``cuda`` need the card and skip
where there is none; on the card run them with the same command."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where none is present")
