"""The benchmark's own tests: ``python -m pytest nerfbench/tests -q`` from
the repository's root. Tests marked ``card`` need a CUDA card and skip
without one (they decide inside the test)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")
