import os
import sys

# tests must see 1 CPU device (the dry-run sets 512 in its own process)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips itself when none is present")
