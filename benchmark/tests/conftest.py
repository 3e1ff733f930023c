"""Put benchmark/ on the import path, as `python benchmark/run.py` does,
and register the marker of the tests that need a CUDA card."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")
