import os
import sys

sys.path.insert(0, os.path.dirname(__file__))  # proptest helper importable


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips with a reason where there is none"
    )
