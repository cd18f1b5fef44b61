"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one entry
point, ``perfbench/run.py``, that runs one cell of ``BENCHMARK.json``."""
