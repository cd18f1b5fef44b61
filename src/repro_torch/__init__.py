"""repro_torch — the PyTorch/CUDA port of :mod:`repro`.

The same FDB storage plane (``repro_torch.core``) with the GRIB codec bound
to hand-written CUDA kernels for Hopper (``repro_torch.kernels``), and the
serving path of the dense model family (``repro_torch.models``,
``repro_torch.serving``) with prefill attention on a hand-written
flash-attention kernel.  The package imports no JAX and nothing of
``repro``: framework-neutral modules are carried over as copies, and
``tests/test_torch_drift.py`` keeps each copy equal to its reference.
Codec calls, parameters, caches and the engine run on the CUDA card unless
the caller asks for the CPU (:mod:`repro_torch.device`).
"""
