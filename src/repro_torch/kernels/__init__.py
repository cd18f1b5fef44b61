"""Hand-written CUDA kernels for Hopper (sm_90a), one package per kernel.

- grib_pack: GRIB-style simple-packing field codec (the NWP I/O-plane hotspot)

Each package mirrors the reference's three files: ``kernel.py`` builds and
binds the CUDA source under ``csrc/``, ``ops.py`` is the public wrapper that
dispatches (a CPU tensor goes to the plain version, a CUDA tensor to the
kernel) and counts kernel launches, and ``ref.py`` is the plain PyTorch
version.  Nothing is compiled when a module is imported: the kernel is built
with ``nvcc`` at its first launch.
"""
