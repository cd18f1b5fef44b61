"""Hand-written CUDA kernels for Hopper (sm_90a), one package per kernel.

- grib_pack: GRIB-style simple-packing field codec (the NWP I/O-plane hotspot)
- flash_attention: tiled online-softmax attention (causal/bidir, GQA), the
  prefill attention of the serving path
- ssd_scan: the Mamba2 SSD chunked scan with a carried state, the scoring
  path of the ssm family
- causal_conv: the Mamba2 mixer's causal depthwise convolution with its bias
  and silu on the channel-last layout, the scoring path's ``ssm.conv`` stage
  (it replaces no TPU kernel)
- rms_norm: one-pass RMSNorm over groups of channels, with the mixer's
  ``y * silu(z)`` gate as an optional second input, the scoring path's norms
  (it replaces no TPU kernel)

Each package mirrors the reference's three files: ``kernel.py`` builds and
binds the CUDA source under ``csrc/``, ``ops.py`` is the public wrapper that
dispatches (a CPU tensor goes to the plain version, a CUDA tensor to the
kernel) and counts kernel launches in :mod:`.launches`, the one counter of
them all, and ``ref.py`` is the plain PyTorch version, on the wrapper's
signature.  The models import the plain versions from here, and nothing here
imports :mod:`repro_torch.models`.  The kernels have no backward, as the
reference's have no VJP (:mod:`._autograd`).  Nothing is compiled when a
module is imported: :mod:`._build` builds a kernel's library with ``nvcc`` at
its first launch.
"""
