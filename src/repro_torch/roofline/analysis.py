"""The hardware model of the port's roofline: one NVIDIA H100.

The reference's ``repro.roofline.analysis`` models a TPU chip and reads
roofline terms out of compiled XLA artifacts.  Neither applies to the card
the port runs on, so this module holds only the card's peaks, from NVIDIA's
data sheet for the H100 SXM part at its 700 W limit (dense rates, no
sparsity).  A card set below that limit runs slower under load; measured
shares are stated against these peaks with the card's limit beside them.
"""

from __future__ import annotations

__all__ = ["HW"]

HW = {
    "peak_flops": 989e12,  # bf16 dense on the tensor cores, operations/s
    "hbm_bw": 3.35e12,     # HBM3, bytes/s
    "f32_flops": 67e12,    # float32 outside the tensor cores, operations/s
}
