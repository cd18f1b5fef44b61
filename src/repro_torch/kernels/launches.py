"""One count of the hand-written kernels' launches, kept by every wrapper.

A wrapper counts each launch of its CUDA kernel under the kernel's name
(``grib_pack``, ``grib_unpack``, ``flash_attention``, ``ssd_scan``,
``causal_conv1d``, and ``rms_norm`` or ``gated_rms_norm`` by whether the gate
ran), and under ``(name, part, value)`` for each part it names: K3 and K4
their ``instance``, K3 its ``head_dim``, K4 the ``layout`` it read x in
(``"bshp"`` or ``"flat"``).  K4's count is kept by its launch function,
``ssd_scan.kernel.ssd_scan_call``, where both are decided, so a direct call
counts too.  The plain versions are not counted.
One more key is not a launch: ``rms_norm.plain_on_card`` (and
``gated_rms_norm.plain_on_card``) counts the DTensors on the card whose
groups were split across ranks, so that the plain version normalised them.
The codec's own counter (``repro_torch.core.codec.kernel_launches``) is
separate, as the reference's is.
"""

from __future__ import annotations

import threading
from collections import Counter

__all__ = ["by", "count", "reset", "snapshot"]

_counts: Counter = Counter()
_mu = threading.Lock()


def count(name: str, **parts) -> None:
    """One launch of kernel ``name``, counted also under each ``part=value``."""
    with _mu:
        _counts[name] += 1
        for part, value in parts.items():
            _counts[name, part, value] += 1


def snapshot() -> Counter:
    """A copy of every count; a key never counted reads 0."""
    with _mu:
        return Counter(_counts)


def by(name: str, part: str) -> dict:
    """``{value: launches}`` of kernel ``name`` by ``part`` ("instance", "head_dim")."""
    return {key[2]: n for key, n in snapshot().items()
            if isinstance(key, tuple) and key[:2] == (name, part)}


def reset() -> None:
    with _mu:
        _counts.clear()
