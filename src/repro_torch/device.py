"""Where the port's codec and kernels run.

The default is the CUDA card.  A caller that wants the CPU says so, either
once per process with :func:`set_default_device` or per call with
``device="cpu"``.  A codec call that would run on CUDA when no CUDA device
is present raises :class:`RuntimeError`; it never quietly runs on the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["default_device", "resolve_device", "set_default_device"]

_default = torch.device("cuda")


def default_device() -> torch.device:
    """The device a call runs on when it is given ``device=None``."""
    return _default


def set_default_device(device: str | torch.device) -> None:
    """Set the process-wide default device (``"cuda"``, ``"cuda:1"``, ``"cpu"``)."""
    global _default
    _default = torch.device(device)


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device a call runs on: ``device``, or the default when it is None.

    Raises :class:`RuntimeError` when that is a CUDA device and PyTorch sees
    none, naming the two ways to ask for the CPU instead.
    """
    dev = _default if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"repro_torch runs on {dev} by default, and no CUDA device is "
            "available; to run on the CPU, call "
            "repro_torch.device.set_default_device('cpu') or pass device='cpu'"
        )
    return dev
