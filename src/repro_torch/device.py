"""Device resolution for the port.

Every entry point takes an optional device.  With none given, the port
runs on CUDA and raises when CUDA is unavailable: the CPU is used only
when a caller asks for it, per call (``device="cpu"``) or process-wide
(:func:`set_device`).  There is no silent fallback.
"""
from __future__ import annotations

import torch

_default: torch.device | None = None


def set_device(device: str | torch.device | None) -> None:
    """Set (or, with None, clear) the process-wide default device."""
    global _default
    _default = None if device is None else torch.device(device)


def get_device(device: str | torch.device | None = None) -> torch.device:
    """The device to run on: ``device`` if given, else the default set by
    :func:`set_device`, else ``cuda``.  Raises if that is a CUDA device
    and CUDA is unavailable."""
    if device is not None:
        dev = torch.device(device)
    elif _default is not None:
        dev = _default
    else:
        dev = torch.device("cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: CUDA is not available; pass device='cpu' "
                "(or call repro_torch.device.set_device('cpu')) to run on "
                "the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
