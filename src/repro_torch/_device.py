"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for another device:
``device=None`` means ``"cuda"``, and without CUDA that raises instead of
quietly running on the CPU.
"""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises when CUDA is unavailable); anything
    else is taken as given (``"cpu"`` for tests and small runs)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU explicitly")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    return dev


_SMS: dict = {}


def sm_count(dev: torch.device) -> int:
    """Streaming multiprocessors of the card ``dev`` (read once per card):
    the kernels' launch plans size their grids by it."""
    i = dev.index if dev.index is not None else torch.cuda.current_device()
    if i not in _SMS:
        _SMS[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _SMS[i]
