"""Device selection helpers."""

import torch

__all__ = ["require_cuda", "resolve_device", "as_dtype"]


def require_cuda():
    """The CUDA device, or RuntimeError when no card is visible. Measurement
    paths call this instead of falling back to the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available")
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device=None):
    """The device an entry point runs on: the card when `device` is None,
    else torch.device(device); RuntimeError when that is CUDA and no card
    is visible (no fallback to the CPU). CPU callers pass "cpu" explicitly."""
    if device is None:
        return require_cuda()
    device = torch.device(device)
    if device.type == "cuda":
        require_cuda()
    return device


def as_dtype(dtype):
    """torch float dtype from a torch dtype, a numpy dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    import numpy as np

    name = np.dtype(dtype).name
    if name == "float32":
        return torch.float32
    if name == "float64":
        return torch.float64
    raise ValueError(f"unsupported dtype {dtype!r}: float32 or float64")
