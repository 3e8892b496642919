"""Device selection for the port's entry points.

`device=None` means the card: it raises when no CUDA device is present
instead of quietly running the plain versions on the CPU.  The plain
versions run only when the caller asks for them with `device="cpu"`.
"""

from __future__ import annotations

import time

import torch


class NoCudaDevice(RuntimeError):
    """An entry point was asked for the card on a host without one."""


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise NoCudaDevice(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoCudaDevice("device 'cuda' requested but no CUDA device is available")
    return dev


def elapsed(t0: float, device: torch.device) -> float:
    """Seconds since `t0` once the work queued on `device` has finished."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.time() - t0
