"""Device resolution for the port's entry points.

Every entry point runs on the card (``cuda``) unless its caller asks for
the CPU. A missing card is an error the caller sees: nothing carries on
silently on the CPU.
"""

from __future__ import annotations

import torch


class DeviceUnavailable(RuntimeError):
    """The requested device does not exist on this machine."""


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device`` ("cuda", "cuda:N", "cpu" or a
    device), raising :class:`DeviceUnavailable` for a CUDA request on a
    machine without a usable card."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceUnavailable(
                "no CUDA device is available; pass --device cpu (or "
                "device='cpu') to run the plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise DeviceUnavailable(f"unsupported device {device!r} "
                                f"(expected cuda or cpu)")
    return dev
