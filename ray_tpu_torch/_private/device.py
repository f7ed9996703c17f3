"""Device resolution for the port's entry points.

The port runs on the card. The CPU is a device a caller asks for by name
(the tests do, to hold the port against the JAX package); it is never
where a call lands because CUDA is missing.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """None -> the current CUDA device, or raise if there is none.

    An explicit device is taken as given; an explicit CUDA device on a
    machine without CUDA raises too."""
    dev = check_device(device)
    if device is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def check_device(device: str | torch.device | None = None) -> torch.device:
    """resolve_device's checks without touching the card: a process that
    only hands the work to a worker (the driver) makes no CUDA context.
    None -> torch.device("cuda"), or raise if CUDA is missing."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; ray_tpu_torch runs on the "
                "GPU unless the caller passes device='cpu'")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           "available")
    return dev
