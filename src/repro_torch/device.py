"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device = DEFAULT_DEVICE) -> torch.device:
    """The device an entry point runs on.

    Asking for ``cuda`` where no card is present raises: an entry point
    never carries on silently on the CPU. Pass ``device="cpu"`` to run the
    plain PyTorch versions of the kernels.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is present; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
