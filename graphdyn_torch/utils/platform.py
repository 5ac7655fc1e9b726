"""Device resolution shared by every entry point of the port.

Entry points take ``device=`` and default to CUDA. On a host without a CUDA
device they raise rather than carry on on the CPU: a run on the CPU happens
only when the caller asks for it with ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The ``torch.device`` an entry point runs on: ``device`` as given, or
    ``cuda`` when it is None. Raises ``RuntimeError`` when that is a CUDA
    device and no CUDA device is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"graphdyn_torch: device {str(dev)!r} requested but no CUDA device "
            "is available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device type {dev.type!r} (cuda or cpu)")
    return dev
