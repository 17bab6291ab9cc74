"""PyTorch / CUDA port of the DiRL serving path for one NVIDIA H100.

The package mirrors ``src/repro``'s layout (``models/``, ``core/``,
``kernels/``, ``serving/``, ``data/``, ``launch/``, ``configs/``) so each
module's counterpart is easy to find.  It imports ``torch``, numpy and
the standard library only.

Every entry point takes an explicit ``device`` that defaults to
``"cuda"``; asking for the card on a machine without one raises instead
of silently running on the CPU.  Tests pass ``device="cpu"``, where the
kernel wrappers evaluate their plain PyTorch versions.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``; raise if it names a CUDA
    card that this process cannot see."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is "
            "available; pass device='cpu' to run the plain versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev
