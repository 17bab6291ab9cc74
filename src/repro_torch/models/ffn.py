"""Dense SwiGLU feed-forward (counterpart of ``repro.models.ffn.swiglu``)."""

from __future__ import annotations

import torch
from torch.nn.functional import silu

from .modules import linear


def swiglu(p: dict, x: torch.Tensor) -> torch.Tensor:
    return linear(p["w_down"],
                  silu(linear(p["w_gate"], x)) * linear(p["w_up"], x))
