"""Tensor-level building blocks (counterpart of ``repro.models.modules``).

Parameters are plain dicts of tensors; linear weights keep the
reference's ``(d_in, d_out)`` layout so converting a JAX parameter tree
is a copy.  ``param_dtype`` is the storage dtype, ``dtype`` the compute
dtype.
"""

from __future__ import annotations

import math

import torch


def normal_init(gen: torch.Generator, shape, scale: float, dtype,
                device) -> torch.Tensor:
    """N(0, scale^2) drawn in f32 from ``gen`` on ``device``."""
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=device)
    return (x * scale).to(dtype)


def lecun_init(gen, shape, fan_in: int, dtype, device) -> torch.Tensor:
    return normal_init(gen, shape, 1.0 / math.sqrt(max(fan_in, 1)), dtype,
                       device)


def linear(w: torch.Tensor, x: torch.Tensor, *, dtype=None) -> torch.Tensor:
    """x @ w with w in (d_in, d_out) layout."""
    if dtype is not None:
        w, x = w.to(dtype), x.to(dtype)
    return x @ w


def embed(table: torch.Tensor, ids: torch.Tensor, *, dtype=None):
    x = table[ids.long()]
    return x if dtype is None else x.to(dtype)


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding in f32: logits = x @ table.T."""
    return x.float() @ table.float().T


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * (1.0 + scale.float())).to(dt)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate pairs (split-half convention).  x (B, L, H, D); positions
    (B, L)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)
    ang = positions[..., None].float() * freqs            # (B, L, d/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Logit soft-capping: cap * tanh(x / cap)."""
    return cap * torch.tanh(x / cap)

