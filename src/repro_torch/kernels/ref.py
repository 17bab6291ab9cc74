"""Dense-mask oracle attention (counterpart of ``repro.kernels.ref``).

Layout convention throughout the kernels package::

    q        : (B, Lq, H, D)
    k, v     : (B, Lk, Hkv, Dv)     (GQA: H % Hkv == 0)
    mask     : (B, Lq, Lk) bool     (True = visible)
    returns  : (B, Lq, H, Dv)

Scores and the softmax run in f32 whatever the input dtype; the result
is cast back to q's dtype.
"""

from __future__ import annotations

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: torch.Tensor | None, *,
                  scale: float | None = None,
                  softcap: float | None = None) -> torch.Tensor:
    B, Lq, H, D = q.shape
    Hkv = k.shape[2]
    Dv = v.shape[3]
    if H % Hkv:
        raise ValueError(f"H={H} is not a multiple of Hkv={Hkv}")
    g = H // Hkv
    if scale is None:
        scale = D ** -0.5
    qh = q.float().reshape(B, Lq, Hkv, g, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qh, k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    if mask is not None:
        s = torch.where(mask[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    if mask is not None:
        allmasked = ~mask.any(dim=-1)                       # (B, Lq)
        p = torch.where(allmasked[:, None, None, :, None], 0.0, p)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Lq, H, Dv).to(q.dtype)
