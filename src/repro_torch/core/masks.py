"""Block-diffusion attention-mask algebra (counterpart of
``repro.core.masks``): ``SeqMeta``, the dense ``visibility`` oracle and
the committed-context ``plain_layout`` the serving path uses.

Copy A holds clean tokens, copy B the all-[MASK] query rows of the
duplicated layouts; ``step`` is a token's reveal step.  The predicate is
the same one the K1 kernel evaluates per tile
(``kernels/csrc/block_diff_attn.cu``).  The duplicated (dirl), packed
and tracer layouts come with the training slice.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class SeqMeta:
    """Per-position metadata, each field (..., T): ``copy`` (0 = clean A,
    1 = mask-row B), ``block``, ``step``, ``pos`` (int32) and ``valid``
    (bool)."""

    copy: torch.Tensor
    block: torch.Tensor
    step: torch.Tensor
    pos: torch.Tensor
    valid: torch.Tensor

    def slice_t(self, start: int, size: int) -> "SeqMeta":
        return SeqMeta(*(getattr(self, f.name)[..., start:start + size]
                         for f in dataclasses.fields(self)))

    def cat(self, other: "SeqMeta") -> "SeqMeta":
        return SeqMeta(*(torch.cat([getattr(self, f.name),
                                    getattr(other, f.name)], dim=-1)
                         for f in dataclasses.fields(self)))


def visibility(q: SeqMeta, k: SeqMeta, *, window: int | None = None,
               strict: bool = False) -> torch.Tensor:
    """Dense visibility mask (..., Tq, Tk) bool — the oracle form of the
    predicate (see ``repro.core.masks.visibility`` for the semantics of
    ``strict``)."""
    qc, kc = q.copy[..., :, None], k.copy[..., None, :]
    qb, kb = q.block[..., :, None], k.block[..., None, :]
    qs, ks = q.step[..., :, None], k.step[..., None, :]
    qp, kp = q.pos[..., :, None], k.pos[..., None, :]

    k_is_a = kc == 0
    k_is_b = kc == 1
    vis_a_query = k_is_a & (kb <= qb)
    if strict:
        ctx = k_is_a & (kb < qb)
        own = k_is_b & (kb == qb) & (ks == qs)
    else:
        ctx = k_is_a & ((kb < qb) | ((kb == qb) & (ks < qs)))
        own = k_is_b & (kb == qb) & (ks >= qs)
    vis = torch.where(qc == 0, vis_a_query, ctx | own)
    if window is not None:
        vis = vis & ((qp - kp) < window)
    return vis & q.valid[..., :, None] & k.valid[..., None, :]


def plain_layout(tokens: torch.Tensor, valid: torch.Tensor, *,
                 block_size: int) -> SeqMeta:
    """Committed-context layout (prefill / cache commit), copy A only."""
    B, L = tokens.shape
    dev = tokens.device
    pos = torch.arange(L, dtype=torch.int32, device=dev).expand(B, L)
    zeros = torch.zeros((B, L), dtype=torch.int32, device=dev)
    return SeqMeta(copy=zeros, block=pos // block_size, step=zeros.clone(),
                   pos=pos, valid=valid)
