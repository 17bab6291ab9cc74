"""Dispatcher for block-diffusion attention (counterpart of
``repro.kernels.ops``).

Three implementations of one contract, all taking (q, k, v) in
(B, L, H|Hkv, D) layout plus ``SeqMeta``:

* ``ref``     — dense-mask oracle (``ref.mha_reference``);
* ``chunked`` — flash-style chunk walk in plain PyTorch with running
                (m, l) statistics (``chunked_masked_attention``);
* ``cuda``    — the hand-written K1 kernel (``block_diff_attn``), which
                visits only the tiles the conservative tile map marks.
"""

from __future__ import annotations

import torch

from repro_torch.core.masks import SeqMeta, visibility
from . import ref as _ref
from .block_diff_attn import (INVALID_COPY, TILE, block_diff_attention,
                              pad_meta, tile_csr)

NEG_INF = _ref.NEG_INF
IMPLS = ("ref", "chunked", "cuda")


def pack_meta(meta: SeqMeta) -> torch.Tensor:
    """SeqMeta -> (B, L, 4) int32; invalid positions get copy=INVALID_COPY."""
    copy = torch.where(meta.valid, meta.copy,
                       torch.full_like(meta.copy, INVALID_COPY))
    return torch.stack([copy, meta.block, meta.step, meta.pos],
                       dim=-1).to(torch.int32)


def build_tile_map(q_meta: torch.Tensor, k_meta: torch.Tensor, tq: int,
                   tk: int, *, window: int | None = None) -> torch.Tensor:
    """Conservative block-sparse map, (B, Lq//tq, Lk//tk) int32:
    0 = provably empty, 1 = partial, 2 = provably full — decided from
    per-tile channel min/max only."""
    B, Lq, _ = q_meta.shape
    Lk = k_meta.shape[1]
    qm = q_meta.reshape(B, Lq // tq, tq, 4)
    km = k_meta.reshape(B, Lk // tk, tk, 4)
    qmin, qmax = qm.amin(dim=2), qm.amax(dim=2)      # (B, nq, 4)
    kmin, kmax = km.amin(dim=2), km.amax(dim=2)      # (B, nk, 4)

    def q_(a, i):
        return a[..., i][:, :, None]

    def k_(a, i):
        return a[..., i][:, None, :]

    COPY, BLOCK, STEP, POS = 0, 1, 2, 3
    any_a_q = q_(qmin, COPY) <= 0
    any_b_q = (q_(qmin, COPY) <= 1) & (q_(qmax, COPY) >= 1)
    any_a_k = k_(kmin, COPY) <= 0
    any_b_k = (k_(kmin, COPY) <= 1) & (k_(kmax, COPY) >= 1)

    c1 = any_a_q & any_a_k & (k_(kmin, BLOCK) <= q_(qmax, BLOCK))
    c2 = any_b_q & any_a_k & (k_(kmin, BLOCK) <= q_(qmax, BLOCK))
    c3 = (any_b_q & any_b_k
          & (k_(kmin, BLOCK) <= q_(qmax, BLOCK))
          & (k_(kmax, BLOCK) >= q_(qmin, BLOCK))
          & (k_(kmax, STEP) >= q_(qmin, STEP)))
    needed = c1 | c2 | c3
    if window is not None:
        needed = needed & ((q_(qmin, POS) - k_(kmax, POS)) < window)

    all_a_q = q_(qmax, COPY) == 0
    all_b_q = (q_(qmin, COPY) == 1) & (q_(qmax, COPY) == 1)
    all_a_k = k_(kmax, COPY) == 0
    full_aa = all_a_q & all_a_k & (k_(kmax, BLOCK) <= q_(qmin, BLOCK))
    full_ba = all_b_q & all_a_k & (k_(kmax, BLOCK) < q_(qmin, BLOCK))
    full = full_aa | full_ba
    if window is not None:
        full = full & ((q_(qmax, POS) - k_(kmin, POS)) < window)
    return needed.to(torch.int32) + (needed & full).to(torch.int32)


def _pick_chunk(length: int, target: int) -> int:
    """Largest divisor of ``length`` that is <= target."""
    c = min(target, length)
    while length % c:
        c -= 1
    return c


def chunked_masked_attention(q, k, v, q_meta: SeqMeta, k_meta: SeqMeta, *,
                             scale=None, softcap=None, window=None,
                             strict: bool = False, q_chunk: int = 512,
                             k_chunk: int = 1024):
    """Flash-style attention in plain PyTorch: a walk over q/kv chunks
    with running (m, l) statistics; never holds more than
    (q_chunk, k_chunk) scores per head.  Returns (B, Lq, H, Dv)."""
    B, Lq, H, D = q.shape
    _, Lk, Hkv, Dv = v.shape
    g = H // Hkv
    if scale is None:
        scale = D ** -0.5
    qc = _pick_chunk(Lq, q_chunk)
    kc = _pick_chunk(Lk, k_chunk)
    qh = q.reshape(B, Lq, Hkv, g, D).float()
    kf, vf = k.float(), v.float()
    outs = []
    for q0 in range(0, Lq, qc):
        qs = qh[:, q0:q0 + qc]
        qm = q_meta.slice_t(q0, qc)
        acc = q.new_zeros((B, Hkv, g, qc, Dv), dtype=torch.float32)
        m = torch.full((B, Hkv, g, qc, 1), NEG_INF, device=q.device)
        l = torch.zeros((B, Hkv, g, qc, 1), device=q.device)
        for k0 in range(0, Lk, kc):
            km = k_meta.slice_t(k0, kc)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qs,
                             kf[:, k0:k0 + kc]) * scale
            if softcap is not None:
                s = softcap * torch.tanh(s / softcap)
            vis = visibility(qm, km, window=window, strict=strict)
            vis = vis[:, None, None]
            s = torch.where(vis, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new) * vis
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bhgqk,bkhd->bhgqd", p,
                                             vf[:, k0:k0 + kc])
            m = m_new
        outs.append(acc / torch.where(l == 0, 1.0, l))
    out = torch.cat(outs, dim=3).reshape(B, H, Lq, Dv)
    return out.transpose(1, 2).to(q.dtype)


def attention(q, k, v, q_meta: SeqMeta, k_meta: SeqMeta, *,
              impl: str = "chunked", scale: float | None = None,
              softcap: float | None = None, window: int | None = None,
              strict: bool = False) -> torch.Tensor:
    """Block-diffusion attention with a selectable backend."""
    if impl == "ref":
        vis = visibility(q_meta, k_meta, window=window, strict=strict)
        return _ref.mha_reference(q, k, v, vis, scale=scale,
                                  softcap=softcap)
    if impl == "chunked":
        return chunked_masked_attention(
            q, k, v, q_meta, k_meta, scale=scale, softcap=softcap,
            window=window, strict=strict)
    if impl == "cuda":
        Lq, Lk = q.shape[1], k.shape[1]
        nq, nk = -(-Lq // TILE), -(-Lk // TILE)
        qm = pack_meta(q_meta)
        km = pack_meta(k_meta)
        tile_map = build_tile_map(pad_meta(qm, nq * TILE),
                                  pad_meta(km, nk * TILE), TILE, TILE,
                                  window=window)
        row_ptr, col_idx = tile_csr(tile_map)
        return block_diff_attention(
            q, k, v, qm, km, row_ptr, col_idx, scale=scale,
            softcap=softcap, window=window, strict=strict)
    raise ValueError(f"unknown attention impl {impl!r}; one of {IMPLS}")
