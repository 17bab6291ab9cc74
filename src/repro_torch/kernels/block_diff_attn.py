"""K1: block-diffusion flash-attention forward (CUDA, ``sm_90a``).

Replaces the Pallas TPU kernel ``repro/kernels/block_diff_attn.py::
_kernel`` (launched by ``_forward``).  The kernel source is
``csrc/block_diff_attn.cu``; its header note says what bounds it on the
H100 and what the design does about it.

``block_diff_attention`` is the wrapper: a CPU tensor takes the plain
PyTorch version ``block_diff_attention_plain`` (dense masked softmax
over all keys), a CUDA tensor launches the kernel or raises — there is
no fallback.  ``block_diff_attention.launches`` counts kernel launches.

The kernel visits only the kv tiles listed for each q tile in a CSR
list (``tile_csr``), built from the conservative tile map
(``ops.build_tile_map``): row offsets over the B * n_q_tiles rows plus
kv-tile indices, the counterpart of ``_compact_tiles``.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import NEG_INF

TILE = 64                  # q rows and kv keys per kernel tile
INVALID_COPY = 2           # matches no predicate clause -> never visible
_PAD = 1 << 30             # meta padding: block/step/pos of ragged tiles


def pad_meta(meta: torch.Tensor, length: int) -> torch.Tensor:
    """Pad packed meta (B, L, 4) to ``length`` rows with invisible
    positions (copy INVALID, huge block/step/pos, so tile-map bounds
    stay conservative)."""
    B, L, _ = meta.shape
    if L == length:
        return meta
    pad = meta.new_full((B, length - L, 4), _PAD)
    pad[..., 0] = INVALID_COPY
    return torch.cat([meta, pad], dim=1)


def tile_csr(tile_map: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, nq, nk) tile map -> CSR (row_ptr (B*nq + 1,), col_idx) int32.

    Row ``b * nq + qi`` lists its visited kv tiles in ascending order.
    Built with scatters only (no host sync); ``col_idx`` has room for
    every tile and the entries past ``row_ptr[-1]`` are unused.
    """
    B, nq, nk = tile_map.shape
    R = B * nq
    vis = (tile_map > 0).reshape(R, nk)
    counts = vis.sum(dim=1, dtype=torch.int32)
    row_ptr = torch.zeros(R + 1, dtype=torch.int32, device=vis.device)
    row_ptr[1:] = torch.cumsum(counts, 0)
    rank = torch.cumsum(vis.to(torch.int32), dim=1) - 1
    dest = torch.where(vis, row_ptr[:-1, None] + rank, R * nk)
    cols = torch.arange(nk, dtype=torch.int32, device=vis.device)
    col_idx = torch.zeros(R * nk + 1, dtype=torch.int32, device=vis.device)
    col_idx.scatter_(0, dest.reshape(-1).long(),
                     cols.expand(R, nk).reshape(-1))
    return row_ptr, col_idx[:R * nk]


def visibility_packed(q_meta: torch.Tensor, k_meta: torch.Tensor, *,
                      window: int | None, strict: bool) -> torch.Tensor:
    """The kernel's predicate on packed meta: (B, Lq, Lk) bool."""
    qc, qb, qs, qp = (q_meta[..., i, None] for i in range(4))
    kc, kb, ks, kp = (k_meta[..., None, :, i] for i in range(4))
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
    vis = vis & (qc != INVALID_COPY)
    if window is not None:
        vis = vis & ((qp - kp) < window)
    return vis


def block_diff_attention_plain(q, k, v, q_meta, k_meta, *, scale,
                               softcap=None, window=None, strict=False):
    """Plain PyTorch version of K1: dense masked softmax in f32 over all
    keys (empty rows give zeros), output in q's dtype."""
    B, Lq, H, D = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    vis = visibility_packed(q_meta, k_meta, window=window, strict=strict)
    qf = q.float().reshape(B, Lq, Hkv, g, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    m = vis[:, None, None]
    s = torch.where(m, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * m
    l = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(l == 0, 1.0, l)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Lq, H, v.shape[-1]).to(q.dtype)


def _dtype_code(t: torch.Tensor) -> int:
    if t.dtype == torch.float32:
        return 0
    if t.dtype == torch.bfloat16:
        return 1
    raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}")


def _check_cuda(*ts: torch.Tensor) -> None:
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError("all operands must be on one device")
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")


_BDA_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                 + [ctypes.c_float, ctypes.c_float]
                 + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def block_diff_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         q_meta: torch.Tensor, k_meta: torch.Tensor,
                         row_ptr: torch.Tensor | None = None,
                         col_idx: torch.Tensor | None = None, *,
                         scale: float | None = None,
                         softcap: float | None = None,
                         window: int | None = None,
                         strict: bool = False) -> torch.Tensor:
    """Flash attention under the block-diffusion mask.

    q (B, Lq, H, D); k, v (B, Lk, Hkv, D|Dv); q_meta (B, Lq, 4) and
    k_meta (B, Lk, 4) int32 [copy, block, step, pos], copy == 2 on
    invalid positions; row_ptr/col_idx the CSR tile list over
    ``TILE``-sized tiles (``tile_csr``; built here when omitted).
    Returns (B, Lq, H, Dv) in q's dtype.
    """
    D = q.shape[-1]
    if scale is None:
        scale = D ** -0.5
    if q.device.type == "cpu":
        return block_diff_attention_plain(
            q, k, v, q_meta, k_meta, scale=scale, softcap=softcap,
            window=window, strict=strict)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    B, Lq, H, _ = q.shape
    _, Lk, Hkv, Dv = v.shape
    if k.shape != (B, Lk, Hkv, D) or H % Hkv or max(D, Dv) > 128:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k, v must share one dtype")
    nq = -(-Lq // TILE)
    if row_ptr is None:
        from .ops import build_tile_map
        nk = -(-Lk // TILE)
        tm = build_tile_map(pad_meta(q_meta, nq * TILE),
                            pad_meta(k_meta, nk * TILE), TILE, TILE,
                            window=window)
        row_ptr, col_idx = tile_csr(tm)
    q_meta = q_meta.to(torch.int32).contiguous()
    k_meta = k_meta.to(torch.int32).contiguous()
    row_ptr = row_ptr.to(torch.int32).contiguous()
    col_idx = col_idx.to(torch.int32).contiguous()
    if row_ptr.shape != (B * nq + 1,):
        raise ValueError(f"row_ptr must have {B * nq + 1} entries")
    _check_cuda(q, k, v, q_meta, k_meta, row_ptr, col_idx)
    o = torch.empty((B, Lq, H, Dv), dtype=q.dtype, device=q.device)
    fn = build.function("block_diff_attn", "bda_forward", _BDA_ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), q_meta.data_ptr(),
            k_meta.data_ptr(), row_ptr.data_ptr(), col_idx.data_ptr(),
            o.data_ptr(), B, Lq, Lk, H, Hkv, D, Dv, nq, float(scale),
            float(softcap or 0.0), -1 if window is None else int(window),
            int(bool(strict)), _dtype_code(q), build.stream_ptr(q))
    build.check(rc, "block_diff_attention")
    block_diff_attention.launches += 1
    return o


block_diff_attention.launches = 0
