"""K4 and K5: attention that reads the KV page pool in place (CUDA).

``paged_decode_attention`` (K4) replaces ``repro/kernels/paged_attn.py::
_kernel`` (``paged_decode_attention``): one block of queries per
sequence over the pool pages of its block table, then the block's own
fresh keys.  ``paged_prefill_attention`` (K5) replaces ``_prefill_kernel``
(``paged_prefill_attention``): plain-mode attention of suffix queries
over the hit-prefix pages, then the suffix's own keys.  Both kernels live
in ``csrc/paged_attn.cu``, whose header note says what bounds them on
the H100 and what the design does about it.

Each wrapper evaluates its plain PyTorch version (``*_plain``: the pages
gathered through the table, then a dense masked softmax in f32) for CPU
tensors, and launches its kernel or raises for CUDA tensors.  Launches
are counted in ``<wrapper>.launches``.

The TPU (8, 128) tile padding and ``plan_exec``/``KernelPlan`` have no
meaning on the card and have no counterpart here.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .block_diff_attn import _check_cuda, _dtype_code
from .ref import NEG_INF

_INT32_MAX = 2 ** 31 - 1


def _masked_softmax_attend(q, keys, vals, mask, *, scale, softcap):
    """q (B, n, H, Dk) over keys (B, S, Hkv, Dk) under mask (B, n, S):
    f32 scores, empty rows zero, output in q's dtype."""
    B, n, H, Dk = q.shape
    Hkv = keys.shape[2]
    g = H // Hkv
    qf = q.float().reshape(B, n, Hkv, g, Dk)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, keys.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    m = mask[:, None, None]
    s = torch.where(m, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * m
    l = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(l == 0, 1.0, l)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, vals.float())
    return o.reshape(B, n, H, vals.shape[-1]).to(q.dtype)


def _gather_pages(pages, pos_pages, table):
    """(B, K) table -> keys (B, K*bsz, ...) and positions (B, K*bsz);
    entries of -1 read page 0 with their positions forced to -1."""
    B, K = table.shape
    bsz = pages.shape[1]
    idx = table.clamp(min=0).long()
    g = pages[idx].reshape(B, K * bsz, *pages.shape[2:])
    pos = torch.where(table[:, :, None] >= 0, pos_pages[idx], -1)
    return g, pos.reshape(B, K * bsz)


def paged_decode_attention_plain(q, k_pages, v_pages, pos_pages, table,
                                 k_self, v_self, positions, cache_limit, *,
                                 scale, softcap=None, window=None):
    """Plain PyTorch version of K4."""
    ck, cpos = _gather_pages(k_pages, pos_pages, table)
    cv, _ = _gather_pages(v_pages, pos_pages, table)
    keys = torch.cat([ck.to(k_self.dtype), k_self], dim=1)
    vals = torch.cat([cv.to(v_self.dtype), v_self], dim=1)
    cvalid = (cpos >= 0) & (cpos < cache_limit[:, None])
    key_pos = torch.cat([cpos, positions.to(cpos.dtype)], dim=1)
    key_ok = torch.cat([cvalid, positions >= 0], dim=1)
    mask = key_ok[:, None, :].expand(-1, q.shape[1], -1)
    if window is not None:
        mask = mask & ((positions[:, :, None] - key_pos[:, None, :])
                       < window)
    return _masked_softmax_attend(q, keys, vals, mask, scale=scale,
                                  softcap=softcap)


def paged_prefill_attention_plain(q, k_pages, v_pages, pos_pages,
                                  context_table, k_self, v_self, positions,
                                  *, scale, softcap=None, window=None):
    """Plain PyTorch version of K5."""
    bsz = k_pages.shape[1]
    ck, cpos = _gather_pages(k_pages, pos_pages, context_table)
    cv, _ = _gather_pages(v_pages, pos_pages, context_table)
    keys = torch.cat([ck.to(k_self.dtype), k_self], dim=1)
    vals = torch.cat([cv.to(v_self.dtype), v_self], dim=1)
    key_pos = torch.cat([cpos, positions.to(cpos.dtype)], dim=1)
    kp = key_pos[:, None, :]
    qp = positions[:, :, None]
    mask = (kp >= 0) & (torch.div(kp, bsz, rounding_mode="floor")
                        <= torch.div(qp, bsz, rounding_mode="floor"))
    if window is not None:
        mask = mask & ((qp - kp) < window)
    return _masked_softmax_attend(q, keys, vals, mask, scale=scale,
                                  softcap=softcap)


def _check_pool(q, k_pages, v_pages, k_self, v_self):
    H, Dk = q.shape[2], q.shape[3]
    P, bsz, Hkv, _ = k_pages.shape
    Dv = v_pages.shape[-1]
    if (k_pages.shape[-1] != Dk or k_self.shape[-1] != Dk
            or v_self.shape[-1] != Dv or H % Hkv or H // Hkv > 64
            or max(Dk, Dv) > 128 or bsz > 64):
        raise ValueError(
            f"unsupported paged shapes q{tuple(q.shape)} "
            f"pages{tuple(k_pages.shape)}/{tuple(v_pages.shape)}")
    if not (q.dtype == k_pages.dtype == v_pages.dtype == k_self.dtype
            == v_self.dtype):
        raise TypeError("q, pages and self keys must share one dtype")
    return bsz, Hkv, Dk, Dv


def _i32(t):
    return t.to(torch.int32).contiguous()


_DECODE_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                    + [ctypes.c_float, ctypes.c_float]
                    + [ctypes.c_int] * 2 + [ctypes.c_void_p])
_PREFILL_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                     + [ctypes.c_float, ctypes.c_float]
                     + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def paged_decode_attention(q, k_pages, v_pages, pos_pages, table, k_self,
                           v_self, positions, cache_limit=None, *, scale,
                           softcap=None, window=None) -> torch.Tensor:
    """Decode attention over (pool pages ++ self block), in place.

    q (B, n, H, Dk) with n == page size; k_pages (P, bsz, Hkv, Dk),
    v_pages (P, bsz, Hkv, Dv); pos_pages (P, bsz) int32 (-1 = empty);
    table (B, K) int32 (-1 = no page); k_self/v_self (B, n, Hkv, ·);
    positions (B, n); cache_limit (B,) — pool keys are visible iff
    pos < cache_limit[b] (None = no limit).  Returns (B, n, H, Dv).
    """
    B, n = q.shape[:2]
    if cache_limit is None:
        cache_limit = torch.full((B,), _INT32_MAX, dtype=torch.int32,
                                 device=q.device)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_pages, v_pages, pos_pages, table, k_self, v_self,
            positions, cache_limit, scale=scale, softcap=softcap,
            window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    bsz, Hkv, Dk, Dv = _check_pool(q, k_pages, v_pages, k_self, v_self)
    if n != bsz:
        raise ValueError(f"decode block {n} != page size {bsz}")
    H, K = q.shape[2], table.shape[1]
    pos_pages, table = _i32(pos_pages), _i32(table)
    positions, cache_limit = _i32(positions), _i32(cache_limit)
    _check_cuda(q, k_pages, v_pages, pos_pages, table, k_self, v_self,
                positions, cache_limit)
    o = torch.empty((B, n, H, Dv), dtype=q.dtype, device=q.device)
    fn = build.function("paged_attn", "paged_decode", _DECODE_ARGTYPES)
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            pos_pages.data_ptr(), table.data_ptr(), k_self.data_ptr(),
            v_self.data_ptr(), positions.data_ptr(), cache_limit.data_ptr(),
            o.data_ptr(), B, n, H, Hkv, Dk, Dv, bsz, K, float(scale),
            float(softcap or 0.0), -1 if window is None else int(window),
            _dtype_code(q), build.stream_ptr(q))
    build.check(rc, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return o


def paged_prefill_attention(q, k_pages, v_pages, pos_pages, context_table,
                            k_self, v_self, positions, *, scale,
                            softcap=None, window=None) -> torch.Tensor:
    """Plain-mode attention of suffix queries over (prefix pages ++
    suffix self keys), reading the pool in place.

    q (B, T, H, Dk); context_table (B, Kp) int32; k_self/v_self
    (B, T, Hkv, ·); positions (B, T) absolute suffix positions.
    Returns (B, T, H, Dv).
    """
    if q.device.type == "cpu":
        return paged_prefill_attention_plain(
            q, k_pages, v_pages, pos_pages, context_table, k_self, v_self,
            positions, scale=scale, softcap=softcap, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    bsz, Hkv, Dk, Dv = _check_pool(q, k_pages, v_pages, k_self, v_self)
    B, T, H, _ = q.shape
    Kp = context_table.shape[1]
    pos_pages, context_table = _i32(pos_pages), _i32(context_table)
    positions = _i32(positions)
    _check_cuda(q, k_pages, v_pages, pos_pages, context_table, k_self,
                v_self, positions)
    o = torch.empty((B, T, H, Dv), dtype=q.dtype, device=q.device)
    fn = build.function("paged_attn", "paged_prefill", _PREFILL_ARGTYPES)
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            pos_pages.data_ptr(), context_table.data_ptr(),
            k_self.data_ptr(), v_self.data_ptr(), positions.data_ptr(),
            o.data_ptr(), B, T, H, Hkv, Dk, Dv, bsz, Kp, float(scale),
            float(softcap or 0.0), -1 if window is None else int(window),
            _dtype_code(q), build.stream_ptr(q))
    build.check(rc, "paged_prefill_attention")
    paged_prefill_attention.launches += 1
    return o


paged_decode_attention.launches = 0
paged_prefill_attention.launches = 0
