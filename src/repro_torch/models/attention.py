"""GQA attention over dense and paged KV caches (counterpart of the GQA
path of ``repro.models.attention``).

Caches store *rotated* keys with explicit position ids; ``pos < 0``
marks unfilled slots.  Unlike the functional reference, the port
updates caches **in place** (``index_copy_``): a functional copy of a
full-width page pool per write would cost a pool's worth of memory
traffic every commit.  Every write function therefore mutates its cache
argument and returns it.

Every paged attention pass — per-step decode and admission-time suffix
prefill — dispatches through one KV-layout object (``resolve_kv_layout``):

* ``dense``    (``AttnCache``) — contiguous per-sequence rows (prefill);
* ``gathered`` (``PagedAttnCache``, ``kernel="ref"``) — pages gathered
               through the block table into a dense-width copy, then the
               plain concat / chunked paths: the portable fallback and
               the parity oracle;
* ``paged``    (``PagedAttnCache``, ``kernel="cuda"``) — the in-place
               CUDA kernels K4 (decode) and K5 (suffix prefill).

All layouts share the masking contract: null page 0, ``pos = -1`` empty
slots, per-row ``cache_limit`` and the sliding window.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.masks import SeqMeta
from repro_torch.kernels import ops as kops
from repro_torch.kernels.paged_attn import (paged_decode_attention,
                                            paged_prefill_attention)
from repro_torch.kernels.ref import mha_reference
from .config import ModelConfig
from .modules import apply_rope, linear


@dataclasses.dataclass
class AttnCache:
    k: torch.Tensor     # (B, S, Hkv, Dk) rotated
    v: torch.Tensor     # (B, S, Hkv, Dv)
    pos: torch.Tensor   # (B, S) int32, -1 = empty


@dataclasses.dataclass
class PagedAttnCache:
    """A shared pool of ``block_size``-token KV pages.  A per-sequence
    block table maps block index -> page; -1 means "no page" (reads
    masked, writes dumped into the null page 0 with ``pos`` = -1)."""
    k: torch.Tensor     # (P, bsz, Hkv, Dk) rotated
    v: torch.Tensor     # (P, bsz, Hkv, Dv)
    pos: torch.Tensor   # (P, bsz) int32, -1 = empty


def make_attn_cache(batch, seq, n_kv, dk, dv, dtype, device) -> AttnCache:
    return AttnCache(
        k=torch.zeros((batch, seq, n_kv, dk), dtype=dtype, device=device),
        v=torch.zeros((batch, seq, n_kv, dv), dtype=dtype, device=device),
        pos=torch.full((batch, seq), -1, dtype=torch.int32, device=device))


def make_paged_attn_cache(n_pages, block_size, n_kv, dk, dv, dtype,
                          device) -> PagedAttnCache:
    return PagedAttnCache(
        k=torch.zeros((n_pages, block_size, n_kv, dk), dtype=dtype,
                      device=device),
        v=torch.zeros((n_pages, block_size, n_kv, dv), dtype=dtype,
                      device=device),
        pos=torch.full((n_pages, block_size), -1, dtype=torch.int32,
                       device=device))


def paged_gather(cache: PagedAttnCache, table: torch.Tensor):
    """Gather each sequence's pages into key order: (k, v, pos) of
    width K*bsz; table entries of -1 read the null page with pos -1."""
    B, K = table.shape
    idx = table.clamp(min=0).long()
    k, v, pos = cache.k[idx], cache.v[idx], cache.pos[idx]
    pos = torch.where(table[:, :, None] >= 0, pos, -1)
    bsz = cache.k.shape[1]
    return (k.reshape(B, K * bsz, *cache.k.shape[2:]),
            v.reshape(B, K * bsz, *cache.v.shape[2:]),
            pos.reshape(B, K * bsz))


def _write_pages(cache: PagedAttnCache, idx, k, v, pos) -> PagedAttnCache:
    idx = idx.long()
    cache.k.index_copy_(0, idx, k.to(cache.k.dtype))
    cache.v.index_copy_(0, idx, v.to(cache.v.dtype))
    cache.pos.index_copy_(0, idx, pos.to(torch.int32))
    return cache


def paged_cache_write(cache: PagedAttnCache, k, v, positions,
                      table) -> PagedAttnCache:
    """Commit one block per sequence into its own page; rows whose block
    has no page are dumped into the null page with ``pos`` = -1."""
    bsz = cache.k.shape[1]
    rows = torch.arange(k.shape[0], device=k.device)
    page = table[rows, positions[:, 0].long() // bsz]
    pos_w = torch.where(page[:, None] >= 0, positions.to(torch.int32), -1)
    return _write_pages(cache, page.clamp(min=0), k, v, pos_w)


def write_prompt_pages(cache: PagedAttnCache, row: AttnCache,
                       pages: torch.Tensor) -> PagedAttnCache:
    """Scatter a B=1 dense prefill row into freshly allocated pages
    (``pages`` (Kp,) receive the first Kp blocks)."""
    bsz = cache.k.shape[1]
    Kp = pages.shape[0]

    def blocks(a):
        L = a.shape[1]
        return a.reshape(L // bsz, bsz, *a.shape[2:])[:Kp]

    return _write_pages(cache, pages, blocks(row.k), blocks(row.v),
                        blocks(row.pos))


def write_suffix_pages(cache: PagedAttnCache, k, v, positions,
                       pages) -> PagedAttnCache:
    """Commit block-aligned suffix K/V (B, T, ...) into per-row pages
    (B, T // bsz)."""
    bsz = cache.k.shape[1]
    B, T = positions.shape

    def blocks(a):
        return a.reshape(B * (T // bsz), bsz, *a.shape[2:])

    return _write_pages(cache, pages.reshape(-1), blocks(k), blocks(v),
                        blocks(positions))


def wipe_pages(cache: PagedAttnCache, pages) -> PagedAttnCache:
    """Force ``pos = -1`` on ``pages`` (free-list / reclaim hygiene)."""
    cache.pos[pages.long()] = -1
    return cache


def cache_write(cache: AttnCache, k, v, positions) -> AttnCache:
    """Write a block of rotated keys at ``positions`` (B, n), modulo the
    cache length (ring buffers)."""
    S = cache.k.shape[1]
    idx = positions.long() % S
    bidx = torch.arange(k.shape[0], device=k.device)[:, None]
    cache.k[bidx, idx] = k.to(cache.k.dtype)
    cache.v[bidx, idx] = v.to(cache.v.dtype)
    cache.pos[bidx, idx] = positions.to(torch.int32)
    return cache


def write_prefill_cache(cache: AttnCache, k, v, positions) -> AttnCache:
    """Write a full prefill's keys; a shorter (ring) buffer keeps only
    the last S entries."""
    S = cache.k.shape[1]
    if k.shape[1] > S:
        k, v, positions = k[:, -S:], v[:, -S:], positions[:, -S:]
    return cache_write(cache, k, v, positions)


def _paged_context_kv(cache: PagedAttnCache, context_table, k_self,
                      v_self, meta: SeqMeta, block_size: int):
    """(keys, vals, k_meta) = gathered shared-prefix pages ++ suffix."""
    ck, cv, cpos = paged_gather(cache, context_table)
    keys = torch.cat([ck.to(k_self.dtype), k_self], dim=1)
    vals = torch.cat([cv.to(v_self.dtype), v_self], dim=1)
    cvalid = cpos >= 0
    zeros = torch.zeros_like(cpos)
    cmeta = SeqMeta(copy=zeros, block=torch.where(
        cvalid, torch.div(cpos, block_size, rounding_mode="floor"), -1),
        step=zeros, pos=cpos, valid=cvalid)
    return keys, vals, cmeta.cat(meta)


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------


def _gqa_scale(cfg: ModelConfig) -> float:
    return cfg.query_scale or cfg.resolved_head_dim ** -0.5


def gqa_qkv(p, x, positions, cfg: ModelConfig):
    B, T, _ = x.shape
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = linear(p["wq"], x).reshape(B, T, H, Dh)
    k = linear(p["wk"], x).reshape(B, T, Hkv, Dh)
    v = linear(p["wv"], x).reshape(B, T, Hkv, Dh)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def gqa_masked(p, x, meta: SeqMeta, cfg: ModelConfig, *,
               window: int | None):
    """Plain mode: the mask comes from SeqMeta (K1 under
    ``attn_impl="cuda"``).  Returns (out, k, v) so prefill can fill the
    cache."""
    B, T, _ = x.shape
    q, k, v = gqa_qkv(p, x, meta.pos, cfg)
    o = kops.attention(q, k, v, meta, meta, impl=cfg.attn_impl,
                       scale=_gqa_scale(cfg),
                       softcap=cfg.attn_logit_softcap or None,
                       window=window)
    return linear(p["wo"], o.reshape(B, T, -1)), k, v


def gqa_plain_paged(p, x, meta: SeqMeta, cache: PagedAttnCache,
                    cfg: ModelConfig, *, window, context_table,
                    write_pages, kernel: str = "ref"):
    """Plain committed pass over a prompt suffix against shared-prefix
    pages; commits the suffix K/V into ``write_pages``."""
    B, T, _ = x.shape
    q, k, v = gqa_qkv(p, x, meta.pos, cfg)
    o = resolve_kv_layout(cache, kernel).prefill_attend(
        q, k, v, meta, cache, context_table=context_table,
        block_size=cfg.block_size, impl=cfg.attn_impl,
        scale=_gqa_scale(cfg), softcap=cfg.attn_logit_softcap or None,
        window=window)
    write_suffix_pages(cache, k, v, meta.pos, write_pages)
    return linear(p["wo"], o.reshape(B, T, -1)), cache


def _decode_key_mask(cache_pos, positions, cache_limit):
    cvalid = cache_pos >= 0
    if cache_limit is not None:
        cvalid = cvalid & (cache_pos < cache_limit[:, None])
    return torch.cat([cvalid, torch.ones_like(positions, dtype=torch.bool)],
                     dim=1)


class KVLayout:
    """How a layer's cached keys reach the attention math: ``attend``
    (decode step) and ``prefill_attend`` (plain pass of suffix queries
    over shared-prefix pages ++ suffix keys)."""

    kind = "?"

    def attend(self, q, k_self, v_self, positions, cache, *, block_table,
               cache_limit, scale, softcap, window):
        raise NotImplementedError

    def prefill_attend(self, q, k_self, v_self, meta, cache, *,
                       context_table, block_size, impl, scale, softcap,
                       window):
        raise NotImplementedError

    def commit(self, cache, k_self, v_self, positions, block_table):
        if isinstance(cache, PagedAttnCache):
            return paged_cache_write(cache, k_self, v_self, positions,
                                     block_table)
        return cache_write(cache, k_self, v_self, positions)

    @staticmethod
    def _concat_attend(ck, cv, cpos, q, k_self, v_self, positions, *,
                       cache_limit, scale, softcap, window):
        keys = torch.cat([ck.to(k_self.dtype), k_self], dim=1)
        vals = torch.cat([cv.to(v_self.dtype), v_self], dim=1)
        key_pos = torch.cat([cpos, positions.to(torch.int32)], dim=1)
        key_valid = _decode_key_mask(cpos, positions, cache_limit)
        mask = key_valid[:, None, :].expand(-1, q.shape[1], -1)
        if window is not None:
            mask = mask & ((positions[:, :, None] - key_pos[:, None, :])
                           < window)
        return mha_reference(q, keys, vals, mask, scale=scale,
                             softcap=softcap)

    @staticmethod
    def transient_bytes(cache, n_rows: int, n_blocks: int) -> int:
        return 0

    @staticmethod
    def prefill_transient_bytes(cache, n_rows: int,
                                n_ctx_blocks: int) -> int:
        return 0


def _kv_token_bytes(cache) -> int:
    hkv, dk = cache.k.shape[-2], cache.k.shape[-1]
    return hkv * (dk * cache.k.element_size()
                  + cache.v.shape[-1] * cache.v.element_size()) + 4


class _DenseKV(KVLayout):
    kind = "dense"

    def attend(self, q, k_self, v_self, positions, cache, *, block_table,
               cache_limit, scale, softcap, window):
        return self._concat_attend(
            cache.k, cache.v, cache.pos, q, k_self, v_self, positions,
            cache_limit=cache_limit, scale=scale, softcap=softcap,
            window=window)


class _GatheredPagedKV(KVLayout):
    """``kernel="ref"``: gather the pool into a dense-width copy, then
    the plain concat / masked-attention paths."""

    kind = "gathered"

    def attend(self, q, k_self, v_self, positions, cache, *, block_table,
               cache_limit, scale, softcap, window):
        ck, cv, cpos = paged_gather(cache, block_table)
        return self._concat_attend(
            ck, cv, cpos, q, k_self, v_self, positions,
            cache_limit=cache_limit, scale=scale, softcap=softcap,
            window=window)

    def prefill_attend(self, q, k_self, v_self, meta, cache, *,
                       context_table, block_size, impl, scale, softcap,
                       window):
        keys, vals, k_meta = _paged_context_kv(
            cache, context_table, k_self, v_self, meta, block_size)
        return kops.attention(q, keys, vals, meta, k_meta, impl=impl,
                              scale=scale, softcap=softcap, window=window)

    @staticmethod
    def transient_bytes(cache, n_rows: int, n_blocks: int) -> int:
        return n_rows * n_blocks * cache.k.shape[1] * _kv_token_bytes(cache)

    @staticmethod
    def prefill_transient_bytes(cache, n_rows: int,
                                n_ctx_blocks: int) -> int:
        return (n_rows * n_ctx_blocks * cache.k.shape[1]
                * _kv_token_bytes(cache))


class _InplacePagedKV(KVLayout):
    """``kernel="cuda"``: K4 and K5 read the pool in place."""

    kind = "paged"

    def attend(self, q, k_self, v_self, positions, cache, *, block_table,
               cache_limit, scale, softcap, window):
        return paged_decode_attention(
            q, cache.k, cache.v, cache.pos, block_table, k_self, v_self,
            positions, cache_limit, scale=scale, softcap=softcap,
            window=window)

    def prefill_attend(self, q, k_self, v_self, meta, cache, *,
                       context_table, block_size, impl, scale, softcap,
                       window):
        return paged_prefill_attention(
            q, cache.k, cache.v, cache.pos, context_table, k_self, v_self,
            meta.pos, scale=scale, softcap=softcap, window=window)


KERNELS = ("ref", "cuda")
_KV_LAYOUTS = {
    ("dense", "ref"): _DenseKV(),
    ("dense", "cuda"): _DenseKV(),
    ("paged", "ref"): _GatheredPagedKV(),
    ("paged", "cuda"): _InplacePagedKV(),
}


def resolve_kv_layout(cache, kernel: str = "ref") -> KVLayout:
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
    store = "paged" if isinstance(cache, PagedAttnCache) else "dense"
    return _KV_LAYOUTS[(store, kernel)]


def gqa_decode(p, x, positions, cache, cfg: ModelConfig, *,
               window: int | None, write_cache: bool, cache_limit=None,
               block_table=None, kernel: str = "ref"):
    """Decode mode: block queries vs cache ++ self block
    (bidirectional); commits the block when ``write_cache``."""
    B, n, _ = x.shape
    q, k_self, v_self = gqa_qkv(p, x, positions, cfg)
    layout = resolve_kv_layout(cache, kernel)
    o = layout.attend(
        q, k_self, v_self, positions, cache, block_table=block_table,
        cache_limit=cache_limit, scale=_gqa_scale(cfg),
        softcap=cfg.attn_logit_softcap or None, window=window)
    if write_cache:
        layout.commit(cache, k_self, v_self, positions, block_table)
    return linear(p["wo"], o.reshape(B, n, -1)), cache
