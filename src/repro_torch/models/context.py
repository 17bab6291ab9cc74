"""Execution context threaded through every layer (counterpart of
``repro.models.context.LayerCtx``).

modes:
  ``plain``  — committed block-causal pass (prefill; fills caches, or
               over paged caches the shared-prefix suffix prefill);
  ``decode`` — current-block denoise step against the caches.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.masks import SeqMeta


@dataclasses.dataclass
class LayerCtx:
    mode: str
    meta: SeqMeta | None = None
    # decode mode
    positions: torch.Tensor | None = None     # (B, n) absolute positions
    cache_limit: torch.Tensor | None = None   # (B,): cache pos < limit
    block_table: torch.Tensor | None = None   # (B, K): paged caches
    write_cache: bool = False
    # paged KV layout: "ref" gathers pages, "cuda" reads them in place
    kv_kernel: str = "ref"
    # plain mode over paged caches (shared-prefix suffix prefill)
    context_table: torch.Tensor | None = None  # (B, Kp)
    write_pages: torch.Tensor | None = None    # (B, T // block_size)
