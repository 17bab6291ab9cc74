"""Model configuration for the port's dense GQA block-diffusion stack.

Counterpart of ``repro.models.config`` restricted to the fields this
slice runs (dense attention layers, optional sliding window and
softcaps, tied or separate unembedding).  ``layer_pattern`` keeps the
reference's (prefix, group, n_groups) decomposition so converted
parameter trees line up layer for layer.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class LayerSpec:
    mixer: str                    # attn (the only mixer of this slice)
    window: int | None = None     # sliding window for this layer
    ffn: str = "dense"
    d_ff: int = 0                 # 0 -> cfg.d_ff


@dataclass(frozen=True)
class ModelConfig:
    name: str = "tiny"
    arch_type: str = "dense"
    source: str = ""

    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0             # 0 -> d_model // n_heads
    d_ff: int = 512
    vocab_size: int = 512
    norm_eps: float = 1e-6
    tie_embeddings: bool = True

    rope_theta: float = 10000.0
    sliding_window: int = 0       # 0 -> disabled
    local_global: bool = False    # even layers local, odd global
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    query_scale: float = 0.0      # 0 -> 1/sqrt(head_dim)

    block_size: int = 32
    mask_token_id: int = -1       # -1 -> vocab_size - 1

    dtype: str = "float32"
    param_dtype: str = "float32"
    # ref | chunked | cuda  (cuda = the hand-written K1 kernel)
    attn_impl: str = "chunked"

    def __post_init__(self):
        if self.arch_type != "dense":
            raise ValueError(
                f"{self.name}: the port runs dense stacks only, got "
                f"arch_type={self.arch_type!r}")
        if self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must be a multiple of n_kv_heads")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def resolved_mask_token(self) -> int:
        return self.mask_token_id if self.mask_token_id >= 0 \
            else self.vocab_size - 1

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def torch_param_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def layer_spec(self, i: int) -> LayerSpec:
        window = None
        if self.local_global:
            window = self.sliding_window if i % 2 == 0 else None
        elif self.sliding_window:
            window = self.sliding_window
        return LayerSpec(mixer="attn", window=window)


def layer_pattern(cfg: ModelConfig
                  ) -> tuple[list[LayerSpec], list[LayerSpec], int]:
    """Returns (prefix_specs, group_specs, n_groups), the reference's
    scan grouping: layer ``g * len(group) + j`` has spec ``group[j]``."""
    period = 2 if cfg.local_global else 1
    if cfg.n_layers % period:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers not "
                         f"divisible by pattern period {period}")
    group = [cfg.layer_spec(j) for j in range(period)]
    return [], group, cfg.n_layers // period
