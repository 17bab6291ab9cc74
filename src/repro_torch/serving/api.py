"""Request API of the serving stack (the port's own copy of
``repro.serving.api``, restricted to what the paged continuous path
uses).

``SamplingParams`` carries every per-request decode knob; the pool reads
them out of per-row vectors, so one pool serves mixed configurations.
``s_max`` — the denoise-loop bound — stays a pool-level value.
``GenerationConfig`` is the pool/engine construction config plus the
default ``SamplingParams``.  Sampling parameters never touch prompt KV,
so requests with different parameters share prefix pages freely.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decode parameters.

    tau             dynamic mode: reveal positions whose top-1 prob
                    exceeds this threshold (at least one per step)
    temperature     0 = greedy argmax, > 0 = categorical sampling
    mode            "dynamic" | "static" (fixed reveal count per step)
    n_steps         static mode: denoise steps per block
    max_new_blocks  response budget in blocks (None = cache capacity)
    eos_id          stop token; -1 disables EOS stopping
    seed            seeds the request's ``torch.Generator`` when the
                    caller passes none
    """
    tau: float = 0.9
    temperature: float = 0.0
    mode: str = "dynamic"
    n_steps: int = 8
    max_new_blocks: int | None = None
    eos_id: int = 1
    seed: int | None = None

    def __post_init__(self):
        if self.mode not in ("dynamic", "static"):
            raise ValueError(
                f"mode must be dynamic|static, got {self.mode!r}")
        if self.n_steps < 1:
            raise ValueError(f"n_steps must be >= 1, got {self.n_steps}")
        if self.temperature < 0:
            raise ValueError(
                f"temperature must be >= 0, got {self.temperature}")
        if self.max_new_blocks is not None and self.max_new_blocks < 0:
            raise ValueError(
                f"max_new_blocks must be >= 0, got {self.max_new_blocks}")

    @property
    def dynamic(self) -> bool:
        return self.mode == "dynamic"

    def replace(self, **kw) -> "SamplingParams":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class Request:
    """One queued request (prompt trimmed to ``prompt_blocks`` blocks)."""
    uid: int
    prompt: np.ndarray                     # (Lp,) int32
    prompt_blocks: int
    generator: torch.Generator | None      # noise source (sampled rows)
    params: SamplingParams = SamplingParams()


@dataclasses.dataclass
class RequestOutput:
    """Structured streaming completion: decoded text trimmed at the first
    EOS, why the request stopped and its admit -> finish latency in
    scheduler ticks."""
    uid: int
    text: str
    token_ids: np.ndarray
    finish_reason: str           # "eos" | "length"
    prompt_blocks: int
    gen_blocks: int
    gen_tokens: int
    denoise_steps: int
    admitted_tick: int
    completed_tick: int
    params: SamplingParams = SamplingParams()
    param_version: int = 0

    @property
    def latency_ticks(self) -> int:
        return self.completed_tick - self.admitted_tick


@dataclasses.dataclass
class GenerationConfig:
    """Pool/engine construction config + default ``SamplingParams``.

    The pool is the paged continuous-batching pool; ``kernel`` picks how
    it reads the page pool: ``"cuda"`` runs the in-place kernels K4/K5,
    ``"ref"`` gathers pages into a dense-width copy (plain path).
    """
    max_len: int = 256
    s_max: int = 8
    mode: str = "dynamic"
    tau: float = 0.9
    n_steps: int = 8
    temperature: float = 0.0
    eos_id: int = 1
    n_slots: int = 8
    n_pages: int | None = None   # None = dense-equivalent pool + null page
    prefix_cache: bool = True
    kernel: str = "cuda"

    def sampling(self, **overrides) -> SamplingParams:
        base = SamplingParams(tau=self.tau, temperature=self.temperature,
                              mode=self.mode, n_steps=self.n_steps,
                              eos_id=self.eos_id)
        return base.replace(**overrides) if overrides else base
