"""RolloutEngine — continuous-batching blockwise-dLLM serving
(counterpart of the continuous path of ``repro.serving.engine``).

Text requests enter through ``submit``; a persistent ``SlotScheduler``
pool (paged KV, shared-prefix index) admits them at block boundaries,
and ``stream`` yields structured ``RequestOutput`` records in finish
order.  Weights are read from a ``ModelServer`` every tick, so an
in-place update takes effect at the next block boundary.

The static lock-step ``generate``/``generate_ids`` path of the reference
is not part of this slice.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterator

import numpy as np
import torch

from repro_torch.data.pipeline import pad_to_block
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.serving.api import (GenerationConfig, RequestOutput,
                                     SamplingParams)
from repro_torch.serving.scheduler import Completion, SlotScheduler

__all__ = ["EngineStats", "GenerationConfig", "RequestOutput",
           "RolloutEngine", "SamplingParams"]


@dataclasses.dataclass
class EngineStats:
    """Engine-level throughput / latency counters (reference names).

    ``wall_seconds`` is host time spent in pool ticks, each ending in the
    host reading the tick's ``done`` flags (which waits for the device).
    """
    rollouts: int = 0
    total_tokens: int = 0
    total_steps: int = 0
    wall_seconds: float = 0.0
    slot_ticks: int = 0
    active_slot_ticks: int = 0
    prefix_hit_blocks: int = 0
    prefix_miss_blocks: int = 0
    transient_kv_bytes: int = 0
    admit_transient_kv_bytes: int = 0
    param_version: int = 0
    latencies: list = dataclasses.field(default_factory=list)

    @property
    def tokens_per_step(self) -> float:
        return self.total_tokens / max(self.total_steps, 1)

    @property
    def utilization(self) -> float:
        return self.active_slot_ticks / max(self.slot_ticks, 1)

    @property
    def prefix_hit_rate(self) -> float:
        total = self.prefix_hit_blocks + self.prefix_miss_blocks
        return self.prefix_hit_blocks / max(total, 1)

    def latency_percentile(self, q: float) -> float:
        return float(np.percentile(self.latencies, q)) \
            if self.latencies else 0.0


class RolloutEngine:
    def __init__(self, model, weight_store, gen_cfg: GenerationConfig,
                 tokenizer: ByteTokenizer | None = None, *, seed: int = 0):
        self.model = model
        self.store = weight_store
        self.gen_cfg = gen_cfg
        self.tok = tokenizer or ByteTokenizer()
        self.stats = EngineStats()
        self._pending: list[Completion] = []
        # the engine's own seed stream for requests that bring no noise
        # source of their own
        self._seeds = np.random.default_rng(seed)
        self.scheduler = SlotScheduler(model, gen_cfg)
        self.stats.transient_kv_bytes = self.scheduler.transient_kv_bytes

    def _encode_prompt(self, prompt: str) -> tuple[np.ndarray, int]:
        bsz = self.model.cfg.block_size
        enc = pad_to_block(self.tok.encode(prompt, bos=True), bsz,
                           self.tok.pad_id)
        return np.asarray(enc, np.int32), len(enc) // bsz

    def submit(self, prompt: str, generator: torch.Generator | None = None,
               params: SamplingParams | None = None) -> int:
        """Queue one text request on the live pool; returns its uid.
        Without a generator or ``params.seed``, sampled requests seed a
        generator from the engine's own stream."""
        toks, blocks = self._encode_prompt(prompt)
        p = params or self.scheduler.default_params
        if generator is None and p.seed is None and p.temperature > 0:
            generator = torch.Generator(device=self.model.device)
            generator.manual_seed(int(self._seeds.integers(2 ** 62)))
        return self.scheduler.submit(toks, blocks, generator, params=params)

    def stream_completions(self, params=None) -> Iterator[Completion]:
        """Drive the pool until it drains, yielding raw ``Completion``
        records in completion order.  ``params=None`` re-reads the live
        store weights every tick."""
        if isinstance(params, SamplingParams):
            raise TypeError("stream(params=) takes model weights; "
                            "SamplingParams belong on submit()")
        sched = self.scheduler
        while sched.has_work or self._pending:
            if sched.has_work:
                version, p = self.store.params_versioned() \
                    if params is None else (self.stats.param_version,
                                            params)
                self.stats.param_version = version
                s0 = dataclasses.replace(sched.stats)
                t0 = time.perf_counter()
                self._pending.extend(sched.step(p, param_version=version))
                self.stats.wall_seconds += time.perf_counter() - t0
                s1 = sched.stats
                self.stats.slot_ticks += s1.slot_ticks - s0.slot_ticks
                self.stats.active_slot_ticks += \
                    s1.active_slot_ticks - s0.active_slot_ticks
                self.stats.prefix_hit_blocks += \
                    s1.prefix_hit_blocks - s0.prefix_hit_blocks
                self.stats.prefix_miss_blocks += \
                    s1.prefix_miss_blocks - s0.prefix_miss_blocks
                self.stats.admit_transient_kv_bytes = max(
                    self.stats.admit_transient_kv_bytes,
                    s1.admit_transient_kv_bytes)
            while self._pending:
                comp = self._pending.pop(0)
                self.stats.rollouts += 1
                self.stats.total_tokens += comp.gen_tokens
                self.stats.total_steps += comp.denoise_steps
                self.stats.latencies.append(comp.latency_ticks)
                yield comp

    def stream(self, params=None) -> Iterator[RequestOutput]:
        """Drive the pool until it drains, yielding ``RequestOutput``
        records in completion order."""
        for comp in self.stream_completions(params):
            yield self._to_output(comp)

    def _to_output(self, comp: Completion) -> RequestOutput:
        bsz = self.model.cfg.block_size
        lo = comp.prompt_blocks * bsz
        ids = comp.tokens[lo:lo + comp.gen_blocks * bsz]
        eos = np.flatnonzero(ids == comp.params.eos_id)
        ids = ids[:eos[0]] if eos.size else ids
        return RequestOutput(
            uid=comp.uid, text=self.tok.decode(ids), token_ids=ids,
            finish_reason=comp.finish_reason,
            prompt_blocks=comp.prompt_blocks, gen_blocks=comp.gen_blocks,
            gen_tokens=comp.gen_tokens, denoise_steps=comp.denoise_steps,
            admitted_tick=comp.admitted_tick,
            completed_tick=comp.completed_tick, params=comp.params,
            param_version=comp.param_version)
