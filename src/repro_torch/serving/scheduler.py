"""Slot-based continuous-batching scheduler over a paged KV pool
(counterpart of ``repro.serving.scheduler.SlotScheduler``, paged path).

The scheduler owns ``n_slots`` decode slots backed by one batched
``core.decoding.GenState``.  One tick = one ``advance_block`` over the
whole pool (every live slot denoises and commits one block).  Between
ticks it admits queued requests into free slots and evicts finished
ones.

Attention KV lives in one shared pool of ``n_pages`` block-sized pages
per layer, addressed through per-slot block tables
(``GenState.table``).  Page 0 is the null page and is never handed out.
Admission reserves a request's worst case up front, so mid-flight
allocation cannot fail; when the queue head does not fit, admission
defers (``stats.deferred``) until evictions free pages.

With ``prefix_cache`` a refcounted radix index (``prefix_cache.py``)
shares committed prompt pages across requests.  Admission takes one of
three paths:

  * ``cold``           — no cached prefix: a B=1 plain prefill (K1 under
                         ``attn_impl="cuda"``) scattered into fresh pages;
  * ``suffix_prefill`` — a partial hit: only the suffix is prefilled,
                         reading the prefix through shared pages (K5
                         under ``kernel="cuda"``);
  * ``full_hit``       — every prompt block is cached: no model call.

Decode reads the pool through K4 under ``kernel="cuda"`` and through a
dense-width gather under ``kernel="ref"``.  Freed and reclaimed pages
get their ``pos`` wiped so stale keys never pass a later owner's
``cache_limit`` mask.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Iterator

import numpy as np
import torch

from repro_torch.core import decoding
from repro_torch.models import attention
from repro_torch.serving.api import GenerationConfig, Request, SamplingParams
from repro_torch.serving.prefix_cache import PrefixIndex, chain_keys

_UNSET = object()


@dataclasses.dataclass
class Completion:
    """A finished request, harvested at eviction time."""
    uid: int
    tokens: np.ndarray           # (max_len,) prompt ++ generation ++ MASK
    steps: np.ndarray            # (max_len,) per-token reveal-step map
    prompt_blocks: int
    gen_blocks: int
    gen_tokens: int              # generated tokens up to first EOS incl.
    denoise_steps: int
    finish_reason: str           # "eos" | "length"
    admitted_tick: int
    completed_tick: int
    params: SamplingParams = SamplingParams()
    param_version: int = 0

    @property
    def latency_ticks(self) -> int:
        return self.completed_tick - self.admitted_tick


@dataclasses.dataclass
class SchedulerStats:
    """Utilization counters (field names as in the reference)."""
    ticks: int = 0
    slot_ticks: int = 0
    active_slot_ticks: int = 0
    admitted: int = 0
    completed: int = 0
    gen_tokens: int = 0
    denoise_steps: int = 0
    peak_active: int = 0
    prefill_blocks: int = 0
    transient_kv_bytes: int = 0        # per-tick decode gather copy
    admit_transient_kv_bytes: int = 0  # peak suffix-prefill gather copy
    deferred: int = 0
    page_allocs: int = 0
    page_frees: int = 0
    peak_pages_in_use: int = 0
    peak_pages_live: int = 0
    prefix_hit_blocks: int = 0
    prefix_miss_blocks: int = 0
    shared_pages: int = 0
    prefix_evictions: int = 0
    # admissions per path: "cold" | "suffix_prefill" | "full_hit"
    admit_paths: dict = dataclasses.field(
        default_factory=lambda: {"cold": 0, "suffix_prefill": 0,
                                 "full_hit": 0})

    @property
    def utilization(self) -> float:
        return self.active_slot_ticks / max(self.slot_ticks, 1)

    @property
    def prefix_hit_rate(self) -> float:
        total = self.prefix_hit_blocks + self.prefix_miss_blocks
        return self.prefix_hit_blocks / max(total, 1)


class SlotScheduler:
    """Fixed-slot continuous batcher over a paged KV pool."""

    def __init__(self, model, gen_cfg: GenerationConfig | None = None,
                 **overrides):
        if gen_cfg is None:
            gen_cfg = GenerationConfig()
        if overrides:
            gen_cfg = dataclasses.replace(gen_cfg, **overrides)
        cfg = model.cfg
        if gen_cfg.n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {gen_cfg.n_slots}")
        if gen_cfg.kernel not in attention.KERNELS:
            raise ValueError(f"kernel must be one of {attention.KERNELS}, "
                             f"got {gen_cfg.kernel!r}")
        if gen_cfg.max_len % cfg.block_size:
            raise ValueError("max_len must be a block multiple")
        self.model = model
        self.device = model.device
        self.gen_cfg = gen_cfg
        self.default_params = gen_cfg.sampling()
        self.n_slots = S = gen_cfg.n_slots
        self.max_len = gen_cfg.max_len
        self.n_blocks_total = self.max_len // cfg.block_size
        self.kernel = gen_cfg.kernel
        self.stats = SchedulerStats()
        self.n_pages = gen_cfg.n_pages if gen_cfg.n_pages is not None \
            else S * self.n_blocks_total + 1
        if self.n_pages < 2:
            raise ValueError("paged cache needs >= 2 pages")
        self._free_pages = list(range(self.n_pages - 1, 0, -1))
        self._table_host = np.full((S, self.n_blocks_total), -1, np.int64)
        self._pages_reserved = 0
        self._slot_resv = [0] * S
        self._slot_limit = [0] * S
        self._slot_blk = [0] * S
        self.prefix = PrefixIndex() if gen_cfg.prefix_cache else None
        self._slot_nodes: list[list[bytes]] = [[] for _ in range(S)]
        self._queue: deque[Request] = deque()
        self._slot_req: list[Request | None] = [None] * S
        self._slot_admit_tick = [0] * S
        self._slot_admit_version = [0] * S
        self._next_uid = 0
        self._state = self._init_pool()
        caches = self._state.caches
        self.transient_kv_bytes = max(
            attention.resolve_kv_layout(c, self.kernel).transient_bytes(
                c, S, self.n_blocks_total) for c in caches)
        self.stats.transient_kv_bytes = self.transient_kv_bytes

    # ----------------------------------------------------------- state
    def _init_pool(self) -> decoding.GenState:
        cfg, dev = self.model.cfg, self.device
        S, L = self.n_slots, self.max_len
        i32 = dict(dtype=torch.int32, device=dev)
        return decoding.GenState(
            tokens=torch.full((S, L), cfg.resolved_mask_token, **i32),
            steps=torch.zeros((S, L), **i32),
            caches=self.model.make_paged_caches(self.n_pages),
            blk=torch.zeros((S,), **i32),
            done=torch.ones((S,), dtype=torch.bool, device=dev),
            limit=torch.zeros((S,), **i32),
            n_denoise=torch.zeros((S,), **i32),
            # free slots carry inert sampling rows (eos -1 = disabled)
            **decoding.sampling_vectors(S, tau=0.0, temperature=0.0,
                                        n_steps=1, mode="static",
                                        eos_id=-1, device=dev),
            generators=[None] * S,
            table=torch.full((S, self.n_blocks_total), -1, **i32))

    @property
    def n_usable_pages(self) -> int:
        return self.n_pages - 1

    @property
    def pages_in_use(self) -> int:
        return self.n_usable_pages - len(self._free_pages)

    @property
    def pages_live(self) -> int:
        idle = self.prefix.n_idle if self.prefix is not None else 0
        return self.pages_in_use - idle

    def _set_slot(self, slot: int, req: Request, row, limit: int,
                  blk: int) -> None:
        """Write one admitted request's per-slot state into the pool."""
        st, p = self._state, req.params
        st.tokens[slot] = torch.as_tensor(row, dtype=torch.int32,
                                          device=self.device)
        st.steps[slot] = 0
        st.blk[slot] = blk
        st.done[slot] = False
        st.limit[slot] = limit
        st.n_denoise[slot] = 0
        st.tau[slot] = p.tau
        st.temperature[slot] = p.temperature
        st.n_steps[slot] = p.n_steps
        st.dynamic[slot] = p.dynamic
        st.eos[slot] = p.eos_id
        st.generators[slot] = req.generator if p.temperature > 0 else None
        st.table[slot] = torch.as_tensor(self._table_host[slot],
                                         dtype=torch.int32,
                                         device=self.device)

    def _prompt_row(self, req: Request) -> np.ndarray:
        row = np.full((self.max_len,), self.model.cfg.resolved_mask_token,
                      np.int32)
        row[:req.prompt.shape[0]] = req.prompt
        return row

    def _admit_cold(self, params, req: Request, pages: list[int]) -> None:
        """B=1 plain prefill of the whole prompt, scattered into
        ``pages``."""
        prompt = torch.as_tensor(req.prompt[None], device=self.device)
        rows = decoding.prefill(self.model, params, prompt, self.max_len,
                                ring=False)
        idx = torch.as_tensor(pages, dtype=torch.int32, device=self.device)
        for pool, row in zip(self._state.caches, rows):
            attention.write_prompt_pages(pool, row, idx)

    def _admit_paged(self, params, slot: int, req: Request,
                     budget: int) -> bool:
        """Admit one request into ``slot``; False (nothing mutated) when
        its worst case does not fit."""
        bsz = self.model.cfg.block_size
        pb = req.prompt_blocks
        limit = pb + budget
        row = self._prompt_row(req)
        if self.prefix is None:
            if self._pages_reserved + limit > self.n_usable_pages:
                return False
            pages = self._take_pages(pb)
            self._table_host[slot, :pb] = pages
            self._pages_reserved += limit
            self._slot_resv[slot] = limit
            self._admit_cold(params, req, pages)
            self.stats.page_allocs += pb
            self.stats.prefill_blocks += pb
            self.stats.admit_paths["cold"] += 1
        else:
            keys = chain_keys(req.prompt, bsz)
            hits = self.prefix.match(keys)
            h = len(hits)
            idle_hits = sum(1 for e in hits if e.refs == 0)
            if self._pages_reserved + self.prefix.n_active + budget \
                    + (pb - h) + idle_hits > self.n_usable_pages:
                return False
            # acquire before allocating: _take_pages may reclaim idle
            # entries, and an unreferenced hit would be fair game
            self.prefix.acquire(hits)
            new_pages = self._take_pages(pb - h)
            hit_pages = [e.page for e in hits]
            self._slot_nodes[slot] = [e.key for e in hits] + \
                self.prefix.register(keys, h, new_pages)
            self._table_host[slot, :pb] = hit_pages + new_pages
            self._pages_reserved += budget
            self._slot_resv[slot] = budget
            self.stats.page_allocs += len(new_pages)
            self.stats.prefix_hit_blocks += h
            self.stats.prefix_miss_blocks += pb - h
            self.stats.prefill_blocks += pb - h
            if h == 0:
                self._admit_cold(params, req, new_pages)
                self.stats.admit_paths["cold"] += 1
            elif h == pb:
                self.stats.admit_paths["full_hit"] += 1
            else:
                self._admit_suffix(params, req, h, hit_pages, new_pages)
                self.stats.admit_paths["suffix_prefill"] += 1
            self.stats.shared_pages = max(self.stats.shared_pages,
                                          self.prefix.n_shared)
        self._slot_limit[slot] = limit
        self._slot_blk[slot] = pb
        self._set_slot(slot, req, row, limit, pb)
        self.stats.peak_pages_in_use = max(self.stats.peak_pages_in_use,
                                           self.pages_in_use)
        self.stats.peak_pages_live = max(self.stats.peak_pages_live,
                                         self.pages_live)
        return True

    def _admit_suffix(self, params, req: Request, h: int,
                      hit_pages: list[int], new_pages: list[int]) -> None:
        """Prefill only the prompt blocks beyond the ``h``-block hit."""
        bsz = self.model.cfg.block_size
        dev = self.device
        self.stats.admit_transient_kv_bytes = max(
            self.stats.admit_transient_kv_bytes,
            max(attention.resolve_kv_layout(c, self.kernel)
                .prefill_transient_bytes(c, 1, h)
                for c in self._state.caches))
        decoding.prefill_suffix(
            self.model, params,
            torch.as_tensor(req.prompt[None, h * bsz:], device=dev), h,
            self._state.caches,
            context_table=torch.as_tensor([hit_pages], dtype=torch.int32,
                                          device=dev),
            write_pages=torch.as_tensor([new_pages], dtype=torch.int32,
                                        device=dev),
            kv_kernel=self.kernel)

    def _empty_completion(self, req: Request, version: int) -> Completion:
        """Zero-budget request: completes without touching a slot."""
        self.stats.admitted += 1
        self.stats.completed += 1
        return Completion(
            uid=req.uid, tokens=self._prompt_row(req),
            steps=np.zeros((self.max_len,), np.int32),
            prompt_blocks=req.prompt_blocks, gen_blocks=0, gen_tokens=0,
            denoise_steps=0, finish_reason="length",
            admitted_tick=self.stats.ticks, completed_tick=self.stats.ticks,
            params=req.params, param_version=version)

    # ------------------------------------------------------------- API
    def submit(self, prompt: np.ndarray, prompt_blocks: int,
               generator: torch.Generator | None = None, *,
               params: SamplingParams | None = None,
               max_new_blocks: int | None = _UNSET) -> int:
        """Queue a request; returns its uid.  ``generator`` is the
        request's noise source (sampled decoding only); without one,
        ``params.seed`` seeds a fresh generator."""
        prompt = np.asarray(prompt, np.int32)
        prompt_blocks = int(prompt_blocks)
        bsz = self.model.cfg.block_size
        if prompt.ndim != 1 or prompt.shape[0] % bsz:
            raise ValueError("prompt must be a 1-D block-aligned array")
        if not 1 <= prompt_blocks <= min(self.n_blocks_total,
                                         prompt.shape[0] // bsz):
            raise ValueError(f"bad prompt_blocks {prompt_blocks}")
        if params is None:
            params = self.default_params
        if max_new_blocks is not _UNSET:
            params = params.replace(max_new_blocks=max_new_blocks)
        if generator is None and params.seed is not None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(params.seed)
        if generator is None and params.temperature > 0:
            raise ValueError("sampled decoding needs a generator or "
                             "params.seed")
        uid = self._next_uid
        self._next_uid += 1
        self._queue.append(Request(uid=uid,
                                   prompt=prompt[:prompt_blocks * bsz],
                                   prompt_blocks=prompt_blocks,
                                   generator=generator, params=params))
        return uid

    @property
    def has_work(self) -> bool:
        return bool(self._queue) or any(r is not None
                                        for r in self._slot_req)

    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self._slot_req)

    # ------------------------------------------------- paged allocator
    def _take_pages(self, n: int) -> list[int]:
        """Pop ``n`` pages: free list first, then LRU prefix reclaims
        (wiped before reuse)."""
        out, reclaimed = [], []
        for _ in range(n):
            if self._free_pages:
                out.append(self._free_pages.pop())
                continue
            page = self.prefix.evict_lru() if self.prefix is not None \
                else None
            if page is None:
                raise RuntimeError(
                    "page pool exhausted — reservation invariant broken")
            reclaimed.append(page)
            out.append(page)
        if reclaimed:
            self.stats.prefix_evictions += len(reclaimed)
            self._invalidate_pages(reclaimed)
        return out

    def _alloc_cursor_pages(self) -> None:
        """Give every live slot a page for the block it commits next."""
        slots, blks, pages = [], [], []
        for slot, req in enumerate(self._slot_req):
            if req is None:
                continue
            b = self._slot_blk[slot]
            if self._table_host[slot, b] < 0:
                pg = self._take_pages(1)[0]
                self._table_host[slot, b] = pg
                slots.append(slot)
                blks.append(b)
                pages.append(pg)
        if slots:
            self._state.table[slots, blks] = torch.as_tensor(
                pages, dtype=torch.int32, device=self.device)
        self.stats.page_allocs += len(slots)
        self.stats.peak_pages_in_use = max(self.stats.peak_pages_in_use,
                                           self.pages_in_use)
        self.stats.peak_pages_live = max(self.stats.peak_pages_live,
                                         self.pages_live)

    def _free_slot_pages(self, slot: int) -> list[int]:
        """Release a slot's pages; returns the exclusive pages freed
        (registered prompt pages only drop a reference)."""
        row = self._table_host[slot]
        pages = [int(p) for p in row[row >= 0]]
        nodes = self._slot_nodes[slot]
        if nodes:
            self.prefix.release(nodes)
            self._slot_nodes[slot] = []
            pages = pages[len(nodes):]
        self._free_pages.extend(pages)
        self.stats.page_frees += len(pages)
        row[:] = -1
        self._pages_reserved -= self._slot_resv[slot]
        self._slot_resv[slot] = 0
        self._slot_limit[slot] = 0
        return pages

    def _invalidate_pages(self, pages: list[int]) -> None:
        idx = torch.as_tensor(pages, dtype=torch.long, device=self.device)
        for c in self._state.caches:
            attention.wipe_pages(c, idx)

    # ------------------------------------------------------------ tick
    def step(self, params, param_version: int = 0) -> list[Completion]:
        """One scheduler tick: admit -> advance -> evict.  ``params`` are
        the model weights; returns the completions harvested."""
        if isinstance(params, SamplingParams):
            raise TypeError("step(params=) takes model weights; "
                            "SamplingParams belong on submit()")
        return self._tick(params, param_version)

    def _tick(self, params, param_version: int) -> list[Completion]:
        out: list[Completion] = []
        for slot in range(self.n_slots):
            if not self._queue or self._slot_req[slot] is not None:
                continue
            req = self._queue[0]
            budget = self.n_blocks_total - req.prompt_blocks
            if req.params.max_new_blocks is not None:
                budget = min(budget, req.params.max_new_blocks)
            if budget <= 0:
                self._queue.popleft()
                out.append(self._empty_completion(req, param_version))
                continue
            if req.prompt_blocks + budget > self.n_usable_pages:
                raise ValueError(
                    f"request {req.uid} needs {req.prompt_blocks + budget}"
                    f" pages but the pool only has {self.n_usable_pages}")
            if not self._admit_paged(params, slot, req, budget):
                self.stats.deferred += 1
                break
            self._queue.popleft()
            self._slot_req[slot] = req
            self._slot_admit_tick[slot] = self.stats.ticks
            self._slot_admit_version[slot] = param_version
            self.stats.admitted += 1
        self.stats.peak_active = max(self.stats.peak_active, self.n_active)
        if not self.n_active:
            return out

        self._alloc_cursor_pages()
        decoding.advance_block(self.model, params, self._state,
                               s_max=self.gen_cfg.s_max,
                               kv_kernel=self.kernel)
        self.stats.ticks += 1
        self.stats.slot_ticks += self.n_slots
        self.stats.active_slot_ticks += self.n_active
        for slot, req in enumerate(self._slot_req):
            if req is not None:
                self._slot_blk[slot] = min(self._slot_blk[slot] + 1,
                                           self._slot_limit[slot])

        st = self._state
        done = st.done.cpu().numpy()
        evicted, freed = [], []
        bsz = self.model.cfg.block_size
        for slot in range(self.n_slots):
            req = self._slot_req[slot]
            if req is None or not done[slot]:
                continue
            # copies: on the CPU .numpy() would alias the pool row that
            # the next admission overwrites
            tokens = st.tokens[slot].cpu().numpy().copy()
            gen_blocks = int(st.blk[slot]) - req.prompt_blocks
            lo = req.prompt_blocks * bsz
            hi = lo + gen_blocks * bsz
            eos_id = req.params.eos_id
            gen_tokens = int(decoding.count_gen_tokens(
                tokens[None], [req.prompt_blocks], [gen_blocks],
                eos_id=eos_id, block_size=bsz)[0])
            comp = Completion(
                uid=req.uid, tokens=tokens,
                steps=st.steps[slot].cpu().numpy().copy(),
                prompt_blocks=req.prompt_blocks, gen_blocks=gen_blocks,
                gen_tokens=gen_tokens,
                denoise_steps=int(st.n_denoise[slot]),
                finish_reason="eos" if (tokens[lo:hi] == eos_id).any()
                else "length",
                admitted_tick=self._slot_admit_tick[slot],
                completed_tick=self.stats.ticks, params=req.params,
                param_version=self._slot_admit_version[slot])
            out.append(comp)
            self._slot_req[slot] = None
            st.generators[slot] = None
            evicted.append(slot)
            freed.extend(self._free_slot_pages(slot))
            self.stats.completed += 1
            self.stats.gen_tokens += gen_tokens
            self.stats.denoise_steps += comp.denoise_steps
        if evicted:
            # freed slots re-commit into the null page from now on
            st.table[evicted] = -1
            if freed:
                self._invalidate_pages(freed)
        return out

    def run(self, params) -> Iterator[Completion]:
        """Drive ticks until queue and slots drain."""
        while self.has_work:
            yield from self.step(params)
