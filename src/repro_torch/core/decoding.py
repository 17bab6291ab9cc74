"""Blockwise semi-autoregressive decoding (counterpart of
``repro.core.decoding``).

``advance_block`` advances every sequence of a ``GenState`` by exactly
one block: denoise (``denoise_block``), freeze finished rows, commit the
block into the caches and move the per-sequence cursors.  The slot
scheduler calls it once per tick.  Every row evolves independently, so
a request's tokens depend only on its own prompt, parameters and noise.

Per-row sampling parameters live in (B,) vectors on the state, and the
two reveal policies (dynamic threshold, static count) are evaluated side
by side and selected per row, exactly as in the reference.

Randomness: categorical sampling is argmax(logits / T + Gumbel noise).
The noise is an explicit input: ``denoise_block`` takes a ``gumbel``
callable, ``advance_block`` draws it from each row's own
``torch.Generator``.  Greedy rows (temperature 0) take no noise, and a
batch of greedy rows draws none at all.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .masks import plain_layout


@dataclasses.dataclass
class GenState:
    tokens: torch.Tensor       # (B, L_max) int32
    steps: torch.Tensor        # (B, L_max) reveal-step map
    caches: list               # one cache per layer
    blk: torch.Tensor          # (B,) next block index per sequence
    done: torch.Tensor         # (B,) bool
    limit: torch.Tensor        # (B,) exclusive block cursor cap
    n_denoise: torch.Tensor    # (B,) cumulative denoise steps used
    tau: torch.Tensor          # (B,) f32 dynamic-mode threshold
    temperature: torch.Tensor  # (B,) f32; 0 = greedy argmax
    n_steps: torch.Tensor      # (B,) i32 static-mode step budget
    dynamic: torch.Tensor      # (B,) bool
    eos: torch.Tensor          # (B,) i32 stop token (-1 disables)
    # per-row noise sources (None for rows that never sample)
    generators: list = dataclasses.field(default_factory=list)
    table: torch.Tensor | None = None  # (B, L_max // bsz) paged only


def sampling_vectors(batch: int, *, tau=0.9, temperature=0.0, n_steps=8,
                     mode="dynamic", eos_id=1, device="cpu") -> dict:
    """Broadcast scalar-or-per-row sampling fields to (B,) vectors."""
    if isinstance(mode, str):
        if mode not in ("dynamic", "static"):
            raise ValueError(f"mode must be dynamic|static, got {mode!r}")
        dynamic = torch.full((batch,), mode == "dynamic", device=device)
    else:
        dynamic = torch.as_tensor(mode, dtype=torch.bool,
                                  device=device).expand(batch).clone()

    def vec(x, dt):
        return torch.as_tensor(x, dtype=dt, device=device).expand(
            batch).clone()

    return {"tau": vec(tau, torch.float32),
            "temperature": vec(temperature, torch.float32),
            "n_steps": vec(n_steps, torch.int32),
            "dynamic": dynamic,
            "eos": vec(eos_id, torch.int32)}


def prefill(model, params, prompt_tokens, max_len: int, *,
            ring: bool = True):
    """Committed pass over block-aligned prompts (B, Lp); returns dense
    caches sized for ``max_len`` with every prompt position written."""
    cfg = model.cfg
    B, Lp = prompt_tokens.shape
    valid = torch.ones((B, Lp), dtype=torch.bool,
                       device=prompt_tokens.device)
    meta = plain_layout(prompt_tokens, valid, block_size=cfg.block_size)
    caches = model.make_caches(B, max_len, ring=ring)
    model.forward_masked(params, prompt_tokens, meta, caches=caches)
    return caches


def prefill_suffix(model, params, suffix_tokens, start_block: int, caches,
                   context_table, write_pages, kv_kernel: str = "ref"):
    """Suffix-only prefill: commit prompt blocks [start_block, ...) while
    reading the shared prefix through ``context_table`` (B, Kp) pages;
    ``write_pages`` (B, Ls // bsz) receive the suffix KV."""
    cfg = model.cfg
    B, Ls = suffix_tokens.shape
    if Ls % cfg.block_size or Ls == 0:
        raise ValueError(f"suffix length {Ls} is not a positive block "
                         "multiple")
    meta = plain_layout(suffix_tokens,
                        torch.ones((B, Ls), dtype=torch.bool,
                                   device=suffix_tokens.device),
                        block_size=cfg.block_size)
    pos = meta.pos + start_block * cfg.block_size
    meta = dataclasses.replace(meta, pos=pos, block=pos // cfg.block_size)
    return model.prefill_suffix(params, suffix_tokens, meta, caches,
                                context_table=context_table,
                                write_pages=write_pages,
                                kv_kernel=kv_kernel)


def denoise_block(model, params, caches, blk, *, tau, temperature,
                  n_steps, dynamic, s_max: int, table=None,
                  kv_kernel: str = "ref", gumbel=None):
    """Denoise one block for every sequence.

    ``gumbel(step)`` returns (B, bsz, V) Gumbel noise for the sampled
    rows (its values on greedy rows are ignored); it is called only when
    some row samples.  Returns (ids, step_map, pos, steps_used).
    """
    cfg = model.cfg
    bsz = cfg.block_size
    MASK = cfg.resolved_mask_token
    B = blk.shape[0]
    dev = blk.device
    ar = torch.arange(bsz, dtype=torch.int32, device=dev)
    pos = blk[:, None] * bsz + ar[None, :]
    cache_limit = blk * bsz
    ns = n_steps.clamp(min=1)
    n_per_step = ((bsz + ns - 1) // ns).clamp(min=1)         # (B,)
    sample = temperature > 0
    safe_temp = torch.where(sample, temperature, 1.0)
    any_sample = bool(sample.any())

    ids = torch.full((B, bsz), MASK, dtype=torch.int32, device=dev)
    step_map = torch.zeros((B, bsz), dtype=torch.int32, device=dev)
    for s in range(s_max):
        logits = model.decode_step(params, ids, pos, caches,
                                   cache_limit=cache_limit,
                                   block_table=table, kv_kernel=kv_kernel)
        lf = logits.float()
        lf[..., MASK] = -torch.inf
        z = lf / safe_temp[:, None, None]
        if any_sample:
            z = z + torch.where(sample[:, None, None], gumbel(s), 0.0)
        cand = z.argmax(dim=-1)
        probs = torch.softmax(lf, dim=-1)
        conf = probs.gather(-1, cand[..., None])[..., 0]

        masked = ids == MASK
        score = torch.where(masked, conf, -1.0)
        rev_dyn = masked & (conf >= tau[:, None])
        best = score.argmax(dim=-1)
        force = (ar[None, :] == best[:, None]) & masked
        rev_dyn = rev_dyn | (force & ~rev_dyn.any(-1, keepdim=True))
        thr = score.sort(dim=-1).values.gather(
            -1, (bsz - n_per_step).long()[:, None])
        rev_st = masked & (score >= thr)
        reveal = torch.where(dynamic[:, None], rev_dyn, rev_st)
        if s >= s_max - 1:
            reveal = masked
        ids = torch.where(reveal, cand.to(torch.int32), ids)
        step_map = torch.where(reveal, s, step_map)
    steps_used = step_map.amax(dim=-1) + 1
    return ids, step_map, pos, steps_used


def row_gumbel(generators, shape, device):
    """A ``gumbel`` callable drawing each row's noise from its own
    generator (zeros for rows without one)."""
    def draw(_step):
        out = torch.zeros((len(generators), *shape), device=device)
        for i, g in enumerate(generators):
            if g is not None:
                u = torch.rand(shape, generator=g, device=device)
                out[i] = -torch.log(-torch.log(u.clamp_min(1e-20)))
        return out
    return draw


def advance_block(model, params, st: GenState, *, s_max: int,
                  kv_kernel: str = "ref", gumbel=None) -> GenState:
    """Advance every sequence of ``st`` by exactly one block, in place:
    denoise, freeze rows already done (they re-commit their block —
    idempotent), commit the block, scatter tokens and step map, update
    cursors, done flags and denoise-step counters."""
    bsz = model.cfg.block_size
    B, L = st.tokens.shape
    if gumbel is None:
        gumbel = row_gumbel(st.generators,
                            (bsz, model.cfg.vocab_size), st.tokens.device)
    blk = st.blk.clamp(max=L // bsz - 1)
    ids, step_map, pos, steps_used = denoise_block(
        model, params, st.caches, blk, tau=st.tau,
        temperature=st.temperature, n_steps=st.n_steps,
        dynamic=st.dynamic, s_max=s_max, table=st.table,
        kv_kernel=kv_kernel, gumbel=gumbel)
    posl = pos.long()
    old_ids = st.tokens.gather(1, posl)
    old_steps = st.steps.gather(1, posl)
    ids = torch.where(st.done[:, None], old_ids, ids)
    step_map = torch.where(st.done[:, None], old_steps, step_map)

    model.decode_step(params, ids, pos, st.caches, cache_limit=blk * bsz,
                      block_table=st.table, write=True, kv_kernel=kv_kernel)
    st.tokens.scatter_(1, posl, ids)
    st.steps.scatter_(1, posl, step_map)
    hit_eos = (ids == st.eos[:, None]).any(dim=-1)
    new_blk = torch.where(st.done, st.blk,
                          torch.minimum(st.blk + 1, st.limit))
    st.n_denoise += torch.where(st.done, 0, steps_used).to(torch.int32)
    st.done = st.done | hit_eos | (new_blk >= st.limit)
    st.blk = new_blk.to(torch.int32)
    return st


def count_gen_tokens(tokens, prompt_blocks, gen_blocks, *, eos_id,
                     block_size: int) -> np.ndarray:
    """Per-sequence generated-token count, cut at the first EOS
    (inclusive)."""
    tokens = np.asarray(tokens)
    pb = np.asarray(prompt_blocks).astype(np.int64)
    gb = np.asarray(gen_blocks).astype(np.int64)
    eos_id = np.broadcast_to(np.asarray(eos_id), (tokens.shape[0],))
    out = np.zeros((tokens.shape[0],), np.int64)
    for i in range(tokens.shape[0]):
        lo, hi = pb[i] * block_size, (pb[i] + gb[i]) * block_size
        eos = np.flatnonzero(tokens[i, lo:hi] == eos_id[i])
        out[i] = eos[0] + 1 if eos.size else hi - lo
    return out
