"""BlockDiffLM — the block-diffusion language model, dense GQA path
(counterpart of ``repro.models.model.BlockDiffLM``).

Parameters are a dict of tensors::

    {"embed": (V, d), "final_norm": (d,), "lm_head": (d, V) [untied],
     "layers": [{"attn_norm", "ffn_norm": (d,),
                 "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"}, ...]}

with linear weights in the reference's (d_in, d_out) layout.  The
reference scans repeating layer groups; here ``layers`` is the flat list
in execution order (``convert.py`` unstacks the groups), and the layer
loop replaces ``_run_stack``'s scan.  Caches are a list with one cache
per layer.

Entry points: ``forward_masked`` (committed plain pass — prefill),
``decode_step`` (one denoise forward of the current block) and
``prefill_suffix`` (plain pass of a prompt suffix through paged caches).
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.core.masks import SeqMeta
from . import attention as attn
from .config import ModelConfig, layer_pattern
from .context import LayerCtx
from .ffn import swiglu
from .modules import (embed, lecun_init, linear, normal_init, rmsnorm,
                      softcap, unembed)

LINEARS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


class BlockDiffLM:
    def __init__(self, cfg: ModelConfig, *, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        prefix, group, n_groups = layer_pattern(cfg)
        self.specs = prefix + group * n_groups

    # ------------------------------------------------------------- init
    def _linear_shapes(self) -> dict[str, tuple[int, int]]:
        cfg = self.cfg
        d, H, Hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
        Dh = cfg.resolved_head_dim
        return {"wq": (d, H * Dh), "wk": (d, Hkv * Dh),
                "wv": (d, Hkv * Dh), "wo": (H * Dh, d),
                "w_gate": (d, cfg.d_ff), "w_up": (d, cfg.d_ff),
                "w_down": (cfg.d_ff, d)}

    def init(self, seed: int = 0) -> dict:
        """Seeded random parameters on the model's device, with the
        reference's shapes and initialisers (lecun-normal linears,
        N(0, 0.02) embedding, zero norm scales), drawn from one
        ``torch.Generator``."""
        cfg, dev = self.cfg, self.device
        dt = cfg.torch_param_dtype
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        d = cfg.d_model
        params = {
            "embed": normal_init(gen, (cfg.vocab_size, d), 0.02, dt, dev),
            "final_norm": torch.zeros(d, dtype=dt, device=dev),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = lecun_init(gen, (d, cfg.vocab_size), d, dt,
                                           dev)
        layers = []
        for _ in self.specs:
            lp = {"attn_norm": torch.zeros(d, dtype=dt, device=dev),
                  "ffn_norm": torch.zeros(d, dtype=dt, device=dev)}
            for name, (din, dout) in self._linear_shapes().items():
                lp[name] = lecun_init(gen, (din, dout), din, dt, dev)
            layers.append(lp)
        params["layers"] = layers
        return params

    # --------------------------------------------------------- plumbing
    def _embed(self, params, ids):
        return embed(params["embed"], ids, dtype=self.cfg.torch_dtype)

    def _logits(self, params, x):
        cfg = self.cfg
        x = rmsnorm(params["final_norm"], x, eps=cfg.norm_eps)
        if cfg.tie_embeddings:
            logits = unembed(params["embed"], x)
        else:
            logits = linear(params["lm_head"], x, dtype=torch.float32)
        if cfg.final_logit_softcap:
            logits = softcap(logits, cfg.final_logit_softcap)
        return logits

    def _layer(self, spec, lp, x, ctx: LayerCtx, cache):
        cfg = self.cfg
        h = rmsnorm(lp["attn_norm"], x, eps=cfg.norm_eps)
        if ctx.mode == "plain" and isinstance(cache, attn.PagedAttnCache):
            y, cache = attn.gqa_plain_paged(
                lp, h, ctx.meta, cache, cfg, window=spec.window,
                context_table=ctx.context_table,
                write_pages=ctx.write_pages, kernel=ctx.kv_kernel)
        elif ctx.mode == "plain":
            y, k, v = attn.gqa_masked(lp, h, ctx.meta, cfg,
                                      window=spec.window)
            if cache is not None:
                attn.write_prefill_cache(cache, k, v, ctx.meta.pos)
        else:
            y, cache = attn.gqa_decode(
                lp, h, ctx.positions, cache, cfg, window=spec.window,
                write_cache=ctx.write_cache, cache_limit=ctx.cache_limit,
                block_table=ctx.block_table, kernel=ctx.kv_kernel)
        x = x + y
        h = rmsnorm(lp["ffn_norm"], x, eps=cfg.norm_eps)
        return x + swiglu(lp, h)

    def _run_stack(self, params, x, ctx: LayerCtx, caches):
        for i, (spec, lp) in enumerate(zip(self.specs, params["layers"])):
            x = self._layer(spec, lp, x, ctx,
                            None if caches is None else caches[i])
        return x

    # ------------------------------------------------------ public API
    @torch.no_grad()
    def forward_masked(self, params, input_ids, meta: SeqMeta, *,
                       caches=None):
        """Committed block-causal pass over ``input_ids`` (B, L); fills
        ``caches`` (dense, in place) when given.  Returns logits
        (B, L, V) in f32."""
        ctx = LayerCtx(mode="plain", meta=meta)
        x = self._run_stack(params, self._embed(params, input_ids), ctx,
                            caches)
        return self._logits(params, x)

    @torch.no_grad()
    def decode_step(self, params, block_ids, positions, caches, *,
                    cache_limit=None, block_table=None, write=False,
                    kv_kernel: str = "ref"):
        """One denoise forward of the current block (B, block_size);
        commits the block into the caches when ``write``.  Returns
        logits (B, block_size, V) in f32."""
        ctx = LayerCtx(mode="decode", positions=positions,
                       cache_limit=cache_limit, block_table=block_table,
                       write_cache=write, kv_kernel=kv_kernel)
        x = self._run_stack(params, self._embed(params, block_ids), ctx,
                            caches)
        return self._logits(params, x)

    @torch.no_grad()
    def prefill_suffix(self, params, suffix_ids, meta: SeqMeta, caches, *,
                       context_table, write_pages, kv_kernel: str = "ref"):
        """Committed pass over a prompt suffix through paged caches: the
        prefix is read through ``context_table`` (B, Kp) pages, the
        suffix blocks are committed into ``write_pages``.  No logits."""
        ctx = LayerCtx(mode="plain", meta=meta, context_table=context_table,
                       write_pages=write_pages, kv_kernel=kv_kernel)
        self._run_stack(params, self._embed(params, suffix_ids), ctx,
                        caches)
        return caches

    def make_caches(self, batch: int, cache_len: int, *, ring: bool = True):
        cfg = self.cfg
        Dh = cfg.resolved_head_dim
        out = []
        for spec in self.specs:
            S = min(cache_len, spec.window) if (spec.window and ring) \
                else cache_len
            out.append(attn.make_attn_cache(batch, S, cfg.n_kv_heads, Dh,
                                            Dh, cfg.torch_dtype,
                                            self.device))
        return out

    def make_paged_caches(self, n_pages: int):
        """One shared page pool per layer (page 0 is the null page)."""
        cfg = self.cfg
        Dh = cfg.resolved_head_dim
        return [attn.make_paged_attn_cache(
            n_pages, cfg.block_size, cfg.n_kv_heads, Dh, Dh,
            cfg.torch_dtype, self.device) for _ in self.specs]

    def param_count(self, params) -> int:
        n = sum(t.numel() for k, t in params.items() if k != "layers")
        return n + sum(t.numel() for lp in params["layers"]
                       for t in lp.values())
