"""Carry weights and caches across from the JAX reference.

``params_from_jax`` takes the reference ``BlockDiffLM.init`` parameter
tree with numpy leaves (``jax.tree.map(np.asarray, params)``) and
returns the port's parameter dict.  It undoes the reference's layer
grouping: ``init`` stacks each repeating group along a leading (G,)
axis (``jax.vmap(init_group)``), so layer ``g * len(group) + j`` is
``groups["l{j}"][..][g]``, after the unscanned ``prefix`` layers.
Linear weights keep their (d_in, d_out) layout, so conversion is a copy.
Tied models have no ``lm_head``.

``paged_caches_from_jax`` / ``caches_from_jax`` do the same for cache
trees, whose group leaves ``_stack_groups`` stacked along (G,).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import attention as attn
from repro_torch.models.model import LINEARS


def _t(a, device, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=device, dtype=dtype)


def _layer_trees(tree: dict) -> list[dict]:
    """Per-layer subtrees in execution order (prefix, then groups)."""
    out = [tree["prefix"][f"l{i}"] for i in range(len(tree.get("prefix",
                                                               {})))]
    groups = tree["groups"]
    n_per = len(groups)
    G = int(np.shape(_first_leaf(groups))[0])
    for g in range(G):
        for j in range(n_per):
            out.append(_index(groups[f"l{j}"], g))
    return out


def _first_leaf(tree):
    while isinstance(tree, (dict, tuple, list)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) \
            else tree[0]
    return tree


def _index(tree, g):
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    if isinstance(tree, tuple):      # NamedTuple caches
        return type(tree)(*(_index(v, g) for v in tree))
    return np.asarray(tree)[g]


def params_from_jax(tree: dict, *, device="cpu",
                    dtype: torch.dtype | None = None) -> dict:
    """Reference parameter tree (numpy leaves) -> port parameters."""
    params = {"embed": _t(tree["embed"]["table"], device, dtype),
              "final_norm": _t(tree["final_norm"]["scale"], device, dtype)}
    if "lm_head" in tree:
        params["lm_head"] = _t(tree["lm_head"]["w"], device, dtype)
    layers = []
    for lt in _layer_trees(tree):
        lp = {"attn_norm": _t(lt["attn_norm"]["scale"], device, dtype),
              "ffn_norm": _t(lt["ffn_norm"]["scale"], device, dtype)}
        for name in ("wq", "wk", "wv", "wo"):
            lp[name] = _t(lt["attn"][name]["w"], device, dtype)
        for name in ("w_gate", "w_up", "w_down"):
            lp[name] = _t(lt["ffn"][name]["w"], device, dtype)
        assert set(lp) == {"attn_norm", "ffn_norm", *LINEARS}
        layers.append(lp)
    params["layers"] = layers
    return params


def paged_caches_from_jax(tree: dict, *, device="cpu") -> list:
    """Reference ``make_paged_caches`` tree (numpy leaves, fields
    k/v/pos) -> the port's per-layer ``PagedAttnCache`` list."""
    return [attn.PagedAttnCache(k=_t(c[0], device), v=_t(c[1], device),
                                pos=_t(c[2], device))
            for c in _layer_trees(tree)]


def caches_from_jax(tree: dict, *, device="cpu") -> list:
    """Reference ``make_caches`` tree -> per-layer ``AttnCache`` list."""
    return [attn.AttnCache(k=_t(c[0], device), v=_t(c[1], device),
                           pos=_t(c[2], device))
            for c in _layer_trees(tree)]
