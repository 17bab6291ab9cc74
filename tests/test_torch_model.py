"""The port's BlockDiffLM against the JAX reference, through ``convert``.

A JAX ``BlockDiffLM.init`` tree is converted with
``repro_torch.convert.params_from_jax`` and both models run on the same
numpy inputs: ``forward_masked`` logits on the plain layout (K1's path),
``decode_step`` logits over paged caches under the gathered and the
in-place layouts (K4's path), and the caches ``prefill_suffix`` commits
(K5's path).  The JAX side runs its Pallas kernels in interpret mode
(``attn_impl="pallas"`` and ``kv_kernel="pallas"`` off-TPU).

Tolerance: f32, atol = 1e-4 on logits and caches.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

jax = pytest.importorskip("jax")  # the card machine has no JAX

import jax.numpy as jnp  # noqa: E402

from repro.configs import sdar_8b as jcfgs  # noqa: E402
from repro.configs import tiny as jtiny  # noqa: E402
from repro.core import decoding as jdec  # noqa: E402
from repro.core.masks import plain_layout as jplain  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.model import BlockDiffLM as JModel  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import sdar_8b as tcfgs  # noqa: E402
from repro_torch.configs import tiny as ttiny  # noqa: E402
from repro_torch.core import decoding as tdec  # noqa: E402
from repro_torch.core.masks import plain_layout as tplain  # noqa: E402
from repro_torch.models.model import BlockDiffLM as TModel  # noqa: E402

ATOL = 1e-4
RTOL = 1e-4
N_PAGES = 16


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    jm = JModel(jcfgs.smoke_config(attn_impl="pallas"))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = TModel(tcfgs.smoke_config(attn_impl="cuda"), device="cpu")
    tp = convert.params_from_jax(_np_tree(jp))
    return jm, jp, tm, tp


def test_converted_params_match_shapes_and_values(models):
    jm, jp, tm, tp = models
    fresh = tm.init(0)
    assert tm.param_count(tp) == jm.param_count(jp)
    assert set(fresh) == set(tp) and "lm_head" in tp   # untied
    for a, b in zip(fresh["layers"], tp["layers"]):
        assert {k: v.shape for k, v in a.items()} == \
            {k: v.shape for k, v in b.items()}
    np.testing.assert_array_equal(
        tp["layers"][1]["wq"].numpy(),
        np.asarray(jp["groups"]["l0"]["attn"]["wq"]["w"][1]))


def test_tied_embeddings_convert():
    jm = JModel(jtiny.config())
    jp = jm.init(jax.random.PRNGKey(1))
    tp = convert.params_from_jax(_np_tree(jp))
    assert "lm_head" not in tp
    tm = TModel(ttiny.config(), device="cpu")
    ids = np.arange(32, dtype=np.int32).reshape(1, 32) % 300
    valid = np.ones((1, 32), bool)
    want = np.asarray(jm.forward_masked(
        jp, jnp.asarray(ids), jplain(jnp.asarray(ids), jnp.asarray(valid),
                                     block_size=16))[0])
    t_ids = torch.from_numpy(ids)
    got = tm.forward_masked(tp, t_ids, tplain(
        t_ids, torch.from_numpy(valid), block_size=16)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("impl", ["cuda", "chunked", "ref"])
def test_forward_masked_logits(models, impl):
    jm, jp, tm, tp = models
    tm = TModel(tm.cfg.replace(attn_impl=impl), device="cpu")
    r = np.random.default_rng(0)
    ids = r.integers(0, 500, (2, 24)).astype(np.int32)
    valid = np.ones_like(ids, bool)
    want = np.asarray(jm.forward_masked(
        jp, jnp.asarray(ids),
        jplain(jnp.asarray(ids), jnp.asarray(valid), block_size=4))[0])
    t_ids = torch.from_numpy(ids)
    got = tm.forward_masked(tp, t_ids, tplain(
        t_ids, torch.from_numpy(valid), block_size=4)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def _paged_pool(jm, seed):
    """A random JAX paged pool (G-stacked) plus a ragged block table."""
    cfg = jm.cfg
    bsz, Hkv, Dh = cfg.block_size, cfg.n_kv_heads, cfg.resolved_head_dim
    r = np.random.default_rng(seed)
    caches = _np_tree(jm.make_paged_caches(3, N_PAGES))
    c = caches["groups"]["l0"]
    G = c.k.shape[0]
    k = r.standard_normal((G, N_PAGES, bsz, Hkv, Dh)).astype(np.float32)
    v = r.standard_normal((G, N_PAGES, bsz, Hkv, Dh)).astype(np.float32)
    table = np.full((3, 6), -1, np.int32)
    table[0, :3] = [1, 2, 3]
    table[1, :5] = [4, 5, 6, 7, 8]
    pos = np.full((G, N_PAGES, bsz), -1, np.int32)
    for row in table:
        for j, page in enumerate(row):
            if page > 0:
                pos[:, page] = j * bsz + np.arange(bsz)
    caches["groups"]["l0"] = type(c)(k=k, v=v, pos=pos)
    return caches, table


@pytest.mark.parametrize("j_kernel,t_kernel", [("pallas", "cuda"),
                                               ("ref", "ref"),
                                               ("pallas", "ref")])
def test_decode_step_over_paged_caches(models, j_kernel, t_kernel):
    jm, jp, tm, tp = models
    bsz = jm.cfg.block_size
    caches, table = _paged_pool(jm, 1)
    r = np.random.default_rng(2)
    ids = r.integers(0, 500, (3, bsz)).astype(np.int32)
    blk = np.array([3, 5, 0], np.int32)
    positions = (blk[:, None] * bsz + np.arange(bsz)).astype(np.int32)
    limit = (blk * bsz).astype(np.int32)
    jc = jax.tree.map(jnp.asarray, caches)
    want, jc2 = jm.decode_step(
        jp, jnp.asarray(ids), jnp.asarray(positions), jc,
        cache_limit=jnp.asarray(limit), block_table=jnp.asarray(table),
        write=True, kv_kernel=j_kernel)
    tc = convert.paged_caches_from_jax(caches)
    got = tm.decode_step(
        tp, torch.from_numpy(ids), torch.from_numpy(positions), tc,
        cache_limit=torch.from_numpy(limit),
        block_table=torch.from_numpy(table), write=True,
        kv_kernel=t_kernel)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    # the commit wrote the same K/V into the same pages
    for a, b in zip(tc, convert.paged_caches_from_jax(_np_tree(jc2))):
        np.testing.assert_array_equal(a.pos.numpy(), b.pos.numpy())
        np.testing.assert_allclose(a.k.numpy(), b.k.numpy(), atol=ATOL)
        np.testing.assert_allclose(a.v.numpy(), b.v.numpy(), atol=ATOL)


@pytest.mark.parametrize("kv_kernel", ["cuda", "ref"])
@pytest.mark.parametrize("hit", [1, 3])
def test_prefill_suffix_caches(models, kv_kernel, hit):
    """Prefill a prompt, then prefill a second prompt's suffix through the
    first one's prefix pages: the committed suffix K/V match JAX."""
    jm, jp, tm, tp = models
    bsz = jm.cfg.block_size
    r = np.random.default_rng(3)
    prompt = r.integers(0, 500, (1, 5 * bsz)).astype(np.int32)
    jc = jm.make_paged_caches(1, N_PAGES)
    rows = jdec.prefill(jm, jp, jnp.asarray(prompt),
                        jnp.asarray([5], jnp.int32), 5 * bsz, ring=False)
    pages = jnp.arange(1, 1 + hit, dtype=jnp.int32)
    jc = {"prefix": {}, "groups": {
        lk: jattn.write_prompt_pages_grouped(c, rows["groups"][lk], pages)
        for lk, c in jc["groups"].items()}}
    tc = convert.paged_caches_from_jax(_np_tree(jc))
    suffix = prompt[:, hit * bsz:]
    write = np.arange(10, 10 + 5 - hit, dtype=np.int32)[None]
    ctx = np.array(pages)[None]
    jc2 = jdec.prefill_suffix(jm, jp, jnp.asarray(suffix), jnp.int32(hit),
                              jc, jnp.asarray(ctx), jnp.asarray(write),
                              kv_kernel="pallas")
    tdec.prefill_suffix(tm, tp, torch.from_numpy(suffix), hit, tc,
                        torch.from_numpy(ctx), torch.from_numpy(write),
                        kv_kernel=kv_kernel)
    for a, b in zip(tc, convert.paged_caches_from_jax(_np_tree(jc2))):
        np.testing.assert_array_equal(a.pos.numpy(), b.pos.numpy())
        np.testing.assert_allclose(a.k.numpy(), b.k.numpy(), atol=ATOL)
        np.testing.assert_allclose(a.v.numpy(), b.v.numpy(), atol=ATOL)


def test_decode_step_over_dense_caches(models):
    """The dense KV layout: decode against a prefilled per-sequence
    cache (cache_limit hides the padded prompt tail)."""
    jm, jp, tm, tp = models
    bsz = jm.cfg.block_size
    r = np.random.default_rng(4)
    prompt = r.integers(0, 500, (2, 3 * bsz)).astype(np.int32)
    jc = jdec.prefill(jm, jp, jnp.asarray(prompt),
                      jnp.asarray([3, 2], jnp.int32), 6 * bsz)
    blk = np.array([3, 2], np.int32)
    positions = (blk[:, None] * bsz + np.arange(bsz)).astype(np.int32)
    ids = r.integers(0, 500, (2, bsz)).astype(np.int32)
    want, _ = jm.decode_step(jp, jnp.asarray(ids), jnp.asarray(positions),
                             jc, cache_limit=jnp.asarray(blk * bsz))
    tc = convert.caches_from_jax(_np_tree(jc))
    got = tm.decode_step(tp, torch.from_numpy(ids),
                         torch.from_numpy(positions), tc,
                         cache_limit=torch.from_numpy(blk * bsz))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_no_gpu_means_no_default_model():
    """Entry points default to the card and refuse to run on the CPU
    when none is present."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TModel(tcfgs.smoke_config())
