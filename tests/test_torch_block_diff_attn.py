"""K1 (block-diffusion attention forward): the port against the JAX
reference.

The port's plain version (what the CUDA kernel is held against on the
card) is compared with the JAX Pallas kernel run in interpret mode and
with the JAX dense oracle ``mha_reference``, on the plain layout and on
hand-built random metadata covering copy A/B, the strict predicate,
INVALID_COPY rows, a sliding window and a softcap.  The port's tile map
and CSR list are compared with JAX ``build_tile_map``.

Tolerance: f32 throughout, atol = rtol = 1e-5 (both sides accumulate in
f32; they differ only in summation order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import masks as tmasks  # noqa: E402
from repro_torch.kernels import block_diff_attn as tbda  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

try:  # the machine with the card has the port but no JAX
    import jax.numpy as jnp

    from repro.core import masks as jmasks
    from repro.kernels import block_diff_attn as jbda
    from repro.kernels import ops as jops
    from repro.kernels.ref import mha_reference
except ImportError:
    jnp = None
needs_jax = pytest.mark.skipif(jnp is None,
                               reason="needs JAX and the reference package")

ATOL = RTOL = 1e-5
H, HKV, D = 4, 2, 32


def _qkv(seed, B, L, Dv=D):
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, L, H, D)).astype(np.float32)
    k = r.standard_normal((B, L, HKV, D)).astype(np.float32)
    v = r.standard_normal((B, L, HKV, Dv)).astype(np.float32)
    return q, k, v


def _random_meta(seed, B, L, bsz=4):
    """Copy A/B halves with random reveal steps and invalid positions."""
    r = np.random.default_rng(seed)
    half = L // 2
    pos = np.tile(np.arange(half), 2)
    copy = np.repeat([0, 1], half)
    meta = dict(
        copy=np.broadcast_to(copy, (B, L)).astype(np.int32),
        block=np.broadcast_to(pos // bsz, (B, L)).astype(np.int32),
        step=r.integers(0, 3, (B, L)).astype(np.int32),
        pos=np.broadcast_to(pos, (B, L)).astype(np.int32),
        valid=r.random((B, L)) > 0.15)
    meta["valid"][0, :3] = False         # a run of INVALID_COPY rows
    return meta


def _plain_meta(B, L, bsz=4):
    pos = np.broadcast_to(np.arange(L), (B, L)).astype(np.int32)
    z = np.zeros((B, L), np.int32)
    return dict(copy=z, block=(pos // bsz).astype(np.int32), step=z,
                pos=pos, valid=np.ones((B, L), bool))


def _jmeta(m):
    return jmasks.SeqMeta(**{k: jnp.asarray(v) for k, v in m.items()})


def _tmeta(m):
    return tmasks.SeqMeta(**{k: torch.from_numpy(np.array(v))
                             for k, v in m.items()})


CASES = [
    ("plain", False, None, None),
    ("random", False, None, None),
    ("random", True, None, None),
    ("random", False, 6, None),
    ("random", False, None, 5.0),
    ("random", True, 6, 5.0),
]


@needs_jax
@pytest.mark.parametrize("layout,strict,window,softcap", CASES)
def test_plain_version_matches_jax_kernel_and_oracle(layout, strict,
                                                     window, softcap):
    B, L, tile = 2, 32, 16
    q, k, v = _qkv(0, B, L)
    meta = _plain_meta(B, L) if layout == "plain" else _random_meta(1, B, L)
    jm = _jmeta(meta)
    pm = jops.pack_meta(jm)
    tm = jops.build_tile_map(pm, pm, tile, tile, window=window)
    scale = D ** -0.5
    want = np.asarray(jbda.block_diff_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pm, pm, tm,
        scale=scale, softcap=softcap, window=window, strict=strict,
        tq=tile, tk=tile, interpret=True))
    vis = jmasks.visibility(jm, jm, window=window, strict=strict)
    oracle = np.asarray(mha_reference(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), vis, scale=scale,
                                      softcap=softcap))

    tq_meta = tops.pack_meta(_tmeta(meta))
    got = tbda.block_diff_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        tq_meta, tq_meta, scale=scale, softcap=softcap, window=window,
        strict=strict).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, oracle, atol=ATOL, rtol=RTOL)
    # rows whose query is padding are exactly zero, as in the kernel
    assert not got[~meta["valid"]].any()


@needs_jax
@pytest.mark.parametrize("impl", ["ref", "chunked", "cuda"])
@pytest.mark.parametrize("window", [None, 6])
def test_attention_dispatcher_impls_match_jax(impl, window):
    B, L = 1, 24
    q, k, v = _qkv(2, B, L)
    meta = _random_meta(3, B, L)
    want = np.asarray(jops.attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), _jmeta(meta),
        _jmeta(meta), impl="ref", window=window, softcap=3.0))
    tm = _tmeta(meta)
    got = tops.attention(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), tm, tm, impl=impl,
                         window=window, softcap=3.0).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@needs_jax
@pytest.mark.parametrize("window", [None, 12])
@pytest.mark.parametrize("layout", ["plain", "random"])
def test_tile_map_and_csr_match_jax(layout, window):
    B, L, tile = 2, 64, 8
    meta = _plain_meta(B, L) if layout == "plain" else _random_meta(4, B, L)
    want = np.asarray(jops.build_tile_map(
        jops.pack_meta(_jmeta(meta)), jops.pack_meta(_jmeta(meta)), tile,
        tile, window=window))
    pm = tops.pack_meta(_tmeta(meta))
    got = tops.build_tile_map(pm, pm, tile, tile, window=window)
    np.testing.assert_array_equal(got.numpy(), want)

    row_ptr, col_idx = tbda.tile_csr(got)
    row_ptr, col_idx = row_ptr.numpy(), col_idx.numpy()
    nq, nk = want.shape[1:]
    for r in range(B * nq):
        cols = col_idx[row_ptr[r]:row_ptr[r + 1]]
        np.testing.assert_array_equal(
            cols, np.flatnonzero(want.reshape(B * nq, nk)[r] > 0))


def test_padded_tile_map_covers_every_visible_pair():
    """Ragged lengths: the kernel pads meta to whole 64-row tiles; the
    padded map must still list every tile holding a visible pair."""
    B, L = 2, 2 * 50
    meta = _random_meta(5, B, L)
    pm = tops.pack_meta(_tmeta(meta))
    n = -(-L // tbda.TILE)
    padded = tbda.pad_meta(pm, n * tbda.TILE)
    tm = tops.build_tile_map(padded, padded, tbda.TILE, tbda.TILE).numpy()
    vis = tbda.visibility_packed(pm, pm, window=None, strict=False).numpy()
    b, i, j = np.nonzero(vis)
    assert (tm[b, i // tbda.TILE, j // tbda.TILE] > 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5),
                                       ("bfloat16", 2e-2)])
def test_cuda_kernel_matches_plain_version(dtype, tol):
    """On a CUDA card: K1 against its plain version, ragged lengths."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    B, L = 2, 2 * 50
    q, k, v = (torch.from_numpy(a).cuda().to(getattr(torch, dtype))
               for a in _qkv(6, B, L))
    pm = tops.pack_meta(_tmeta(_random_meta(7, B, L))).cuda()
    for strict, window, softcap in [(False, None, None), (True, 6, 5.0)]:
        kw = dict(scale=D ** -0.5, softcap=softcap, window=window,
                  strict=strict)
        got = tbda.block_diff_attention(q, k, v, pm, pm, **kw)
        want = tbda.block_diff_attention_plain(q, k, v, pm, pm, **kw)
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)
