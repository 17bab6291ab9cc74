"""K4 (paged decode) and K5 (paged suffix prefill): the port's plain
versions against the JAX Pallas kernels run in interpret mode.

Pools are random, block tables have -1 holes and an all-hole row, and
``cache_limit`` covers 0, mid-sequence and full; window and softcap are
on and off; block sizes 4 and 8; hit depths Kp in {0, 1, 3}.  Each
comparison is by tolerance, never bitwise: the JAX prefill kernel is not
even bitwise equal to its own gathered path at these shapes (a known
fault of the reference, recorded in ROADMAP.md).

Tolerance: f32, atol = rtol = 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import paged_attn as tpa  # noqa: E402

try:  # the machine with the card has the port but no JAX
    import jax.numpy as jnp

    from repro.kernels import paged_attn as jpa
except ImportError:
    jnp = None
needs_jax = pytest.mark.skipif(jnp is None,
                               reason="needs JAX and the reference package")

ATOL = RTOL = 1e-5
H, HKV, D = 4, 2, 16
P, K = 11, 5


def _pool(seed, bsz, B=3):
    r = np.random.default_rng(seed)
    kp = r.standard_normal((P, bsz, HKV, D)).astype(np.float32)
    vp = r.standard_normal((P, bsz, HKV, D)).astype(np.float32)
    pos = (np.arange(P * bsz).reshape(P, bsz) % (K * bsz)).astype(np.int32)
    pos[4, bsz // 2:] = -1                      # partially filled page
    table = np.full((B, K), -1, np.int32)
    table[0, :3] = [1, 2, 3]                    # trailing holes
    table[1] = [5, 6, 7, 8, 9]                  # full row
    # row 2: no pages at all — only the self block is visible
    return r, kp, vp, pos, table


def _np2t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


@needs_jax
@pytest.mark.parametrize("bsz", [4, 8])
@pytest.mark.parametrize("window,softcap", [(None, None), (6, None),
                                            (None, 5.0), (6, 5.0)])
def test_decode_plain_matches_jax_kernel(bsz, window, softcap):
    r, kp, vp, pos, table = _pool(0, bsz)
    B = table.shape[0]
    q = r.standard_normal((B, bsz, H, D)).astype(np.float32)
    ks = r.standard_normal((B, bsz, HKV, D)).astype(np.float32)
    vs = r.standard_normal((B, bsz, HKV, D)).astype(np.float32)
    blk = np.array([0, 3, K], np.int32)         # cache_limit edges
    positions = (blk[:, None] * bsz + np.arange(bsz)).astype(np.int32)
    limit = (blk * bsz).astype(np.int32)
    scale = D ** -0.5
    want = np.asarray(jpa.paged_decode_attention(
        *map(jnp.asarray, (q, kp, vp, pos, table, ks, vs, positions,
                           limit)),
        scale=scale, softcap=softcap, window=window, interpret=True))
    got = tpa.paged_decode_attention(
        *_np2t(q, kp, vp, pos, table, ks, vs, positions, limit),
        scale=scale, softcap=softcap, window=window).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_decode_null_page_garbage_never_leaks():
    """Pool rows behind -1 entries and past cache_limit are never read:
    filling them with garbage leaves the output unchanged."""
    bsz = 4
    r, kp, vp, pos, table = _pool(1, bsz)
    B = table.shape[0]
    q, ks, vs = (r.standard_normal((B, bsz, H, D)).astype(np.float32),
                 r.standard_normal((B, bsz, HKV, D)).astype(np.float32),
                 r.standard_normal((B, bsz, HKV, D)).astype(np.float32))
    positions = (np.array([2, 3, 0])[:, None] * bsz
                 + np.arange(bsz)).astype(np.int32)
    limit = np.array([2 * bsz, 3 * bsz, 0], np.int32)
    args = dict(scale=D ** -0.5)
    base = tpa.paged_decode_attention(
        *_np2t(q, kp, vp, pos, table, ks, vs, positions, limit), **args)
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[0] = 1e4                                # the null page
    vp2[[0, 4, 10]] = -1e4                      # unreferenced pages
    got = tpa.paged_decode_attention(
        *_np2t(q, kp2, vp2, pos, table, ks, vs, positions, limit), **args)
    np.testing.assert_array_equal(got.numpy(), base.numpy())


@needs_jax
@pytest.mark.parametrize("bsz", [4, 8])
@pytest.mark.parametrize("kp_hit", [0, 1, 3])
@pytest.mark.parametrize("window,softcap", [(None, None), (6, 5.0)])
def test_prefill_plain_matches_jax_kernel(bsz, kp_hit, window, softcap):
    r, kp, vp, pos, _ = _pool(2, bsz)
    B, Ts = 2, 2
    T = Ts * bsz
    # each row's hit prefix: pages whose positions are the first blocks
    pos = np.full((P, bsz), -1, np.int32)
    ctx = np.zeros((B, kp_hit), np.int32)
    for b in range(B):
        for j in range(kp_hit):
            page = 1 + b * 4 + j
            ctx[b, j] = page
            pos[page] = j * bsz + np.arange(bsz)
    q = r.standard_normal((B, T, H, D)).astype(np.float32)
    ks = r.standard_normal((B, T, HKV, D)).astype(np.float32)
    vs = r.standard_normal((B, T, HKV, D)).astype(np.float32)
    positions = np.broadcast_to(kp_hit * bsz + np.arange(T),
                                (B, T)).astype(np.int32)
    scale = D ** -0.5
    want = np.asarray(jpa.paged_prefill_attention(
        *map(jnp.asarray, (q, kp, vp, pos, ctx, ks, vs, positions)),
        scale=scale, softcap=softcap, window=window, interpret=True))
    got = tpa.paged_prefill_attention(
        *_np2t(q, kp, vp, pos, ctx, ks, vs, positions), scale=scale,
        softcap=softcap, window=window).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_wrappers_refuse_other_devices():
    """A wrapper runs its plain version only for CPU tensors; anything
    that is neither CPU nor CUDA raises instead of computing."""
    bsz = 4
    meta = torch.device("meta")
    q = torch.empty((1, bsz, H, D), device=meta)
    pages = torch.empty((P, bsz, HKV, D), device=meta)
    ints = torch.empty((P, bsz), dtype=torch.int32, device=meta)
    table = torch.empty((1, K), dtype=torch.int32, device=meta)
    selfk = torch.empty((1, bsz, HKV, D), device=meta)
    pos = torch.empty((1, bsz), dtype=torch.int32, device=meta)
    with pytest.raises(ValueError):
        tpa.paged_decode_attention(q, pages, pages, ints, table, selfk,
                                   selfk, pos, scale=1.0)
    with pytest.raises(ValueError):
        tpa.paged_prefill_attention(q, pages, pages, ints, table, selfk,
                                    selfk, pos, scale=1.0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5),
                                       ("bfloat16", 2e-2)])
def test_cuda_kernels_match_plain_versions(dtype, tol):
    """On a CUDA card: K4 and K5 against their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dt = getattr(torch, dtype)
    bsz = 4
    r, kp, vp, pos, table = _pool(3, bsz)
    B = table.shape[0]
    q = r.standard_normal((B, bsz, H, D)).astype(np.float32)
    ks = r.standard_normal((B, bsz, HKV, D)).astype(np.float32)
    positions = (np.array([0, 3, K])[:, None] * bsz
                 + np.arange(bsz)).astype(np.int32)
    limit = (np.array([0, 3, K]) * bsz).astype(np.int32)
    f = [t.cuda() for t in _np2t(q, kp, vp, pos, table, ks, ks, positions,
                                 limit)]
    for i in (0, 1, 2, 5, 6):
        f[i] = f[i].to(dt)
    kw = dict(scale=D ** -0.5, softcap=5.0, window=6)
    got = tpa.paged_decode_attention(*f, **kw)
    want = tpa.paged_decode_attention_plain(*f, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)
    ctx = torch.tensor([[1, 2], [5, 6], [7, 8]], dtype=torch.int32).cuda()
    qs = f[0].repeat(1, 2, 1, 1)
    kss = f[5].repeat(1, 2, 1, 1)
    spos = torch.arange(2 * bsz, 4 * bsz, dtype=torch.int32).cuda()
    spos = spos.expand(B, -1).contiguous()
    args = (qs, f[1], f[2], f[3], ctx, kss, kss, spos)
    got = tpa.paged_prefill_attention(*args, **kw)
    want = tpa.paged_prefill_attention_plain(*args, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)
