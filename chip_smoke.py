"""Smoke run of the PyTorch port on one CUDA card (an H100 is the target).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. card     — the card's name and power limit (nvidia-smi) and
              torch.cuda.get_device_name(0).
2. build    — nvcc builds every kernel source of repro_torch (one
              process per source, in parallel).
3. kernels  — K1 (block-diffusion prefill attention), K4 (paged decode)
              and K5 (paged suffix prefill) at SDAR-8B shapes (32 query
              heads over 8 KV heads, head dim 128, block 4), each held
              against its plain PyTorch version in f32 (TF32 off,
              atol = rtol = 2e-5) and in bf16 (atol = rtol = 2e-2, one
              bf16 rounding of outputs of magnitude ~1), over edge cases
              (empty rows, -1 pages, cache_limit edges, window, softcap);
              then timed at the main path's shapes in bf16: the device
              time (torch.profiler) of the kernel, its plain version and
              one library call (SDPA), and the kernel's time per call
              including the host (CUDA events around back-to-back calls).
4. parity   — SDAR-8B at full width with 2 layers in f32: the kernel path
              (attn_impl="cuda", kernel="cuda") and the plain path
              (attn_impl="chunked", kernel="ref") give the same greedy
              tokens; prompt logits and every decode step's logits agree
              within atol 1e-3; the page pools agree within 1e-4.
5. serve    — SDAR-8B at full width (36 layers) in bf16 from the port's
              seeded init, through RolloutEngine/SlotScheduler: 8
              requests over 4 slots, max_len 128, s_max 4, prompts
              sharing an 8-block prefix plus repeats, so the cold,
              suffix-hit and full-hit admissions all run.  The kernels'
              launch counts are zeroed just before and read just after.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # CUDA-core f32, TC bf16
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SDAR = dict(H=32, Hkv=8, D=128, bsz=4)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters=20, warmup=3) -> float:
    """Device time per call: the summed durations of the CUDA kernels and
    copies one call runs, read from torch.profiler (host time between
    launches excluded)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    if us <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return us / iters / 1e3


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(torch, a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check_close(torch, name, got, want, dtype):
    err = max_err(torch, got, want)
    tol = TOL[dtype]
    bad = (got.float() - want.float()).abs() > tol + tol * want.float().abs()
    if bad.any() or not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name} [{dtype}]: max |err| {err:.3e} "
                             f"exceeds atol=rtol={tol}")
    return err


# ---------------------------------------------------------------- K1
def k1_phase(torch, dev):
    from repro_torch.kernels import block_diff_attn as bda
    from repro_torch.kernels.ops import pack_meta
    from repro_torch.core.masks import SeqMeta, plain_layout
    H, Hkv, D, bsz = (SDAR[k] for k in ("H", "Hkv", "D", "bsz"))
    g = torch.Generator(device=dev)
    g.manual_seed(1)

    def qkv(B, L, dt):
        mk = lambda h: torch.randn((B, L, h, D), generator=g, device=dev)
        return mk(H).to(dt), mk(Hkv).to(dt), mk(Hkv).to(dt)

    def plain_meta(L):
        ids = torch.zeros((1, L), dtype=torch.int32, device=dev)
        return pack_meta(plain_layout(ids, torch.ones_like(ids, dtype=bool),
                                      block_size=bsz))

    def dup_meta(B, half):
        pos = torch.arange(half, dtype=torch.int32, device=dev).repeat(2)
        copy = torch.repeat_interleave(
            torch.tensor([0, 1], dtype=torch.int32, device=dev), half)
        step = torch.randint(0, 4, (B, 2 * half), generator=g, device=dev,
                             dtype=torch.int32)
        valid = torch.rand((B, 2 * half), generator=g, device=dev) > 0.1
        valid[0, :70] = False            # a whole empty q tile and more
        e = lambda t: t.expand(B, -1)
        return pack_meta(SeqMeta(copy=e(copy), block=e(pos // bsz),
                                 step=step, pos=e(pos), valid=valid))

    L_main = 48                     # a 12-block prompt, cold prefill
    cases = [("prefill", 1, L_main, False, None, None),
             ("dup_window_softcap", 2, 200, False, 32, 20.0),
             ("dup_strict", 2, 200, True, None, None)]
    errs = {}
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        for name, B, L, strict, window, softcap in cases:
            q, k, v = qkv(B, L, dt)
            m = plain_meta(L) if name == "prefill" else dup_meta(B, L // 2)
            kw = dict(scale=D ** -0.5, softcap=softcap, window=window,
                      strict=strict)
            got = bda.block_diff_attention(q, k, v, m, m, **kw)
            want = bda.block_diff_attention_plain(q, k, v, m, m, **kw)
            torch.cuda.synchronize()
            err = check_close(torch, f"K1 {name}", got, want, dt_name)
            if name == "dup_window_softcap":
                invalid = m[..., 0] == bda.INVALID_COPY
                if got[invalid].float().abs().max() != 0:
                    raise AssertionError("K1: empty rows are not zero")
            errs[(name, dt_name)] = err
            print(f"[K1] {name:20s} {dt_name:9s} max|err| {err:.3e}")

    # timing at the main path's shape, bf16
    dt = torch.bfloat16
    q, k, v = qkv(1, L_main, dt)
    m = plain_meta(L_main)
    kw = dict(scale=D ** -0.5)
    from repro_torch.kernels.ops import build_tile_map
    n = -(-L_main // bda.TILE)
    tm = build_tile_map(bda.pad_meta(m, n * bda.TILE),
                        bda.pad_meta(m, n * bda.TILE), bda.TILE, bda.TILE)
    rp, ci = bda.tile_csr(tm)
    vis = bda.visibility_packed(m, m, window=None, strict=False)
    kr = k.repeat_interleave(H // Hkv, dim=2).transpose(1, 2)
    vr = v.repeat_interleave(H // Hkv, dim=2).transpose(1, 2)
    qt = q.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kern = lambda: bda.block_diff_attention(q, k, v, m, m, rp, ci, **kw)
    t = dict(
        ms=device_ms(torch, kern),
        plain_ms=device_ms(torch, lambda: bda.block_diff_attention_plain(
            q, k, v, m, m, **kw)),
        library_ms=device_ms(torch, lambda: sdpa(
            qt, kr, vr, attn_mask=vis[:, None], scale=D ** -0.5)),
        call_ms=cuda_ms(torch, kern))
    n_vis = int(vis.sum())
    nbytes = (q.numel() + k.numel() + v.numel() + q.numel()) * 2 \
        + 2 * m.numel() * 4 + rp.numel() * 4 + int(rp[-1]) * 4
    flops = 2.0 * n_vis * H * (D + D)
    b, by = bound_ms(nbytes, flops, "bfloat16")
    return dict(name="K1 block_diff_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/block_diff_attn.cu",
                replaces="src/repro/kernels/block_diff_attn.py:178",
                max_abs_err=errs[("prefill", "bfloat16")],
                max_abs_err_f32=max(v for (c, d), v in errs.items()
                                    if d == "float32"),
                **t, bound_ms=b, bound_by=by,
                library_call="scaled_dot_product_attention (bool mask, "
                             "K/V pre-expanded to 32 heads)",
                shape=f"B=1 L={L_main} H={H} Hkv={Hkv} D={D} bf16")


# ------------------------------------------------------------- K4 / K5
def _pool(torch, dev, dt, g, P, K, B, fill):
    """A random page pool; row b's table maps fill[b] pages (with a -1
    hole every 7th entry), positions match the table."""
    H, Hkv, D, bsz = (SDAR[k] for k in ("H", "Hkv", "D", "bsz"))
    kp = torch.randn((P, bsz, Hkv, D), generator=g, device=dev).to(dt)
    vp = torch.randn((P, bsz, Hkv, D), generator=g, device=dev).to(dt)
    pos = torch.full((P, bsz), -1, dtype=torch.int32, device=dev)
    table = torch.full((B, K), -1, dtype=torch.int32, device=dev)
    nxt = 1
    for b in range(B):
        for j in range(fill[b]):
            if j % 7 == 6:
                continue                     # a -1 hole
            table[b, j] = nxt
            pos[nxt] = j * bsz + torch.arange(bsz, device=dev)
            nxt += 1
    return kp, vp, pos, table


def k4_phase(torch, dev):
    from repro_torch.kernels import paged_attn as pa
    H, Hkv, D, bsz = (SDAR[k] for k in ("H", "Hkv", "D", "bsz"))
    B, K, P = 4, 32, 129               # 4 slots, max_len 128, dense pool
    fill = [12, 16, 0, 31]
    blk = torch.tensor([12, 10, 0, 31], dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    errs = {}
    main = None
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        kp, vp, pos, table = _pool(torch, dev, dt, g, P, K, B, fill)
        q = torch.randn((B, bsz, H, D), generator=g, device=dev).to(dt)
        ks = torch.randn((B, bsz, Hkv, D), generator=g, device=dev).to(dt)
        vs = torch.randn((B, bsz, Hkv, D), generator=g, device=dev).to(dt)
        positions = (blk[:, None] * bsz
                     + torch.arange(bsz, device=dev)).to(torch.int32)
        limit = blk * bsz                # edges: 0, mid, full
        args = (q, kp, vp, pos, table, ks, vs, positions, limit)
        for name, window, softcap in (("decode", None, None),
                                      ("window_softcap", 9, 30.0)):
            kw = dict(scale=D ** -0.5, window=window, softcap=softcap)
            got = pa.paged_decode_attention(*args, **kw)
            want = pa.paged_decode_attention_plain(*args, **kw)
            torch.cuda.synchronize()
            err = check_close(torch, f"K4 {name}", got, want, dt_name)
            errs[(name, dt_name)] = err
            print(f"[K4] {name:20s} {dt_name:9s} max|err| {err:.3e}")
        if dt_name == "bfloat16":
            main = args

    q, kp, vp, pos, table, ks, vs, positions, limit = main
    kw = dict(scale=D ** -0.5)
    ck = kp[table.clamp(min=0).long()].reshape(B, K * bsz, Hkv, D)
    cv = vp[table.clamp(min=0).long()].reshape(B, K * bsz, Hkv, D)
    cpos = torch.where(table[:, :, None] >= 0,
                       pos[table.clamp(min=0).long()], -1).reshape(B, -1)
    cvis = (cpos >= 0) & (cpos < limit[:, None])
    mask = torch.cat([cvis, torch.ones((B, bsz), dtype=torch.bool,
                                       device=dev)], 1)
    mask = mask[:, None, None, :].expand(B, 1, bsz, -1)
    rep = lambda x: x.repeat_interleave(H // Hkv, dim=2).transpose(1, 2)
    kr, vr = rep(torch.cat([ck, ks], 1)), rep(torch.cat([cv, vs], 1))
    qt = q.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kern = lambda: pa.paged_decode_attention(*main, **kw)
    t = dict(
        ms=device_ms(torch, kern),
        plain_ms=device_ms(torch, lambda: pa.paged_decode_attention_plain(
            *main, **kw)),
        library_ms=device_ms(torch, lambda: sdpa(
            qt, kr, vr, attn_mask=mask, scale=D ** -0.5)),
        call_ms=cuda_ms(torch, kern))
    n_keys = int(cvis.sum()) + B * bsz            # visible pool + self
    kv_bytes = Hkv * 2 * D * 2 + 4
    nbytes = n_keys * kv_bytes + 2 * q.numel() * 2 + table.numel() * 4 \
        + positions.numel() * 4 + B * 4
    flops = 2.0 * n_keys * bsz * H * 2 * D
    b, by = bound_ms(nbytes, flops, "bfloat16")
    return dict(name="K4 paged_decode_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/paged_attn.cu",
                replaces="src/repro/kernels/paged_attn.py:179",
                max_abs_err=errs[("decode", "bfloat16")],
                max_abs_err_f32=max(v for (c, d), v in errs.items()
                                    if d == "float32"),
                **t, bound_ms=b, bound_by=by,
                library_call="scaled_dot_product_attention over the "
                             "pre-gathered pages (gather not timed)",
                shape=f"B={B} n={bsz} K={K} pages={P} H={H} Hkv={Hkv} "
                      f"D={D} bf16")


def k5_phase(torch, dev):
    from repro_torch.kernels import paged_attn as pa
    H, Hkv, D, bsz = (SDAR[k] for k in ("H", "Hkv", "D", "bsz"))
    P, T = 40, 16                      # 4-block suffix after the hit
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    errs = {}
    main = None
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        for Kp in (0, 1, 8):
            kp, vp, pos, _ = _pool(torch, dev, dt, g, P, 1, 1, [0])
            ctx = torch.arange(1, 1 + Kp, dtype=torch.int32,
                               device=dev)[None]
            for j in range(Kp):
                pos[1 + j] = j * bsz + torch.arange(bsz, device=dev)
            q = torch.randn((1, T, H, D), generator=g, device=dev).to(dt)
            ks = torch.randn((1, T, Hkv, D), generator=g, device=dev).to(dt)
            vs = torch.randn((1, T, Hkv, D), generator=g, device=dev).to(dt)
            positions = (Kp * bsz + torch.arange(T, device=dev)
                         ).to(torch.int32)[None]
            args = (q, kp, vp, pos, ctx, ks, vs, positions)
            for name, window, softcap in (("prefill", None, None),
                                          ("window_softcap", 9, 30.0)):
                kw = dict(scale=D ** -0.5, window=window, softcap=softcap)
                got = pa.paged_prefill_attention(*args, **kw)
                want = pa.paged_prefill_attention_plain(*args, **kw)
                torch.cuda.synchronize()
                err = check_close(torch, f"K5 {name} Kp={Kp}", got, want,
                                  dt_name)
                errs[(name, Kp, dt_name)] = err
                print(f"[K5] {name:14s} Kp={Kp} {dt_name:9s} "
                      f"max|err| {err:.3e}")
            if dt_name == "bfloat16" and Kp == 8:
                main = args

    q, kp, vp, pos, ctx, ks, vs, positions = main
    Kp = ctx.shape[1]
    kw = dict(scale=D ** -0.5)
    keys = torch.cat([kp[ctx[0].long()].reshape(1, Kp * bsz, Hkv, D), ks],
                     1)
    vals = torch.cat([vp[ctx[0].long()].reshape(1, Kp * bsz, Hkv, D), vs],
                     1)
    kpos = torch.cat([pos[ctx[0].long()].reshape(1, -1), positions], 1)
    mask = (kpos[:, None, :] // bsz) <= (positions[:, :, None] // bsz)
    rep = lambda x: x.repeat_interleave(H // Hkv, dim=2).transpose(1, 2)
    kr, vr, qt = rep(keys), rep(vals), q.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kern = lambda: pa.paged_prefill_attention(*main, **kw)
    t = dict(
        ms=device_ms(torch, kern),
        plain_ms=device_ms(torch, lambda: pa.paged_prefill_attention_plain(
            *main, **kw)),
        library_ms=device_ms(torch, lambda: sdpa(
            qt, kr, vr, attn_mask=mask[:, None], scale=D ** -0.5)),
        call_ms=cuda_ms(torch, kern))
    n_pairs = int(mask.sum())
    n_keys = (Kp * bsz + T)
    nbytes = n_keys * (Hkv * 2 * D * 2 + 4) + 2 * q.numel() * 2 \
        + Kp * 4 + T * 4
    flops = 2.0 * n_pairs * H * 2 * D
    b, by = bound_ms(nbytes, flops, "bfloat16")
    return dict(name="K5 paged_prefill_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/paged_attn.cu",
                replaces="src/repro/kernels/paged_attn.py:366",
                max_abs_err=errs[("prefill", 8, "bfloat16")],
                max_abs_err_f32=max(v for (c, k_, d), v in errs.items()
                                    if d == "float32"),
                **t, bound_ms=b, bound_by=by,
                library_call="scaled_dot_product_attention over the "
                             "pre-gathered prefix (gather not timed)",
                shape=f"B=1 T={T} Kp={Kp} H={H} Hkv={Hkv} D={D} bf16")


# --------------------------------------------------------------- prompts
def prompts():
    """8 requests: a shared 8-block prefix (BOS + 31 bytes), distinct
    4-block suffixes, two of them repeated (full prefix hits)."""
    prefix = "System: answer with one number.\n"[:31]
    tails = ["Q: 12+34=?\nA:", "Q: 56-7=?\nA: ", "Q: 8*9=?\nA:  ",
             "Q: 3+4*5=?\nA:", "Q: 99-1=?\nA: ", "Q: 2*21=?\nA: "]
    order = [0, 1, 0, 2, 3, 1, 4, 5]
    return [prefix + tails[i] for i in order]


# ---------------------------------------------------------------- parity
def parity_phase(torch, dev):
    from repro_torch.configs import sdar_8b
    from repro_torch.core.masks import plain_layout
    from repro_torch.models.model import BlockDiffLM
    from repro_torch.serving.api import GenerationConfig, SamplingParams
    from repro_torch.serving.scheduler import SlotScheduler
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.data.pipeline import pad_to_block
    t0 = time.perf_counter()
    cfg = sdar_8b.config().replace(n_layers=2)
    base = BlockDiffLM(cfg.replace(attn_impl="chunked"), device=dev)
    params = base.init(seed=0)
    kern = BlockDiffLM(cfg.replace(attn_impl="cuda"), device=dev)
    tok = ByteTokenizer()
    enc = [pad_to_block(tok.encode(p, bos=True), 4, tok.pad_id)
           for p in prompts()[:5]]

    from repro_torch.kernels import block_diff_attn, paged_attn
    counters = (block_diff_attn.block_diff_attention,
                paged_attn.paged_decode_attention,
                paged_attn.paged_prefill_attention)
    before = [c.launches for c in counters]

    ids = torch.tensor([enc[0]], dtype=torch.int32, device=dev)
    meta = plain_layout(ids, torch.ones_like(ids, dtype=torch.bool),
                        block_size=cfg.block_size)
    lk = kern.forward_masked(params, ids, meta)
    lp = base.forward_masked(params, ids, meta)
    err_prompt = max_err(torch, lk, lp)
    worst = err_prompt

    gcfg = GenerationConfig(max_len=128, s_max=4, n_slots=4)
    sk = SlotScheduler(kern, gcfg, kernel="cuda")
    sp = SlotScheduler(base, gcfg, kernel="ref")
    for e in enc:
        for s in (sk, sp):
            s.submit(e, len(e) // 4, None,
                     params=SamplingParams(max_new_blocks=3))
    n_done = 0
    while sk.has_work:
        out_k = sk.step(params)
        out_p = sp.step(params)
        n_done += len(out_k)
        if not torch.equal(sk._state.tokens, sp._state.tokens):
            raise AssertionError("parity: greedy tokens differ")
        if [c.uid for c in out_k] != [c.uid for c in out_p]:
            raise AssertionError("parity: completion order differs")
        # decode logits of the live pool on both paths, no commit
        st_k, st_p = sk._state, sp._state
        live = ~st_k.done
        if live.any():
            blk = st_k.blk.clamp(max=sk.n_blocks_total - 1)
            pos = blk[:, None] * 4 + torch.arange(4, device=dev)
            ids_k = torch.full_like(pos, cfg.resolved_mask_token)
            a = kern.decode_step(params, ids_k, pos.to(torch.int32),
                                 st_k.caches, cache_limit=blk * 4,
                                 block_table=st_k.table, kv_kernel="cuda")
            b = base.decode_step(params, ids_k, pos.to(torch.int32),
                                 st_p.caches, cache_limit=blk * 4,
                                 block_table=st_p.table, kv_kernel="ref")
            worst = max(worst, max_err(torch, a[live], b[live]))
    for ck, cp in zip(sk._state.caches, sp._state.caches):
        if not torch.equal(ck.pos, cp.pos):
            raise AssertionError("parity: page pools hold other positions")
        filled = (ck.pos >= 0)[..., None, None]
        for x, y in ((ck.k, cp.k), (ck.v, cp.v)):
            e = float(((x - y).abs() * filled).max())
            if e > 1e-4:
                raise AssertionError(f"parity: page pools differ by {e}")
    if worst > 1e-3:
        raise AssertionError(f"parity: logits differ by {worst:.3e}")
    ran = [c.launches - b for c, b in zip(counters, before)]
    if min(ran) <= 0 and dev.type == "cuda":
        raise AssertionError(f"parity: the kernel path skipped a kernel "
                             f"(launches K1/K4/K5 {ran})")
    paths = sk.stats.admit_paths
    print(f"[parity] SDAR-8B width, 2 layers, f32: {n_done} requests, "
          f"tokens equal, max |logit diff| {worst:.3e} (prompt "
          f"{err_prompt:.3e}), admissions {paths}, kernel launches "
          f"K1/K4/K5 {ran}, "
          f"{time.perf_counter() - t0:.1f} s")
    if not all(paths.values()):
        raise AssertionError(f"parity: an admission path never ran {paths}")
    del sk, sp, params, base, kern
    torch.cuda.empty_cache()
    return worst


# ----------------------------------------------------------------- serve
def serve_phase(torch, dev):
    from repro_torch.configs import sdar_8b
    from repro_torch.kernels import block_diff_attn, paged_attn
    from repro_torch.models.model import BlockDiffLM
    from repro_torch.serving.engine import RolloutEngine
    from repro_torch.serving.api import GenerationConfig, SamplingParams
    from repro_torch.serving.server import ModelServer
    t0 = time.perf_counter()
    cfg = sdar_8b.config(dtype="bfloat16", param_dtype="bfloat16",
                         attn_impl="cuda")
    model = BlockDiffLM(cfg, device=dev)
    params = model.init(seed=0)
    torch.cuda.synchronize()
    n_params = model.param_count(params)
    print(f"[serve] SDAR-8B {cfg.n_layers} layers bf16: {n_params / 1e9:.2f}"
          f" B params initialised in {time.perf_counter() - t0:.1f} s")
    engine = RolloutEngine(model, ModelServer(params), GenerationConfig(
        max_len=128, s_max=4, n_slots=4, kernel="cuda", prefix_cache=True))
    reqs = prompts()
    for p in reqs:
        engine.submit(p, params=SamplingParams(max_new_blocks=6))
    torch.cuda.reset_peak_memory_stats(dev)
    counters = (block_diff_attn.block_diff_attention,
                paged_attn.paged_decode_attention,
                paged_attn.paged_prefill_attention)
    for c in counters:
        c.launches = 0
    t1 = time.perf_counter()
    outs = list(engine.stream())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = [c.launches for c in counters]
    peak = torch.cuda.max_memory_allocated(dev)
    s, ss = engine.stats, engine.scheduler.stats
    gen = sum(o.gen_tokens for o in outs)
    print(f"[serve] {len(outs)} requests, {ss.ticks} ticks, {gen} tokens in "
          f"{wall:.3f} s = {gen / wall:.1f} tok/s, peak memory "
          f"{peak / 2**30:.2f} GiB, admissions {ss.admit_paths}, "
          f"prefix hit/miss blocks {s.prefix_hit_blocks}/"
          f"{s.prefix_miss_blocks}, launches K1/K4/K5 {launches}")
    if len(outs) != len(reqs) or any(o.gen_blocks < 1 for o in outs):
        raise AssertionError("serve: not every request completed")
    if not all(ss.admit_paths.values()):
        raise AssertionError(f"serve: an admission path never ran "
                             f"{ss.admit_paths}")
    if min(launches) <= 0:
        raise AssertionError(f"serve: a kernel never launched {launches}")
    # the logits the pool decodes from are finite
    st = engine.scheduler._state
    pos = (torch.arange(4, device=dev) + 4 * 10)[None].to(torch.int32)
    ids = torch.full((1, 4), cfg.resolved_mask_token, dtype=torch.int32,
                     device=dev)
    logits = model.decode_step(params, ids, pos, st.caches,
                               cache_limit=torch.tensor([40], device=dev),
                               block_table=st.table[:1], kv_kernel="cuda")
    if not torch.isfinite(logits).all():
        raise AssertionError("serve: non-finite logits")
    return launches, dict(tokens_per_s=gen / wall, ticks=ss.ticks,
                          wall_s=wall, gen_tokens=gen,
                          peak_mem_gib=peak / 2**30,
                          admissions=ss.admit_paths)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[card] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {kind}")

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.load()
    print(f"[build] {len(build.SOURCES)} sources in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    rows = [k1_phase(torch, dev), k4_phase(torch, dev), k5_phase(torch, dev)]
    for r in rows:
        print(f"[time] {r['name']}: kernel {r['ms']:.4f} ms (device; "
              f"{r['call_ms']:.4f} ms per call with the host) | plain "
              f"{r['plain_ms']:.4f} ms | library {r['library_ms']:.4f} ms"
              f" | bound {r['bound_ms']:.5f} ms ({r['bound_by']}) | "
              f"{r['shape']}")
    parity_phase(torch, dev)
    launches, serve = serve_phase(torch, dev)
    for r, n in zip(rows, launches):
        r["launches"] = n
    print(json.dumps({"serve": serve, "card": card}))
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    line = {"kernels": [{**{k: r[k] for k in keys},
                         **{k: v for k, v in r.items() if k not in keys}}
                        for r in rows]}
    for r in line["kernels"]:
        for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms"):
            if not math.isfinite(r[k]):
                raise AssertionError(f"{r['name']}: {k} is not finite")
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
