"""Serving launcher: stand up a RolloutEngine and answer a request batch.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tiny --smoke
  PYTHONPATH=src python -m repro_torch.launch.serve --arch sdar-8b \\
      --dtype bfloat16 --max-len 128 --s-max 4

Defaults are the main path: a paged continuous pool with the prefix
cache on, decode and suffix prefill through the in-place CUDA kernels
(``--kernel cuda``) and prompt prefill through K1 (``attn_impl="cuda"``).
Weights are the port's seeded random init (``--seed``).  ``--device``
defaults to ``cuda`` and the launcher refuses to fall back to the CPU;
``--device cpu`` runs the kernels' plain versions.

``--tau`` and ``--temperature`` accept comma lists that round-robin over
the requests as per-request ``SamplingParams`` on one pool.
"""

from __future__ import annotations

import argparse
import random


def _float_list(s: str) -> list[float]:
    return [float(v) for v in s.split(",") if v != ""]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tiny")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weight init")
    ap.add_argument("--dtype", choices=["float32", "bfloat16"],
                    default="float32", help="parameter / activation dtype")
    ap.add_argument("--tau", type=_float_list, default=[0.9])
    ap.add_argument("--temperature", type=_float_list, default=[0.0])
    ap.add_argument("--max-new-blocks", type=int, default=None)
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--s-max", type=int, default=8)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batching", choices=["continuous"],
                    default="continuous")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cache", choices=["paged"], default="paged")
    ap.add_argument("--pages", type=int, default=None)
    ap.add_argument("--kernel", choices=["cuda", "ref"], default="cuda",
                    help="paged KV layout: read pages in place with the "
                         "CUDA kernels (cuda) or gather them (ref)")
    ap.add_argument("--attn-impl", choices=["cuda", "chunked", "ref"],
                    default="cuda", help="prompt-prefill attention")
    ap.add_argument("--prefix-cache", default=True,
                    action=argparse.BooleanOptionalAction)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="after one warm-up request, record the serve "
                         "loop with torch.profiler: a Chrome trace and a "
                         "table of time by kernel go into DIR")
    return ap


def _profiled(device, out_dir, fn):
    """Run ``fn`` under torch.profiler; write trace.json and kernels.txt
    into ``out_dir`` and print the device busy share of the window."""
    import os
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        result = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
    events = prof.key_averages()
    sort = "self_cuda_time_total" if device.type == "cuda" \
        else "self_cpu_time_total"
    table = events.table(sort_by=sort, row_limit=30)
    with open(os.path.join(out_dir, "kernels.txt"), "w") as f:
        f.write(table)
    print(table)
    if device.type == "cuda":
        # device kernels only: operator rows carry the same time again
        busy_us = sum(e.self_device_time_total for e in events
                      if e.device_type == DeviceType.CUDA)
        print(f"[profile] window {wall:.3f} s, device busy "
              f"{busy_us / 1e6:.3f} s = {busy_us / 1e6 / wall:.1%}")
    return result


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from repro_torch import configs, resolve_device
    from repro_torch.data.math_tasks import sample_problem
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.models.model import BlockDiffLM
    from repro_torch.serving.engine import (GenerationConfig, RolloutEngine,
                                            SamplingParams)
    from repro_torch.serving.server import ModelServer

    device = resolve_device(args.device)
    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    cfg = cfg.replace(dtype=args.dtype, param_dtype=args.dtype,
                      attn_impl=args.attn_impl)
    model = BlockDiffLM(cfg, device=device)
    server = ModelServer(model.init(args.seed))
    engine = RolloutEngine(model, server, GenerationConfig(
        max_len=args.max_len, s_max=args.s_max, mode="dynamic",
        tau=args.tau[0], temperature=args.temperature[0],
        n_slots=args.slots, n_pages=args.pages,
        prefix_cache=args.prefix_cache, kernel=args.kernel))
    rng = random.Random(0)
    prompts = [sample_problem(rng, level=0).prompt
               for _ in range(args.requests)]
    eos = ByteTokenizer().eos_id
    if args.profile_dir:
        engine.submit("warm-up", params=SamplingParams(max_new_blocks=1))
        list(engine.stream())
        engine.stats = type(engine.stats)()
    first = engine.scheduler._next_uid
    for i, p in enumerate(prompts):
        engine.submit(p, params=SamplingParams(
            tau=args.tau[i % len(args.tau)],
            temperature=args.temperature[i % len(args.temperature)],
            max_new_blocks=args.max_new_blocks, eos_id=eos, seed=i))

    def serve():
        return {o.uid - first: o for o in engine.stream()}

    outs = _profiled(device, args.profile_dir, serve) \
        if args.profile_dir else serve()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    for uid in sorted(outs):
        o = outs[uid]
        print(f"{prompts[uid]!r} -> {o.text!r}")
        print(f"  [{uid}] finish={o.finish_reason} "
              f"latency={o.latency_ticks} ticks")
    s, ss = engine.stats, engine.scheduler.stats
    print(f"[engine] {s.rollouts} rollouts | {s.total_tokens} tokens | "
          f"{s.tokens_per_step:.2f} tokens/denoise-step | "
          f"{s.total_tokens / max(s.wall_seconds, 1e-9):.0f} tok/s | "
          f"slot-util {s.utilization:.0%} | latency p50 "
          f"{s.latency_percentile(50):.0f}/p95 "
          f"{s.latency_percentile(95):.0f} ticks | prefix-hit "
          f"{s.prefix_hit_rate:.0%} | kernel {args.kernel} "
          f"(transient KV {s.transient_kv_bytes / 1024:.0f} KiB/tick, "
          f"admit {s.admit_transient_kv_bytes / 1024:.0f} KiB) | "
          f"admissions {ss.admit_paths} | device {device}")
    return outs


if __name__ == "__main__":
    main()
