#!/usr/bin/env python3
"""Where the port's time goes on the GPU: a torch.profiler breakdown.

Run from the repository root with one card visible:

    python3 profile_torch.py [--seed N] [--out DIR] [--model NAME]

Traces chip_smoke.py's workload (its ``workload``: GPT-2 small in bf16 with
random weights from the seed, batch 8, 704-token prompt, 1024-slot cache,
the per-op decode Impl): one prefill, then 8 decode steps; then one decode
dispatch of the serving engine (chip_smoke.py's engine geometry: 8 slots,
256 blocks of 128, the first 8 of its prompts just prefilled) through each
decode backend, 8 per-op steps and 16 K8 steps. ``--model`` traces another
preset instead (chip_smoke.py's families phase: random bf16 weights from
the seed, the same batch, prompt and cache, ``Impl(attention="flash",
norm="fused")``): its prefill and 8 decode steps on the route
``decode_route`` picks, no engine. Each region runs on its own
after a warm-up. Prints one JSON line per region with its
wall ms (host clock around work ending in ``torch.cuda.synchronize()``), the
device-busy ms (the union of the kernels' intervals in the trace), the idle
share, and the kernels by total device time. With ``--out`` it also writes
each region's Chrome trace there.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from chip_smoke import B, CACHE, nvidia_smi, workload
from mlio_tpu_torch.profiling import device_busy_ms

STEPS = 8  # decode steps traced


def _region(name, fn, out_dir, top=12):
    fn()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    busy = device_busy_ms(events)
    kernels = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(e.name, [0, 0.0])
            k[0] += 1
            k[1] += (e.time_range.end - e.time_range.start) / 1e3
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:top]
    if out_dir:
        prof.export_chrome_trace(os.path.join(out_dir, f"trace_{name}.json"))
    print(json.dumps(dict(
        region=name, wall_ms=wall_ms, device_busy_ms=busy,
        idle_share=1 - busy / wall_ms if busy else None,
        kernels=[dict(name=n[:90], calls=c, ms=ms) for n, (c, ms) in ranked])), flush=True)
    if not busy:
        raise RuntimeError(f"{name}: the trace holds no device time")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--model", default="gpt2")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mlio_tpu_torch.models import Impl, forward, load_model
    from mlio_tpu_torch.runtime import init_cache

    if args.out:
        os.makedirs(args.out, exist_ok=True)
    dev = torch.device("cuda", 0)
    spec, params, ids, impl = workload(args.seed, dev)
    if args.model != "gpt2":
        del params
        spec, params = load_model(args.model, dtype=torch.bfloat16, device=dev, seed=args.seed)
        impl = Impl(attention="flash", norm="fused")
    print(json.dumps(dict(nvidia_smi=nvidia_smi(), torch=torch.__version__)))

    def prefill():
        cache = init_cache(spec, B, CACHE, dtype=torch.bfloat16, device=dev)
        return forward(params, spec, ids, impl=impl, cache=cache)

    with torch.inference_mode():
        _region("prefill", prefill, args.out)
        logits, cache = prefill()
        tok = logits[:, -1].argmax(-1)[:, None]

        def decode():
            c = cache
            t = tok
            for _ in range(STEPS):
                lg, c = forward(params, spec, t, impl=impl, cache=c)
                t = lg[:, -1].argmax(-1)[:, None]

        _region(f"decode_{STEPS}_steps", decode, args.out)
        for stack, k in (() if args.model != "gpt2" else (("perop", STEPS), ("mega", 2 * STEPS))):
            _region(f"engine_{stack}_{k}_steps", engine_dispatch(spec, params, impl, stack, k),
                    args.out)
    return 0


def engine_dispatch(spec, params, impl, stack, k):
    """A function running one k-step decode dispatch of the engine from the
    state after prefilling chip_smoke.py's first B prompts."""
    from chip_smoke import POOL_BLOCKS, POOL_BS, engine_prompts
    from mlio_tpu_torch.runtime import InferenceEngine
    from mlio_tpu_torch.runtime import engine as engine_mod

    eng = InferenceEngine(spec, params, max_batch=B, num_blocks=POOL_BLOCKS, block_size=POOL_BS,
                          impl=impl, steps_per_dispatch=k, decode_stack=stack)
    for prompt in engine_prompts(0, spec.vocab_size)[:B]:
        eng.submit(prompt, 64)
    eng._prefill_batch(list(eng.sched.admit()))
    eng.sched.plan_multi_step(k)
    cur, tables, ctx = (eng._upload(a) for a in (eng.sched.cur, eng.sched.tables, eng.sched.ctx))
    if stack == "mega":
        return lambda: engine_mod._decode_mega_steps(
            params, eng._lm_w, cur, eng.k_pool, eng.v_pool, tables, ctx, eng.generator,
            spec=spec, k=k, method=eng.method, lm_vmajor=eng._lm_vmajor)
    return lambda: engine_mod._decode_multi_steps(
        params, cur, eng.k_pool, eng.v_pool, tables, ctx, eng.generator, spec=spec, impl=impl,
        k=k, method=eng.method)


if __name__ == "__main__":
    sys.exit(main())
