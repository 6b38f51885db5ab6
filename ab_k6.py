"""K6 (the tiled decode megakernel) and K4 and K8 (the decode megakernels of
decode_stack.cuh) at their main shapes, and the decode steps that run them,
timed on one card from one checkout of this repository: one JSON line.

    python3 ab_k6.py [--tree DIR] [--label NAME] [--only stack] [--rounds N]

DIR (default: the directory of this script) is the checkout whose
``chip_smoke.py`` and ``mlio_tpu_torch`` are imported and whose kernels are
built. To compare two commits, unpack the other one into a git-ignored
directory (``git archive <commit> | tar -x -C build/parent``) and run, in one
call on the card: the other, this, this, the other.

The line carries the card's name and power limit and the device ms
(``chip_smoke.time_ms``) of one K6 launch, with its phase durations where
the checkout's kernel stamps them, at: llama3-8b at full width and depth
(bf16 weights over a bf16 cache; int8 weights over an INT8 cache), B 8,
context 896 in a 1024-slot cache; Mixtral-8x7B at full depth with int8
weights over an INT8 cache at B 8 and the same context; Mixtral-8x7B at 4
layers (int8, INT8 cache) at B 1 and B 32. Then the decode step of
``generate`` on the "tiled" route (two-length marginal, 16 against 80 new
tokens after a 704-token prompt at B 8): llama3-8b bf16, the quick start's
llama3-8b (int8, INT8 cache) and Mixtral-8x7B (int8, INT8 cache,
``moe="ragged"``).

K4 and K8 (``--only stack`` runs these alone, without K6's part, whose
models take most of a call): K4 at GPT-2 small, B 8, context 896, the
tied-head greedy epilogue (bf16; int8 weights over an INT8 cache; int8
weights alone; an INT8 cache alone; int8 weights but wo and w_down over an
INT8 cache), and at llama3-8b's width with 2 of its layers (int8 weights
over an INT8 cache, the untied head), with block 0's phase durations; K8 at
GPT-2 small over the engine's pools at chip_smoke.py's ragged contexts (the
GPT-2 rows ``--rounds`` times, each a list of one entry a round); the
decode step of GPT-2 small's ``generate`` on its default route (K4) and of
the quick start's llama3-8b on the "mega" route (K4). One model is loaded at
a time and freed before the next. Random weights from seed 0. Needs a CUDA
card.
"""
import argparse
import dataclasses
import gc
import json
import os
import sys
import time

import numpy as np
import torch

B, CACHE, CTX, PROMPT = 8, 1024, 896, 704
SHORT, LONG = 16, 80  # new tokens of the decode step's two-length marginal


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--label", default=None)
    ap.add_argument("--only", choices=("all", "stack"), default="all")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_k6: no CUDA device is available", file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import chip_smoke as cs
    from mlio_tpu_torch.models import Impl, get_spec, init_params, rope_cos_sin
    from mlio_tpu_torch.ops import _build
    from mlio_tpu_torch.ops import decode_tiled as dt
    from mlio_tpu_torch.ops.quant import quantize_kv
    from mlio_tpu_torch.runtime import generate, quantize_params
    from mlio_tpu_torch.runtime.quantization import init_quantized_params

    if not os.path.samefile(_build.CSRC.parents[1], tree):
        raise RuntimeError(f"ab_k6: imported the port from {_build.CSRC}, not from {tree}")
    t_start = time.perf_counter()
    out = dict(tree=tree, label=args.label or os.path.basename(tree), nvidia_smi=cs.nvidia_smi(),
               build_s=_build.build_all(tuple(n for n in _build.SOURCES if n in (
                   ("flash_fwd", "fused_norm", "quant_matmul", "decode_layer", "decode_layer_kv8",
                    "paged_stack") + (() if args.only == "stack" else (
                        "decode_tiled_bf16", "decode_tiled_int8", "decode_attn"))))))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(6)
    k6, steps = out["k6_ms"], out["step_ms"] = {}, {}
    phases = out["k6_phase_us"] = {}

    def caches(spec, batch, kv8):
        shape = (spec.num_layers, batch, CACHE, spec.num_kv_heads, spec.head_size)
        kc, vc = (torch.randn(shape, generator=gen, device=dev) for _ in range(2))
        if kv8:
            (kc, ks), (vc, vs) = quantize_kv(kc), quantize_kv(vc)
            return kc, vc, dict(k_scales=ks, v_scales=vs)
        return kc.to(torch.bfloat16), vc.to(torch.bfloat16), {}

    def time_k6(key, spec, blocks, batch, kv8):
        kc, vc, sk = caches(spec, batch, kv8)
        x = torch.randn((batch, spec.hidden_size), generator=gen, device=dev).to(torch.bfloat16)
        pos = CTX - 1
        cos, sin = rope_cos_sin(torch.arange(pos, pos + 1, device=dev), spec.rope_dim,
                                spec.rope_theta)

        def call(i):
            return dt.decode_layer_tiled(x, blocks, kc, vc, pos, cos, sin, spec=spec, **sk)

        k6[key] = cs.time_ms(call, 10)[0]
        stamps = torch.zeros(dt.phase_stamps(spec), dtype=torch.int64, device=dev)
        dt.decode_layer_tiled(x, blocks, kc, vc, pos, cos, sin, spec=spec, phase_times=stamps,
                              **sk)
        phases[key] = cs.tiled_phase_us(dt, spec, stamps)
        del kc, vc, sk

    def step_ms(key, spec, params, impl, quant):
        ids = torch.from_numpy(np.random.default_rng(0).integers(
            0, spec.vocab_size, (B, PROMPT))).to(dev)

        def run(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            generate(params, spec, ids, max_new_tokens=n, impl=impl, cache_len=CACHE,
                     cache_quant=quant, device=dev)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        run(4)  # warm-up
        steps[key] = (run(LONG) - run(SHORT)) / (LONG - SHORT) * 1e3

    def free():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    stack_part(cs, dev, gen, out, step_ms, free, args.rounds)
    if args.only == "stack":
        out["seconds"] = time.perf_counter() - t_start
        print(json.dumps(out))
        return 0

    tiled = Impl(attention="flash", norm="fused", decode_stack="tiled")
    spec = get_spec(cs.LLAMA)
    params = init_params(spec, torch.Generator(device=dev).manual_seed(0), dtype=torch.bfloat16,
                         device=dev)
    time_k6("llama3_8b_bf16", spec, params["blocks"], B, False)
    step_ms("generate_8b_tiled_bf16", spec, params, tiled, None)
    q8 = quantize_params(params, spec, "int8")
    del params
    free()
    time_k6("llama3_8b_w8kv8", spec, q8["blocks"], B, True)
    step_ms("generate_8b_tiled_w8kv8", spec, q8, tiled, "int8")
    del q8
    free()

    spec = get_spec(cs.MIXTRAL)
    params = init_quantized_params(spec, torch.Generator(device=dev).manual_seed(0), "int8",
                                   quantize_lm_head=True, device=dev)
    time_k6("mixtral_w8kv8", spec, params["blocks"], B, True)
    step_ms("generate_moe", spec, params, Impl(attention="flash", norm="fused", moe="ragged"),
            "int8")
    del params
    free()

    spec4 = dataclasses.replace(spec, num_layers=4)
    bf = init_params(spec4, torch.Generator(device=dev).manual_seed(7), dtype=torch.bfloat16,
                     device=dev)
    q8 = quantize_params(bf, spec4, "int8")
    del bf
    free()
    for batch in (1, 32):
        time_k6(f"mixtral_4_layers_w8kv8_b{batch}", spec4, q8["blocks"], batch, True)
    del q8
    free()
    out["seconds"] = time.perf_counter() - t_start
    print(json.dumps(out))
    return 0


def stack_part(cs, dev, gen, out, step_ms, free, rounds):
    """K4's and K8's rows of the line (see the module note)."""
    from mlio_tpu_torch.models import Impl, get_spec, init_params, load_model
    from mlio_tpu_torch.ops import decode_layer as dl
    from mlio_tpu_torch.ops import decode_paged_stack as dps
    from mlio_tpu_torch.ops.quant import quantize_kv
    from mlio_tpu_torch.runtime import quantize_params

    ms, phases = out["k4_k8_ms"], out["k4_k8_phase_us"] = {}, {}
    pos = CTX - 1

    def time_k4(key, spec, params, kv8):
        x, kc, vc, cos, sin, kw = cs.stack_inputs(spec, params, B, CACHE, pos, 1, gen)
        sk = {}
        if kv8:
            (kc, ks), (vc, vs) = quantize_kv(kc.float()), quantize_kv(vc.float())
            sk = dict(k_scales=ks, v_scales=vs)
        blocks = params["blocks"]
        t = cs.time_ms(lambda i: dl.decode_layer_stack(x, blocks, kc, vc, pos, cos, sin,
                                                       **kw, **sk), 20)[0]
        stamps = torch.zeros(dl.phase_stamps(spec), dtype=torch.int64, device=dev)
        dl.decode_layer_stack(x, blocks, kc, vc, pos, cos, sin, phase_times=stamps, **kw, **sk)
        ms.setdefault(key, []).append(t)
        phases.setdefault(key, []).append(cs.phase_us(spec, stamps))

    spec, params = load_model("gpt2", dtype=torch.bfloat16, device=dev, seed=0)
    q8 = quantize_params(params, spec, "int8")
    mixed = quantize_params(params, spec, "int8", skip=("wo", "w_down"))
    # K8 at the ragged contexts over the engine's pools
    shape = (spec.num_layers, cs.POOL_BLOCKS, cs.POOL_BS, spec.num_kv_heads, spec.head_size)
    kp = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    vp = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    tables = cs.paged_tables(gen, dev, B, cs.TABLE_BLOCKS, cs.POOL_BLOCKS)
    past = torch.tensor(cs.RAGGED, dtype=torch.int32, device=dev)
    ids = torch.randint(0, spec.vocab_size, (B,), generator=gen, device=dev)
    x, _, _ = cs.paged_x(spec, params, ids, past)
    pkw = dict(spec=spec, head_norm=(params["final_scale"], params["final_bias"]),
               lm_head=params["tok_embed"], lm_head_bias=None, lm_vmajor=True)
    for _ in range(rounds):
        time_k4("k4_gpt2_bf16", spec, params, False)
        time_k4("k4_gpt2_w8kv8", spec, q8, True)
        time_k4("k4_gpt2_w8", spec, q8, False)
        time_k4("k4_gpt2_kv8", spec, params, True)
        time_k4("k4_gpt2_w8kv8_wo_wdown_bf16", spec, mixed, True)
        ms.setdefault("k8_gpt2_ragged", []).append(cs.time_ms(lambda i: dps.decode_paged_stack(
            x, params["blocks"], kp, vp, tables, past, **pkw), 20)[0])
        stamps = torch.zeros(dl.phase_stamps(spec), dtype=torch.int64, device=dev)
        dps.decode_paged_stack(x, params["blocks"], kp, vp, tables, past, phase_times=stamps,
                               **pkw)
        phases.setdefault("k8_gpt2_ragged", []).append(cs.phase_us(spec, stamps))
    del kp, vp, q8, mixed
    step_ms("generate_gpt2", spec, params, Impl(attention="flash", mlp="fused", norm="fused"),
            None)
    del params
    free()
    spec2 = dataclasses.replace(get_spec(cs.LLAMA), num_layers=2)
    bf = init_params(spec2, torch.Generator(device=dev).manual_seed(0), dtype=torch.bfloat16,
                     device=dev)
    time_k4("k4_llama3_8b_2_layers_w8kv8", spec2, quantize_params(bf, spec2, "int8"), True)
    del bf
    free()
    spec = get_spec(cs.LLAMA)
    bf = init_params(spec, torch.Generator(device=dev).manual_seed(0), dtype=torch.bfloat16,
                     device=dev)
    q8 = quantize_params(bf, spec, "int8")
    del bf
    free()
    step_ms("generate_8b_mega_w8kv8", spec, q8,
            Impl(attention="flash", norm="fused", decode_stack="mega"), "int8")
    del q8
    free()


if __name__ == "__main__":
    sys.exit(main())
