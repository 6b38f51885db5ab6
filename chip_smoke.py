#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mlio_tpu_torch``) on one NVIDIA GPU.

Run from the repository root, with one card visible:

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line; any failure exits non-zero and no
phase's failure is caught:

1. device: needs ``torch.cuda.is_available()``; reads nvidia-smi's name and
   power limit.
2. build: builds every kernel of ``mlio_tpu_torch/csrc`` with nvcc
   (in parallel, into ``build/kernels``) and reports the seconds.
3. kernels: each kernel of the main paths (K1 flash prefill, K2 fused norm,
   K3 decode attention, K4 decode megakernel, K7 paged attention, K8 paged
   decode megakernel, K11 fused MLP, K12 fused norm + QKV, K5 dequant-fused
   int8 / int4 / grouped-int4 matmul) at the main paths' shapes, on inputs
   from the seed:
   held against its plain PyTorch version on the card in bf16 within the
   stated tolerance, then timed with CUDA events beside its plain version,
   one PyTorch library call of the same function where there is one, and
   the least time the card could take (bound). K3's, K4's, K7's and K8's
   checks are shown to catch a context one token short; K4 is also held
   against its plain version over 8 in-kernel steps. K7 and K8 run over the
   engine's pools (256 blocks of 128, permuted tables) at ragged contexts
   and at a context of 896; K8 also with two inactive engine slots, whose
   rows are not compared and must not touch a live row. K11, K12 and K5 run
   at the runner's GPT-2 shapes (8 x 704 rows) and at one llama3-8b layer's
   (2048 rows; K5 int8 also at 8 rows), and each must fail its check against
   the plain version with the weight's last 32 rows of K zeroed. Then the
   kernels' other instances at small, ragged shapes (variants).
4. generate: GPT-2 small at full width, bf16, random weights from the seed,
   batch 8, a 704-token prompt, a 1024-slot cache,
   ``Impl(attention="flash", norm="fused")`` with the default decode (K4).
   The prefill logits are held against the same forward with every kernel
   replaced by its plain version; the launch counters are zeroed just before
   a 64-token greedy generate and read just after, and must show every
   prefill attention and norm on a kernel and the whole decode in one K4
   launch; prefill time, the decode step time by the two-length marginal
   (64 vs 320 new tokens) and K4's device time a step.
5. generate_scan: the same generate with ``decode_stack="scan"`` (the
   per-layer decode through K3 and K2), its launch counts and step time.
6. engine: the serving engine (``InferenceEngine``) on GPT-2 small with
   bench_extra.py's engine_bench workload: 8 slots, 256 pool blocks of 128,
   24 prompts of 8..119 tokens from the seed, 256 new tokens each, 128 decode
   steps a dispatch, after a warm-up wave. The launch counters, zeroed after
   the warm-up, must show K8 once per decode step (768) and K1/K2 12/25 per
   prefill call; then 8 prompts and 64 tokens through the per-op decode
   (K7 12 per step); generated tok/s, one dispatch's device and wall ms, the
   idle share, the ratio to the port's K4 generate tok/s at batch 8, and one
   decode step through both backends from one state (logits within 0.1).
7. runner: the inference runner on GPT-2 small at full width, bf16, a
   [8, 704] prompt: ``benchmark_optimization_impact`` with its seven default
   configurations, then runners with ``fused_ln_qkv``, int4 weights (g 128)
   and int4 weights with per-channel scales. Each configuration's
   ``run_inference`` runs with the launch counters zeroed just before it and
   read just after (K11 12 a forward where the MLP is fused, K5 72 where the
   weights are quantized, K12 12 with K2 13 for ``fused_ln_qkv``), and its
   logits must lie within 0.1 of the same configuration with every kernel
   replaced by its plain version; mean and p99 ms, peak bytes, speedup.

Then the ``{"kernels": [...]}`` summary line, nvidia-smi's line, and last
``{"ok": true, "device": {...}}``. Imports neither JAX nor ``mlio_tpu``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

# Published H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel
# is the larger of its bytes over the memory rate and its operations over
# the peak rate of their type.
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
FP32_FLOPS = 67e12

B, PROMPT, CACHE = 8, 704, 1024   # bench.py's main-path workload
DECODE_CTX = 896                  # a decode step's context inside 705..1023
SHORT, LONG = 64, 320             # new tokens of the two-length marginal
RUNNER_ITERS = 3                  # timed forwards a runner config (the harness's default)

# The engine's pools (bench_extra.py's engine_bench): 256 blocks of 128 slots;
# the paged kernels' checks take B = 8 tables of 8 blocks each, permuted over
# blocks 1..255 (block 0 is the scratch block), at these ragged past
# contexts, then all at DECODE_CTX.
POOL_BLOCKS, POOL_BS, TABLE_BLOCKS = 256, 128, 8
RAGGED = (1, 15, 16, 127, 128, 500, 895, 1022)
N_PROMPTS, ENGINE_NEW, WARM_NEW, DISPATCH = 24, 256, 128, 128  # engine_bench

# bf16 tolerances, |kernel - plain| <= atol + rtol * |plain|: a few bf16
# ulps (2^-8 relative), for sums taken in another order and, in K1, p
# rounded to bf16 against a running instead of the final row max. K3 keeps
# fp32 throughout at one query head per KV head (GPT-2) and differs from its
# plain version only by the output's rounding (one ulp is at most 2^-7
# relative), so its limit is tight enough to catch a context one token short
# (about 1e-2 at ctx 896). With grouped heads K3 rounds p to bf16 against a
# running max, as K1 does, and takes the looser limit.
#
# K4's x_out and cache slots come out of 12 bf16 layers: the kernel sums its
# products in another order than the plain version and takes a running
# softmax max, so a bf16 rounding of an intermediate (h, attn, activation)
# can fall the other way and move what follows by one bf16 ulp of that
# element. Reversing the summation order of every product in the plain
# version moved x_out of 4 GPT-2 layers by at most 0.03125 where |x| <= 5
# (CPU, bf16); the limit 5e-2 + 5e-2*|plain| leaves room for 12 layers. The
# same run at pos - 1 moved x_out by 3.3, far past it.
#
# K7 keeps fp32 between its bf16 loads and its output, grouped heads too, and
# takes K3's limits; K8 takes K4's (its phases are K4's).
#
# K5, K11 and K12 sum their products in fp32 in another order than the plain
# versions (fp32 matmuls): their bf16 outputs differ by the output's rounding
# (one ulp, 2^-8 relative) and, in K11 and K12, by an intermediate (the
# activation, the normalised x) rounded to bf16 the other way, which moves
# an output by a small fraction of an ulp. K11 also adds its partial sums
# with atomics in no fixed order. 1e-2 + 1e-2*|plain| holds them; zeroing
# the weight's last 32 rows of K moves the outputs far past it.
TOL = {"flash_attention": (2e-2, 2e-2), "fused_norm": (1e-2, 1e-2),
       "decode_attention": (1e-3, 2 ** -7), "decode_attention_grouped": (1e-2, 1e-2),
       "decode_layer_stack": (5e-2, 5e-2), "paged_attention": (1e-3, 2 ** -7),
       "paged_attention_grouped": (1e-2, 1e-2), "decode_paged_stack": (5e-2, 5e-2),
       "quant_matmul": (1e-2, 1e-2), "quant_matmul_int4": (1e-2, 1e-2),
       "quant_matmul_int4_group": (1e-2, 1e-2), "fused_mlp": (1e-2, 1e-2),
       "fused_norm_matmul": (1e-2, 1e-2)}
# Logits of GPT-2 small (std ~0.5 with random weights) through 12 bf16
# layers: kernels against plain versions, max-abs. Random weights make the
# argmax flip on bf16 noise, so a token is checked as "the plain logit at
# the kernel's token is within LOGITS_ATOL of the plain maximum".
LOGITS_ATOL = 0.1


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def _sleep_cycles_per_ms() -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    end.synchronize()
    return 10_000_000 / start.elapsed_time(end)


def time_ms(fn, reps: int, warmup: int = 3):
    """(device ms, call ms) per call of fn(i), by CUDA events over reps calls.

    Call ms paces the calls from the host, so it includes the wrapper's host
    work when that is longer than the kernel. For device ms a sleep kernel
    holds the stream while the calls are queued; they then run back to back
    and the events see the device's time alone."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for i in range(reps):
        fn(i)
    end.record()
    end.synchronize()
    call_ms = start.elapsed_time(end) / reps
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda._sleep(int(2 * host_ms * _sleep_cycles_per_ms()))
    start.record()
    for i in range(reps):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, call_ms


def bound(nbytes: float, ops: float, peak_ops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def timings(kernel, plain, library, reps: int) -> dict:
    """Device ms of the kernel (as both ``ms`` and ``kernel_ms``), of its
    plain version and of the library call (None where no single PyTorch
    call computes the function), and the kernel's host-paced call ms."""
    ms, call_ms = time_ms(kernel, reps)
    return dict(ms=ms, kernel_ms=ms, call_ms=call_ms,
                plain_ms=time_ms(plain, max(4, reps // 5))[0],
                library_ms=None if library is None else time_ms(library, reps)[0])


def within(name: str, got: torch.Tensor, want: torch.Tensor):
    """(whether got is finite and within name's tolerance of want, max-abs)."""
    atol, rtol = TOL[name]
    got, want = got.float(), want.float()
    err = (got - want).abs()
    ok = bool(torch.isfinite(got).all()) and not bool((err > atol + rtol * want.abs()).any())
    return ok, err.max().item()


def check_close(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    ok, err = within(name, got, want)
    if not ok:
        atol, rtol = TOL[name]
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"(max_abs_err {err}, atol {atol}, rtol {rtol})")
    return err


def stack_inputs(spec, params, batch, smax, pos, steps, gen, epilogue=True):
    """Seeded bf16 caches [L, batch, smax, Hkv, D], x (the embedding rows of
    seeded ids) and K4's keyword arguments for ``steps`` steps from ``pos``."""
    from mlio_tpu_torch.models import rope_cos_sin

    dev = params["tok_embed"].device
    shape = (spec.num_layers, batch, smax, spec.num_kv_heads, spec.head_size)
    kc = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    vc = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    ids = torch.randint(0, spec.vocab_size, (batch,), generator=gen, device=dev)
    learned = spec.positional == "learned"
    cos = sin = None
    if not learned:
        cos, sin = rope_cos_sin(torch.arange(pos, pos + steps, device=dev), spec.rope_dim,
                                spec.rope_theta)
    kw = dict(spec=spec, steps=steps, pos_embed=params["pos_embed"] if learned else None)
    if epilogue:
        tied = params["lm_head"] is None
        kw.update(head_norm=(params["final_scale"], params["final_bias"]),
                  lm_head=params["tok_embed"] if tied else params["lm_head"],
                  lm_head_bias=params["lm_head_bias"], lm_vmajor=tied)
    return params["tok_embed"][ids], kc, vc, cos, sin, kw


def plain_logits(dl, spec, kw, x_out):
    """The epilogue's logits in plain PyTorch from a step's x_out."""
    return dl.logits_plain(x_out, kw["head_norm"], kw["lm_head"], kw["lm_head_bias"], spec=spec,
                           lm_vmajor=kw["lm_vmajor"], dtype=x_out.dtype)


def stack_check(dl, spec, params, x, kc, vc, pos, cos, sin, kw):
    """K4 from (x, kc, vc) against its plain version, which is fed the
    kernel's own tokens step by step (teacher forcing). Checks x_out after the
    last step, every slot written, that no other slot changed, and each
    step's token by LOGITS_ATOL. Returns (plain x_out of the last step, the
    errors)."""
    steps = kw["steps"]
    kk, kv = kc.clone(), vc.clone()
    xk, tk = dl.decode_layer_stack(x, params["blocks"], kk, kv, pos, cos, sin, **kw)
    torch.cuda.synchronize()
    pk, pv = kc.clone(), vc.clone()
    one = dict(kw, steps=1)
    xin, gap = x, 0.0
    for s in range(steps):
        cs = (cos[s:s + 1], sin[s:s + 1]) if cos is not None else (None, None)
        xp, _ = dl.decode_layer_stack_plain(xin, params["blocks"], pk, pv, pos + s, *cs, **one)
        if tk is not None:
            tok = tk.reshape(steps, -1)[s].long()
            logits = plain_logits(dl, spec, kw, xp)
            gap = max(gap, (logits.max(-1).values
                            - logits.gather(1, tok[:, None])[:, 0]).max().item())
            if s + 1 < steps:  # multi-step runs the tied head: the token's embedding row
                xin = kw["lm_head"][tok]
    if gap > LOGITS_ATOL:
        raise AssertionError(f"decode_layer_stack: a kernel token's plain logit is {gap} below "
                             f"the plain maximum (> {LOGITS_ATOL})")
    written = slice(pos, pos + steps)
    for got, want, name in ((kk, kc, "k"), (kv, vc, "v")):
        rest = torch.ones(kc.shape[2], dtype=torch.bool, device=kc.device)
        rest[written] = False
        if not torch.equal(got[:, :, rest], want[:, :, rest]):
            raise AssertionError(f"decode_layer_stack: {name} slots outside {pos}..{pos + steps - 1} "
                                 "changed")
    errs = dict(x_out=check_close("decode_layer_stack", xk, xp),
                k_slots=check_close("decode_layer_stack", kk[:, :, written], pk[:, :, written]),
                v_slots=check_close("decode_layer_stack", kv[:, :, written], pv[:, :, written]))
    if tk is not None:
        errs["token_logit_gap"] = gap
    return xp, errs


def stack_bound(spec, params, batch, slots):
    """(bound ms, bound_by) of one decode step with the tied-head epilogue
    (K4, K8): every weight, bias and norm, the lm_head and the K/V of
    ``slots`` cache slots (summed over the batch) of every layer read once;
    x, a position row, x_out and the tokens."""
    blocks = [t for t in params["blocks"].values() if t is not None]
    H, L = spec.hidden_size, spec.num_layers
    nbytes = sum(t.numel() * t.element_size() for t in blocks)
    nbytes += sum(params[k].numel() * 2 for k in ("final_scale", "final_bias", "tok_embed")
                  if params[k] is not None)
    nbytes += 2 * L * slots * spec.kv_dim * 2 + (2 * batch + 1) * H * 2 + batch * 4
    mats = sum(t.numel() for t in blocks if t.ndim == 3)
    flops = (2 * batch * (mats + spec.vocab_size * H)
             + 4 * spec.num_heads * spec.head_size * slots * L)
    return bound(nbytes, flops, BF16_TENSOR_FLOPS)


def stack_row(dl, dev, seed):
    """K4 at the main path's shapes: GPT-2 small, B = 8, context 896, the
    tied-head epilogue and learned positions; single step, the check that a
    context one token short fails, 8 in-kernel steps, timings."""
    from mlio_tpu_torch.models import load_model

    spec, params = load_model("gpt2", dtype=torch.bfloat16, device=dev, seed=seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    pos = DECODE_CTX - 1
    x, kc, vc, _, _, kw = stack_inputs(spec, params, B, CACHE, pos, 1, gen)
    x_plain, errs = stack_check(dl, spec, params, x, kc, vc, pos, None, None, kw)
    # The check must catch the current token one slot early: the kernel at
    # pos - 1 against the plain version at pos has to fail it.
    x_short, _ = dl.decode_layer_stack(x, params["blocks"], kc.clone(), vc.clone(), pos - 1, **kw)
    short_ok, short_err = within("decode_layer_stack", x_short, x_plain)
    if short_ok:
        raise AssertionError(f"decode_layer_stack: the check passes a context one token short "
                             f"(max_abs_err {short_err})")
    _, errs8 = stack_check(dl, spec, params, x, kc, vc, pos, None, None, dict(kw, steps=8))
    b_ms, b_by = stack_bound(spec, params, B, B * DECODE_CTX)
    blocks = params["blocks"]
    row = dict(
        name="decode_layer_stack", route="cuda", source="mlio_tpu_torch/csrc/decode_layer.cu",
        replaces="mlio_tpu/ops/decode_layer.py:136",
        shape=f"GPT-2 small bf16, x [{B},{spec.hidden_size}], cache [{spec.num_layers},{B},"
              f"{CACHE},{spec.num_kv_heads},{spec.head_size}], ctx {DECODE_CTX}, tied-head "
              "greedy epilogue, one step a launch",
        max_abs_err=errs["x_out"], errors=errs, errors_8_steps=errs8,
        atol=TOL["decode_layer_stack"][0], rtol=TOL["decode_layer_stack"][1],
        ctx_minus_1_max_abs_err=short_err,
        library_note="no single PyTorch call computes a decode step",
        **timings(lambda i: dl.decode_layer_stack(x, blocks, kc, vc, pos, **kw),
                  lambda i: dl.decode_layer_stack_plain(x, blocks, kc, vc, pos, **kw),
                  None, 20),
        bound_ms=b_ms, bound_by=b_by)
    # Where K4's time goes: device ms of the same launch at context 16,
    # without the epilogue, and of one layer without the epilogue.
    bare = dict(spec=spec, pos_embed=params["pos_embed"])
    one = dataclasses.replace(spec, num_layers=1)
    blocks1 = {k: (v[:1] if v is not None else None) for k, v in blocks.items()}
    row["where_ms"] = dict(
        ctx_16=time_ms(lambda i: dl.decode_layer_stack(x, blocks, kc, vc, 15, **kw), 20)[0],
        no_epilogue=time_ms(lambda i: dl.decode_layer_stack(x, blocks, kc, vc, pos, **bare),
                            20)[0],
        one_layer_no_epilogue=time_ms(lambda i: dl.decode_layer_stack(
            x, blocks1, kc[:1], vc[:1], pos, **dict(bare, spec=one)), 20)[0])
    # Phase durations of one launch (block 0's global timer after each grid
    # barrier): the five phases of a layer averaged over the layers.
    stamps = torch.zeros(dl.phase_stamps(spec), dtype=torch.int64, device=dev)
    dl.decode_layer_stack(x, blocks, kc, vc, pos, phase_times=stamps, **kw)
    row["phase_us"] = phase_us(spec, stamps)
    return row


def phase_us(spec, stamps):
    """Phase durations (us) of one single-step launch from its phase probe
    (block 0's timer after each grid barrier): the five phases of a layer
    averaged over the layers, and the logits."""
    us = (stamps[1:] - stamps[:-1]).double().cpu() / 1e3
    L = spec.num_layers
    layers = us[1:1 + 5 * L].reshape(L, 5).mean(0).tolist()
    return dict(start=us[0].item(), **dict(zip(
        ("qkv", "attention", "out_proj", "up", "down"), layers)),
        logits=us[1 + 5 * L].item(), launch_total=(stamps[-1] - stamps[0]).item() / 1e3)


def kernel_phase(rng, dev, seed, fa, norms, da, dl):
    """Check and time K1-K4 at the main path's shapes; returns their rows."""
    from mlio_tpu_torch.models.spec import get_spec

    spec = get_spec("gpt2")
    H, D, L, HID = spec.num_heads, spec.head_size, spec.num_layers, spec.hidden_size

    def randn(*shape):
        a = rng.standard_normal(shape, dtype=np.float32)
        return torch.from_numpy(a).to(dev, torch.bfloat16)

    rows = []

    # K1: prefill attention of one layer over the whole cache.
    q, k, v = randn(B, PROMPT, H, D), randn(B, CACHE, H, D), randn(B, CACHE, H, D)
    args = dict(causal=True, q_offset=0, kv_len=PROMPT)
    err = check_close("flash_attention", fa.flash_attention(q, k, v, **args),
                      fa.flash_attention_plain(q, k, v, **args))
    ks, vs = k[:, :PROMPT].transpose(1, 2), v[:, :PROMPT].transpose(1, 2)
    qs = q.transpose(1, 2)
    pairs = sum(min(PROMPT, i + 1) for i in range(PROMPT))
    nbytes = (2 * q.numel() + 2 * B * PROMPT * H * D) * 2  # q, out, valid K/V rows
    b_ms, b_by = bound(nbytes, 4 * B * H * D * pairs, BF16_TENSOR_FLOPS)
    rows.append(dict(
        name="flash_attention", route="cuda", source="mlio_tpu_torch/csrc/flash_fwd.cu",
        replaces="mlio_tpu/ops/flash_attention.py:37",
        shape=f"q [{B},{PROMPT},{H},{D}] k/v [{B},{CACHE},{H},{D}] bf16, kv_len {PROMPT}",
        max_abs_err=err, atol=TOL["flash_attention"][0], rtol=TOL["flash_attention"][1],
        **timings(lambda i: fa.flash_attention(q, k, v, **args),
                  lambda i: fa.flash_attention_plain(q, k, v, **args),
                  lambda i: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True), 50),
        bound_ms=b_ms, bound_by=b_by))
    del q, k, v, ks, vs, qs

    # K2: the prefill's norms, [B * PROMPT, 768].
    x = randn(B * PROMPT, HID)
    scale, bias = 1 + 0.1 * randn(HID), 0.1 * randn(HID)
    err = check_close("fused_norm", norms.fused_norm(x, scale, bias),
                      norms.fused_norm_plain(x, scale, bias))
    b_ms, b_by = bound((2 * x.numel() + 2 * HID) * 2, 7 * x.numel(), FP32_FLOPS)
    rows.append(dict(
        name="fused_norm", route="cuda", source="mlio_tpu_torch/csrc/fused_norm.cu",
        replaces="mlio_tpu/ops/norms.py:21",
        shape=f"x [{B * PROMPT},{HID}] bf16, layernorm",
        max_abs_err=err, atol=TOL["fused_norm"][0], rtol=TOL["fused_norm"][1],
        **timings(lambda i: norms.fused_norm(x, scale, bias),
                  lambda i: norms.fused_norm_plain(x, scale, bias),
                  lambda i: F.layer_norm(x, (HID,), scale, bias, 1e-5), 200),
        bound_ms=b_ms, bound_by=b_by))
    del x

    # K3: one decode step's attention at one layer of the full cache. Timed
    # launches walk the 12 layers, as a decode step does, so the 25 MB of a
    # layer's K/V is not already in the 50 MB L2 from the previous launch.
    qd = randn(B, H, D)
    kc, vc = randn(L, B, CACHE, H, D), randn(L, B, CACHE, H, D)
    ctx = torch.full((B,), DECODE_CTX, dtype=torch.int32, device=dev)
    want = da.decode_attention_plain(qd, kc, vc, ctx, layer=5)
    err = check_close("decode_attention", da.decode_attention(qd, kc, vc, ctx, layer=5), want)
    # The check must catch the current token left out: the kernel at ctx - 1
    # against the plain version at ctx has to fail it.
    short_ok, short_err = within("decode_attention",
                                 da.decode_attention(qd, kc, vc, ctx - 1, layer=5), want)
    if short_ok:
        raise AssertionError(f"decode_attention: the check passes a context one token "
                             f"short (max_abs_err {short_err})")
    nbytes = (2 * qd.numel() + 2 * B * DECODE_CTX * H * D) * 2
    b_ms, b_by = bound(nbytes, 4 * B * H * DECODE_CTX * D, FP32_FLOPS)
    q4 = qd[:, :, None, :]
    rows.append(dict(
        name="decode_attention", route="cuda", source="mlio_tpu_torch/csrc/decode_attn.cu",
        replaces="mlio_tpu/ops/decode_attention.py:50",
        shape=f"q [{B},{H},{D}] cache [{L},{B},{CACHE},{H},{D}] bf16, ctx {DECODE_CTX}",
        max_abs_err=err, atol=TOL["decode_attention"][0], rtol=TOL["decode_attention"][1],
        ctx_minus_1_max_abs_err=short_err,
        **timings(lambda i: da.decode_attention(qd, kc, vc, ctx, layer=i % L),
                  lambda i: da.decode_attention_plain(qd, kc, vc, ctx, layer=i % L),
                  lambda i: F.scaled_dot_product_attention(
                      q4, kc[i % L, :, :DECODE_CTX].transpose(1, 2),
                      vc[i % L, :, :DECODE_CTX].transpose(1, 2)), 240),
        bound_ms=b_ms, bound_by=b_by))
    del kc, vc
    rows.append(stack_row(dl, dev, seed))
    return rows


def paged_tables(gen, dev, batch, blocks, pool_blocks):
    """[batch, blocks] int32 tables: a random permutation of the pool's
    blocks 1.. (block 0 is the scratch block)."""
    perm = torch.randperm(pool_blocks - 1, generator=gen, device=dev)[:batch * blocks] + 1
    return perm.reshape(batch, blocks).to(torch.int32).contiguous()


def paged_attention_check(pa, q, kp, vp, tables, ctx, layer, short=False):
    """K7 against its plain version; with ``short`` the kernel at ctx - 1
    must fail the same check. Returns (max_abs_err, short max_abs_err)."""
    G = q.shape[1] // kp.shape[3]
    name = "paged_attention" if G == 1 else "paged_attention_grouped"
    want = pa.paged_attention_plain(q, kp, vp, tables, ctx, layer=layer)
    err = check_close(name, pa.paged_attention(q, kp, vp, tables, ctx, layer=layer), want)
    if not short:
        return err, None
    short_ok, short_err = within(name, pa.paged_attention(q, kp, vp, tables, ctx - 1,
                                                          layer=layer), want)
    if short_ok:
        raise AssertionError(f"paged_attention: the check passes a context one token short "
                             f"(max_abs_err {short_err})")
    return err, short_err


def paged_stack_check(dps, spec, params, x, kp, vp, tables, past, cos, sin, kw, active=None):
    """K8 from (x, kp, vp) against its plain version on clones of the pools:
    x_out, the written pool rows and the greedy token (its plain logit
    within LOGITS_ATOL of the plain maximum) of the active rows, K8's
    emitted logits within LOGITS_ATOL of the plain ones, and no other pool
    row changed but the scratch block's row 0 that inactive rows write.
    Returns (plain x_out, the errors)."""
    act = torch.arange(x.shape[0], device=x.device) if active is None else active
    blocks = params["blocks"]
    kk, kv, pk, pv = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    xk, tk = dps.decode_paged_stack(x, blocks, kk, kv, tables, past, cos, sin, **kw)
    _, lk = dps.decode_paged_stack(x, blocks, kk, kv, tables, past, cos, sin, emit="logits",
                                   **kw)
    torch.cuda.synchronize()
    xp, lp = dps.decode_paged_stack_plain(x, blocks, pk, pv, tables, past, cos, sin,
                                          emit="logits", **kw)
    bs = kp.shape[2]
    pa_ = past.long()[act]
    phys = tables.long()[act, pa_ // bs]
    written = torch.zeros(kp.shape[1:3], dtype=torch.bool, device=kp.device)
    written[phys, pa_ % bs] = True
    if active is not None:
        written[0, 0] = True
    for got, want, name in ((kk, kp, "k"), (kv, vp, "v")):
        if not torch.equal(got[:, ~written], want[:, ~written]):
            raise AssertionError(f"decode_paged_stack: {name} pool rows other than the "
                                 "sequences' current slots changed")
    tok = tk.long()[act]
    gap = (lp[act].max(-1).values - lp[act].gather(1, tok[:, None])[:, 0]).max().item()
    if gap > LOGITS_ATOL:
        raise AssertionError(f"decode_paged_stack: a kernel token's plain logit is {gap} below "
                             f"the plain maximum (> {LOGITS_ATOL})")
    logits_err = (lk[act] - lp[act]).abs().max().item()
    if not logits_err <= LOGITS_ATOL:
        raise AssertionError(f"decode_paged_stack: emitted logits {logits_err} off the plain "
                             f"ones (> {LOGITS_ATOL})")
    errs = dict(x_out=check_close("decode_paged_stack", xk[act], xp[act]),
                k_rows=check_close("decode_paged_stack", kk[:, phys, pa_ % bs],
                                   pk[:, phys, pa_ % bs]),
                v_rows=check_close("decode_paged_stack", kv[:, phys, pa_ % bs],
                                   pv[:, phys, pa_ % bs]),
                token_logit_gap=gap, logits=logits_err)
    return xp, errs


def paged_x(spec, params, ids, past):
    """K8's input as the engine builds it (``paged_forward.embed``): the
    embedding rows plus the learned position at ``past`` in the compute
    dtype, or the RoPE tables at ``past``. Returns (x, cos, sin)."""
    from mlio_tpu_torch.runtime import paged_forward

    return paged_forward.embed(params, spec, ids, past.long())


def paged_rows(pa, dps, dev, seed):
    """K7 and K8 at GPT-2 small's full width over the engine's pools: B = 8,
    256 blocks of 128, permuted tables of 8 blocks, the ragged past contexts
    and then a context of DECODE_CTX (K7: DECODE_CTX slots, the current token
    included; K8: DECODE_CTX - 1 past tokens, so both read DECODE_CTX slots,
    as K3 and K4 do); a context one token short must fail; K8 also with two
    inactive rows. Returns the two rows of the kernels line."""
    from mlio_tpu_torch.models import load_model
    from mlio_tpu_torch.ops import decode_layer as dl

    spec, params = load_model("gpt2", dtype=torch.bfloat16, device=dev, seed=seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    L, H, D = spec.num_layers, spec.num_heads, spec.head_size
    shape = (L, POOL_BLOCKS, POOL_BS, spec.num_kv_heads, D)
    kp = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    vp = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    tables = paged_tables(gen, dev, B, TABLE_BLOCKS, POOL_BLOCKS)
    past = torch.tensor(RAGGED, dtype=torch.int32, device=dev)
    past896 = torch.full((B,), DECODE_CTX - 1, dtype=torch.int32, device=dev)
    shp = (f"GPT-2 small bf16, pools [{L},{POOL_BLOCKS},{POOL_BS},{spec.num_kv_heads},{D}], "
           f"tables [{B},{TABLE_BLOCKS}] permuted, past contexts {list(RAGGED)}")

    # K7: one layer's attention; timed launches walk the 12 layers.
    q = torch.randn((B, H, D), generator=gen, device=dev).to(torch.bfloat16)
    ctx = past + 1  # K7 counts the current token
    err, short_err = paged_attention_check(pa, q, kp, vp, tables, ctx, 5, short=True)
    err896, short896 = paged_attention_check(pa, q, kp, vp, tables, past896 + 1, 5, short=True)
    slots = int(ctx.sum())
    b_ms, b_by = bound((2 * q.numel() + 2 * slots * H * D) * 2 + tables.numel() * 4 + B * 4,
                       4 * H * D * slots, FP32_FLOPS)
    # the library yardstick: SDPA over the dense K/V the tables name, masked
    # to each context (the gather into dense tensors is not timed)
    T = TABLE_BLOCKS * POOL_BS
    dense = [(pa.gather_blocks(kp, l, tables).transpose(1, 2).contiguous(),
              pa.gather_blocks(vp, l, tables).transpose(1, 2).contiguous()) for l in range(L)]
    mask = (torch.arange(T, device=dev)[None, :] < ctx[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    k7 = dict(
        name="paged_attention", route="cuda", source="mlio_tpu_torch/csrc/paged_attn.cu",
        replaces="mlio_tpu/ops/paged_attention.py:177",
        shape=f"q [{B},{H},{D}], {shp} (+1 current token)",
        max_abs_err=err, atol=TOL["paged_attention"][0], rtol=TOL["paged_attention"][1],
        ctx_minus_1_max_abs_err=short_err, max_abs_err_ctx896=err896,
        ctx896_minus_1_max_abs_err=short896,
        library_note="F.scaled_dot_product_attention over the dense K/V the tables name, "
                     "masked to each context; the gather is not timed",
        **timings(lambda i: pa.paged_attention(q, kp, vp, tables, ctx, layer=i % L),
                  lambda i: pa.paged_attention_plain(q, kp, vp, tables, ctx, layer=i % L),
                  lambda i: F.scaled_dot_product_attention(q4, *dense[i % L], attn_mask=mask),
                  240),
        bound_ms=b_ms, bound_by=b_by,
        ms_ctx896=time_ms(lambda i: pa.paged_attention(q, kp, vp, tables, past896 + 1,
                                                       layer=i % L), 240)[0],
        bound_ms_ctx896=bound((2 * q.numel() + 2 * B * DECODE_CTX * H * D) * 2,
                              4 * H * D * B * DECODE_CTX, FP32_FLOPS)[0])
    del dense

    # K8: one step with the tied-head epilogue.
    ids = torch.randint(0, spec.vocab_size, (B,), generator=gen, device=dev)
    kw = dict(spec=spec, head_norm=(params["final_scale"], params["final_bias"]),
              lm_head=params["tok_embed"], lm_head_bias=None, lm_vmajor=True)
    x, _, _ = paged_x(spec, params, ids, past)
    x_plain, errs = paged_stack_check(dps, spec, params, x, kp, vp, tables, past, None, None, kw)
    # the check must catch the current token one slot early
    x_short, _ = dps.decode_paged_stack(x, params["blocks"], kp.clone(), vp.clone(), tables,
                                        past - 1, **kw)
    short_ok, short_err = within("decode_paged_stack", x_short, x_plain)
    if short_ok:
        raise AssertionError(f"decode_paged_stack: the check passes a context one token short "
                             f"(max_abs_err {short_err})")
    x896, _, _ = paged_x(spec, params, ids, past896)
    x896_plain, errs896 = paged_stack_check(dps, spec, params, x896, kp, vp, tables, past896,
                                            None, None, kw)
    x_short, _ = dps.decode_paged_stack(x896, params["blocks"], kp.clone(), vp.clone(), tables,
                                        past896 - 1, **kw)
    short896_ok, short896 = within("decode_paged_stack", x_short, x896_plain)
    if short896_ok:
        raise AssertionError(f"decode_paged_stack: the check passes a context one token short "
                             f"at {DECODE_CTX} (max_abs_err {short896})")
    # two inactive engine slots (scratch tables, no past) beside six live ones
    live = torch.tensor([0, 1, 3, 4, 6, 7], device=dev)
    t_in, p_in = tables.clone(), past.clone()
    t_in[[2, 5]], p_in[[2, 5]] = 0, 0
    x_in, _, _ = paged_x(spec, params, ids, p_in)
    _, errs_inactive = paged_stack_check(dps, spec, params, x_in, kp, vp, t_in, p_in, None,
                                         None, kw, active=live)
    blocks = params["blocks"]
    slots = int(past.sum()) + B
    b_ms, b_by = stack_bound(spec, params, B, slots)
    k8 = dict(
        name="decode_paged_stack", route="cuda", source="mlio_tpu_torch/csrc/paged_stack.cu",
        replaces="mlio_tpu/ops/decode_paged_stack.py:70",
        shape=f"x [{B},{spec.hidden_size}], {shp}, tied-head greedy epilogue",
        max_abs_err=errs["x_out"], errors=errs, errors_ctx896=errs896,
        errors_two_inactive=errs_inactive, atol=TOL["decode_paged_stack"][0],
        rtol=TOL["decode_paged_stack"][1], ctx_minus_1_max_abs_err=short_err,
        ctx896_minus_1_max_abs_err=short896,
        library_note="no single PyTorch call computes a decode step",
        **timings(lambda i: dps.decode_paged_stack(x, blocks, kp, vp, tables, past, **kw),
                  lambda i: dps.decode_paged_stack_plain(x, blocks, kp, vp, tables, past, **kw),
                  None, 20),
        bound_ms=b_ms, bound_by=b_by,
        ms_ctx896=time_ms(lambda i: dps.decode_paged_stack(x896, blocks, kp, vp, tables,
                                                           past896, **kw), 20)[0],
        bound_ms_ctx896=stack_bound(spec, params, B, B * DECODE_CTX)[0])
    stamps = torch.zeros(dl.phase_stamps(spec), dtype=torch.int64, device=dev)
    dps.decode_paged_stack(x, blocks, kp, vp, tables, past, phase_times=stamps, **kw)
    k8["phase_us"] = phase_us(spec, stamps)
    return [k7, k8]


def paged_variants(dev, seed, pa, dps):
    """K7's and K8's other instances against their plain versions at small
    shapes: grouped heads, head dim 128, block sizes 8 to 64, batch 3 and 5,
    and K8 with GQA 4, RMSNorm, SwiGLU, per-sequence RoPE, an untied head
    with a bias, learned positions and a past context of 0."""
    from mlio_tpu_torch.models import get_spec, init_params

    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    errs = {}
    # (L, NB, bs, Hkv, G, D, ctx, layer)
    for i, (nl, nb, bs, hkv, g, d, ctx, layer) in enumerate([
            (2, 40, 16, 1, 4, 128, [1, 16, 33], 1),
            (3, 64, 8, 2, 2, 64, [5, 8, 9, 64, 17], 2),
            (1, 20, 32, 1, 8, 64, [32, 1], 0),
            (2, 30, 64, 3, 1, 128, [64, 65, 100, 2], 1)]):
        c = torch.tensor(ctx, dtype=torch.int32, device=dev)
        tables = paged_tables(gen, dev, len(ctx), -(-max(ctx) // bs) + 1, nb)
        shape = (nl, nb, bs, hkv, d)
        kp = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        vp = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        q = torch.randn((len(ctx), hkv * g, d), generator=gen, device=dev).to(torch.bfloat16)
        errs[f"paged_attention[{i}]"] = paged_attention_check(pa, q, kp, vp, tables, c, layer)[0]
    gpt2, llama = get_spec("gpt2"), get_spec("llama-tiny")
    cases = {  # name: (spec, block size, past contexts)
        "gqa4_rmsnorm_swiglu_rope_untied_bias_d128": (dataclasses.replace(
            llama, name="pv-gqa", hidden_size=512, num_heads=4, num_kv_heads=1,
            intermediate_size=1024, num_layers=2, vocab_size=1000, use_head_bias=True),
            16, [5, 16, 40]),
        "learned_gqa2_bs32": (dataclasses.replace(
            gpt2, name="pv-gpt2", hidden_size=256, num_heads=4, num_kv_heads=2,
            intermediate_size=512, num_layers=2, vocab_size=1001), 32, [0, 31, 32, 70, 3]),
    }
    for name, (spec, bs, past_l) in cases.items():
        params = init_params(spec, gen, dtype=torch.bfloat16, device=dev)
        for key, vec in [(k, v) for k, v in params.items() if k != "blocks"] + \
                list(params["blocks"].items()):
            if vec is not None and ("bias" in key or key.startswith("b") or "scale" in key):
                noise = 0.1 * torch.randn(vec.shape, generator=gen, device=dev)
                vec.copy_((noise + (1 if "scale" in key else 0)).to(vec.dtype))
        past = torch.tensor(past_l, dtype=torch.int32, device=dev)
        tables = paged_tables(gen, dev, len(past_l), -(-(max(past_l) + 1) // bs), 48)
        shape = (spec.num_layers, 48, bs, spec.num_kv_heads, spec.head_size)
        kp = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        vp = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        ids = torch.randint(0, spec.vocab_size, (len(past_l),), generator=gen, device=dev)
        x, cos, sin = paged_x(spec, params, ids, past)
        tied = params["lm_head"] is None
        kw = dict(spec=spec, head_norm=(params["final_scale"], params["final_bias"]),
                  lm_head=params["tok_embed"] if tied else params["lm_head"],
                  lm_head_bias=params["lm_head_bias"], lm_vmajor=tied)
        errs[f"decode_paged_stack[{name}]"] = paged_stack_check(
            dps, spec, params, x, kp, vp, tables, past, cos, sin, kw)[1]
    return errs


def stack_variants(dev, seed, dl):
    """K4's other instances against its plain version at small shapes, with
    norm scales and every bias drawn from the seed."""
    import dataclasses

    from mlio_tpu_torch.models import get_spec, init_params

    gpt2, llama = get_spec("gpt2"), get_spec("llama-tiny")
    small = dict(num_layers=2, vocab_size=1000)
    cases = {  # name: (spec, batch, cache slots, pos, steps, epilogue)
        "rope_partial": (dataclasses.replace(
            gpt2, name="v-rope", hidden_size=256, num_heads=4, num_kv_heads=4,
            intermediate_size=512, positional="rope", rope_fraction=0.5, activation="gelu",
            **small), 4, 128, 77, 1, True),
        "gqa4_rmsnorm_swiglu_nobias": (dataclasses.replace(
            llama, name="v-gqa", hidden_size=512, num_heads=4, num_kv_heads=1,
            intermediate_size=1024, **small), 8, 256, 200, 1, True),
        "untied_head_bias": (dataclasses.replace(
            gpt2, name="v-untied", hidden_size=256, num_heads=4, num_kv_heads=2,
            intermediate_size=512, tie_embeddings=False, use_head_bias=True,
            activation="relu", num_layers=2, vocab_size=1001), 8, 64, 40, 1, True),
        "odd_batch": (dataclasses.replace(
            gpt2, name="v-odd", hidden_size=256, num_heads=4, num_kv_heads=4,
            intermediate_size=512, num_layers=2, vocab_size=1001), 3, 64, 10, 1, True),
        "no_epilogue_gqa8": (dataclasses.replace(
            llama, name="v-noepi", hidden_size=1024, num_heads=8, num_kv_heads=1,
            intermediate_size=512, activation="geglu", **small), 5, 96, 95, 1, False),
        "steps_rope": (dataclasses.replace(
            llama, name="v-steps", hidden_size=256, num_heads=2, num_kv_heads=2,
            intermediate_size=512, tie_embeddings=True, **small), 2, 64, 30, 5, True),
    }
    errs = {}
    for name, (spec, batch, smax, pos, steps, epilogue) in cases.items():
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = init_params(spec, gen, dtype=torch.bfloat16, device=dev)
        for key, vec in [(k, v) for k, v in params.items() if k != "blocks"] + \
                list(params["blocks"].items()):
            if vec is not None and ("bias" in key or key.startswith("b") or "scale" in key):
                noise = 0.1 * torch.randn(vec.shape, generator=gen, device=dev)
                vec.copy_((noise + (1 if "scale" in key else 0)).to(vec.dtype))
        x, kc, vc, cos, sin, kw = stack_inputs(spec, params, batch, smax, pos, steps, gen,
                                               epilogue=epilogue)
        errs[f"decode_layer_stack[{name}]"] = stack_check(dl, spec, params, x, kc, vc, pos,
                                                          cos, sin, kw)[1]
    return errs


# The GEMM kernels' shapes: GPT-2 small's prefill (B x PROMPT tokens) and one
# layer of llama3-8b at 2048 tokens (H 4096, I 14336, 32/8 heads of 128).
GPT2_M, GPT2_H, GPT2_I = B * PROMPT, 768, 3072
LLAMA_M, LLAMA_H, LLAMA_I, LLAMA_KVD = 2048, 4096, 14336, 1024
DECODE_M = 8  # a decode step's rows at batch 8


def must_fail(name, got, plain_fn, weight, rows):
    """The check has to catch the last K tile lost: the plain version with
    ``weight``'s rows ``rows`` zeroed must fail it. Returns that max-abs."""
    saved = weight[rows].clone()
    weight[rows] = 0
    try:
        ok, err = within(name, got, plain_fn())
    finally:
        weight[rows] = saved
    if ok:
        raise AssertionError(f"{name}: the check passes with the weight's last K tile zeroed "
                             f"(max_abs_err {err})")
    return err


def gemm_row(name, source, replaces, shape, kernel, plain, library, nbytes, flops, weight, rows,
             reps):
    """A kernel row: the kernel against its plain version, the must-fail
    check, device ms of kernel, plain and library, and the bound."""
    got = kernel()
    err = check_close(name, got, plain())
    short = must_fail(name, got, plain, weight, rows)
    b_ms, b_by = bound(nbytes, flops, BF16_TENSOR_FLOPS)
    return dict(name=name, route="cuda", source=source, replaces=replaces, shape=shape,
                max_abs_err=err, atol=TOL[name][0], rtol=TOL[name][1],
                last_k_tile_zeroed_max_abs_err=short,
                **timings(lambda i: kernel(), lambda i: plain(), library, reps),
                bound_ms=b_ms, bound_by=b_by)


def gemm_rows(dev, seed, fm, lq, qm):
    """K11, K12 and K5 at the runner's shapes (GPT-2 small, B x PROMPT rows)
    and at one llama3-8b layer's, each held against its plain version and
    timed beside one PyTorch library call of the same function."""
    gen = torch.Generator(device=dev).manual_seed(seed + 3)

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    def extra(row, key, other):  # a second shape's numbers beside the first's
        row[key] = {k: other[k] for k in ("shape", "max_abs_err", "last_k_tile_zeroed_max_abs_err",
                                          "ms", "plain_ms", "library_ms", "bound_ms",
                                          "bound_by")}

    rows = []
    spec_h, spec_i = GPT2_H, GPT2_I
    # K11: GPT-2 (gelu_new, biases), then llama3-8b (SwiGLU, no biases).
    x = rn(GPT2_M, spec_h)
    wu, wd = rn(spec_h, spec_i, scale=spec_h ** -0.5), rn(spec_i, spec_h, scale=spec_i ** -0.5)
    bu, bd = rn(spec_i, scale=0.1), rn(spec_h, scale=0.1)
    kw = dict(b_up=bu, b_down=bd, activation="gelu_new")
    src = ("fused_mlp", "mlio_tpu_torch/csrc/fused_mlp.cu", "mlio_tpu/ops/fused_mlp.py:45")
    k11 = gemm_row(*src, f"x [{GPT2_M},{spec_h}], I {spec_i}, gelu_new, b_up and b_down, bf16",
                   lambda: fm.fused_mlp(x, wu, wd, **kw), lambda: fm.fused_mlp_plain(x, wu, wd, **kw),
                   lambda i: F.gelu(x @ wu + bu, approximate="tanh") @ wd + bd,
                   (2 * GPT2_M * spec_h + 2 * spec_h * spec_i + spec_i + spec_h) * 2,
                   2 * GPT2_M * spec_h * spec_i * 2, wu, slice(spec_h - 32, spec_h), 20)
    x = rn(LLAMA_M, LLAMA_H)
    wu, wg = (rn(LLAMA_H, LLAMA_I, scale=LLAMA_H ** -0.5) for _ in range(2))
    wd = rn(LLAMA_I, LLAMA_H, scale=LLAMA_I ** -0.5)
    kw = dict(w_gate=wg, activation="swiglu")
    extra(k11, "llama3_8b", gemm_row(
        *src, f"x [{LLAMA_M},{LLAMA_H}], I {LLAMA_I}, swiglu, no biases, bf16",
        lambda: fm.fused_mlp(x, wu, wd, **kw), lambda: fm.fused_mlp_plain(x, wu, wd, **kw),
        lambda i: (F.silu(x @ wg) * (x @ wu)) @ wd,
        (2 * LLAMA_M * LLAMA_H + 3 * LLAMA_H * LLAMA_I) * 2, 2 * LLAMA_M * LLAMA_H * LLAMA_I * 3,
        wu, slice(LLAMA_H - 32, LLAMA_H), 4))
    rows.append(k11)
    del x, wu, wg, wd

    # K12: GPT-2 LayerNorm with q/k/v of 768 each, then llama3-8b RMSNorm, GQA 32/8.
    src = ("fused_norm_matmul", "mlio_tpu_torch/csrc/ln_matmul.cu", "mlio_tpu/ops/ln_qkv.py:25")
    cases = ((GPT2_M, spec_h, (spec_h,) * 3, "layernorm", True),
             (LLAMA_M, LLAMA_H, (LLAMA_H, LLAMA_KVD, LLAMA_KVD), "rmsnorm", False))
    for i, (m, h, widths, kind, with_bias) in enumerate(cases):
        x = rn(m, h) + 0.5
        sc, b = 1 + rn(h, scale=0.1), (rn(h, scale=0.1) if with_bias else None)
        ws = [rn(h, n, scale=h ** -0.5) for n in widths]
        w_cat = torch.cat(ws, dim=1)
        n = sum(widths)
        norm_fn = ((lambda: F.layer_norm(x, (h,), sc, b, 1e-5)) if kind == "layernorm"
                   else (lambda: F.rms_norm(x, (h,), sc, 1e-5)))
        row = gemm_row(
            *src, f"x [{m},{h}] @ [Wq|Wk|Wv] {list(widths)}, {kind}"
                  f"{', norm bias' if with_bias else ''}, bf16",
            lambda: lq.fused_norm_matmul(x, None, sc, b, kind=kind, parts=ws),
            lambda: lq.fused_norm_matmul_plain(x, None, sc, b, kind=kind, parts=ws),
            lambda i: norm_fn() @ w_cat, (m * h + h * n + m * n + 2 * h) * 2, 2 * m * h * n,
            ws[0], slice(h - 32, h), 20 if i == 0 else 8)
        if i == 0:
            k12 = row
        else:
            extra(k12, "llama3_8b", row)
        del x, ws, w_cat
    rows.append(k12)

    # K5: int8 at GPT-2's up projection (M = B x PROMPT and M = 8), int4 with
    # per-channel and with g = 128 scales at llama3-8b's up projection.
    def k5(name, line, fmt, m, k, n, gs, reps):
        x = rn(m, k)
        w = torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
        t = qm.quantize_int8(w) if fmt == "int8" else qm.quantize_int4(w, group_size=gs)
        del w
        deq_rows = slice(k - 32, k) if fmt == "int8" else slice(k // 2 - 16, k // 2)
        return gemm_row(
            name, "mlio_tpu_torch/csrc/quant_matmul.cu", f"mlio_tpu/ops/quant.py:{line}",
            f"x [{m},{k}] @ {fmt} q {list(t.q.shape)}, scale {list(t.scale.shape)}, bf16",
            lambda: qm.quant_matmul(x, t.q, t.scale, fmt=fmt),
            lambda: qm.quant_matmul_plain(x, t.q, t.scale, fmt=fmt),
            lambda i: x @ qm.dequantize(t, torch.bfloat16),
            m * k * 2 + t.q.numel() + t.scale.numel() * 4 + m * n * 2, 2 * m * k * n,
            t.q, deq_rows, reps)

    row = k5("quant_matmul", 221, "int8", GPT2_M, spec_h, spec_i, None, 20)
    extra(row, "m8", k5("quant_matmul", 221, "int8", DECODE_M, spec_h, spec_i, None, 200))
    rows.append(row)
    rows.append(k5("quant_matmul_int4", 240, "int4", LLAMA_M, LLAMA_H, LLAMA_I, None, 8))
    rows.append(k5("quant_matmul_int4_group", 263, "int4", LLAMA_M, LLAMA_H, LLAMA_I, 128, 8))
    for r in rows[-3:]:
        r["library_note"] = "x @ dequantize(q, scale) in bf16, the dequantisation included"
    k11["library_note"] = "torch.matmul, the activation, torch.matmul"
    k12["library_note"] = "F.layer_norm or F.rms_norm, then torch.matmul by [Wq|Wk|Wv]"
    return rows


def gemm_variants(dev, seed, fm, lq, qm):
    """K5, K11 and K12 against their plain versions at small ragged shapes:
    rows, columns and depths that are not multiples of the tiles (nor of 8,
    the 16-byte vector width), every activation, biases, grouped heads."""
    gen = torch.Generator(device=dev).manual_seed(seed + 4)

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    errs = {}
    for i, (m, k, n, fmt, gs) in enumerate([
            (37, 200, 72, "int8", None), (130, 776, 264, "int8", None), (1, 64, 17, "int8", None),
            (37, 200, 72, "int4", None), (50, 512, 136, "int4", 128), (9, 96, 40, "int4", 16),
            (5, 30, 24, "int4", None)]):
        x, w = rn(m, k), torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
        t = qm.quantize_int8(w) if fmt == "int8" else qm.quantize_int4(w, group_size=gs)
        errs[f"quant_matmul[{i}]"] = check_close(
            "quant_matmul", qm.quant_matmul(x, t.q, t.scale, fmt=fmt),
            qm.quant_matmul_plain(x, t.q, t.scale, fmt=fmt))
    for i, (m, h, inter, act, with_bias) in enumerate([
            (37, 72, 200, "gelu", True), (70, 64, 300, "relu", False), (3, 40, 24, "geglu", True),
            (130, 136, 520, "swiglu", True), (9, 36, 20, "gelu_new", False)]):
        gated = act in ("swiglu", "geglu")
        x, wu, wd = rn(m, h), rn(h, inter, scale=h ** -0.5), rn(inter, h, scale=inter ** -0.5)
        kw = dict(activation=act, w_gate=rn(h, inter, scale=h ** -0.5) if gated else None)
        if with_bias:
            kw.update(b_up=rn(inter, scale=0.1), b_down=rn(h, scale=0.1),
                      b_gate=rn(inter, scale=0.1) if gated else None)
        errs[f"fused_mlp[{i}]"] = check_close("fused_mlp", fm.fused_mlp(x, wu, wd, **kw),
                                              fm.fused_mlp_plain(x, wu, wd, **kw))
    for i, (m, h, widths, kind, with_bias) in enumerate([
            (37, 72, (40, 16, 16), "layernorm", False), (130, 100, (50, 30, 30), "rmsnorm", True),
            (5, 64, (200,), "layernorm", True), (3, 256, (256, 64, 64), "rmsnorm", False)]):
        x, sc = rn(m, h) + 0.5, 1 + rn(h, scale=0.1)
        b = rn(h, scale=0.1) if with_bias else None
        ws = [rn(h, w, scale=h ** -0.5) for w in widths]
        errs[f"fused_norm_matmul[{i}]"] = check_close(
            "fused_norm_matmul", lq.fused_norm_matmul(x, None, sc, b, kind=kind, parts=ws),
            lq.fused_norm_matmul_plain(x, None, sc, b, kind=kind, parts=ws))
    return errs


def variant_phase(rng, dev, seed, fa, norms, da, dl, pa, dps, fm, lq, qm):
    """The kernels' other instances (GQA, head dim 128, ragged lengths,
    empty rows, the block-per-row norm) against their plain versions at
    small shapes, in bf16: the card-side counterpart of the CPU tests."""
    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(
            dev, torch.bfloat16)

    errs = {}
    # (B, Sq, Skv, Hq, Hkv, D, causal, q_offset, kv_len)
    for i, (b, sq, skv, hq, hkv, d, causal, qo, kvl) in enumerate([
            (2, 100, 160, 8, 2, 128, True, 37, [150, 60]),
            (1, 65, 65, 4, 4, 64, True, 0, None),
            (2, 33, 128, 4, 1, 64, False, 0, [0, 77])]):
        q, k, v = randn(b, sq, hq, d), randn(b, skv, hkv, d), randn(b, skv, hkv, d)
        kv = None if kvl is None else torch.tensor(kvl, dtype=torch.int32, device=dev)
        args = dict(causal=causal, q_offset=qo, kv_len=kv)
        errs[f"flash_attention[{i}]"] = check_close(
            "flash_attention", fa.flash_attention(q, k, v, **args),
            fa.flash_attention_plain(q, k, v, **args))
    # (M, H, kind, bias, residual_alpha)
    for i, (m, h, kind, with_bias, alpha) in enumerate([
            (37, 4096, "rmsnorm", False, 0.5),
            (10, 768, "layernorm", True, 1.0),
            (3, 64, "layernorm", False, None)]):
        x, scale, bias = randn(m, h), 1 + 0.1 * randn(h), 0.1 * randn(h)
        kw = dict(kind=kind, residual=None if alpha is None else randn(m, h),
                  residual_alpha=1.0 if alpha is None else alpha)
        bias = bias if with_bias else None
        errs[f"fused_norm[{i}]"] = check_close("fused_norm", norms.fused_norm(x, scale, bias, **kw),
                                               norms.fused_norm_plain(x, scale, bias, **kw))
    # (L, Smax, Hkv, G, D, ctx, layer)
    for i, (nl, smax, hkv, g, d, ctx, layer) in enumerate([
            (3, 512, 2, 4, 128, [1, 300, 0, 512], 2),
            (2, 64, 3, 1, 64, [5, 64], 1),
            (1, 40, 1, 8, 64, [33, 17], 0),
            (2, 96, 2, 2, 128, [96, 50, 7], 1)]):
        bsz = len(ctx)
        q = randn(bsz, hkv * g, d)
        kc, vc = randn(nl, bsz, smax, hkv, d), randn(nl, bsz, smax, hkv, d)
        c = torch.tensor(ctx, dtype=torch.int32, device=dev)
        errs[f"decode_attention[{i}]"] = check_close(
            "decode_attention" if g == 1 else "decode_attention_grouped",
            da.decode_attention(q, kc, vc, c, layer=layer),
            da.decode_attention_plain(q, kc, vc, c, layer=layer))
    errs.update(stack_variants(dev, seed, dl))
    errs.update(paged_variants(dev, seed, pa, dps))
    errs.update(gemm_variants(dev, seed, fm, lq, qm))
    emit(dict(phase="variants", max_abs_err=errs))


# the kernel wrappers a forward calls, and their plain versions
PLAIN = {"flash_attention": "flash_attention_plain", "fused_norm": "fused_norm_plain",
         "decode_attention": "decode_attention_plain", "fused_mlp": "fused_mlp_plain",
         "fused_norm_matmul": "fused_norm_matmul_plain", "quant_matmul": "quant_matmul_plain"}


@contextlib.contextmanager
def plain_kernels(*modules):
    """Every kernel wrapper of the modules given replaced by its plain
    version."""
    saved = [(m, name, getattr(m, name)) for m in modules for name in PLAIN if hasattr(m, name)]
    for m, name, _ in saved:
        setattr(m, name, getattr(m, PLAIN[name]))
    try:
        yield
    finally:
        for m, name, real in saved:
            setattr(m, name, real)


def workload(seed: int, dev):
    """The main path's model and prompt: GPT-2 small in bf16 with random
    weights from the seed, a [B, PROMPT] prompt of ids from the seed, and
    the main path's Impl (its decode: K4). Returns (spec, params, ids, impl)."""
    from mlio_tpu_torch.models import Impl, load_model

    spec, params = load_model("gpt2", dtype=torch.bfloat16, device=dev, seed=seed)
    ids = np.random.default_rng(seed).integers(0, spec.vocab_size, (B, PROMPT))
    impl = Impl(attention="flash", norm="fused")
    return spec, params, torch.from_numpy(ids).to(dev), impl


def generate_phase(dev, seed, fa, norms, da, dl, decode_stack=None):
    """A 64-token greedy generate of the workload with launch counters, the
    decode step by the two-length marginal and the device time of a step.
    The main path (decode_stack None) also checks the prefill logits and
    times the prefill; "scan" runs the per-layer decode through K3."""
    from mlio_tpu_torch.models import forward
    from mlio_tpu_torch.runtime import generate, init_cache

    spec, params, ids, impl = workload(seed, dev)
    if decode_stack is not None:
        impl = dataclasses.replace(impl, decode_stack=decode_stack)
    L = spec.num_layers

    def prefill():
        cache = init_cache(spec, B, CACHE, dtype=torch.bfloat16, device=dev)
        with torch.inference_mode():
            return forward(params, spec, ids, impl=impl, cache=cache)

    result = dict(phase="generate" if decode_stack is None else f"generate_{decode_stack}",
                  model="gpt2", dtype="bf16", batch=B, prompt=PROMPT, cache_len=CACHE,
                  impl=repr(impl))
    if decode_stack is None:
        logits = prefill()[0]
        with plain_kernels(fa, norms, da):
            logits_plain = prefill()[0]
        if logits.shape != (B, PROMPT, spec.vocab_size) or not torch.isfinite(logits).all():
            raise AssertionError(f"prefill logits: shape {tuple(logits.shape)} or not finite")
        logits_err = (logits.float() - logits_plain.float()).abs().max().item()
        if logits_err > LOGITS_ATOL:
            raise AssertionError(f"prefill logits: kernels vs plain max-abs {logits_err} "
                                 f"> {LOGITS_ATOL}")
        del logits, logits_plain
        prefill_ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prefill()
            torch.cuda.synchronize()
            prefill_ms.append((time.perf_counter() - t0) * 1e3)
        result.update(prefill_logits_max_abs_err=logits_err, logits_atol=LOGITS_ATOL,
                      prefill_ms=prefill_ms, prefill_device_ms=time_ms(lambda i: prefill(), 2)[0])

    def run(new_tokens):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = generate(params, spec, ids, max_new_tokens=new_tokens, impl=impl,
                       cache_len=CACHE, device=dev)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    run(4)  # warm-up
    wrappers = (fa.flash_attention, norms.fused_norm, da.decode_attention, dl.decode_layer_stack)
    for w in wrappers:
        w.launches = 0
    out, t_short = run(SHORT)
    launches = {w.__name__: w.launches for w in wrappers}
    steps = SHORT - 1
    if decode_stack is None:
        want = {"flash_attention": L, "fused_norm": 2 * L + 1, "decode_attention": 0,
                "decode_layer_stack": 1}
    else:
        want = {"flash_attention": L, "fused_norm": (2 * L + 1) * (1 + steps),
                "decode_attention": L * steps, "decode_layer_stack": 0}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != expected {want}")
    if out.shape != (B, PROMPT + SHORT) or not torch.equal(out[:, :PROMPT], ids) \
            or int(out.min()) < 0 or int(out.max()) >= spec.vocab_size:
        raise AssertionError("generate: wrong shape, prompt changed or token out of range")
    _, t_long = run(LONG)
    step_s = (t_long - t_short) / (LONG - SHORT)

    # Device time of a decode step, the work queued behind a sleep kernel so
    # it runs back to back: the idle share is 1 - device / wall.
    cache = prefill()[1]
    with torch.inference_mode():
        if decode_stack is None:  # the 63-step K4 launch, over its steps
            x = params["tok_embed"][out[:, PROMPT]]
            kw = dict(spec=spec, head_norm=(params["final_scale"], params["final_bias"]),
                      lm_head=params["tok_embed"], pos_embed=params["pos_embed"], steps=steps)
            step_dev_ms = time_ms(lambda i: dl.decode_layer_stack(
                x, params["blocks"], cache["k"], cache["v"], PROMPT, **kw), 2)[0] / steps
        else:  # one forward (rewriting the same cache slot each call)
            tok = out[:, PROMPT:PROMPT + 1]
            step_dev_ms = time_ms(lambda i: forward(params, spec, tok, impl=impl,
                                                    cache=dict(cache)), 2)[0]
    result.update(launches=launches, generate_s={str(SHORT): t_short, str(LONG): t_long},
                  decode_step_ms=step_s * 1e3, decode_tok_per_s=B / step_s,
                  decode_step_device_ms=step_dev_ms,
                  decode_idle_share=1 - step_dev_ms / (step_s * 1e3))
    emit(result)
    return launches


def runner_expected(name, L):
    """Launches a forward of a runner configuration must make: the wrappers'
    counts, GPT-2's L layers (K5: six projections a layer)."""
    k1 = {"flash_attention": L}
    fused_norm = {"fused_norm": 2 * L + 1}
    return {
        "baseline": {},
        "flash_attention": k1,
        "fused_mlp": {"fused_mlp": L},
        "flash+fusion": {**k1, **fused_norm, "fused_mlp": L},
        "int8_weights": {**k1, "quant_matmul": 6 * L},
        "int8_kv_cache": k1,
        "all": {**k1, **fused_norm, "quant_matmul": 6 * L},
        "fused_ln_qkv": {**k1, "fused_norm": L + 1, "fused_mlp": L, "fused_norm_matmul": L},
        "int4_weights": {**k1, **fused_norm, "quant_matmul": 6 * L},
        "int4_per_channel": {**k1, **fused_norm, "quant_matmul": 6 * L},
    }[name]


def runner_phase(dev, seed, wrappers, modules):
    """The inference runner on GPT-2 small at full width and depth, bf16,
    random weights from the seed, a [B, PROMPT] prompt from the seed:
    ``benchmark_optimization_impact`` with its seven default configurations,
    then runners with ``fused_ln_qkv``, with int4 weights (g = 128, the
    quantizer's default) and with int4 weights with per-channel scales. Each
    configuration's ``run_inference`` (one warm-up and RUNNER_ITERS timed
    forwards) runs with the launch counters zeroed just before it and read
    just after, and its logits are held against the same configuration's
    forward with every kernel replaced by its plain version, and a forward's
    device time is taken by CUDA events beside the harness's host-clock
    times. Returns the launches by configuration."""
    from mlio_tpu_torch.models import Impl
    from mlio_tpu_torch.ops import quant as qm
    from mlio_tpu_torch.runtime import inference

    spec, params, ids, _ = workload(seed, dev)
    L = spec.num_layers
    checked = []
    real = inference.InferenceRunner.run_inference

    def run_inference(self, input_ids, *, iters=1):
        for w in wrappers:
            w.launches = 0
        r = real(self, input_ids, iters=iters)
        counts = {w.__name__: w.launches for w in wrappers}
        # a forward's device time, the launches queued behind a sleep kernel
        device_ms = time_ms(lambda i: self._forward(input_ids), 2, warmup=1)[0]
        with plain_kernels(*modules):
            plain = self._forward(input_ids)
        out = r["output"]
        if out.shape != (B, PROMPT, spec.vocab_size) or not torch.isfinite(out).all():
            raise AssertionError(f"runner {self.precision} {self.impl}: logits of shape "
                                 f"{tuple(out.shape)} or not finite")
        err = (out.float() - plain.float()).abs().max().item()
        checked.append(dict(launches=counts, forwards=self.warmup_iters + iters,
                            device_ms=device_ms, logits_max_abs_err=err))
        del plain
        return r

    inference.InferenceRunner.run_inference = run_inference
    try:
        results = inference.benchmark_optimization_impact(spec, params, ids, iters=RUNNER_ITERS)
        per_channel = dict(params, blocks={
            k: (qm.quantize_int4(v, group_size=None) if k in ("wq", "wk", "wv", "wo", "w_up",
                                                              "w_down") else v)
            for k, v in params["blocks"].items()})
        for name, runner in (
                ("fused_ln_qkv", inference.InferenceRunner(spec, params, impl=Impl(
                    attention="flash", mlp="fused", norm="fused", fused_ln_qkv=True))),
                ("int4_weights", inference.InferenceRunner(spec, params, precision="int4")),
                ("int4_per_channel", inference.InferenceRunner(spec, per_channel, precision="bf16"))):
            r = runner.run_inference(ids, iters=RUNNER_ITERS)
            results[name] = dict(mean_ms=r["mean_ms"], p99_ms=r["p99_ms"],
                                 peak_bytes=r["peak_bytes"], **runner.quantization_stats(),
                                 speedup=results["baseline"]["mean_ms"] / r["mean_ms"])
            del runner
    finally:
        inference.InferenceRunner.run_inference = real
    if len(checked) != len(results):
        raise AssertionError(f"runner: {len(checked)} runs checked for {len(results)} configs")
    launches = {}
    for (name, entry), c in zip(results.items(), checked):
        want = {w.__name__: runner_expected(name, L).get(w.__name__, 0) * c["forwards"]
                for w in wrappers}
        if c["launches"] != want:
            raise AssertionError(f"runner {name}: launch counts {c['launches']} != expected "
                                 f"{want}")
        if not c["logits_max_abs_err"] <= LOGITS_ATOL:
            raise AssertionError(f"runner {name}: logits {c['logits_max_abs_err']} off the "
                                 f"plain path (> {LOGITS_ATOL})")
        entry.update(c)
        launches[name] = c["launches"]
    emit(dict(phase="runner", model="gpt2", dtype="bf16", batch=B, prompt=PROMPT,
              iters=RUNNER_ITERS, logits_atol=LOGITS_ATOL, configs=results))
    return launches


def engine_prompts(seed, vocab):
    """bench_extra.py's engine_bench traffic: N_PROMPTS prompts of 8..119
    tokens, lengths and tokens from one numpy generator."""
    rng = np.random.default_rng(seed)
    return [list(rng.integers(0, vocab, int(rng.integers(8, 120)))) for _ in range(N_PROMPTS)]


@contextlib.contextmanager
def counted(module, name, count):
    """Wrap module.name so that each call adds count(*args, **kwargs) to
    calls[0]."""
    calls = [0]
    real = getattr(module, name)

    def wrapper(*args, **kwargs):
        calls[0] += count(*args, **kwargs)
        return real(*args, **kwargs)

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def busy_ms(events) -> float:
    """Union of the device kernels' intervals in a torch.profiler trace, ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e3  # us -> ms


def dispatch_times(run_chunk):
    """(device ms, device-busy ms, wall ms) of one decode dispatch. Device ms
    by CUDA events with the chunk queued behind a sleep kernel; it holds
    only while the chunk's launches fit the launch queue, so a dispatch of
    thousands of small launches (the per-op decode) waits on the host and
    reads high. Device-busy ms is the union of the dispatch's kernels in a
    torch.profiler trace. Wall ms by the host clock around the chunk and the
    fetch of its tokens, without the profiler."""
    from torch.profiler import ProfilerActivity, profile

    device_ms = time_ms(lambda i: run_chunk(), 2, warmup=1)[0]
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_chunk().cpu()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run_chunk().cpu()
    busy = busy_ms(prof.events())
    if not busy:
        raise AssertionError("engine: the profiler saw no device time in a dispatch")
    return device_ms, busy, min(walls)


def engine_phase(dev, seed, wrappers, generate_tok_s):
    """The serving engine on GPT-2 small at full width: engine_bench's
    workload (24 prompts of 8..119 tokens, 256 new tokens each, after a
    warm-up wave of 8 prompts and 128 tokens) through the default decode
    (K8), then 8 prompts and 64 tokens through the per-op decode (K7), with
    launch counters, the generated tok/s, the device, device-busy and wall
    ms of one decode dispatch and the idle share (1 - busy / wall); and one decode step from one state
    through both backends, whose logits must agree within LOGITS_ATOL."""
    from mlio_tpu_torch.models import Impl, load_model
    from mlio_tpu_torch.runtime import InferenceEngine
    from mlio_tpu_torch.runtime import engine as engine_mod
    from mlio_tpu_torch.runtime import paged_forward

    spec, params = load_model("gpt2", dtype=torch.bfloat16, device=dev, seed=seed)
    prompts = engine_prompts(seed, spec.vocab_size)
    L = spec.num_layers
    geometry = dict(max_batch=B, num_blocks=POOL_BLOCKS, block_size=POOL_BS,
                    impl=Impl(attention="flash", norm="fused"), device=dev)
    results, launches = {}, {}
    for path, stack, n, new, k in (("mega", "auto", N_PROMPTS, ENGINE_NEW, DISPATCH),
                                    ("perop", "perop", B, 64, 8)):
        eng = InferenceEngine(spec, params, steps_per_dispatch=k, decode_stack=stack, **geometry)
        if eng.decode_stack != path:
            raise AssertionError(f"engine: decode_stack={stack!r} resolved to "
                                 f"{eng.decode_stack!r}, not {path!r}")
        eng.run(prompts[:B], max_new_tokens=WARM_NEW if path == "mega" else 8)  # warm-up
        free0 = eng.manager.num_free
        for w in wrappers:
            w.launches = 0
        with counted(paged_forward, "prefill_paged", lambda *a, **kw: 1) as prefills, \
                counted(engine_mod, "_decode_mega_steps", lambda *a, **kw: kw["k"]) as mega, \
                counted(paged_forward, "decode_paged", lambda *a, **kw: 1) as perop:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = eng.run(prompts[:n], max_new_tokens=new)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = {w.__name__: w.launches for w in wrappers}
        steps = mega[0] if path == "mega" else perop[0]
        want = {"flash_attention": L * prefills[0], "fused_norm": (2 * L + 1) * prefills[0],
                "decode_attention": 0, "decode_layer_stack": 0,
                "paged_attention": 0 if path == "mega" else L * steps,
                "decode_paged_stack": steps if path == "mega" else 0}
        if path == "perop":  # the per-op step's two norms a layer and the final one
            want["fused_norm"] += (2 * L + 1) * steps
        if counts != want:
            raise AssertionError(f"engine {path}: launch counts {counts} != expected {want}")
        if path == "mega" and steps != 768:
            raise AssertionError(f"engine mega: {steps} decode steps dispatched, not 768")
        if [len(o) for o in outs] != [new] * n or eng.manager.num_free != free0:
            raise AssertionError(f"engine {path}: outputs of the wrong length or blocks not "
                                 "returned")
        if min(min(o) for o in outs) < 0 or max(max(o) for o in outs) >= spec.vocab_size:
            raise AssertionError(f"engine {path}: a token out of range")
        launches[path] = counts
        # one dispatch of k steps from the state after a fresh admission
        eng.submit(prompts[0], new)
        for p_ in prompts[1:B]:
            eng.submit(p_, new)
        with torch.inference_mode():
            eng._prefill_batch(list(eng.sched.admit()))
            eng.sched.plan_multi_step(k)
            cur, tables, ctx = (eng._tensor(a) for a in
                                (eng.sched.cur, eng.sched.tables, eng.sched.ctx))
            if path == "mega":
                chunk = lambda: engine_mod._decode_mega_steps(  # noqa: E731
                    params, eng._lm_w, cur, eng.k_pool, eng.v_pool, tables, ctx, eng.generator,
                    spec=spec, k=k, method=eng.method, lm_vmajor=eng._lm_vmajor)
            else:
                chunk = lambda: engine_mod._decode_multi_steps(  # noqa: E731
                    params, cur, eng.k_pool, eng.v_pool, tables, ctx, eng.generator, spec=spec,
                    impl=eng.impl, k=k, method=eng.method)
            device_ms, busy, wall_ms = dispatch_times(chunk)
            if path == "mega":  # one step from this state through both backends
                kp2, vp2 = eng.k_pool.clone(), eng.v_pool.clone()
                lg_mega = engine_mod._mega_step(params, spec, eng._lm_w, eng._lm_vmajor, cur,
                                                eng.k_pool, eng.v_pool, tables, ctx, "logits")
                lg_perop = paged_forward.decode_paged(params, spec, cur, kp2, vp2, tables, ctx,
                                                      impl=eng.impl)
                cross = (lg_mega.float() - lg_perop.float()).abs().max().item()
                if not cross <= LOGITS_ATOL:
                    raise AssertionError(f"engine: K8 and per-op logits {cross} apart "
                                         f"(> {LOGITS_ATOL})")
                results["cross_backend_logits_max_abs"] = cross
                del kp2, vp2
        tok_s = n * new / wall
        results[path] = dict(
            decode_stack=stack, prompts=n, max_new_tokens=new, steps_per_dispatch=k,
            wall_s=wall, generated_tok_per_s=tok_s, prefill_calls=prefills[0],
            decode_steps_dispatched=steps, launches=counts, dispatch_device_ms=device_ms,
            dispatch_busy_ms=busy, dispatch_wall_ms=wall_ms,
            dispatch_busy_ms_per_step=busy / k, decode_idle_share=1 - busy / wall_ms,
            vs_generate=tok_s / generate_tok_s)
        del eng
    emit(dict(phase="engine", model="gpt2", dtype="bf16", max_batch=B, num_blocks=POOL_BLOCKS,
              block_size=POOL_BS, generate_tok_per_s=generate_tok_s,
              logits_atol=LOGITS_ATOL, **results))
    return launches


def generate_tok_s(dev, seed):
    """The port's K4 generate at engine_bench's denominator: batch 8, a
    128-token prompt, a 512-slot cache; tok/s by the two-length marginal
    (160 minus 32 new tokens)."""
    from mlio_tpu_torch.runtime import generate

    spec, params, _, impl = workload(seed, dev)
    ids = torch.zeros((B, 128), dtype=torch.long, device=dev)

    def run(new):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generate(params, spec, ids, max_new_tokens=new, impl=impl, cache_len=512, device=dev)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run(4)
    return B * 128 / (run(160) - run(32))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mlio_tpu_torch.ops import _build
    from mlio_tpu_torch.ops import decode_attention as da
    from mlio_tpu_torch.ops import decode_layer as dl
    from mlio_tpu_torch.ops import decode_paged_stack as dps
    from mlio_tpu_torch.ops import flash_attention as fa
    from mlio_tpu_torch.ops import fused_mlp as fm
    from mlio_tpu_torch.ops import ln_qkv as lq
    from mlio_tpu_torch.ops import norms
    from mlio_tpu_torch.ops import paged_attention as pa
    from mlio_tpu_torch.ops import quant as qm

    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    emit(dict(phase="device", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
              count=torch.cuda.device_count(), torch=torch.__version__,
              cuda=torch.version.cuda))
    emit(dict(phase="build", seconds=_build.build_all()))

    rng = np.random.default_rng(args.seed)
    rows = kernel_phase(rng, dev, args.seed, fa, norms, da, dl)
    rows += paged_rows(pa, dps, dev, args.seed)
    rows += gemm_rows(dev, args.seed, fm, lq, qm)
    emit(dict(phase="kernels", checked=[r["name"] for r in rows]))
    variant_phase(rng, dev, args.seed, fa, norms, da, dl, pa, dps, fm, lq, qm)
    launches = generate_phase(dev, args.seed, fa, norms, da, dl)
    scan_launches = generate_phase(dev, args.seed, fa, norms, da, dl, decode_stack="scan")
    wrappers = (fa.flash_attention, norms.fused_norm, da.decode_attention, dl.decode_layer_stack,
                pa.paged_attention, dps.decode_paged_stack)
    served = engine_phase(dev, args.seed, wrappers, generate_tok_s(dev, args.seed))
    ran = runner_phase(dev, args.seed, wrappers + (fm.fused_mlp, lq.fused_norm_matmul,
                                                   qm.quant_matmul), (fa, norms, da, fm, lq, qm))
    # K5's three instances by the configurations that run them (one wrapper
    # launches all three)
    k5 = {"quant_matmul": ("int8_weights", "all"), "quant_matmul_int4": ("int4_per_channel",),
          "quant_matmul_int4_group": ("int4_weights",)}
    for r in rows:  # each kernel's launches on the path that runs it
        if r["name"] in k5:
            r["launches"] = sum(ran[c]["quant_matmul"] for c in k5[r["name"]])
        elif r["name"] in ("fused_mlp", "fused_norm_matmul"):
            r["launches"] = sum(c[r["name"]] for c in ran.values())
        else:
            r["launches"] = (launches.get(r["name"]) or scan_launches.get(r["name"])
                             or served["mega"][r["name"]] or served["perop"][r["name"]])
        if not r["launches"]:
            raise AssertionError(f"{r['name']}: no launch on the path that runs it")
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
