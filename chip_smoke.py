#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mlio_tpu_torch``) on one NVIDIA GPU.

Run from the repository root, with one card visible:

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line; any failure exits non-zero and no
phase's failure is caught:

1. device: needs ``torch.cuda.is_available()``; reads nvidia-smi's name and
   power limit.
2. build: builds every kernel of ``mlio_tpu_torch/csrc`` with nvcc
   (in parallel, into ``build/kernels``) and reports the seconds and each
   source's registers, stack frames and spills as ptxas reports them.
2b. bandwidth: the probe (K14, ``utils/dma_bench.py``): each configuration
   of its auto and manual streams held against the plain versions over 4
   and 8 GB of seeded data (the corners' sum, and a checksum of every word
   read), then timed by the two-length marginal over those lengths for
   several depths, slice and chunk sizes and blocks an SM, beside a 4 GB
   ``copy_``. The highest rate, the best stream's or the copy's, is the
   rate every row's bound divides bytes by (``bound_ms_spec_sheet`` keeps
   the spec sheet's 3.35 TB/s beside it).
3. kernels: each kernel of the main paths (K1 flash prefill, K9 flash
   prefill over an INT8 cache, K2 fused norm, K3 decode attention, K4 decode
   megakernel, K7 paged attention, K8 paged decode megakernel, K11 fused
   MLP, K12 fused norm + QKV, K5 dequant-fused int8 / int4 / grouped-int4
   matmul) at the main paths' shapes, on inputs from the seed:
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
   the plain version with the weight's last 32 rows of K zeroed, and with a
   64-row K slice halfway down the weight taken from the slice before (K12's
   W, K11's w_up, K5's q: a stale ring slot); K11 also with w_down's rows of
   its second I chunk taken from the first (the fixed-order sum over the
   chunks), and must give the same bits in two launches. The int8
   instances (the K3, K4, K7 and K8 rows' ``int8`` entries, and K9's row):
   K9 at GPT-2's prefill into a 1024-slot INT8 cache and at llama3-8b's
   head geometry; K3 and K7 over INT8 caches; K4 with int8 weights, an INT8
   cache and both, at GPT-2 small and at llama3-8b's full width with 2
   layers; K8 with int8 weights. Each must also fail its check with
   all-ones V scales (an INT8 cache) and a context one token short; an
   INT8 cache written in the kernel is within one int8 step, its scales
   within 1e-4, of the plain quantize. Then the kernels' other instances,
   int8 ones included, at small, ragged shapes (variants; K6 at groups 1, 2,
   4 and 7, head dims 64 and 128, a masked last intermediate chunk, batches
   1, 3, 16 and 32, GPT-2's LayerNorm, biases and learned positions, with
   bf16, int8 + INT8-cache and fp8 weights).
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
   per-layer decode through K3 and K2), its launch counts and step time;
   generate_tiled: with ``"tiled"`` (K6 and the head a token), the K4-or-K6
   rule's measurement at GPT-2 small.
5b. generate_int8 and generate_int8_scan: the README quick start, the same
   workload with ``quantize_params(..., "int8")`` weights and
   ``cache_quant="int8"``: K9 12, K5 72 and K2 25 launches in the prefill
   and one K4 launch for the decode (no K1, no K3); the prefill logits
   within 0.1 of the plain path; the cache's bytes against a bf16 cache's;
   the scan variant's K3 launches (12 a step).
6. engine: the serving engine (``InferenceEngine``) on GPT-2 small with
   bench_extra.py's engine_bench workload: 8 slots, 256 pool blocks of 128,
   24 prompts of 8..119 tokens from the seed, 256 new tokens each, 128 decode
   steps a dispatch, after a warm-up wave. The launch counters, zeroed after
   the warm-up, must show K8 once per decode step (768) and K1/K2 12/25 per
   prefill call; then 8 prompts and 64 tokens through the per-op decode
   (K7 12 per step); generated tok/s, one dispatch's device and wall ms, the
   idle share, the ratio to the port's K4 generate tok/s at batch 8, and one
   decode step through both backends from one state (logits within 0.1).
6b. engine_int8: the same traffic through the default decode with int8
   weights: it must resolve to K8 ("mega") with no K7 launch, K5 in every
   prefill projection; generated tok/s.
7. runner: the inference runner on GPT-2 small at full width, bf16, a
   [8, 704] prompt: ``benchmark_optimization_impact`` with its seven default
   configurations, then runners with ``fused_ln_qkv``, int4 weights (g 128)
   and int4 weights with per-channel scales. Each configuration's
   ``run_inference`` runs with the launch counters zeroed just before it and
   read just after (K11 12 a forward where the MLP is fused, K5 72 where the
   weights are quantized, K12 12 with K2 13 for ``fused_ln_qkv``), and its
   logits must lie within 0.1 of the same configuration with every kernel
   replaced by its plain version; mean and p99 ms, peak bytes, speedup.
8. K6 (the tiled megakernel) at llama3-8b's full width and depth (32
   layers, 4096 hidden, 14336 intermediate, 32/8 heads of 128, random
   weights from the seed), B 8, context 896 in a 1024-slot cache: bf16
   weights and cache, int8 weights with an INT8 cache, int8 weights, fp8
   weights; each against its plain version (x_out under the deep
   tolerance), failing a context one token short (and all-ones V scales over
   the INT8 cache), and failing on x_out with one KV head's query group left
   out of attention at every layer; device ms beside the plain version's,
   the bound, K4's at the same shapes and the phase durations.
9. generate_8b: the slice's path, llama3-8b (32 layers), B 8, a 704-token
   prompt, a 1024-slot cache, greedy, bf16 weights and then the README quick
   start (int8 weights, ``cache_quant="int8"``): prefill logits held against
   an fp32 path, no farther from it than the bf16 plain path (within 5 %, in
   max-abs and RMS); decode_stack "auto", "tiled" (K6: 63 launches, no K4, no
   K3) and "mega" (K4, a launch a token) with launch counters, the decode
   step by the two-length marginal, tok/s, a step's device ms, the idle
   share, and the K4-or-K6 rule's pick beside both times.
9b. widen: K15 (``utils/fp8_convert.py``), the weight-widening probe: its
   four widenings (int8; fp8 by the e4m3x2 convert K6 uses; fp8 through
   fp32; fp8 by bit assembly) over a seeded 1 GB slab (256 chunks of 2048 x
   2048), each held against its plain version, failing over 255 of the 256
   chunks and with one chunk's bytes changed, then timed by the two-length
   marginal (2 and 6 passes) beside K14's rate and its bound.
9c. tiled_moe: K6's MoE phases (the router in the kernel, every expert's
   intermediate chunks weighted by the rows' routing weights) at Mixtral's
   widths, 4 layers, bf16, fp8 and int8 (INT8 cache) weights, B 1, 8 and
   32; then at full depth (32 layers), int8 weights drawn on the card
   (``init_quantized_params``: the build's peak must show no wider copy)
   and an INT8 cache, B 8, ctx 896. Each against the plain version that
   follows the kernel's expert picks, the routing itself held by ROUTE_TOL;
   the full-depth x_out must fail with each row's second expert dropped,
   and a context one token short must fail; device ms, the bound (the
   experts this run's rows pick, and all of them), the phase durations.
9d. generate_moe: the MoE slice's path, Mixtral-8x7B (32 layers, int8
   weights and head), B 8, a 704-token prompt, a 1024-slot INT8 cache,
   greedy, ``Impl(attention="flash", norm="fused", moe="ragged")``: prefill
   logits held against an fp32 path as generate_8b holds them, the plain and
   fp32 paths following the kernel path's expert picks at every layer, and a
   control with K9's output rounded to e4m3 failing that gate; "auto" must
   route to K6 (K4 refuses experts); launch counters (K9 32, K2 65 and one
   a step, K5 129 and one a step, K6 one a step); the decode step by the
   two-length marginal, tok/s, device ms, idle share and bound; three decode
   steps' logits within LOGITS_ATOL of the plain route.
9e. rule: the K4-or-K6 rule's crossover, gpt2-xl and opt-1.3b at full
   depth, bf16 and int8 weights, B 8: the decode step on "mega" and on
   "tiled" beside the route "auto" picks.
10. f1: GPT-2 small greedy generate at B 16 ("auto" must route off K4) and
   ``InferenceEngine(max_batch=16)`` on engine_bench's prompts (per-op K7,
   no K8), each with launch counters and logits within 0.1 of the plain path.
11. flash_grad: K1's dropout instance and K13 (``ops/flash_attention_grad.py``:
   K13a the forward with the log-sum-exp, K13b dQ, K13c dK/dV per query
   head) against their plain versions at llama3-8b's attention (B 1, S 2048,
   32/8 heads of 128, causal), GPT-2's (B 8, S 1024, 12 heads of 64), a
   ragged S 1000 with group 4, a non-causal case, and dropout 0.1 (seed 7)
   at llama3-8b's shape; each must fail with a dropout seed one off (K1's
   output, dq) and against plain versions whose causal frontier is one key
   short (o, lse, dq, dK, dV), and give the same bits twice; timed at
   llama3-8b's attention beside the plain versions, the bound, and
   ``aten._scaled_dot_product_flash_attention`` (K13a) and SDPA's backward
   (the whole K13 backward, K13a's recompute included).
12. train_8b: the training slice's path, llama3-8b at full width and depth,
   bf16 weights from the seed requiring grad, ids [1, 2049]: three SGD steps
   (lr 1e-3) of the next-token loss through ``forward(...,
   impl=Impl(attention="flash"))`` (K1 forward, K13 backward, norms and MLP
   dense): forward, backward and step ms, tokens/s, each loss (finite), peak
   memory, launches (K1, K13a, K13b, K13c 32 a step; no other kernel), the
   idle share. Then the gradient gate at full width and 2 layers: the loss
   and every gradient leaf of the kernel path within 5 % of the bf16 plain
   path's relative RMS error from an fp32 dense path, the plain path taking
   the same route with K1's and K13's plain versions; the dense bf16 path
   (``Impl()``) is reported beside it; a control whose dK/dV come from one
   query head a group must fail.

13. flash_stream: K10 (``ops/flash_attention.py::flash_attention_stream``,
   the long-context forward) through ``flash_attention``'s route, against
   its plain version (``flash_stream_plain``, K/V streamed in 64-key blocks)
   at Mistral-7B-Instruct-v0.2's prefill (B 1, 32,704 queries over a
   32,768-slot cache, 32/8 heads of 128), a ragged B 2 with a decode-style
   q_offset, a non-causal call, head dim 64 and a ragged Sq tail; o and the
   lse (within 1e-4; also against K13a's at S 16,384); o within K1's limit
   and each query row within 1e-2 of its own RMS (ROW_REL_RMS: a row over
   32K keys has |o| near 0.009); failing the plain version one key short,
   with q_offset one off, with one interior V tile stale (rows past 16K or
   30K), and all-ones V; the same
   bits twice; timed beside the plain version, SDPA's flash forward and the
   bound, and against K1 at 8K, 16K and 32K keys. K1's new lse instance
   (kv_len, q_offset) against its plain version.
14. long_context: the long-context slice's path, Mistral-7B-Instruct-v0.2
   (``spec_from_hf_config`` of its published config's values) at full
   width and depth, random bf16 weights from the seed, B 1, a 32,704-token
   prompt into a 32,768-slot cache, 64 greedy tokens through ``generate``
   with ``Impl(attention="flash", norm="fused")``: launch counters (K10 32
   and no K1 in the prefill; the decode on the route "auto" names), the
   prefill (median of 3 by CUDA events, idle share and K10's share from a
   torch.profiler trace), a decode step at context 32,704, peak memory.
   First its prefill gate at 2 layers and the full context: the kernel
   path's logits at 79 positions as far from an fp32 path as the bf16 plain
   path, within 5 %, two controls (K10 with the causal frontier one key
   short; K10 with the V tile at key 16,384 stale) failing it; K10's last
   call of that prefill against its plain version, the stale-tile controls
   failing; and K6 against its plain version at that context.

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
SPEC_BYTES_PER_S = 3.35e12
# The rate bound() divides bytes by: the spec sheet's until the bandwidth
# phase replaces it with the probe's best measured stream (K14).
HBM_BYTES_PER_S = SPEC_BYTES_PER_S
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
# an output by a small fraction of an ulp. K11 adds its chunks' partial
# sums over I one after another in a fixed order, so two launches give the
# same bits (checked). 1e-2 + 1e-2*|plain| holds them; zeroing the weight's
# last 32 rows of K moves the outputs far past it, and so does a 64-row K
# slice of the weight read from the slice before (a stale ring slot) or, in
# K11, w_down's rows of the second I chunk read from the first.
#
# K9 (flash attention over an INT8 cache) rounds q and p * v_scale to bf16 as
# K1 rounds q and p, against a running max where the plain version takes the
# final one: K1's tolerance. The int8 instances of K3, K4, K7 and K8 take
# their bf16 instances' tolerances; an INT8 cache written by the kernel may
# differ from the plain quantize by one int8 step where a value sits on a
# rounding boundary (the fp32 RoPE sums in another order), with its scales
# within 1e-4, the JAX package's own bounds (tests/test_decode_layer.py).
TOL = {"flash_attention": (2e-2, 2e-2), "flash_attention_kvq": (2e-2, 2e-2),
       "fused_norm": (1e-2, 1e-2),
       "decode_attention": (1e-3, 2 ** -7), "decode_attention_grouped": (1e-2, 1e-2),
       "decode_layer_stack": (5e-2, 5e-2), "paged_attention": (1e-3, 2 ** -7),
       "paged_attention_grouped": (1e-2, 1e-2), "decode_paged_stack": (5e-2, 5e-2),
       "quant_matmul": (1e-2, 1e-2), "quant_matmul_int4": (1e-2, 1e-2),
       "quant_matmul_int4_group": (1e-2, 1e-2), "fused_mlp": (1e-2, 1e-2),
       "fused_norm_matmul": (1e-2, 1e-2), "decode_layer_tiled": (5e-2, 5e-2),
       "dma_bench": (1e-4, 1e-4)}
#
# K6's checks at small depth (its ragged variants, and the cache slots it
# writes) take K4's limit. Its x_out at llama3-8b's 32 layers
# ("decode_layer_tiled_deep") adds 2.5e-2 x the row's largest |plain|
# (ROW_TOL): the bf16 roundings that K4's limit allows for 12 layers compound
# over 32 with a residual that grows to |x| ~ 15, and on the card (NVIDIA
# H100 80GB HBM3, 700 W) x_out lay within 0.156 of the plain version's. At
# that depth a context one token short moved x_out by only 0.28-0.34, so
# that case fails on layer 0's written slot; the deep x_out check is shown
# to catch the attention output of one KV head's group of query heads left
# out of every layer.
TOL["decode_layer_tiled_deep"] = TOL["decode_layer_tiled"]
ROW_TOL = {"decode_layer_tiled_deep": 2.5e-2}
ROW_REL_RMS = {}  # name: each row's RMS error over its own RMS (row_rel_rms); K10's, K13's below
ROW_RMS_FLOOR = {}  # name: the least RMS a row is taken to have, over the tensor's (K13's below)
# K6's MoE phases take the same limits; at Mixtral's 32 layers the deep one
# holds x_out and the slots written at every layer alike: a late layer's K/V
# carry the residual's 31-layer noise, and the 12-layer limit on them failed
# at 0.080 on the card (NVIDIA H100 80GB HBM3, 700 W) where x_out passed;
# layer 0's slot keeps its exact int8 check. Their plain version follows
# the kernel's expert picks, read from the kernel's router softmax: a row
# whose k-th and next expert nearly tie may
# pick either on bf16 noise, and the other pick moves x_out by far more than
# the limits. ROUTE_TOL bounds that noise instead: the kernel's softmax
# within 2e-2 of the plain one's and no picked expert more than 2e-2 below
# the plain softmax's k-th largest (at Mixtral's widths and 2 layers the
# softmaxes lay within 1e-3 on the card, NVIDIA H100 80GB HBM3, 700 W); a
# wrong pick lies about 0.1 or more below.
ROUTE_TOL = 2e-2
# Logits of GPT-2 small (std ~0.5 with random weights) through 12 bf16
# layers: kernels against plain versions, max-abs. Random weights make the
# argmax flip on bf16 noise, so a token is checked as "the plain logit at
# the kernel's token is within LOGITS_ATOL of the plain maximum".
LOGITS_ATOL = 0.1
# llama3-8b's prefill (generate_8b) runs 32 layers with a bf16 residual
# that grows to |x| ~ 15, where one bf16 step is 2^-4: a rounding that falls
# the other way there moves every later logit a little. Its kernels' logits
# are held against an fp32 plain path (the same weights, the same INT8 cache
# for the quick start, every activation in fp32): their error has to be no
# larger than the bf16 plain path's own, in max-abs and in RMS, where both
# round at the same points and which of the two lies farther is chance:
# LOGITS_8B_OVER_PLAIN times it. On the card (NVIDIA H100 80GB HBM3, 700 W)
# the kernels' max-abs was 0.105 against the plain path's 0.107 with bf16
# weights and 0.162 against 0.166 for the quick start, their RMS 0.0174743
# against 0.0174745 and 0.025374 against 0.025363; against the bf16 plain
# path itself they lay 0.109 and 0.144 off (GPT-2's 12 layers: within 0.04).
# Mixtral's prefill (generate_moe), the plain and fp32 paths following the
# kernel path's expert picks: 0.2981 against 0.2993 max-abs, 0.041557
# against 0.041487 RMS; the kernel path with K9's output rounded to e4m3 lay
# 0.684 and 0.0960 off, 2.3x, and fails.
LOGITS_8B_OVER_PLAIN = 1.05


_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also carries the seconds since start."""
    if "phase" in obj:
        obj = dict(obj, elapsed_s=time.perf_counter() - _START)
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
    from mlio_tpu_torch.utils.dma_bench import bound_ms

    return bound_ms(nbytes, ops, HBM_BYTES_PER_S, peak_ops)


def timings(kernel, plain, library, reps: int) -> dict:
    """Device ms of the kernel (as both ``ms`` and ``kernel_ms``), of its
    plain version and of the library call (None where no single PyTorch
    call computes the function), and the kernel's host-paced call ms."""
    ms, call_ms = time_ms(kernel, reps)
    return dict(ms=ms, kernel_ms=ms, call_ms=call_ms,
                plain_ms=time_ms(plain, max(4, reps // 5))[0],
                library_ms=None if library is None else time_ms(library, reps)[0])


def within(name: str, got: torch.Tensor, want: torch.Tensor, rows: bool = True):
    """(whether got is finite and within name's tolerance of want, max-abs).
    The tolerance is atol + rtol * |want|, plus ROW_TOL[name] times the
    largest |want| of the element's last-dimension row where one is set;
    where ROW_REL_RMS[name] is set (and ``rows``), each last-dimension row is
    also held to it relative to its own size (row_rel_rms, its floor
    ROW_RMS_FLOOR[name])."""
    atol, rtol = TOL[name]
    got, want = got.float(), want.float()
    err = (got - want).abs()
    limit = atol + rtol * want.abs()
    if name in ROW_TOL:
        limit = limit + ROW_TOL[name] * want.abs().amax(-1, keepdim=True)
    ok = bool(torch.isfinite(got).all()) and not bool((err > limit).any())
    if rows and name in ROW_REL_RMS:
        ok = ok and row_rel_rms(got, want, ROW_RMS_FLOOR.get(name, 0.0)) <= ROW_REL_RMS[name]
    return ok, err.max().item()


def row_rel_rms(got: torch.Tensor, want: torch.Tensor, floor: float = 0.0) -> float:
    """The largest RMS of got - want over the RMS of want, a last-dimension
    row at a time; inf where want's row is zero and got's is not. With a
    floor, a row's RMS is taken as at least floor times the RMS of all of
    want."""
    got, want = got.float(), want.float()
    num = (got - want).square().sum(-1)
    den = want.square().sum(-1)
    if floor:
        den = den.clamp_min(floor ** 2 * den.mean().item())
    rel = torch.where(den > 0, (num / den.clamp_min(1e-30)).sqrt(),
                      torch.where(num > 0, float("inf"), 0.0))
    return rel.max().item()


def check_close(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    ok, err = within(name, got, want)
    if not ok:
        atol, rtol = TOL[name]
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"(max_abs_err {err}, atol {atol}, rtol {rtol})")
    return err


def must_fail_within(name, what, got, want):
    """A deliberately wrong run (``what``) has to fail name's check against
    the plain version. Returns its max-abs."""
    ok, err = within(name, got, want)
    if ok:
        raise AssertionError(f"{name}: the check passes {what} (max_abs_err {err})")
    return err


def int8_kv(gen, shape, dev):
    """An INT8 cache of seeded normal rows: (int8 values, fp32 scales), by
    the port's quantize_kv (the JAX package's per-(token, head) INT8)."""
    from mlio_tpu_torch.ops.quant import quantize_kv

    return quantize_kv(torch.randn(shape, generator=gen, device=dev))


def dequant_bf16(q, scale):
    """An INT8 cache dequantized to bf16: the library yardstick's input."""
    return (q.float() * scale[..., None]).to(torch.bfloat16)


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


def stack_check(dl, spec, params, x, kc, vc, pos, cos, sin, kw, scales=None):
    """K4 from (x, kc, vc) against its plain version, which is fed the
    kernel's own tokens step by step (teacher forcing). Checks x_out after the
    last step, every slot written, that no other slot changed, and each
    step's token by LOGITS_ATOL. With ``scales`` (k_scales, v_scales) the
    caches are INT8. Layer 0's K/V come from the same inputs on both sides,
    so there the kernel's quantize is held to the plain one: ints within one
    step, scales within 1e-4. A later layer's K/V differ by the bf16 noise
    that K4's tolerance allows its residual, so there the written slots,
    dequantized, are held to that tolerance. Returns (plain x_out of the
    last step, the errors)."""
    steps = kw["steps"]
    kk, kv = kc.clone(), vc.clone()
    ksk = psk = {}
    if scales is not None:
        ksk = dict(k_scales=scales[0].clone(), v_scales=scales[1].clone())
        psk = dict(k_scales=scales[0].clone(), v_scales=scales[1].clone())
    xk, tk = dl.decode_layer_stack(x, params["blocks"], kk, kv, pos, cos, sin, **kw, **ksk)
    torch.cuda.synchronize()
    pk, pv = kc.clone(), vc.clone()
    one = dict(kw, steps=1)
    xin, gap = x, 0.0
    for s in range(steps):
        cs = (cos[s:s + 1], sin[s:s + 1]) if cos is not None else (None, None)
        xp, _ = dl.decode_layer_stack_plain(xin, params["blocks"], pk, pv, pos + s, *cs, **one,
                                            **psk)
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
    errs = dict(x_out=check_close("decode_layer_stack", xk, xp))
    errs.update(slot_checks("decode_layer_stack", slice(pos, pos + steps), (kk, kv), (pk, pv),
                            (kc, vc), scales, ksk, psk))
    if tk is not None:
        errs["token_logit_gap"] = gap
    return xp, errs


def slot_checks(name, written, got, want, orig, scales, gsk, wsk):
    """The cache slots ``written`` of the kernel's caches ``got`` against the
    plain version's ``want`` (both from ``orig``); no other slot changed.
    With ``scales`` (the INT8 cache's originals; ``gsk``/``wsk`` the two
    runs' scale tensors) layer 0's K/V come from the same inputs on both
    sides, so there the kernel's quantize is held to the plain one: ints
    within one step, scales within 1e-4. A later layer's K/V differ by the
    bf16 noise that the kernel's tolerance allows its residual, so there the
    written slots, dequantized, are held to that tolerance. Returns the
    errors."""
    rest = torch.ones(orig[0].shape[2], dtype=torch.bool, device=orig[0].device)
    rest[written] = False
    pairs = [(got[0], orig[0], "k"), (got[1], orig[1], "v")]
    if scales is not None:
        pairs += [(gsk["k_scales"], scales[0], "k_scales"),
                  (gsk["v_scales"], scales[1], "v_scales")]
    for g, o, what in pairs:
        if not torch.equal(g[:, :, rest], o[:, :, rest]):
            raise AssertionError(f"{name}: {what} slots outside {written.start}.."
                                 f"{written.stop - 1} changed")
    errs = {}
    if scales is None:
        errs.update(k_slots=check_close(name, got[0][:, :, written], want[0][:, :, written]),
                    v_slots=check_close(name, got[1][:, :, written], want[1][:, :, written]))
        return errs
    for i, kind in enumerate(("k", "v")):
        gs, ws = gsk[f"{kind}_scales"][:, :, written], wsk[f"{kind}_scales"][:, :, written]
        g8, w8 = got[i][:, :, written], want[i][:, :, written]
        steps_l = (g8.int() - w8.int()).abs().amax(dim=(1, 2, 3, 4)).tolist()
        sc0 = (gs[0] - ws[0]).abs().max().item()
        if steps_l[0] > 1 or not sc0 <= 1e-4:
            raise AssertionError(f"{name}: layer 0's written INT8 {kind} slots are "
                                 f"{steps_l[0]} steps and their scales {sc0} off the plain "
                                 "quantize")
        errs[f"{kind}_slots_dequantized"] = check_close(
            name, g8.float() * gs[..., None], w8.float() * ws[..., None])
        errs[f"{kind}_layer0_int8_steps"], errs[f"{kind}_layer0_scales_max_abs"] = \
            steps_l[0], sc0
        errs[f"{kind}_int8_steps_by_layer"] = steps_l
    return errs


def stack_bound(spec, params, batch, slots, kv8=False, head=True):
    """(bound ms, bound_by) of one decode step with the greedy epilogue (K4,
    K8), or without it (``head=False``: K6): every weight (int8 or fp8
    payloads with their scales), bias and norm, the lm_head (the tied table
    or the untied head) and the K/V of ``slots`` cache slots (summed over the
    batch) of every layer read once (an INT8 cache: one byte an element and
    an fp32 scale a row of a head); x, a position row, x_out and the
    tokens."""
    from mlio_tpu_torch.ops.quant import QTensor

    blocks = [t for v in params["blocks"].values() if v is not None
              for t in ((v.q, v.scale) if isinstance(v, QTensor) else (v,))]
    H, L = spec.hidden_size, spec.num_layers
    nbytes = sum(t.numel() * t.element_size() for t in blocks)
    if head:
        lm = "tok_embed" if params["lm_head"] is None else "lm_head"
        nbytes += sum(params[k].numel() * 2 for k in ("final_scale", "final_bias", lm,
                                                      "lm_head_bias") if params[k] is not None)
    kv_row = spec.kv_dim + 4 * spec.num_kv_heads if kv8 else spec.kv_dim * 2
    nbytes += 2 * L * slots * kv_row + (2 * batch + 1) * H * 2 + (batch * 4 if head else 0)
    mats = sum(t.numel() for t in blocks if t.ndim == 3)
    flops = (2 * batch * (mats + (spec.vocab_size * H if head else 0))
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
    short_err = must_fail_within("decode_layer_stack", "a context one token short", x_short,
                                 x_plain)
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
    row["int8"] = stack_int8(dl, dev, seed)
    return row


def stack_int8(dl, dev, seed):
    """K4's int8 paths: int8 weights, an INT8 cache, and both, at GPT-2
    small (12 layers, full width) and at llama3-8b's full width with 2 of its
    32 layers (the only cut: RoPE, GQA 4, SwiGLU, RMSNorm and the untied
    head at full width), B = 8, context DECODE_CTX, the greedy epilogue.
    Each is held against its plain version (K4's tolerance, the tokens'
    plain logits within LOGITS_ATOL, an INT8 cache's written ints within one
    step and its scales within 1e-4 of the plain quantize) and must fail with
    a context one token short and, over an INT8 cache, with all-ones V
    scales; device ms, plain ms, the bound and the phase durations. Returns
    the K4 row's ``int8`` entry."""
    from mlio_tpu_torch.models import get_spec, init_params, load_model
    from mlio_tpu_torch.ops.quant import quantize_kv
    from mlio_tpu_torch.runtime import quantize_params

    name = "decode_layer_stack"
    out = {}
    for model in ("gpt2", "llama3_8b"):
        if model == "gpt2":
            spec, params = load_model("gpt2", dtype=torch.bfloat16, device=dev, seed=seed)
        else:
            spec = dataclasses.replace(get_spec("llama3-8b"), num_layers=2)
            params = init_params(spec, torch.Generator(device=dev).manual_seed(seed),
                                 dtype=torch.bfloat16, device=dev)
        qparams = quantize_params(params, spec, "int8")
        gen = torch.Generator(device=dev).manual_seed(seed + 7)
        pos = DECODE_CTX - 1
        x, kc, vc, cos, sin, kw = stack_inputs(spec, params, B, CACHE, pos, 1, gen)
        kq, ks = quantize_kv(kc.float())
        vq, vs = quantize_kv(vc.float())
        for variant, p_, kv8 in (("w8", qparams, False), ("kv8", params, True),
                                 ("w8kv8", qparams, True)):
            blocks = p_["blocks"]
            caches = (kq, vq) if kv8 else (kc, vc)
            x_plain, errs = stack_check(dl, spec, p_, x, *caches, pos, cos, sin, kw,
                                        scales=(ks, vs) if kv8 else None)

            def kernel(at, v_scales=vs):
                sk = dict(k_scales=ks.clone(), v_scales=v_scales.clone()) if kv8 else {}
                return dl.decode_layer_stack(x, blocks, caches[0].clone(), caches[1].clone(), at,
                                             cos, sin, **kw, **sk)[0]

            row = dict(errors=errs, max_abs_err=errs["x_out"], ctx_minus_1_max_abs_err=(
                must_fail_within(name, "a context one token short", kernel(pos - 1), x_plain)))
            if kv8:
                row["ones_v_scale_max_abs_err"] = must_fail_within(
                    name, "with all-ones V scales", kernel(pos, torch.ones_like(vs)), x_plain)
            sk = dict(k_scales=ks.clone(), v_scales=vs.clone()) if kv8 else {}
            tk, tv = caches[0].clone(), caches[1].clone()
            b_ms, b_by = stack_bound(spec, p_, B, B * DECODE_CTX, kv8=kv8)
            row.update(
                shape=f"{spec.name} ({spec.num_layers} layers) bf16 activations, "
                      f"{'int8' if p_ is qparams else 'bf16'} weights, "
                      f"{'INT8' if kv8 else 'bf16'} cache [{spec.num_layers},{B},{CACHE},"
                      f"{spec.num_kv_heads},{spec.head_size}], ctx {DECODE_CTX}, greedy epilogue",
                **timings(lambda i: dl.decode_layer_stack(x, blocks, tk, tv, pos, cos, sin, **kw,
                                                          **sk),
                          lambda i: dl.decode_layer_stack_plain(x, blocks, tk, tv, pos, cos, sin,
                                                                **kw, **sk),
                          None, 20),
                bound_ms=b_ms, bound_by=b_by)
            stamps = torch.zeros(dl.phase_stamps(spec), dtype=torch.int64, device=dev)
            dl.decode_layer_stack(x, blocks, tk, tv, pos, cos, sin, phase_times=stamps, **kw,
                                  **sk)
            row["phase_us"] = phase_us(spec, stamps)
            out[f"{model}_{variant}"] = row
        del params, qparams, kc, vc, kq, vq
    return out


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
    o, o_plain = fa.flash_attention(q, k, v, **args), fa.flash_attention_plain(q, k, v, **args)
    err = check_close("flash_attention", o, o_plain)
    row_err = row_rel_rms(o, o_plain)
    del o, o_plain
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
        row_rel_rms=row_err, row_rel_rms_limit=ROW_REL_RMS["flash_attention"],
        **timings(lambda i: fa.flash_attention(q, k, v, **args),
                  lambda i: fa.flash_attention_plain(q, k, v, **args),
                  lambda i: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True), 50),
        bound_ms=b_ms, bound_by=b_by))
    rows[-1]["tflop_per_s"] = 4 * B * H * D * pairs / (rows[-1]["ms"] * 1e-3) / 1e12
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
    short_err = must_fail_within("decode_attention", "a context one token short",
                                 da.decode_attention(qd, kc, vc, ctx - 1, layer=5), want)
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
    rows[-1]["int8"] = decode_attention_int8(da, dev, seed, spec)
    rows.append(flash_kvq_row(fa, dev, seed))
    rows.append(stack_row(dl, dev, seed))
    return rows


def flash_kvq_row(fa, dev, seed):
    """K9 at GPT-2 small's prefill (8 x 704 queries into a 1024-slot INT8
    cache, 12 heads of 64, G 1) and at llama3-8b's head geometry (32 query
    heads, 8 KV heads of 128: 2 x 1024 queries into a 2048-slot cache), each
    held against its plain version, failing its check with all-ones V scales
    and with a context one token short; timed beside SDPA over the K/V
    already dequantized to bf16 (the dequantize not timed)."""
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    name = "flash_attention_kvq"

    def case(b, sq, skv, hq, hkv, d, reps):
        q = torch.randn((b, sq, hq, d), generator=gen, device=dev).to(torch.bfloat16)
        kq, ks = int8_kv(gen, (b, skv, hkv, d), dev)
        vq, vs = int8_kv(gen, (b, skv, hkv, d), dev)
        args = dict(causal=True, q_offset=0, kv_len=sq)
        want = fa.flash_attention_kvq_plain(q, kq, vq, ks, vs, **args)
        err = check_close(name, fa.flash_attention_kvq(q, kq, vq, ks, vs, **args), want)
        ones = must_fail_within(name, "with all-ones V scales", fa.flash_attention_kvq(
            q, kq, vq, ks, torch.ones_like(vs), **args), want)
        short = must_fail_within(name, "a context one token short", fa.flash_attention_kvq(
            q, kq, vq, ks, vs, **dict(args, kv_len=sq - 1)), want)
        pairs = sum(min(sq, i + 1) for i in range(sq))
        nbytes = 2 * q.numel() * 2 + 2 * b * sq * hkv * d + 2 * b * sq * hkv * 4
        b_ms, b_by = bound(nbytes, 4 * b * hq * d * pairs, BF16_TENSOR_FLOPS)
        g = hq // hkv
        qs = q.transpose(1, 2)
        kd = dequant_bf16(kq[:, :sq], ks[:, :sq]).repeat_interleave(g, dim=2).transpose(1, 2)
        vd = dequant_bf16(vq[:, :sq], vs[:, :sq]).repeat_interleave(g, dim=2).transpose(1, 2)
        row = dict(
            shape=f"q [{b},{sq},{hq},{d}] bf16, k/v int8 [{b},{skv},{hkv},{d}] + fp32 scales "
                  f"[{b},{skv},{hkv}], kv_len {sq}",
            max_abs_err=err, ones_v_scale_max_abs_err=ones, ctx_minus_1_max_abs_err=short,
            **timings(lambda i: fa.flash_attention_kvq(q, kq, vq, ks, vs, **args),
                      lambda i: fa.flash_attention_kvq_plain(q, kq, vq, ks, vs, **args),
                      None, reps),
            sdpa_dequantized_ms=time_ms(lambda i: F.scaled_dot_product_attention(
                qs, kd, vd, is_causal=True), reps)[0],
            bound_ms=b_ms, bound_by=b_by)
        return row

    row = dict(name=name, route="cuda", source="mlio_tpu_torch/csrc/flash_fwd.cu",
               replaces="mlio_tpu/ops/flash_attention.py:199",
               **case(B, PROMPT, CACHE, 12, 12, 64, 50),
               atol=TOL[name][0], rtol=TOL[name][1], tolerance_of="flash_attention (K1)",
               library_note="no single PyTorch call attends over int8 K/V with per-(token, "
                            "head) scales; sdpa_dequantized_ms is F.scaled_dot_product_attention "
                            "over the K/V already dequantized to bf16, the dequantize not timed")
    row["llama3_8b"] = case(*KVQ_LLAMA, 20)
    return row


def decode_attention_int8(da, dev, seed, spec):
    """K3's int8 instance at GPT-2 small's decode step over a 1024-slot INT8
    cache at context DECODE_CTX, held against its plain version, failing
    with all-ones V scales and with a context one token short; the timed
    launches walk the 12 layers. Returns the K3 row's ``int8`` entry."""
    gen = torch.Generator(device=dev).manual_seed(seed + 6)
    H, D, L = spec.num_heads, spec.head_size, spec.num_layers
    qd = torch.randn((B, H, D), generator=gen, device=dev).to(torch.bfloat16)
    kc, ks = int8_kv(gen, (L, B, CACHE, H, D), dev)
    vc, vs = int8_kv(gen, (L, B, CACHE, H, D), dev)
    ctx = torch.full((B,), DECODE_CTX, dtype=torch.int32, device=dev)
    sc = dict(k_scales=ks, v_scales=vs)
    want = da.decode_attention_plain(qd, kc, vc, ctx, layer=5, **sc)
    err = check_close("decode_attention", da.decode_attention(qd, kc, vc, ctx, layer=5, **sc),
                      want)
    ones = must_fail_within("decode_attention", "with all-ones V scales", da.decode_attention(
        qd, kc, vc, ctx, layer=5, k_scales=ks, v_scales=torch.ones_like(vs)), want)
    short = must_fail_within("decode_attention", "a context one token short",
                             da.decode_attention(qd, kc, vc, ctx - 1, layer=5, **sc), want)
    nbytes = 2 * qd.numel() * 2 + 2 * B * DECODE_CTX * H * D + 2 * B * DECODE_CTX * H * 4
    b_ms, b_by = bound(nbytes, 4 * B * H * DECODE_CTX * D, FP32_FLOPS)
    q4 = qd[:, :, None, :]
    dense = [(dequant_bf16(kc[l, :, :DECODE_CTX], ks[l, :, :DECODE_CTX]).transpose(1, 2),
              dequant_bf16(vc[l, :, :DECODE_CTX], vs[l, :, :DECODE_CTX]).transpose(1, 2))
             for l in range(L)]
    return dict(
        shape=f"q [{B},{H},{D}] bf16, cache int8 [{L},{B},{CACHE},{H},{D}] + fp32 scales, "
              f"ctx {DECODE_CTX}",
        max_abs_err=err, atol=TOL["decode_attention"][0], rtol=TOL["decode_attention"][1],
        ones_v_scale_max_abs_err=ones, ctx_minus_1_max_abs_err=short,
        **timings(lambda i: da.decode_attention(qd, kc, vc, ctx, layer=i % L, **sc),
                  lambda i: da.decode_attention_plain(qd, kc, vc, ctx, layer=i % L, **sc),
                  None, 240),
        sdpa_dequantized_ms=time_ms(lambda i: F.scaled_dot_product_attention(
            q4, *dense[i % L]), 240)[0],
        library_note="no single PyTorch call; sdpa_dequantized_ms over the K/V already "
                     "dequantized to bf16",
        bound_ms=b_ms, bound_by=b_by)


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
    return err, must_fail_within(name, "a context one token short", pa.paged_attention(
        q, kp, vp, tables, ctx - 1, layer=layer), want)


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
    short_err = must_fail_within("decode_paged_stack", "a context one token short", x_short,
                                 x_plain)
    x896, _, _ = paged_x(spec, params, ids, past896)
    x896_plain, errs896 = paged_stack_check(dps, spec, params, x896, kp, vp, tables, past896,
                                            None, None, kw)
    x_short, _ = dps.decode_paged_stack(x896, params["blocks"], kp.clone(), vp.clone(), tables,
                                        past896 - 1, **kw)
    short896 = must_fail_within("decode_paged_stack", f"a context one token short at "
                                f"{DECODE_CTX}", x_short, x896_plain)
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

    # K8's int8 weight path over the same bf16 pools (the JAX K8 has no INT8
    # KV path): the ragged contexts, a context one token short must fail.
    from mlio_tpu_torch.runtime import quantize_params

    qparams = quantize_params(params, spec, "int8")
    qblocks = qparams["blocks"]
    xq_plain, errs_q = paged_stack_check(dps, spec, qparams, x, kp, vp, tables, past, None, None,
                                         kw)
    b_ms, b_by = stack_bound(spec, qparams, B, slots)
    k8["int8_weights"] = dict(
        shape=f"{k8['shape']}, int8 weights [L, in, out] + fp32 scales [L, out]",
        errors=errs_q, max_abs_err=errs_q["x_out"],
        ctx_minus_1_max_abs_err=must_fail_within(
            "decode_paged_stack", "a context one token short", dps.decode_paged_stack(
                x, qblocks, kp.clone(), vp.clone(), tables, past - 1, **kw)[0], xq_plain),
        **timings(lambda i: dps.decode_paged_stack(x, qblocks, kp, vp, tables, past, **kw),
                  lambda i: dps.decode_paged_stack_plain(x, qblocks, kp, vp, tables, past, **kw),
                  None, 20),
        bound_ms=b_ms, bound_by=b_by)
    del qparams, qblocks

    # K7's int8 instance over INT8 pools (int8 rows, fp32 scale pools
    # [L, NB, bs, Hkv]) at the ragged contexts and at DECODE_CTX; all-ones V
    # scales and a context one token short must fail. No main path runs INT8
    # pools (the JAX engine has none), so it has no launches there.
    from mlio_tpu_torch.ops.quant import quantize_kv

    kq, ks = quantize_kv(kp.float())
    vq, vs = quantize_kv(vp.float())
    sc = dict(k_scale_pool=ks, v_scale_pool=vs)

    def k7q(c, layer, v_scale=vs):
        return pa.paged_attention(q, kq, vq, tables, c, layer=layer, k_scale_pool=ks,
                                  v_scale_pool=v_scale)

    errs7 = {}
    for key, c in (("ragged", ctx), ("ctx896", past896 + 1)):
        want = pa.paged_attention_plain(q, kq, vq, tables, c, layer=5, **sc)
        errs7[key] = dict(
            max_abs_err=check_close("paged_attention", k7q(c, 5), want),
            ones_v_scale_max_abs_err=must_fail_within(
                "paged_attention", "with all-ones V scales", k7q(c, 5, torch.ones_like(vs)), want),
            ctx_minus_1_max_abs_err=must_fail_within(
                "paged_attention", "a context one token short", k7q(c - 1, 5), want))
    slots7 = int(ctx.sum())
    b_ms, b_by = bound(2 * q.numel() * 2 + 2 * slots7 * H * D + 2 * slots7 * H * 4
                       + tables.numel() * 4 + B * 4, 4 * H * D * slots7, FP32_FLOPS)
    dense = [(dequant_bf16(pa.gather_blocks(kq, l, tables), pa.gather_blocks(ks, l, tables))
              .transpose(1, 2).contiguous(),
              dequant_bf16(pa.gather_blocks(vq, l, tables), pa.gather_blocks(vs, l, tables))
              .transpose(1, 2).contiguous()) for l in range(L)]
    k7["int8"] = dict(
        shape=f"q [{B},{H},{D}] bf16, INT8 pools [{L},{POOL_BLOCKS},{POOL_BS},"
              f"{spec.num_kv_heads},{D}] + fp32 scale pools, tables [{B},{TABLE_BLOCKS}], "
              f"past contexts {list(RAGGED)} (+1 current token)",
        errors=errs7, max_abs_err=errs7["ragged"]["max_abs_err"],
        launches=0, launches_note="no main path runs INT8 pools: the JAX engine has none",
        **timings(lambda i: k7q(ctx, i % L),
                  lambda i: pa.paged_attention_plain(q, kq, vq, tables, ctx, layer=i % L, **sc),
                  None, 240),
        sdpa_dequantized_ms=time_ms(lambda i: F.scaled_dot_product_attention(
            q4, *dense[i % L], attn_mask=mask), 240)[0],
        library_note="no single PyTorch call; sdpa_dequantized_ms over the K/V the tables "
                     "name, dequantized to bf16 (gather and dequantize not timed)",
        bound_ms=b_ms, bound_by=b_by,
        ms_ctx896=time_ms(lambda i: k7q(past896 + 1, i % L), 240)[0])
    del dense, kq, vq
    return [k7, k8]


def paged_variants(dev, seed, pa, dps):
    """K7's and K8's other instances against their plain versions at small
    shapes: grouped heads, head dim 128, block sizes 8 to 64, batch 3 and 5,
    and K8 with GQA 4, RMSNorm, SwiGLU, per-sequence RoPE, an untied head
    with a bias, learned positions and a past context of 0."""
    from mlio_tpu_torch.models import get_spec, init_params
    from mlio_tpu_torch.ops.quant import quantize_kv
    from mlio_tpu_torch.runtime import quantize_params

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
        (kq, ks), (vq, vs) = (quantize_kv(t.float()) for t in (kp, vp))
        sc = dict(k_scale_pool=ks, v_scale_pool=vs)
        errs[f"paged_attention_int8[{i}]"] = check_close(
            "paged_attention" if g == 1 else "paged_attention_grouped",
            pa.paged_attention(q, kq, vq, tables, c, layer=layer, **sc),
            pa.paged_attention_plain(q, kq, vq, tables, c, layer=layer, **sc))
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
        errs[f"decode_paged_stack_int8_weights[{name}]"] = paged_stack_check(
            dps, spec, quantize_params(params, spec, "int8"), x, kp, vp, tables, past, cos, sin,
            kw)[1]
    return errs


def stack_variants(dev, seed, dl):
    """K4's other instances against its plain version at small shapes, with
    norm scales and every bias drawn from the seed."""
    import dataclasses

    from mlio_tpu_torch.models import get_spec, init_params
    from mlio_tpu_torch.ops.quant import quantize_kv
    from mlio_tpu_torch.runtime import quantize_params

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
        # int8 weights and an INT8 cache together
        (kq, ks), (vq, vs) = (quantize_kv(t.float()) for t in (kc, vc))
        errs[f"decode_layer_stack_int8[{name}]"] = stack_check(
            dl, spec, quantize_params(params, spec, "int8"), x, kq, vq, pos, cos, sin, kw,
            scales=(ks, vs))[1]
    return errs


# The GEMM kernels' shapes: GPT-2 small's prefill (B x PROMPT tokens) and one
# layer of llama3-8b at 2048 tokens (H 4096, I 14336, 32/8 heads of 128).
GPT2_M, GPT2_H, GPT2_I = B * PROMPT, 768, 3072
LLAMA_M, LLAMA_H, LLAMA_I, LLAMA_KVD = 2048, 4096, 14336, 1024
DECODE_M = 8  # a decode step's rows at batch 8
# K9 at llama3-8b's head geometry: (batch, queries, cache slots, Hq, Hkv, D)
KVQ_LLAMA = (2, 1024, 2048, 32, 8, 128)


def must_fail(name, got, plain_fn, weight, rows):
    """The check has to catch the last K tile lost: the plain version with
    ``weight``'s rows ``rows`` zeroed must fail it. Returns that max-abs."""
    saved = weight[rows].clone()
    weight[rows] = 0
    try:
        want = plain_fn()
    finally:
        weight[rows] = saved
    return must_fail_within(name, "with the weight's last K tile zeroed", got, want)


def stale_rows(name, got, plain_fn, weights, at, src, count, what):
    """name's output must fail its check against the plain version with rows
    [at, at + count) of each weight taken from rows [src, src + count): a K
    tile read from a stale ring slot, or a chunk's rows summed in place of
    another's. Returns that max-abs."""
    saved = [w[at:at + count].clone() for w in weights]
    for w in weights:
        w[at:at + count] = w[src:src + count]
    try:
        want = plain_fn()
    finally:
        for w, old in zip(weights, saved):
            w[at:at + count] = old
    return must_fail_within(name, f"against {what} rows {at}.. taken from rows {src}..", got,
                            want)


def stale_k_slice(got, plain_fn, weights, at, name="fused_norm_matmul", what="W's K slice"):
    """The output must fail its check against the plain version with the
    weights' 64-row K slice at ``at`` taken from the slice before, in every
    part (K12's W, K11's w_up, K5's q): a K tile read from a stale ring slot.
    Returns that max-abs."""
    return stale_rows(name, got, plain_fn, weights, at, at - 64, 64, what)


def same_bits_twice(name, kernel):
    """Two launches on the same inputs must give the same bits (a sum in a
    fixed order)."""
    if not torch.equal(kernel(), kernel()):
        raise AssertionError(f"{name}: two launches on the same inputs gave different bits")
    return True


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
                                          "stale_k_slice_max_abs_err",
                                          "stale_w_down_chunk_max_abs_err", "same_bits_twice",
                                          "tflop_per_s", "ms", "plain_ms", "library_ms",
                                          "bound_ms", "bound_by")
                    if k in other}

    def k11_checks(row, kernel, plain, wu, wd, h, flops):
        """K11's same bits twice, its stale w_up K slice (at H/2) and w_down's
        second I chunk taken from the first: the ring and the fixed-order sum."""
        row["same_bits_twice"] = same_bits_twice("fused_mlp", kernel)
        row["stale_k_slice_max_abs_err"] = stale_k_slice(kernel(), plain, [wu], h // 2,
                                                         "fused_mlp", "w_up's K slice")
        row["stale_w_down_chunk_max_abs_err"] = stale_rows(
            "fused_mlp", kernel(), plain, [wd], fm.BLOCK_I, 0, fm.BLOCK_I,
            "w_down's second I chunk")
        row["tflop_per_s"] = flops / (row["ms"] * 1e-3) / 1e12
        return row

    rows = []
    spec_h, spec_i = GPT2_H, GPT2_I
    # K11: GPT-2 (gelu_new, biases), then llama3-8b (SwiGLU, no biases).
    x = rn(GPT2_M, spec_h)
    wu, wd = rn(spec_h, spec_i, scale=spec_h ** -0.5), rn(spec_i, spec_h, scale=spec_i ** -0.5)
    bu, bd = rn(spec_i, scale=0.1), rn(spec_h, scale=0.1)
    kw = dict(b_up=bu, b_down=bd, activation="gelu_new")
    src = ("fused_mlp", "mlio_tpu_torch/csrc/fused_mlp.cu", "mlio_tpu/ops/fused_mlp.py:45")
    kernel, plain = (lambda: fm.fused_mlp(x, wu, wd, **kw)), (lambda: fm.fused_mlp_plain(x, wu, wd, **kw))
    flops = 2 * GPT2_M * spec_h * spec_i * 2
    k11 = k11_checks(gemm_row(
        *src, f"x [{GPT2_M},{spec_h}], I {spec_i}, gelu_new, b_up and b_down, bf16", kernel, plain,
        lambda i: F.gelu(x @ wu + bu, approximate="tanh") @ wd + bd,
        (2 * GPT2_M * spec_h + 2 * spec_h * spec_i + spec_i + spec_h) * 2, flops, wu,
        slice(spec_h - 32, spec_h), 20), kernel, plain, wu, wd, spec_h, flops)
    x = rn(LLAMA_M, LLAMA_H)
    wu, wg = (rn(LLAMA_H, LLAMA_I, scale=LLAMA_H ** -0.5) for _ in range(2))
    wd = rn(LLAMA_I, LLAMA_H, scale=LLAMA_I ** -0.5)
    kw = dict(w_gate=wg, activation="swiglu")
    kernel, plain = (lambda: fm.fused_mlp(x, wu, wd, **kw)), (lambda: fm.fused_mlp_plain(x, wu, wd, **kw))
    flops = 2 * LLAMA_M * LLAMA_H * LLAMA_I * 3
    extra(k11, "llama3_8b", k11_checks(gemm_row(
        *src, f"x [{LLAMA_M},{LLAMA_H}], I {LLAMA_I}, swiglu, no biases, bf16", kernel, plain,
        lambda i: (F.silu(x @ wg) * (x @ wu)) @ wd,
        (2 * LLAMA_M * LLAMA_H + 3 * LLAMA_H * LLAMA_I) * 2, flops,
        wu, slice(LLAMA_H - 32, LLAMA_H), 4), kernel, plain, wu, wd, LLAMA_H, flops))
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
        row["stale_k_slice_max_abs_err"] = stale_k_slice(
            lq.fused_norm_matmul(x, None, sc, b, kind=kind, parts=ws),
            lambda: lq.fused_norm_matmul_plain(x, None, sc, b, kind=kind, parts=ws), ws, h // 2)
        row["tflop_per_s"] = 2 * m * h * n / (row["ms"] * 1e-3) / 1e12
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
        kernel = lambda: qm.quant_matmul(x, t.q, t.scale, fmt=fmt)  # noqa: E731
        plain = lambda: qm.quant_matmul_plain(x, t.q, t.scale, fmt=fmt)  # noqa: E731
        row = gemm_row(
            name, "mlio_tpu_torch/csrc/quant_matmul.cu", f"mlio_tpu/ops/quant.py:{line}",
            f"x [{m},{k}] @ {fmt} q {list(t.q.shape)}, scale {list(t.scale.shape)}, bf16",
            kernel, plain, lambda i: x @ qm.dequantize(t, torch.bfloat16),
            m * k * 2 + t.q.numel() + t.scale.numel() * 4 + m * n * 2, 2 * m * k * n,
            t.q, deq_rows, reps)
        if m > DECODE_M:  # q's 64-row slice halfway down its rows from the slice before
            row["stale_k_slice_max_abs_err"] = stale_k_slice(
                kernel(), plain, [t.q], t.q.shape[0] // 2, name, "q's row slice")
        row["tflop_per_s"] = 2 * m * k * n / (row["ms"] * 1e-3) / 1e12
        return row

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
    the 16-byte vector width), every activation, biases, grouped heads; K12
    also at the widest H whose scale and bias it stages in shared memory
    (8,952) and past it, by the TMA and by cp.async. Past the 128-row tiles
    of K5 and K11 (M 130): K5 with N past 256 (int8) or 128 (int4), K not a
    multiple of 64, int4's K/2 crossing a 64-row step, groups of 16, 32 and
    64; K11 with I past a chunk and not a multiple of 64, H past a 256-column
    tile; each by the TMA and by cp.async (int8 N % 16 != 0, int4 K % 16 !=
    0, K11 H or I % 8 != 0)."""
    gen = torch.Generator(device=dev).manual_seed(seed + 4)

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    errs = {}
    for i, (m, k, n, fmt, gs) in enumerate([
            (37, 200, 72, "int8", None), (130, 776, 264, "int8", None), (1, 64, 17, "int8", None),
            (37, 200, 72, "int4", None), (50, 512, 136, "int4", 128), (9, 96, 40, "int4", 16),
            (5, 30, 24, "int4", None), (130, 200, 272, "int8", None),
            (130, 272, 272, "int4", None), (130, 288, 144, "int4", 16),
            (70, 320, 136, "int4", 32), (130, 384, 272, "int4", 64),
            (130, 200, 264, "int8", None), (130, 264, 136, "int4", None)]):
        x, w = rn(m, k), torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
        t = qm.quantize_int8(w) if fmt == "int8" else qm.quantize_int4(w, group_size=gs)
        errs[f"quant_matmul[{i}]"] = check_close(
            "quant_matmul", qm.quant_matmul(x, t.q, t.scale, fmt=fmt),
            qm.quant_matmul_plain(x, t.q, t.scale, fmt=fmt))
    for i, (m, h, inter, act, with_bias) in enumerate([
            (37, 72, 200, "gelu", True), (70, 64, 300, "relu", False), (3, 40, 24, "geglu", True),
            (130, 136, 520, "swiglu", True), (9, 36, 20, "gelu_new", False),
            (130, 264, 584, "gelu_new", True), (200, 200, 776, "geglu", False),
            (130, 100, 300, "swiglu", True), (131, 260, 580, "gelu", True)]):
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
            (5, 64, (200,), "layernorm", True), (3, 256, (256, 64, 64), "rmsnorm", False),
            (129, 200, (136, 40, 40), "rmsnorm", True),
            (129, 8952, (128, 64, 64), "layernorm", True),
            (129, 8968, (128, 64, 64), "layernorm", True),
            (130, 8970, (50, 30, 30), "rmsnorm", True)]):
        x, sc = rn(m, h) + 0.5, 1 + rn(h, scale=0.1)
        b = rn(h, scale=0.1) if with_bias else None
        ws = [rn(h, w, scale=h ** -0.5) for w in widths]
        errs[f"fused_norm_matmul[{i}]"] = check_close(
            "fused_norm_matmul", lq.fused_norm_matmul(x, None, sc, b, kind=kind, parts=ws),
            lq.fused_norm_matmul_plain(x, None, sc, b, kind=kind, parts=ws))
    return errs


def variant_phase(rng, dev, seed, fa, norms, da, dl, pa, dps, fm, lq, qm, dt):
    """The kernels' other instances (GQA, head dim 128, ragged lengths,
    empty rows, the block-per-row norm; the int8 instances of K9, K3, K4,
    K7 and K8) against their plain versions at small shapes, in bf16: the
    card-side counterpart of the CPU tests."""
    from mlio_tpu_torch.ops.quant import quantize_kv

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(
            dev, torch.bfloat16)

    errs = {}
    # (B, Sq, Skv, Hq, Hkv, D, causal, q_offset, kv_len)
    for i, (b, sq, skv, hq, hkv, d, causal, qo, kvl) in enumerate([
            (2, 100, 160, 8, 2, 128, True, 37, [150, 60]),
            (1, 65, 65, 4, 4, 64, True, 0, None),
            (2, 33, 128, 4, 1, 64, False, 0, [0, 77]),
            (2, 1089, 1089, 16, 4, 128, True, 0, [1089, 700]),
            (2, 300, 800, 8, 2, 64, True, 11, [311, 200])]):
        q, k, v = randn(b, sq, hq, d), randn(b, skv, hkv, d), randn(b, skv, hkv, d)
        kv = None if kvl is None else torch.tensor(kvl, dtype=torch.int32, device=dev)
        args = dict(causal=causal, q_offset=qo, kv_len=kv)
        errs[f"flash_attention[{i}]"] = check_close(
            "flash_attention", fa.flash_attention(q, k, v, **args),
            fa.flash_attention_plain(q, k, v, **args))
        (kq, ks), (vq, vs) = (quantize_kv(t.float()) for t in (k, v))
        errs[f"flash_attention_kvq[{i}]"] = check_close(
            "flash_attention_kvq", fa.flash_attention_kvq(q, kq, vq, ks, vs, **args),
            fa.flash_attention_kvq_plain(q, kq, vq, ks, vs, **args))
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
        name = "decode_attention" if g == 1 else "decode_attention_grouped"
        errs[f"decode_attention[{i}]"] = check_close(
            name, da.decode_attention(q, kc, vc, c, layer=layer),
            da.decode_attention_plain(q, kc, vc, c, layer=layer))
        (kq, ks), (vq, vs) = (quantize_kv(t.float()) for t in (kc, vc))
        sc = dict(k_scales=ks, v_scales=vs)
        errs[f"decode_attention_int8[{i}]"] = check_close(
            name, da.decode_attention(q, kq, vq, c, layer=layer, **sc),
            da.decode_attention_plain(q, kq, vq, c, layer=layer, **sc))
    errs.update(stack_variants(dev, seed, dl))
    errs.update(paged_variants(dev, seed, pa, dps))
    errs.update(gemm_variants(dev, seed, fm, lq, qm))
    errs.update(tiled_variants(dev, seed, dt))
    emit(dict(phase="variants", max_abs_err=errs))


# the kernel wrappers a forward calls, and their plain versions
PLAIN = {"flash_attention": "flash_attention_plain",
         "flash_attention_kvq": "flash_attention_kvq_plain", "fused_norm": "fused_norm_plain",
         "decode_attention": "decode_attention_plain", "fused_mlp": "fused_mlp_plain",
         "fused_norm_matmul": "fused_norm_matmul_plain", "quant_matmul": "quant_matmul_plain",
         "decode_layer_tiled": "decode_layer_tiled_plain", "flash_fwd_lse": "flash_fwd_lse_plain",
         "flash_bwd_dq": "flash_bwd_dq_plain", "flash_bwd_dkv": "flash_bwd_dkv_plain",
         "flash_attention_stream": "flash_stream_plain"}


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


def generate_phase(dev, seed, fa, norms, da, dl, qm, decode_stack=None, int8=False, dt=None):
    """A 64-token greedy generate of the workload with launch counters, the
    decode step by the two-length marginal and the device time of a step.
    The main path (decode_stack None) also checks the prefill logits and
    times the prefill; "scan" runs the per-layer decode through K3. With
    ``int8`` it is the README quick start: the weights through
    ``quantize_params(..., "int8")`` and an INT8 KV cache
    (``cache_quant="int8"``): K9 and K5 in the prefill, K4's int8 paths (or
    K3's int8 instances) in the decode; it also reports the cache's bytes
    against a bf16 cache's. "tiled" (``dt`` given) decodes through K6 and
    the head a token: the K4-or-K6 rule's measurement at GPT-2 small."""
    from mlio_tpu_torch.models import forward
    from mlio_tpu_torch.runtime import cache_memory_bytes, generate, init_cache, quantize_params

    spec, params, ids, impl = workload(seed, dev)
    if int8:
        params = quantize_params(params, spec, "int8")
    quant = "int8" if int8 else None
    if decode_stack is not None:
        impl = dataclasses.replace(impl, decode_stack=decode_stack)
    L = spec.num_layers

    def prefill():
        cache = init_cache(spec, B, CACHE, dtype=torch.bfloat16, quant=quant, device=dev)
        with torch.inference_mode():
            return forward(params, spec, ids, impl=impl, cache=cache)

    name = "generate" + ("_int8" if int8 else "") + \
        ("" if decode_stack is None else f"_{decode_stack}")
    result = dict(phase=name, model="gpt2", dtype="bf16", batch=B, prompt=PROMPT,
                  cache_len=CACHE, impl=repr(impl), weights="int8" if int8 else "bf16",
                  cache_quant=quant)
    if int8:
        result.update(cache_bytes=cache_memory_bytes(spec, B, CACHE, quant="int8"),
                      cache_bytes_bf16=cache_memory_bytes(spec, B, CACHE, torch.bfloat16))
    if decode_stack is None:
        logits = prefill()[0]
        with plain_kernels(fa, norms, da, qm):
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
                       cache_len=CACHE, cache_quant=quant, device=dev)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    run(4)  # warm-up
    wrappers = (fa.flash_attention, fa.flash_attention_kvq, norms.fused_norm, qm.quant_matmul,
                da.decode_attention, dl.decode_layer_stack) + (() if dt is None
                                                               else (dt.decode_layer_tiled,))
    for w in wrappers:
        w.launches = 0
    out, t_short = run(SHORT)
    launches = {w.__name__: w.launches for w in wrappers}
    steps = SHORT - 1
    attn = "flash_attention_kvq" if int8 else "flash_attention"
    want = {w.__name__: 0 for w in wrappers}
    want[attn] = L
    if decode_stack is None:
        want.update(fused_norm=2 * L + 1, decode_layer_stack=1)
        want["quant_matmul"] = 6 * L if int8 else 0
    elif decode_stack == "tiled":
        want.update(fused_norm=2 * L + 1 + steps, decode_layer_tiled=steps)
        want["quant_matmul"] = 6 * L if int8 else 0
    else:
        want.update(fused_norm=(2 * L + 1) * (1 + steps), decode_attention=L * steps)
        want["quant_matmul"] = 6 * L * (1 + steps) if int8 else 0
    if launches != want:
        raise AssertionError(f"{name}: launch counts {launches} != expected {want}")
    if out.shape != (B, PROMPT + SHORT) or not torch.equal(out[:, :PROMPT], ids) \
            or int(out.min()) < 0 or int(out.max()) >= spec.vocab_size:
        raise AssertionError(f"{name}: wrong shape, prompt changed or token out of range")
    _, t_long = run(LONG)
    step_s = (t_long - t_short) / (LONG - SHORT)

    # Device time of a decode step, the work queued behind a sleep kernel so
    # it runs back to back: the idle share is 1 - device / wall.
    cache = prefill()[1]
    with torch.inference_mode():
        if decode_stack is None:  # the 63-step K4 launch, over its steps
            x = params["tok_embed"][out[:, PROMPT]]
            kw = dict(spec=spec, head_norm=(params["final_scale"], params["final_bias"]),
                      lm_head=params["tok_embed"], pos_embed=params["pos_embed"], steps=steps,
                      k_scales=cache.get("k_scale"), v_scales=cache.get("v_scale"))
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


def engine_phase(dev, seed, wrappers, generate_tok_s, int8=False):
    """The serving engine on GPT-2 small at full width: engine_bench's
    workload (24 prompts of 8..119 tokens, 256 new tokens each, after a
    warm-up wave of 8 prompts and 128 tokens) through the default decode
    (K8), then 8 prompts and 64 tokens through the per-op decode (K7), with
    launch counters, the generated tok/s, the device, device-busy and wall
    ms of one decode dispatch and the idle share (1 - busy / wall); and one decode step from one state
    through both backends, whose logits must agree within LOGITS_ATOL. With
    ``int8`` the weights go through ``quantize_params(..., "int8")`` and only
    the default decode runs: it must resolve to K8 ("mega", its int8 weight
    path) with no K7 launch, K5 in every prefill projection."""
    from mlio_tpu_torch.models import Impl, load_model
    from mlio_tpu_torch.runtime import InferenceEngine, quantize_params
    from mlio_tpu_torch.runtime import engine as engine_mod
    from mlio_tpu_torch.runtime import paged_forward

    spec, params = load_model("gpt2", dtype=torch.bfloat16, device=dev, seed=seed)
    if int8:
        params = quantize_params(params, spec, "int8")
    prompts = engine_prompts(seed, spec.vocab_size)
    L = spec.num_layers
    geometry = dict(max_batch=B, num_blocks=POOL_BLOCKS, block_size=POOL_BS,
                    impl=Impl(attention="flash", norm="fused"), device=dev)
    results, launches = {}, {}
    paths = (("mega", "auto", N_PROMPTS, ENGINE_NEW, DISPATCH), ("perop", "perop", B, 64, 8))
    for path, stack, n, new, k in paths[:1] if int8 else paths:
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
                "decode_paged_stack": steps if path == "mega" else 0,
                "flash_attention_kvq": 0, "quant_matmul": 6 * L * prefills[0] if int8 else 0}
        want = {w: want[w] for w in counts}
        if path == "perop":  # the per-op step's two norms a layer and the final one
            want["fused_norm"] += (2 * L + 1) * steps
        if counts != want:
            raise AssertionError(f"engine {path}: launch counts {counts} != expected {want}")
        if path == "mega" and steps != N_PROMPTS * ENGINE_NEW // B:
            raise AssertionError(f"engine mega: {steps} decode steps dispatched, not "
                                 f"{N_PROMPTS * ENGINE_NEW // B}")
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
    emit(dict(phase="engine_int8" if int8 else "engine", model="gpt2", dtype="bf16",
              weights="int8" if int8 else "bf16", max_batch=B, num_blocks=POOL_BLOCKS,
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


# ---------------------------------------------------------------------------
# The bandwidth probe (K14), the tiled megakernel (K6) at llama3-8b, F1
# ---------------------------------------------------------------------------

PROBE_BYTES = 4 << 30  # the probe's short stream; the long one is twice it
LLAMA = "llama3-8b"    # the tiled slice's model: full width and depth


def bandwidth_phase(dev, seed):
    """K14: every configuration of the probe held against its plain version
    (o within TOL["dma_bench"], the checksum of every word equal) and timed
    by the two-length marginal over 4 and 8 GB of seeded data (well past
    L2), for several depths, slice sizes, chunk sizes and blocks an SM,
    beside a ``torch.Tensor.copy_`` of 4 GB. The highest rate measured, the
    best stream's or the copy's (counting its reads and writes), becomes
    the rate that bound() divides bytes by for every row. Returns the K14
    rows."""
    global HBM_BYTES_PER_S
    from mlio_tpu_torch.utils import dma_bench as db

    gen = torch.Generator(device=dev).manual_seed(seed)
    buf = torch.empty(PROBE_BYTES, dtype=torch.bfloat16, device=dev)  # 8 GB: both lengths
    for part in buf.split(1 << 28):
        part.normal_(generator=gen)
    x = torch.full((1,), 0.5, dtype=torch.float32, device=dev)
    db.auto_stream.launches = db.manual_stream.launches = 0
    atol, rtol = TOL["dma_bench"]
    res = db.probe(dev, total_bytes=PROBE_BYTES, buf=buf, atol=atol, rtol=rtol)
    launches = dict(auto=db.auto_stream.launches, manual=db.manual_stream.launches)
    streams = {k: v for k, v in res.items() if k != "copy"}
    best = max(streams, key=lambda k: streams[k]["gb_per_s"])
    HBM_BYTES_PER_S, rate_from = db.best_rate(res)
    emit(dict(phase="bandwidth", streams=res, best_stream=best, rate_from=rate_from,
              measured_bytes_per_s=HBM_BYTES_PER_S, spec_sheet_bytes_per_s=SPEC_BYTES_PER_S,
              measured_over_spec_sheet=HBM_BYTES_PER_S / SPEC_BYTES_PER_S, launches=launches))
    rows = []
    for kind, plain in (("auto", db.auto_stream_plain), ("manual", db.manual_stream_plain)):
        name = max((k for k in streams if streams[k]["kind"] == kind),
                   key=lambda k: streams[k]["gb_per_s"])
        r = streams[name]
        C = db.chunk_cols(r["chunk_mb"])
        n = PROBE_BYTES // (db.ROWS * C * 2)
        wv = buf[: n * db.ROWS * C].view(n, db.ROWS, C)
        b_ms, b_by = bound(r["bytes_short"], 0, BF16_TENSOR_FLOPS)
        rows.append(dict(
            name=f"dma_bench_{kind}", route="cuda", source="mlio_tpu_torch/csrc/dma_bench.cu",
            replaces="dma_bench.py:113" if kind == "auto" else "dma_bench.py:151",
            shape=f"w [{n},{db.ROWS},{C}] bf16 ({r['bytes_short']} bytes), best config {name}",
            max_abs_err=max(r["max_abs_err"].values()), checksum_equal=r["checksum_equal"],
            atol=atol, rtol=rtol, ms=r["ms_short"], kernel_ms=r["ms_short"],
            gb_per_s=r["gb_per_s"], plain_ms=time_ms(lambda i: plain(wv, x), 5)[0],
            library_ms=res["copy"]["ms"],
            library_note="torch.Tensor.copy_ of the same 4 GB (reads and writes them)",
            bound_ms=b_ms, bound_by=b_by, launches=launches[kind]))
    del buf
    torch.cuda.empty_cache()
    return rows


def tiled_check(dt, spec, blocks, x, kc, vc, pos, cos, sin, scales=None,
                x_name="decode_layer_tiled"):
    """K6 from (x, kc, vc) against its plain version: x_out (under
    ``x_name``'s tolerance) and the slot written at every layer
    (slot_checks). Returns (plain x_out, its caches (and scales), errors)."""
    ksk = psk = {}
    if scales is not None:
        ksk = dict(k_scales=scales[0].clone(), v_scales=scales[1].clone())
        psk = dict(k_scales=scales[0].clone(), v_scales=scales[1].clone())
    kk, kv = kc.clone(), vc.clone()
    xk = dt.decode_layer_tiled(x, blocks, kk, kv, pos, cos, sin, spec=spec, **ksk)
    torch.cuda.synchronize()
    pk, pv = kc.clone(), vc.clone()
    xp = dt.decode_layer_tiled_plain(x, blocks, pk, pv, pos, cos, sin, spec=spec, **psk)
    errs = dict(x_out=check_close(x_name, xk, xp))
    errs.update(slot_checks("decode_layer_tiled", slice(pos, pos + 1), (kk, kv), (pk, pv),
                            (kc, vc), scales, ksk, psk))
    del kk, kv
    return xp, (pk, pv, psk), errs


def tiled_must_fail(dt, spec, blocks, x, kc, vc, at, pos, cos, sin, plain, what, scales=None):
    """K6 run wrongly (at slot ``at``, or over other ``scales``) has to fail
    the check against the plain run at ``pos`` (``plain``: its x_out and
    caches): x_out (the deep tolerance), or the slot written at layer 0
    (values within K6's tolerance, ints within one step). Returns the two
    max-abs errors."""
    name = "decode_layer_tiled"
    sk = {} if scales is None else dict(k_scales=scales[0].clone(), v_scales=scales[1].clone())
    kk, kv = kc.clone(), vc.clone()
    xk = dt.decode_layer_tiled(x, blocks, kk, kv, at, cos, sin, spec=spec, **sk)
    x_ok, x_err = within("decode_layer_tiled_deep", xk, plain[0])
    got = kk[0, :, pos].float()
    want = plain[1][0][0, :, pos].float()
    if scales is None:
        s_ok, s_err = within(name, got, want)
    else:
        s_err = (got - want).abs().max().item()
        s_ok = s_err <= 1
    del kk, kv
    if x_ok and s_ok:
        raise AssertionError(f"{name}: the check passes {what} (x_out {x_err}, layer 0's "
                             f"slot {s_err})")
    return dict(x_out=x_err, layer0_slot=s_err)


def without_head_group(spec, blocks, vc, groups: int = 1):
    """(blocks, V cache) whose first ``groups`` KV heads give V = 0 at every
    layer, in the cache and for the current token (their Wv columns and
    bias zeroed): the attention output of those heads' query groups is 0."""
    from mlio_tpu_torch.ops.quant import QTensor

    cols = slice(0, groups * spec.head_size)
    out = dict(blocks)
    wv = blocks["wv"]
    if isinstance(wv, QTensor):
        q = wv.q.clone()
        q[:, :, cols] = 0
        out["wv"] = wv._replace(q=q)
    else:
        out["wv"] = wv.clone()
        out["wv"][:, :, cols] = 0
    if blocks.get("bv") is not None:
        out["bv"] = blocks["bv"].clone()
        out["bv"][:, cols] = 0
    v0 = vc.clone()
    v0[:, :, :, :groups] = 0
    return out, v0


def tiled_x_must_fail(dt, spec, blocks, x, kc, vc, pos, cos, sin, plain, scales=None):
    """K6 with the attention output of one KV head's query group zeroed in
    every layer (without_head_group) has to fail the deep x_out check
    against the plain run (``plain``: its x_out). Returns its max-abs."""
    sk = {} if scales is None else dict(k_scales=scales[0].clone(), v_scales=scales[1].clone())
    blocks0, v0 = without_head_group(spec, blocks, vc)
    kk = kc.clone()
    xk = dt.decode_layer_tiled(x, blocks0, kk, v0, pos, cos, sin, spec=spec, **sk)
    err = must_fail_within("decode_layer_tiled_deep", "one head group's attention left out",
                           xk, plain)
    del kk, v0, blocks0
    return err


def tiled_phase_us(dt, spec, stamps):
    """K6's phases (us), averaged over the layers, from its phase probe."""
    us = (stamps[1:] - stamps[:-1]).double().cpu() / 1e3
    per = us[1:].reshape(spec.num_layers, len(dt.PHASES)).mean(0).tolist()
    return dict(start=us[0].item(), **dict(zip(dt.PHASES, per)),
                launch_total=(stamps[-1] - stamps[0]).item() / 1e3)


def tiled_row(dt, dl, dev, seed, spec, weights):
    """K6 at llama3-8b's full width and depth, B = 8, context 896 in a
    1024-slot cache: bf16 weights and cache, int8 weights and an INT8 cache,
    int8 weights alone, fp8 weights. Each is held against its plain version
    (K6's tolerance; an INT8 cache as slot_checks says) and must fail with a
    context one token short and, over an INT8 cache, with all-ones V scales;
    device ms beside the plain version's, the bound, K4's device ms at the
    same shapes (without its epilogue; not for fp8, which K4 does not take)
    and the phase durations. ``weights`` maps bf16/int8/fp8 to the params."""
    from mlio_tpu_torch.models import rope_cos_sin
    from mlio_tpu_torch.ops.quant import quantize_kv

    name = "decode_layer_tiled"
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    pos = DECODE_CTX - 1
    shape = (spec.num_layers, B, CACHE, spec.num_kv_heads, spec.head_size)
    kc = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    vc = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    x = torch.randn((B, spec.hidden_size), generator=gen, device=dev).to(torch.bfloat16)
    cos, sin = rope_cos_sin(torch.arange(pos, pos + 1, device=dev), spec.rope_dim,
                            spec.rope_theta)
    (kq, ks), (vq, vs) = quantize_kv(kc.float()), quantize_kv(vc.float())
    out = {}
    for variant, wname, kv8 in (("bf16", "bf16", False), ("w8kv8", "int8", True),
                                ("w8", "int8", False), ("fp8", "fp8", False)):
        blocks = weights[wname]["blocks"]
        caches = (kq, vq) if kv8 else (kc, vc)
        scales = (ks, vs) if kv8 else None
        x_plain, pcaches, errs = tiled_check(dt, spec, blocks, x, *caches, pos, cos, sin, scales,
                                             x_name="decode_layer_tiled_deep")
        plain = (x_plain, pcaches)
        row = dict(errors=errs, max_abs_err=errs["x_out"], ctx_minus_1_max_abs_err=(
            tiled_must_fail(dt, spec, blocks, x, *caches, pos - 1, pos, cos, sin, plain,
                            "a context one token short", scales)),
            head_group_out_max_abs_err=tiled_x_must_fail(dt, spec, blocks, x, *caches, pos, cos,
                                                         sin, x_plain, scales))
        if kv8:
            row["ones_v_scale_max_abs_err"] = tiled_must_fail(
                dt, spec, blocks, x, *caches, pos, pos, cos, sin, plain, "with all-ones V scales",
                (ks, torch.ones_like(vs)))
        del plain, pcaches
        sk = dict(k_scales=ks.clone(), v_scales=vs.clone()) if kv8 else {}
        tk, tv = caches[0].clone(), caches[1].clone()
        b_ms, b_by = stack_bound(spec, weights[wname], B, B * DECODE_CTX, kv8=kv8, head=False)
        row.update(
            shape=f"{spec.name} ({spec.num_layers} layers) bf16 activations, {wname} weights, "
                  f"{'INT8' if kv8 else 'bf16'} cache [{spec.num_layers},{B},{CACHE},"
                  f"{spec.num_kv_heads},{spec.head_size}], ctx {DECODE_CTX}, no head",
            tiling=list(dt.choose_tiling(spec, B)),
            **timings(lambda i: dt.decode_layer_tiled(x, blocks, tk, tv, pos, cos, sin,
                                                      spec=spec, **sk),
                      lambda i: dt.decode_layer_tiled_plain(x, blocks, tk, tv, pos, cos, sin,
                                                            spec=spec, **sk), None, 10),
            bound_ms=b_ms, bound_by=b_by)
        row["k4_ms"] = None if wname == "fp8" else time_ms(
            lambda i: dl.decode_layer_stack(x, blocks, tk, tv, pos, cos, sin, spec=spec, **sk),
            10)[0]
        stamps = torch.zeros(dt.phase_stamps(spec), dtype=torch.int64, device=dev)
        dt.decode_layer_tiled(x, blocks, tk, tv, pos, cos, sin, spec=spec, phase_times=stamps,
                              **sk)
        row["phase_us"] = tiled_phase_us(dt, spec, stamps)
        out[variant] = row
        del tk, tv
    bf = out.pop("bf16")
    return dict(
        name=name, route="cuda", source="mlio_tpu_torch/csrc/decode_tiled.cuh",
        replaces="mlio_tpu/ops/decode_tiled.py:362", atol=TOL[name][0], rtol=TOL[name][1],
        x_out_row_tol=ROW_TOL["decode_layer_tiled_deep"],
        library_note="no single PyTorch call computes a decode step; K4 at the same shapes "
        "is k4_ms", **bf, variants=out)


def tiled_variants(dev, seed, dt):
    """K6's other instances against its plain version at small, ragged
    shapes (norm scales and biases from the seed): groups 1, 2, 4, 7, head
    dims 64 and 128, an intermediate width that leaves the last chunk
    masked, batches 1, 3, 16 and 32, GPT-2's LayerNorm, biases and learned
    positions; bf16, int8 weights with an INT8 cache, fp8 weights."""
    from mlio_tpu_torch.models import get_spec, init_params, rope_cos_sin
    from mlio_tpu_torch.ops.quant import quantize_kv
    from mlio_tpu_torch.runtime import quantize_params

    gpt2, llama = get_spec("gpt2"), get_spec("llama-tiny")
    small = dict(num_layers=2, vocab_size=1000)
    cases = {  # name: (spec, batch, cache slots, pos)
        "g4_d128_b3": (dataclasses.replace(
            llama, name="t-g4", hidden_size=1024, num_heads=8, num_kv_heads=2,
            intermediate_size=1040, **small), 3, 256, 200),
        "g7_d64_b5": (dataclasses.replace(
            llama, name="t-g7", hidden_size=448, num_heads=7, num_kv_heads=1,
            intermediate_size=1200, **small), 5, 128, 127),
        "g2_d64_geglu_b16": (dataclasses.replace(
            llama, name="t-g2", hidden_size=512, num_heads=8, num_kv_heads=4,
            intermediate_size=784, activation="geglu", **small), 16, 128, 77),
        "g1_rope_partial_b32": (dataclasses.replace(
            gpt2, name="t-rope", hidden_size=256, num_heads=4, num_kv_heads=4,
            intermediate_size=528, positional="rope", rope_fraction=0.5, activation="gelu",
            **small), 32, 128, 99),
        "gpt2_ln_bias_learned_b1": (dataclasses.replace(gpt2, name="t-gpt2", **small), 1, 128, 0),
    }
    errs = {}
    for name, (spec, batch, smax, pos) in cases.items():
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = init_params(spec, gen, dtype=torch.bfloat16, device=dev)
        for key, vec in params["blocks"].items():
            if vec is not None and ("bias" in key or key.startswith("b") or "scale" in key):
                noise = 0.1 * torch.randn(vec.shape, generator=gen, device=dev)
                vec.copy_((noise + (1 if "scale" in key else 0)).to(vec.dtype))
        shape = (spec.num_layers, batch, smax, spec.num_kv_heads, spec.head_size)
        kc = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        vc = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        x = torch.randn((batch, spec.hidden_size), generator=gen, device=dev).to(torch.bfloat16)
        cos = sin = None
        if spec.positional != "learned":
            cos, sin = rope_cos_sin(torch.arange(pos, pos + 1, device=dev), spec.rope_dim,
                                    spec.rope_theta)
        errs[f"decode_layer_tiled[{name}]"] = tiled_check(
            dt, spec, params["blocks"], x, kc, vc, pos, cos, sin)[2]
        (kq, ks), (vq, vs) = quantize_kv(kc.float()), quantize_kv(vc.float())
        errs[f"decode_layer_tiled_int8[{name}]"] = tiled_check(
            dt, spec, quantize_params(params, spec, "int8")["blocks"], x, kq, vq, pos, cos, sin,
            (ks, vs))[2]
        errs[f"decode_layer_tiled_fp8[{name}]"] = tiled_check(
            dt, spec, quantize_params(params, spec, "fp8")["blocks"], x, kc, vc, pos, cos,
            sin)[2]
    return errs


def llama_weights(dev, seed):
    """llama3-8b at full width and depth (32 layers), random bf16 weights
    from the seed, and its int8 and fp8 quantizations: (spec, {bf16, int8,
    fp8: params})."""
    from mlio_tpu_torch.models import get_spec, init_params
    from mlio_tpu_torch.runtime import quantize_params

    spec = get_spec(LLAMA)
    params = init_params(spec, torch.Generator(device=dev).manual_seed(seed),
                         dtype=torch.bfloat16, device=dev)
    return spec, dict(bf16=params, int8=quantize_params(params, spec, "int8"),
                      fp8=quantize_params(params, spec, "fp8"))


def route_launches(route, L, steps, int8, projections=7, quant_head=False):
    """The launch counts of a 64-token generate of llama3-8b (untied head)
    on ``route``: prefill K1 (K9 over an INT8 cache) and K2 a layer pair and
    the final norm, K5 in every projection with int8 weights; the decode one
    K6 a token with K2 for the head's norm, or one K4 (epilogue) a token.
    ``projections``: the K5 projections a layer (Mixtral's 4: its experts
    run in plain products in prefill); ``quant_head``: an int8 head, K5
    once in prefill and once a K6 step."""
    want = dict(flash_attention=0 if int8 else L, flash_attention_kvq=L if int8 else 0,
                fused_norm=2 * L + 1, quant_matmul=projections * L if int8 else 0,
                decode_attention=0, decode_layer_stack=0, decode_layer_tiled=0)
    if quant_head:
        want["quant_matmul"] += 1 + (steps if route == "tiled" else 0)
    if route == "tiled":
        want["decode_layer_tiled"] = steps
        want["fused_norm"] += steps
    elif route == "mega":
        want["decode_layer_stack"] = steps
    return want


def fp32_prefill(spec, params, ids, impl, quant, dev):
    """The prefill logits of ``params`` with every floating tensor in fp32
    (int8 payloads and their scales as they are) over an fp32 cache (INT8
    with ``quant``): the fp32 path the kernels' bf16 logits are held
    against. Call it under plain_kernels."""
    from mlio_tpu_torch.models import forward
    from mlio_tpu_torch.runtime import init_cache

    def up(v):
        if isinstance(v, dict):
            return {k: up(t) for k, t in v.items()}
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            return v.float()
        return v

    p32 = up(params)
    cache = init_cache(spec, B, CACHE, dtype=torch.float32, quant=quant, device=dev)
    with torch.inference_mode():
        logits = forward(p32, spec, ids, impl=impl, cache=cache)[0]
    del p32, cache
    torch.cuda.empty_cache()
    return logits


def logit_errors(got, want) -> dict:
    """Max-abs and RMS of got - want (fp32, a batch row at a time), and the
    values past LOGITS_ATOL."""
    mx, sq, over = 0.0, 0.0, 0
    for g, w in zip(got, want):
        d = (g.float() - w.float()).abs()
        mx = max(mx, d.max().item())
        sq += d.square().sum().item()
        over += int((d > LOGITS_ATOL).sum())
    return dict(max_abs=mx, rms=(sq / got.numel()) ** 0.5, over_logits_atol=over,
                values=got.numel())


def generate_8b_phase(dev, seed, spec, weights, wrappers, fa, norms, da, qm, dt, dl):
    """The slice's path: llama3-8b at full width and depth, random weights
    from the seed, batch 8, a 704-token prompt, a 1024-slot cache, greedy,
    Impl(attention="flash", norm="fused"); bf16 weights, then the README quick
    start (int8 weights, cache_quant="int8"). For each: the prefill logits
    held against an fp32 path, no farther from it than the bf16 plain
    path's (LOGITS_8B_OVER_PLAIN); for decode_stack
    "auto", "tiled" and
    "mega", the launch counters around a 64-token generate, the decode step
    by the two-length marginal (64 against 320 new tokens), tok/s, a step's
    device ms and the idle share. "auto" must take the route decode_route
    picks. Returns the launch counts by weights and route."""
    from mlio_tpu_torch.models import Impl, forward
    from mlio_tpu_torch.models.transformer import decode_route
    from mlio_tpu_torch.runtime import generate, init_cache

    L = spec.num_layers
    ids = torch.from_numpy(np.random.default_rng(seed).integers(
        0, spec.vocab_size, (B, PROMPT))).to(dev)
    base = Impl(attention="flash", norm="fused")
    out_counts = {}
    for wname, quant in (("bf16", None), ("int8", "int8")):
        params = weights[wname]

        def prefill(impl=base):
            cache = init_cache(spec, B, CACHE, dtype=torch.bfloat16, quant=quant, device=dev)
            with torch.inference_mode():
                return forward(params, spec, ids, impl=impl, cache=cache)

        logits = prefill()[0]
        with plain_kernels(fa, norms, da, qm):
            logits_plain = prefill()[0]
        if logits.shape != (B, PROMPT, spec.vocab_size) or not torch.isfinite(logits).all():
            raise AssertionError(f"generate_8b: prefill logits shape {tuple(logits.shape)} or "
                                 "not finite")
        with plain_kernels(fa, norms, da, qm):
            logits_ref = fp32_prefill(spec, params, ids, base, quant, dev)
        errs = dict(kernels_vs_fp32=logit_errors(logits, logits_ref),
                    plain_vs_fp32=logit_errors(logits_plain, logits_ref),
                    kernels_vs_plain=logit_errors(logits, logits_plain))
        del logits, logits_plain, logits_ref
        for stat in ("max_abs", "rms"):
            if not (errs["kernels_vs_fp32"][stat]
                    <= LOGITS_8B_OVER_PLAIN * errs["plain_vs_fp32"][stat]):
                raise AssertionError(f"generate_8b {wname}: the kernels' prefill logits lie "
                                     f"farther from the fp32 path ({stat}) than the bf16 plain "
                                     f"path's: {errs}")
        logits_err = errs["kernels_vs_plain"]["max_abs"]
        picked = decode_route(spec, base, params["blocks"], B, cache_quant=quant is not None,
                              smax=CACHE)
        result = dict(phase="generate_8b", model=spec.name, layers=L, weights=wname,
                      cache_quant=quant, batch=B, prompt=PROMPT, cache_len=CACHE,
                      prefill_logits_max_abs_err=logits_err, prefill_logits=errs,
                      logits_over_plain=LOGITS_8B_OVER_PLAIN,
                      auto_route=picked, routes={})
        for stack in ("auto", "tiled", "mega"):
            impl = dataclasses.replace(base, decode_stack=stack)
            route = picked if stack == "auto" else stack

            def run(new_tokens):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = generate(params, spec, ids, max_new_tokens=new_tokens, impl=impl,
                               cache_len=CACHE, cache_quant=quant, device=dev)
                torch.cuda.synchronize()
                return out, time.perf_counter() - t0

            run(4)  # warm-up
            for w in wrappers:
                w.launches = 0
            out, t_short = run(SHORT)
            launches = {w.__name__: w.launches for w in wrappers}
            want = route_launches(route, L, SHORT - 1, quant is not None)
            want = {k: want.get(k, 0) for k in launches}
            if launches != want:
                raise AssertionError(f"generate_8b {wname} {stack}: launch counts {launches} "
                                     f"!= expected {want}")
            if out.shape != (B, PROMPT + SHORT) or not torch.equal(out[:, :PROMPT], ids) \
                    or int(out.min()) < 0 or int(out.max()) >= spec.vocab_size:
                raise AssertionError(f"generate_8b {wname} {stack}: wrong shape, prompt "
                                     "changed or token out of range")
            _, t_long = run(LONG)
            step_s = (t_long - t_short) / (LONG - SHORT)
            cache = prefill(impl)[1]
            tok = out[:, PROMPT:PROMPT + 1]
            with torch.inference_mode():
                if route == "mega":  # K4 with the untied head's epilogue, a launch a token
                    kw = dict(spec=spec, head_norm=(params["final_scale"], params["final_bias"]),
                              lm_head=params["lm_head"], lm_vmajor=False,
                              k_scales=cache.get("k_scale"), v_scales=cache.get("v_scale"))
                    from mlio_tpu_torch.models import rope_cos_sin
                    cs, sn = rope_cos_sin(torch.arange(PROMPT, PROMPT + 1, device=dev),
                                          spec.rope_dim, spec.rope_theta)
                    x = params["tok_embed"][tok[:, 0]]
                    step_dev_ms = time_ms(lambda i: dl.decode_layer_stack(
                        x, params["blocks"], cache["k"], cache["v"], PROMPT, cs, sn, **kw),
                        3)[0]
                else:  # one forward (rewriting the same cache slot each call)
                    step_dev_ms = time_ms(lambda i: forward(params, spec, tok, impl=impl,
                                                            cache=dict(cache)), 3)[0]
            del cache
            result["routes"][stack] = dict(
                route=route, launches=launches, generate_s={str(SHORT): t_short, str(LONG): t_long},
                decode_step_ms=step_s * 1e3, decode_tok_per_s=B / step_s,
                decode_step_device_ms=step_dev_ms,
                decode_idle_share=1 - step_dev_ms / (step_s * 1e3))
            out_counts[(wname, stack)] = launches
        r = result["routes"]
        result["rule"] = dict(
            picked=picked, tiled_step_ms=r["tiled"]["decode_step_ms"],
            mega_step_ms=r["mega"]["decode_step_ms"],
            faster=("tiled" if r["tiled"]["decode_step_ms"] < r["mega"]["decode_step_ms"]
                    else "mega"),
            layer_weight_bytes=dt.layer_weight_bytes(spec, 2 if wname == "bf16" else 1),
            mega_max_layer_bytes=dt.MEGA_MAX_LAYER_BYTES)
        emit(result)
    return out_counts


MIXTRAL = "mixtral-8x7b"  # the MoE slice's model: full width and depth
MOE_SMALL_LAYERS = 4      # the variants' depth: a 32-layer bf16 Mixtral (93 GB) does not fit
DECODE_CHECK_STEPS = 3    # generate_moe's decode steps held against the plain route


def widen_phase(dev, seed):
    """K15 (``utils/fp8_convert.py``): each of the four widenings over a
    seeded 1 GB slab (256 chunks of 2048 x 2048 int8 or e4m3 bytes, x bf16
    [8, 2048]) held against its plain version (fp8_convert's ATOL, RTOL,
    entered in TOL here), failing
    over 255 of the 256 chunks and over the slab with one chunk's bytes
    changed; then timed by the two-length marginal (2 and 6 passes) with the
    launch counter zeroed just before, beside the plain version, the bound
    (the bytes over K14's rate, the FMAs over CUDA-core fp32's peak) and the
    ratio to K14's rate. Returns K15's row (int8, the Mixtral path's
    weights; the fp8 widenings as its variants)."""
    from mlio_tpu_torch.utils import fp8_convert as fc

    name = "widen_matmul"
    TOL[name] = atol, rtol = fc.ATOL, fc.RTOL
    gen = torch.Generator(device=dev).manual_seed(seed + 15)
    x = torch.randn((fc.ROWS, fc.R), generator=gen, device=dev).to(torch.bfloat16)
    slabs, rows = {}, {}
    for v in fc.VARIANTS:
        kind = fc.storage_dtype(v)
        if kind not in slabs:
            slabs[kind] = fc.draw_weights(v, fc.N_CHUNKS, fc.R, fc.C, gen)
        w = slabs[kind]
        _, want, err = fc.check(x, w, v, atol, rtol)
        missing = must_fail_within(name, f"{v} over 255 of the 256 chunks",
                                   fc.widen_matmul(x, w[:-1], v), want)
        j = fc.N_CHUNKS // 2
        saved = w[j].clone()
        w[j] = fc.draw_weights(v, 1, fc.R, fc.C, gen)[0]
        changed = must_fail_within(name, f"{v} with chunk {j}'s bytes changed",
                                   fc.widen_matmul(x, w, v), want)
        w[j] = saved
        fc.widen_matmul.launches = 0
        ms = fc.marginal_ms(lambda: fc.widen_matmul(x, w, v))
        launches = fc.widen_matmul.launches
        nbytes = w.numel() * w.element_size() + x.numel() * 2 + fc.ROWS * fc.C * 4
        fmas = fc.ROWS * w.numel()
        b_ms, b_by = bound(nbytes, 2 * fmas, FP32_FLOPS)
        gbs = w.numel() / (ms * 1e-3) / 1e9
        rows[v] = dict(
            shape=f"x [{fc.ROWS},{fc.R}] bf16 @ {fc.N_CHUNKS} chunks [{fc.R},{fc.C}] "
                  f"{'int8' if v == 'int8' else 'e4m3'} ({w.numel()} bytes), fp32 out",
            max_abs_err=err, missing_chunk_max_abs_err=missing,
            changed_chunk_max_abs_err=changed, ms=ms, kernel_ms=ms, gb_per_s=gbs,
            over_k14_rate=gbs * 1e9 / HBM_BYTES_PER_S, launches=launches,
            plain_ms=time_ms(lambda i: fc.widen_matmul_plain(x, w, v), 3)[0],
            bound_ms=b_ms, bound_by=b_by, bound_bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
            bound_fmas_ms=2 * fmas / FP32_FLOPS * 1e3, library_ms=None)
        if not launches:
            raise AssertionError(f"widen {v}: no launch in the timed run")
    del slabs, w
    torch.cuda.empty_cache()
    emit(dict(phase="widen", rate_bytes_per_s=HBM_BYTES_PER_S, atol=atol, rtol=rtol,
              variants=rows))
    main_row = rows.pop("int8")
    return dict(name=name, route="cuda", source="mlio_tpu_torch/csrc/fp8_convert.cu",
                replaces="exp_fp8_convert.py:46", atol=atol, rtol=rtol,
                library_note="no single PyTorch call widens int8 or e4m3 weights and "
                "multiplies", **main_row, variants=rows)


def route_errors(probs, pprobs, picks, k) -> dict:
    """A run's routing (softmax ``probs`` [L, T, E], picks ``picks``, a
    [L, T, E] mask) against another run's softmax ``pprobs`` that followed
    those picks: the softmaxes' max-abs difference, how far the picks lie
    below the other softmax's k-th largest (a pick differs only where two
    experts nearly tie), and how many (layer, row) picks differ from the
    other run's own top-k."""
    from mlio_tpu_torch.ops.moe import topk_mask

    kth = pprobs.topk(k, dim=-1).values[..., -1:]
    short = (kth - pprobs).masked_fill(~picks, float("-inf")).amax().item()
    return dict(router_probs_max_abs_err=(probs - pprobs).abs().max().item(),
                pick_shortfall=max(short, 0.0),
                picks_differing=int((topk_mask(pprobs, k) != picks).any(-1).sum()),
                row_layers=picks.shape[0] * picks.shape[1])


def route_check(probs, pprobs, picks, k):
    """K6's routing against the plain run that followed its picks
    (route_errors), each within ROUTE_TOL; raises otherwise."""
    errs = route_errors(probs, pprobs, picks, k)
    if not max(errs["router_probs_max_abs_err"], errs["pick_shortfall"]) <= ROUTE_TOL:
        raise AssertionError(f"decode_layer_tiled (MoE): routing off the plain run's by more "
                             f"than {ROUTE_TOL}: {errs}")
    return errs


@contextlib.contextmanager
def following_routes(moe_ops, picks=None):
    """``ops.moe.router_topk`` recording each call's (softmax, expert
    indices), one call a layer in order, into the list it yields. Given
    ``picks`` (an earlier run's indices, [L, T, k]), each call takes its
    layer's experts from there instead of its own top-k, weighted by its
    own softmax renormalized over them, as K6's plain version follows
    ``experts=``."""
    real = moe_ops.router_topk
    calls = []

    def route(x, w_router, top_k):
        weights, idx, probs = real(x, w_router, top_k)
        if picks is not None:
            idx = picks[len(calls)]
            weights = probs.gather(-1, idx.long())
            weights = weights / weights.sum(-1, keepdim=True)
        calls.append((probs, idx))
        return weights, idx, probs

    with patched(moe_ops, "router_topk", route):
        yield calls


def moe_check(dt, spec, blocks, x, kc, vc, pos, cos, sin, scales=None,
              x_name="decode_layer_tiled"):
    """K6's MoE phases from (x, kc, vc) against the plain version that
    follows the kernel's expert picks (read from its router softmax by the
    same top-k rule): the routing (route_check), x_out and the slot written
    at every layer (slot_checks) under ``x_name``'s tolerance. Returns
    (plain x_out, its caches (and scales), the errors, the picks)."""
    from mlio_tpu_torch.ops.moe import topk_mask

    L, E, k = spec.num_layers, spec.num_experts, spec.num_experts_per_tok
    ksk = psk = {}
    if scales is not None:
        ksk = dict(k_scales=scales[0].clone(), v_scales=scales[1].clone())
        psk = dict(k_scales=scales[0].clone(), v_scales=scales[1].clone())
    probs = torch.zeros((L, x.shape[0], E), dtype=torch.float32, device=x.device)
    kk, kv = kc.clone(), vc.clone()
    xk = dt.decode_layer_tiled(x, blocks, kk, kv, pos, cos, sin, spec=spec, router_probs=probs,
                               **ksk)
    torch.cuda.synchronize()
    picks = topk_mask(probs, k)
    pprobs = torch.zeros_like(probs)
    pk, pv = kc.clone(), vc.clone()
    xp = dt.decode_layer_tiled_plain(x, blocks, pk, pv, pos, cos, sin, spec=spec,
                                     router_probs=pprobs, experts=picks, **psk)
    errs = route_check(probs, pprobs, picks, k)
    errs["x_out"] = check_close(x_name, xk, xp)
    errs.update(slot_checks(x_name, slice(pos, pos + 1), (kk, kv), (pk, pv), (kc, vc), scales,
                            ksk, psk))
    del kk, kv
    return xp, (pk, pv, psk), errs, picks


def moe_bound(spec, params, batch, slots, picks=None, kv8=False, head=False):
    """(bound ms, bound_by) of a Mixtral decode step (``head``: with the
    final norm and the lm_head): every non-expert weight (payloads and
    scales), norm and router read once; of the experts, those some row picks
    at each layer (``picks`` [L, B, E]; None: all of them, as the kernel
    streams them); the K/V of ``slots`` cache slots of every layer; x and
    x_out. Operations: each row's products with the attention weights, the
    router and its top-k experts."""
    from mlio_tpu_torch.ops.quant import QTensor

    def nbytes_of(v):
        ts = (v.q, v.scale) if isinstance(v, QTensor) else (v,)
        return sum(t.numel() * t.element_size() for t in ts)

    b = params["blocks"]
    H, I, L, E, k = (spec.hidden_size, spec.intermediate_size, spec.num_layers,
                     spec.num_experts, spec.num_experts_per_tok)
    experts = ("moe_up", "moe_gate", "moe_down")
    nbytes = sum(nbytes_of(v) for n, v in b.items() if v is not None and n not in experts)
    per_expert = sum(nbytes_of(b[n]) for n in experts if b[n] is not None) / (L * E)
    used = L * E if picks is None else int(picks.any(1).sum())
    nbytes += used * per_expert
    if head:
        nbytes += nbytes_of(params["lm_head"]) + params["final_scale"].numel() * 2
    kv_row = spec.kv_dim + 4 * spec.num_kv_heads if kv8 else spec.kv_dim * 2
    nbytes += 2 * L * slots * kv_row + 2 * batch * H * 2
    attn_mats = H * (spec.q_dim + 2 * spec.kv_dim) + spec.q_dim * H + H * E
    flops = (2 * batch * L * (attn_mats + k * 3 * H * I)
             + 4 * spec.num_heads * spec.head_size * slots * L
             + (2 * batch * spec.vocab_size * H if head else 0))
    return bound(nbytes, flops, BF16_TENSOR_FLOPS) + (used,)


def moe_small_variants(dt, dev, seed, spec):
    """K6's MoE instances at Mixtral's widths and MOE_SMALL_LAYERS layers,
    random weights from the seed: bf16 and fp8 weights over a bf16 cache,
    int8 weights over an INT8 cache, at B 1 (most experts unpicked by every
    row), 8 and 32 (the 32 x 2 tier), ctx DECODE_CTX in a CACHE-slot cache;
    each against the plain version (moe_check, K6's tolerance), with its
    device ms."""
    from mlio_tpu_torch.models import init_params, rope_cos_sin
    from mlio_tpu_torch.ops.quant import quantize_kv
    from mlio_tpu_torch.runtime import quantize_params

    spec4 = dataclasses.replace(spec, num_layers=MOE_SMALL_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    bf = init_params(spec4, gen, dtype=torch.bfloat16, device=dev)
    pos = DECODE_CTX - 1
    cos, sin = rope_cos_sin(torch.arange(pos, pos + 1, device=dev), spec.rope_dim,
                            spec.rope_theta)
    out = {}
    for wname in ("bf16", "fp8", "int8"):
        params = bf if wname == "bf16" else quantize_params(bf, spec4, wname)
        for batch in (1, 8, 32):
            shape = (spec4.num_layers, batch, CACHE, spec.num_kv_heads, spec.head_size)
            kc = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
            vc = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
            x = torch.randn((batch, spec.hidden_size), generator=gen,
                            device=dev).to(torch.bfloat16)
            scales = None
            if wname == "int8":  # the quick start's pairing: an INT8 cache
                (kc, ks), (vc, vs) = quantize_kv(kc.float()), quantize_kv(vc.float())
                scales = (ks, vs)
            _, _, errs, picks = moe_check(dt, spec4, params["blocks"], x, kc, vc, pos, cos, sin,
                                          scales)
            sk = {} if scales is None else dict(k_scales=scales[0].clone(),
                                                v_scales=scales[1].clone())
            tk, tv = kc.clone(), vc.clone()
            ms = time_ms(lambda i: dt.decode_layer_tiled(x, params["blocks"], tk, tv, pos, cos,
                                                         sin, spec=spec4, **sk), 5)[0]
            out[f"{wname}{'_kv8' if scales else ''}_b{batch}"] = dict(
                errors=errs, max_abs_err=errs["x_out"], ms=ms,
                experts_used=int(picks.any(1).sum()), tiling=list(dt.choose_tiling(spec4, batch)))
            del kc, vc, tk, tv
        if wname != "bf16":
            del params
    del bf
    torch.cuda.empty_cache()
    return out


def mixtral_weights(dev, seed, spec):
    """Mixtral-8x7B with int8 weights drawn directly (init_quantized_params,
    quantized head) on the card: (params, the build's bytes). The build must
    not hold a bf16 copy: its peak allocation may pass the tree's bytes by
    at most one layer's int8 experts."""
    from mlio_tpu_torch.runtime import quantized_size_bytes
    from mlio_tpu_torch.runtime.quantization import init_quantized_params

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_quantized_params(spec, torch.Generator(device=dev).manual_seed(seed), "int8",
                                   quantize_lm_head=True, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    tree = quantized_size_bytes(params)
    peak = torch.cuda.max_memory_allocated() - before
    layer_experts = 3 * spec.num_experts * spec.hidden_size * spec.intermediate_size
    build = dict(tree_bytes=tree, peak_allocated_bytes=peak, layer_int8_expert_bytes=layer_experts,
                 peak_over_tree_bytes=peak - tree, seconds=seconds)
    if peak > tree + layer_experts:
        raise AssertionError(f"mixtral build: peak {peak} bytes passes the int8 tree ({tree}) by "
                             f"more than one layer's int8 experts ({layer_experts}): a wider copy")
    return params, build


def tiled_moe_row(dt, dev, seed, spec, params, small):
    """K6's MoE phases at Mixtral's full width and depth (32 layers), int8
    weights (``params``) and an INT8 cache, B 8, ctx DECODE_CTX: against the
    plain version following its picks (moe_check; x_out under the 32-layer
    row tolerance), failing with each row's second expert dropped at every
    layer (top-1 routing: x_out alone must catch it) and with a context one
    token short; device ms beside the plain version's, the bound (the
    experts this run's rows pick; all experts beside it), the phase
    durations; two runs must give the same bits, and the plan's workspace
    bytes are printed. ``small``: the 4-layer variants. Returns K6's MoE
    row."""
    from mlio_tpu_torch.models import rope_cos_sin
    from mlio_tpu_torch.ops.quant import quantize_kv
    from mlio_tpu_torch.utils.dma_bench import event_ms

    gen = torch.Generator(device=dev).manual_seed(seed + 13)
    pos = DECODE_CTX - 1
    shape = (spec.num_layers, B, CACHE, spec.num_kv_heads, spec.head_size)
    (kq, ks), (vq, vs) = (quantize_kv(torch.randn(shape, generator=gen, device=dev))
                          for _ in range(2))
    x = torch.randn((B, spec.hidden_size), generator=gen, device=dev).to(torch.bfloat16)
    cos, sin = rope_cos_sin(torch.arange(pos, pos + 1, device=dev), spec.rope_dim,
                            spec.rope_theta)
    blocks = params["blocks"]
    x_plain, pcaches, errs, picks = moe_check(dt, spec, blocks, x, kq, vq, pos, cos, sin,
                                              (ks, vs), x_name="decode_layer_tiled_deep")
    plain = (x_plain, pcaches)
    again = [dt.decode_layer_tiled(x, blocks, kq.clone(), vq.clone(), pos, cos, sin, spec=spec,
                                   k_scales=ks.clone(), v_scales=vs.clone()) for _ in range(2)]
    if not torch.equal(*again):
        raise AssertionError("decode_layer_tiled (MoE): two runs give different bits")
    tiling = dt.choose_tiling(spec, B)
    workspace = dict(bytes=dt.decode_layer_tiled.workspace_bytes,
                     partials_bytes=tiling.km * B * spec.hidden_size * 4)
    del again
    top1 = dataclasses.replace(spec, num_experts_per_tok=1)
    sk = dict(k_scales=ks.clone(), v_scales=vs.clone())
    xt = dt.decode_layer_tiled(x, blocks, kq.clone(), vq.clone(), pos, cos, sin, spec=top1, **sk)
    top1_err = must_fail_within("decode_layer_tiled_deep",
                                "each row's second expert dropped at every layer", xt, x_plain)
    short = tiled_must_fail(dt, spec, blocks, x, kq, vq, pos - 1, pos, cos, sin, plain,
                            "a context one token short", (ks, vs))
    del plain, pcaches, xt
    tk, tv = kq.clone(), vq.clone()
    sk = dict(k_scales=ks.clone(), v_scales=vs.clone())
    ms, call_ms = time_ms(lambda i: dt.decode_layer_tiled(x, blocks, tk, tv, pos, cos, sin,
                                                          spec=spec, **sk), 10)
    # the plain version, launch-bound over its 32 x 8 x 128 (layer, expert,
    # chunk) phases, takes seconds a call: one call after one warm-up
    plain_ms = event_ms(lambda: dt.decode_layer_tiled_plain(x, blocks, tk, tv, pos, cos, sin,
                                                            spec=spec, experts=picks, **sk), 1)
    t = dict(ms=ms, kernel_ms=ms, call_ms=call_ms, plain_ms=plain_ms, library_ms=None)
    b_ms, b_by, used = moe_bound(spec, params, B, B * DECODE_CTX, picks, kv8=True)
    all_ms, _, _ = moe_bound(spec, params, B, B * DECODE_CTX, None, kv8=True)
    stamps = torch.zeros(dt.phase_stamps(spec), dtype=torch.int64, device=dev)
    dt.decode_layer_tiled(x, blocks, tk, tv, pos, cos, sin, spec=spec, phase_times=stamps, **sk)
    del tk, tv
    name = "decode_layer_tiled_moe"
    return dict(
        name=name, route="cuda", source="mlio_tpu_torch/csrc/decode_tiled.cuh",
        replaces="mlio_tpu/ops/decode_tiled.py:362",
        replaces_note="the MoE phases of _tiled_kernel (mlio_tpu/ops/decode_tiled.py:704-795)",
        shape=f"{spec.name} ({spec.num_layers} layers, {spec.num_experts} experts, top "
              f"{spec.num_experts_per_tok}) bf16 activations, int8 weights, INT8 cache "
              f"[{spec.num_layers},{B},{CACHE},{spec.num_kv_heads},{spec.head_size}], ctx "
              f"{DECODE_CTX}, no head",
        tiling=list(tiling), workspace=workspace, repeat_bitwise_equal=True,
        atol=TOL["decode_layer_tiled"][0],
        rtol=TOL["decode_layer_tiled"][1], x_out_row_tol=ROW_TOL["decode_layer_tiled_deep"],
        route_tol=ROUTE_TOL, errors=errs, max_abs_err=errs["x_out"],
        top1_max_abs_err=top1_err, ctx_minus_1_max_abs_err=short, **t, bound_ms=b_ms,
        bound_by=b_by, bound_experts_used=used, bound_ms_all_experts=all_ms,
        phase_us=tiled_phase_us(dt, spec, stamps),
        library_note="no single PyTorch call computes a decode step", variants=small)


def moe_prefill_logits(prefill, fp32, spec, fa, norms, da, qm):
    """generate_moe's prefill logits: ``prefill()`` through the kernels,
    recording its expert picks at every layer; then, each following those
    picks (following_routes), the bf16 plain path, ``fp32()`` under the
    plain versions, and a lower-precision control, the kernel path with
    K9's output rounded to e4m3. Returns (each path's logit errors, the
    plain and fp32 paths' routing against the kernel path's:
    route_errors)."""
    from mlio_tpu_torch.ops import moe as moe_ops

    with following_routes(moe_ops) as kernel_routes:
        logits = prefill()[0]
    if logits.shape != (B, PROMPT, spec.vocab_size) or not torch.isfinite(logits).all():
        raise AssertionError(f"generate_moe: prefill logits shape {tuple(logits.shape)} or not "
                             "finite")
    kprobs = torch.stack([p for p, _ in kernel_routes])
    kpicks = torch.stack([i for _, i in kernel_routes])
    kmask = torch.zeros_like(kprobs, dtype=torch.bool).scatter_(-1, kpicks.long(), True)
    with plain_kernels(fa, norms, da, qm):
        with following_routes(moe_ops, kpicks) as plain_routes:
            logits_plain = prefill()[0]
        with following_routes(moe_ops, kpicks) as ref_routes:
            logits_ref = fp32()
    k9 = fa.flash_attention_kvq

    def k9_e4m3(*args, **kwargs):  # 3 mantissa bits where bf16 keeps 7
        return k9(*args, **kwargs).to(qm.FP8).to(torch.bfloat16)

    k9_e4m3.launches = 0  # the wrapper counts on the module name it is patched under
    with patched(fa, "flash_attention_kvq", k9_e4m3), following_routes(moe_ops, kpicks):
        logits_ctl = prefill()[0]
    errs = dict(kernels_vs_fp32=logit_errors(logits, logits_ref),
                plain_vs_fp32=logit_errors(logits_plain, logits_ref),
                kernels_vs_plain=logit_errors(logits, logits_plain),
                k9_e4m3_control_vs_fp32=logit_errors(logits_ctl, logits_ref))
    routes = {name: route_errors(kprobs, torch.stack([p for p, _ in calls]), kmask,
                                 spec.num_experts_per_tok)
              for name, calls in (("plain", plain_routes), ("fp32", ref_routes))}
    return errs, routes


def generate_moe_phase(dev, seed, spec, params, build, wrappers, fa, norms, da, qm, dt):
    """The slice's path: Mixtral-8x7B (32 layers, int8 weights and head from
    init_quantized_params), B 8, a 704-token prompt, a 1024-slot INT8 cache,
    greedy, Impl(attention="flash", norm="fused", moe="ragged"). The prefill
    logits held against an fp32 path (the same int8 payloads dequantized one
    expert at a time, every activation in fp32), no farther from it than the
    bf16 plain path (LOGITS_8B_OVER_PLAIN, max-abs and RMS), where both
    paths follow the kernel path's expert picks at every layer
    (following_routes; a near tie flipped by bf16 noise would otherwise
    swamp the kernels' own error; every path routes by the same plain
    router_topk, so their softmaxes' distance from the kernel path's is
    reported, not bounded); the gate must reject a lower-precision control,
    the kernel path with K9's output rounded to e4m3; "auto" must
    route to K6; the launch counters around a 64-token generate (K9 32, K2
    65 and one a step, K5 129 and one a step (the int8 head), K6 one a
    step); the decode step by the two-length marginal, tok/s, a step's
    device ms, the idle share and the bound; DECODE_CHECK_STEPS decode steps
    whose logits (K6 and the head) lie within LOGITS_ATOL of the plain route
    that follows K6's expert picks. The prefill checks fail the phase after
    its line is printed. Returns the launch counts."""
    from mlio_tpu_torch.models import Impl, forward, rope_cos_sin
    from mlio_tpu_torch.models.transformer import _head, decode_route
    from mlio_tpu_torch.ops.moe import topk_mask
    from mlio_tpu_torch.runtime import generate, init_cache

    L = spec.num_layers
    ids = torch.from_numpy(np.random.default_rng(seed).integers(
        0, spec.vocab_size, (B, PROMPT))).to(dev)
    base = Impl(attention="flash", norm="fused", moe="ragged")

    def prefill():
        cache = init_cache(spec, B, CACHE, dtype=torch.bfloat16, quant="int8", device=dev)
        with torch.inference_mode():
            return forward(params, spec, ids, impl=base, cache=cache)

    errs, routes = moe_prefill_logits(
        prefill, lambda: fp32_prefill(spec, params, ids, base, "int8", dev), spec, fa, norms, da,
        qm)
    torch.cuda.empty_cache()
    picked = decode_route(spec, base, params["blocks"], B, cache_quant=True, smax=CACHE,
                          on_card=dev.type == "cuda")
    if picked != "tiled":
        raise AssertionError(f"generate_moe: decode_stack='auto' picks {picked!r}, not 'tiled'")

    def run(new_tokens):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = generate(params, spec, ids, max_new_tokens=new_tokens, impl=base,
                       cache_len=CACHE, cache_quant="int8", device=dev)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    run(4)  # warm-up
    for w in wrappers:
        w.launches = 0
    out, t_short = run(SHORT)
    launches = {w.__name__: w.launches for w in wrappers}
    want = route_launches("tiled", L, SHORT - 1, True, projections=4, quant_head=True)
    want = {k: want.get(k, 0) for k in launches}
    if launches != want:
        raise AssertionError(f"generate_moe: launch counts {launches} != expected {want}")
    if out.shape != (B, PROMPT + SHORT) or not torch.equal(out[:, :PROMPT], ids) \
            or int(out.min()) < 0 or int(out.max()) >= spec.vocab_size:
        raise AssertionError("generate_moe: wrong shape, prompt changed or token out of range")
    _, t_long = run(LONG)
    step_s = (t_long - t_short) / (LONG - SHORT)
    cache = prefill()[1]
    tok = out[:, PROMPT:PROMPT + 1]
    with torch.inference_mode():
        step_dev_ms = time_ms(lambda i: forward(params, spec, tok, impl=base,
                                                cache=dict(cache)), 3)[0]
    # decode steps: K6 and the head against the plain route over the same cache
    blocks, k = params["blocks"], spec.num_experts_per_tok
    steps = []
    with torch.inference_mode():
        for s in range(DECODE_CHECK_STEPS):
            pos = PROMPT + s
            x = params["tok_embed"][tok[:, 0]]
            cs, sn = rope_cos_sin(torch.arange(pos, pos + 1, device=dev), spec.rope_dim,
                                  spec.rope_theta)
            ck, cv = cache["k"].clone(), cache["v"].clone()
            psk = dict(k_scales=cache["k_scale"].clone(), v_scales=cache["v_scale"].clone())
            probs = torch.zeros((L, B, spec.num_experts), dtype=torch.float32, device=dev)
            xk = dt.decode_layer_tiled(x, blocks, cache["k"], cache["v"], pos, cs, sn, spec=spec,
                                       k_scales=cache["k_scale"], v_scales=cache["v_scale"],
                                       router_probs=probs)
            picks = topk_mask(probs, k)
            pprobs = torch.zeros_like(probs)
            xp = dt.decode_layer_tiled_plain(x, blocks, ck, cv, pos, cs, sn, spec=spec,
                                             router_probs=pprobs, experts=picks, **psk)
            lk = _head(xk[:, None], params, spec, base)[:, 0]
            with plain_kernels(norms, qm):
                lp = _head(xp[:, None], params, spec, base)[:, 0]
            step = route_check(probs, pprobs, picks, k)
            step.update(x_out_max_abs_err=(xk.float() - xp.float()).abs().max().item(),
                        logits_max_abs_err=(lk.float() - lp.float()).abs().max().item())
            steps.append(step)
            tok = lk.argmax(-1)[:, None]
            del ck, cv, psk
    del cache
    torch.cuda.empty_cache()
    b_ms, b_by, used = moe_bound(spec, params, B, B * (PROMPT + (SHORT + LONG) // 2), picks,
                                 kv8=True, head=True)
    all_ms, _, _ = moe_bound(spec, params, B, B * (PROMPT + (SHORT + LONG) // 2), None,
                             kv8=True, head=True)
    result = dict(phase="generate_moe", model=spec.name, layers=L, experts=spec.num_experts,
                  top_k=k, weights="int8", head="int8", cache_quant="int8", batch=B,
                  prompt=PROMPT, cache_len=CACHE, build=build, impl=dict(
                      attention=base.attention, norm=base.norm, moe=base.moe),
                  auto_route=picked, launches=launches, prefill_logits=errs,
                  prefill_routes_followed=routes, logits_over_plain=LOGITS_8B_OVER_PLAIN,
                  generate_s={str(SHORT): t_short, str(LONG): t_long},
                  decode_step_ms=step_s * 1e3, decode_tok_per_s=B / step_s,
                  decode_step_device_ms=step_dev_ms,
                  decode_idle_share=1 - step_dev_ms / (step_s * 1e3),
                  decode_step_bound_ms=b_ms, decode_step_bound_by=b_by,
                  bound_experts_used=used, decode_step_bound_ms_all_experts=all_ms,
                  step_over_bound=step_s * 1e3 / b_ms, decode_steps=steps)
    emit(result)
    def passes(got):
        return all(errs[got][stat] <= LOGITS_8B_OVER_PLAIN * errs["plain_vs_fp32"][stat]
                   for stat in ("max_abs", "rms"))

    if not passes("kernels_vs_fp32"):
        raise AssertionError(f"generate_moe: the kernels' prefill logits lie farther from the "
                             f"fp32 path than the bf16 plain path's: {errs}")
    if passes("k9_e4m3_control_vs_fp32"):
        raise AssertionError(f"generate_moe: the prefill gate passes K9 rounded to e4m3: {errs}")
    worst = max(st["logits_max_abs_err"] for st in steps)
    if not worst <= LOGITS_ATOL:
        raise AssertionError(f"generate_moe: a decode step's logits lie {worst} from the plain "
                             f"route (> {LOGITS_ATOL})")
    return launches


RULE_MODELS = ("gpt2-xl", "opt-1.3b")  # layer weights on K4's side of the crossover


def rule_phase(dev, seed, dt):
    """The K4-or-K6 rule's crossover: the presets whose layer weights lie
    nearest below ``decode_tiled.MEGA_MAX_LAYER_BYTES`` (gpt2-xl, 58.6 MiB a
    layer in bf16; opt-1.3b, 96 MiB), at full depth with random weights from
    the seed, bf16 and int8 weights (bf16 cache), batch 8, the workload's
    prompt length and cache: a greedy generate's decode step by the two-length marginal on
    decode_stack "mega" (K4 with its epilogue, one launch for all steps) and
    "tiled" (K6, then the head, a forward a token), beside the route that
    "auto" picks. Returns the results by model and weights."""
    from mlio_tpu_torch.models import Impl, get_spec, init_params
    from mlio_tpu_torch.models.transformer import decode_route
    from mlio_tpu_torch.runtime import generate, quantize_params

    out = {}
    for name in RULE_MODELS:
        spec = get_spec(name)
        bf = init_params(spec, torch.Generator(device=dev).manual_seed(seed),
                         dtype=torch.bfloat16, device=dev)
        ids = torch.from_numpy(np.random.default_rng(seed).integers(
            0, spec.vocab_size, (B, PROMPT))).to(dev)
        for wname in ("bf16", "int8"):
            params = bf if wname == "bf16" else quantize_params(bf, spec, "int8")
            base = Impl(attention="flash", norm="fused")
            steps = {}
            for stack in ("mega", "tiled"):
                impl = dataclasses.replace(base, decode_stack=stack)

                def run(new_tokens):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    generate(params, spec, ids, max_new_tokens=new_tokens, impl=impl,
                             cache_len=CACHE, device=dev)
                    torch.cuda.synchronize()
                    return time.perf_counter() - t0

                run(4)  # warm-up
                t_short, t_long = run(SHORT), run(LONG)
                steps[stack] = (t_long - t_short) / (LONG - SHORT) * 1e3
            picked = decode_route(spec, base, params["blocks"], B, smax=CACHE)
            out[f"{name}_{wname}"] = dict(
                layer_weight_bytes=dt.layer_weight_bytes(spec, 2 if wname == "bf16" else 1),
                mega_step_ms=steps["mega"], tiled_step_ms=steps["tiled"], picked=picked,
                faster=min(steps, key=steps.get))
            del params
        del bf
        torch.cuda.empty_cache()
    emit(dict(phase="rule", batch=B, prompt=PROMPT, cache_len=CACHE,
              mega_max_layer_bytes=dt.MEGA_MAX_LAYER_BYTES, models=out))
    return out


@contextlib.contextmanager
def patched(module, name, value):
    real = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, real)


def f1_phase(dev, seed, wrappers, fa, norms, da, qm, dt, pa):
    """Fault F1's cases on the card. GPT-2 small greedy generate at B = 16
    (the workload's prompt, twice): "auto" must route off K4; the launch
    counters show the route; the prefill logits and one decode step's logits
    through the route within LOGITS_ATOL of the plain path. Then
    InferenceEngine(max_batch=16) on engine_bench's 24 prompts, 64 new
    tokens each: "auto" must resolve to the per-op decode (K7, no K8), and
    one per-op step from one state within LOGITS_ATOL of the plain path."""
    from mlio_tpu_torch.models import Impl, forward
    from mlio_tpu_torch.models.transformer import decode_route
    from mlio_tpu_torch.runtime import InferenceEngine, generate, init_cache
    from mlio_tpu_torch.runtime import paged_forward

    spec, params, ids8, impl = workload(seed, dev)
    ids = torch.cat([ids8, ids8.flip(1)])
    Bf = ids.shape[0]
    L = spec.num_layers
    route = decode_route(spec, impl, params["blocks"], Bf, smax=CACHE)
    if route == "mega":
        raise AssertionError("F1: decode_stack='auto' sends batch 16 to K4")

    def prefill(plain=False):
        cache = init_cache(spec, Bf, CACHE, dtype=torch.bfloat16, device=dev)
        with torch.inference_mode(), (plain_kernels(fa, norms, da, qm, dt) if plain
                                      else contextlib.nullcontext()):
            return forward(params, spec, ids, impl=impl, cache=cache)

    (lg, cache), (lp, cache_p) = prefill(), prefill(True)
    prefill_err = (lg.float() - lp.float()).abs().max().item()
    tok = lg[:, -1].argmax(-1)[:, None]
    with torch.inference_mode():
        sg = forward(params, spec, tok, impl=impl, cache=cache)[0]
        with plain_kernels(fa, norms, da, qm, dt):
            sp = forward(params, spec, tok, impl=impl, cache=cache_p)[0]
    step_err = (sg.float() - sp.float()).abs().max().item()
    del lg, lp, cache, cache_p
    if not max(prefill_err, step_err) <= LOGITS_ATOL:
        raise AssertionError(f"F1 generate B16: logits {prefill_err} (prefill), {step_err} "
                             f"(decode step) from the plain path (> {LOGITS_ATOL})")
    generate(params, spec, ids, max_new_tokens=4, impl=impl, cache_len=CACHE, device=dev)
    for w in wrappers:
        w.launches = 0
    out = generate(params, spec, ids, max_new_tokens=SHORT, impl=impl, cache_len=CACHE,
                   device=dev)
    launches = {w.__name__: w.launches for w in wrappers}
    want = {w: 0 for w in launches}
    want.update(flash_attention=L, fused_norm=2 * L + 1)
    want["decode_layer_tiled" if route == "tiled" else "decode_attention"] = (
        SHORT - 1 if route == "tiled" else L * (SHORT - 1))
    want["fused_norm"] += (SHORT - 1) * (1 if route == "tiled" else 2 * L + 1)
    if launches != want or out.shape != (Bf, PROMPT + SHORT):
        raise AssertionError(f"F1 generate B16: launch counts {launches} != expected {want} or "
                             f"shape {tuple(out.shape)}")
    result = dict(phase="f1", generate=dict(batch=Bf, route=route, launches=launches,
                                            prefill_logits_max_abs_err=prefill_err,
                                            decode_step_logits_max_abs_err=step_err))

    prompts = engine_prompts(seed, spec.vocab_size)
    eng = InferenceEngine(spec, params, max_batch=16, num_blocks=POOL_BLOCKS, block_size=POOL_BS,
                          impl=Impl(attention="flash", norm="fused"), steps_per_dispatch=8,
                          device=dev)
    if eng.decode_stack != "perop":
        raise AssertionError(f"F1 engine: max_batch 16 resolved to {eng.decode_stack!r}, "
                             "not 'perop'")
    eng.run(prompts[:4], max_new_tokens=4)  # warm-up
    for w in wrappers:
        w.launches = 0
    with counted(paged_forward, "decode_paged", lambda *a, **kw: 1) as steps:
        t0 = time.perf_counter()
        outs = eng.run(prompts, max_new_tokens=64)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = {w.__name__: w.launches for w in wrappers}
    if counts["paged_attention"] != L * steps[0] or counts["decode_paged_stack"] \
            or [len(o) for o in outs] != [64] * len(prompts):
        raise AssertionError(f"F1 engine: launches {counts} for {steps[0]} per-op steps, or "
                             "outputs of the wrong length")
    for p_ in prompts[:16]:
        eng.submit(p_, 8)
    with torch.inference_mode():
        eng._prefill_batch(list(eng.sched.admit()))
        cur, tables, ctx = (eng._tensor(a) for a in (eng.sched.cur, eng.sched.tables,
                                                      eng.sched.ctx))
        kp, vp = eng.k_pool.clone(), eng.v_pool.clone()
        lg = paged_forward.decode_paged(params, spec, cur, eng.k_pool, eng.v_pool, tables, ctx,
                                        impl=eng.impl)
        with plain_kernels(fa, norms, da, qm), \
                patched(paged_forward, "paged_attention", pa.paged_attention_plain):
            lp = paged_forward.decode_paged(params, spec, cur, kp, vp, tables, ctx,
                                            impl=eng.impl)
    eng_err = (lg.float() - lp.float()).abs().max().item()
    if not eng_err <= LOGITS_ATOL:
        raise AssertionError(f"F1 engine: per-op step logits {eng_err} from the plain path")
    result["engine"] = dict(max_batch=16, decode_stack=eng.decode_stack, prompts=len(prompts),
                            max_new_tokens=64, decode_steps=steps[0], launches=counts,
                            generated_tok_per_s=len(prompts) * 64 / wall,
                            step_logits_max_abs_err=eng_err)
    emit(result)
    del eng
    return launches


# ---------------------------------------------------------------------------
# The training slice: K1's dropout instance and K13, then llama3-8b's step
# ---------------------------------------------------------------------------

# K13's cases on the card: (name, B, S, Hq, Hkv, D, causal, dropout_rate).
# llama3-8b's attention is the training path's shape (train_8b).
FLASH_GRAD_CASES = (("llama3-8b", 1, 2048, 32, 8, 128, True, 0.0),
                    ("gpt2", 8, 1024, 12, 12, 64, True, 0.0),
                    ("ragged_g4", 2, 1000, 8, 2, 64, True, 0.0),
                    ("noncausal_g2", 2, 640, 16, 8, 128, False, 0.0),
                    ("llama3-8b_dropout", 1, 2048, 32, 8, 128, True, 0.1),
                    ("ragged_tile_g4_dropout", 2, 1089, 16, 4, 128, True, 0.1))
DROP_SEED = 7
# K1's dropout instance, K13a's o and K13b's dq are bf16 outputs, K13c's
# dK/dV fp32 sums of bf16 products: each rounds p, dS or P~ to bf16 as its
# plain version does, but from scores and sums taken in another order (and
# K1/K13a against a running max), so a value on a rounding boundary can fall
# the other way; K1's limit holds them (first chip run of this slice: o
# 0.0078, dq 0.0039, dK 0.0011, dV 0.0055 at most, NVIDIA H100 80GB HBM3,
# 700 W). The log-sum-exp is fp32 throughout: its sums in another order
# moved it by 1e-6 on the card; 1e-4 would still miss a causal frontier one
# key short on the last row (a change of log(1 - p) ~ 5e-4 there).
TOL.update({"flash_attention_dropout": TOL["flash_attention"],
            "flash_fwd_lse": TOL["flash_attention"], "flash_fwd_lse_lse": (1e-4, 0.0),
            "flash_bwd_dq": TOL["flash_attention"], "flash_bwd_dkv": TOL["flash_attention"]})
# K13b's and K13c's rings at depth. |dq| falls to about 1/sqrt(n) for a row
# that sees n keys (0.02 at 2K), as small as K1's atol, so a K/V tile read from
# a stale ring slot, which moves a row of dq, dK or dV by about sqrt(64 / n)
# of its size, could pass the elementwise limit. Each query row of dq and
# each key row of dK and dV is also held to its own size (ROW_REL_RMS). The
# floor: row 0 of a causal case sees one key, where P = 1 and delta = dP up
# to the order of two fp32 sums, so its dS and dq are a cancellation's
# residue (~1e-6) that no two summation orders agree on; a row is taken to be
# at least a tenth of the tensor's RMS. The depth controls take the tile at
# STALE_ROW from the tile before: K and V for dq, q and dO for dK and dV. On
# the card (NVIDIA H100 80GB HBM3, 700 W) the kernels' largest row error over
# FLASH_GRAD_CASES was 5.2e-3 (dq) and 6.7e-3 (dK, dV), the controls' 3.12
# (dq), 1.84 (dK) and 2.12 (dV), the same with the floor at 0.01 or 0.1:
# 3e-2 lies 5.7x and 4.5x over the kernels, 104x and 61x under the controls.
ROW_REL_RMS.update({"flash_bwd_dq": 3e-2, "flash_bwd_dkv": 3e-2})
ROW_RMS_FLOOR.update({"flash_bwd_dq": 0.1, "flash_bwd_dkv": 0.1})
# K1's and K13a's o at depth, for the same reason: |o| falls to about
# sqrt(1 / n) for a row over n keys, and a K/V tile read from a stale ring
# slot moves a row past it by about sqrt(64 / n) of its size, which K1's
# elementwise limit may not see at 2K keys. Each query row of o (kernel and
# plain differ by flipped bf16 roundings, 2^-8 of a value) is held to 2e-2
# of its own RMS, wherever K1's or K13a's o is checked; the controls take the
# 64-key K/V tile at STALE_ROW from the tile before (k1_depth_controls). On
# the card (NVIDIA H100 80GB HBM3, 700 W) the kernels' largest row error was
# 5.0e-3 (FLASH_GRAD_CASES and GPT-2's prefill alike), 4.7e-3 for K1's
# dropout instance, and the controls' 1.144 a row: 2e-2 lies 4.0x over the
# kernels and 57x under the controls. K1's dropout instance, a kernel of its
# own, answers to the same limit and its own control.
ROW_REL_RMS.update({"flash_attention": 2e-2, "flash_fwd_lse": 2e-2,
                    "flash_attention_dropout": 2e-2})
STALE_ROW = 1024


def causal_pairs(Sq: int, Skv: int, causal: bool, q_offset: int = 0) -> int:
    """(query, key) pairs a causal (or full) attention scores over Skv valid
    keys, its queries at positions q_offset onward."""
    return sum(min(Skv, q_offset + i + 1) for i in range(Sq)) if causal else Sq * Skv


@contextlib.contextmanager
def frontier_one_short(*modules):
    """The causal mask of every module given one key short: query i sees
    keys j < i, where it should see j <= i."""
    from mlio_tpu_torch.ops.reference import attention_mask

    def short(*args, **kw):
        return attention_mask(*args, **dict(kw, q_offset=kw["q_offset"] - 1))

    with contextlib.ExitStack() as stack:
        for m in modules:
            stack.enter_context(patched(m, "attention_mask", short))
        yield


def flash_grad_phase(dev, seed, fa, fg):
    """K1's dropout instance and K13a/b/c, each held against its plain
    version on the card at FLASH_GRAD_CASES (dq, dK and dV also a row at a
    time, ROW_REL_RMS); failing a dropout seed one off (K1's output, dq), a
    causal frontier one key short in the plain versions (o, lse, dq, dK, dV)
    and one tile stale at depth (k13_depth_controls; k1_depth_controls with
    and without dropout); the same bits twice;
    the row checks' margins; timed at llama3-8b's attention beside the plain
    version, a PyTorch call where one computes the same function, and the
    bound. Returns the kernels line's rows (K1's dropout, K13a, K13b, K13c,
    and the whole backward)."""
    gen = torch.Generator(device=dev).manual_seed(seed + 13)
    checks, rows = {}, {}
    for name, B, S, Hq, Hkv, D, causal, rate in FLASH_GRAD_CASES:
        def r(*shape):
            return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

        q, k, v, do = r(B, S, Hq, D), r(B, S, Hkv, D), r(B, S, Hkv, D), r(B, S, Hq, D)
        kw = dict(causal=causal, dropout_rate=rate, dropout_seed=DROP_SEED)
        res = {}
        o1 = fa.flash_attention(q, k, v, **kw)
        o1_plain = fa.flash_attention_plain(q, k, v, **kw)
        k1_name = "flash_attention_dropout" if rate else "flash_attention"
        res["k1_max_abs_err"] = check_close(k1_name, o1, o1_plain)
        o, lse = fg.flash_fwd_lse(q, k, v, **kw)
        o_plain, lse_plain = fg.flash_fwd_lse_plain(q, k, v, **kw)
        res["o_max_abs_err"] = check_close("flash_fwd_lse", o, o_plain)
        res["lse_max_abs_err"] = check_close("flash_fwd_lse_lse", lse, lse_plain)
        fwd_rows = {"k1_o": row_rel_rms(o1, o1_plain), "k13a_o": row_rel_rms(o, o_plain)}
        # the backward kernels and their plain versions take the same (o, lse)
        delta = (do.float() * o_plain.float()).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, do, lse_plain, delta)
        dq, dq_plain = fg.flash_bwd_dq(*args, **kw), fg.flash_bwd_dq_plain(*args, **kw)
        res["dq_max_abs_err"] = check_close("flash_bwd_dq", dq, dq_plain)
        (dk, dv), (dk_plain, dv_plain) = fg.flash_bwd_dkv(*args, **kw), \
            fg.flash_bwd_dkv_plain(*args, **kw)
        res["dk_max_abs_err"] = check_close("flash_bwd_dkv", dk, dk_plain)
        res["dv_max_abs_err"] = check_close("flash_bwd_dkv", dv, dv_plain)
        res["row_rel_rms"] = {w: row_rel_rms(got, want, ROW_RMS_FLOOR[n]) for w, n, got, want in (
            ("dq", "flash_bwd_dq", dq, dq_plain), ("dk", "flash_bwd_dkv", dk, dk_plain),
            ("dv", "flash_bwd_dkv", dv, dv_plain))}
        res["row_rel_rms"].update(fwd_rows)
        again = (fa.flash_attention(q, k, v, **kw), *fg.flash_fwd_lse(q, k, v, **kw),
                 fg.flash_bwd_dq(*args, **kw), *fg.flash_bwd_dkv(*args, **kw))
        if not all(torch.equal(a, b) for a, b in zip(again, (o1, o, lse, dq, dk, dv))):
            raise AssertionError(f"flash_grad {name}: two runs gave different bits")
        res["same_bits_twice"] = True
        if rate:  # a dropout seed one off must fail K1's and dq's checks
            off = dict(kw, dropout_seed=DROP_SEED + 1)
            res["seed_off_max_abs_err"] = dict(
                k1=must_fail_within("flash_attention_dropout", "with the dropout seed one off",
                                    fa.flash_attention(q, k, v, **off), o1_plain),
                dq=must_fail_within("flash_bwd_dq", "with the dropout seed one off",
                                    fg.flash_bwd_dq(*args, **off), dq_plain))
        if name == "llama3-8b":  # the plain versions one key short must fail every check
            with frontier_one_short(fa, fg):
                o_s, lse_s = fg.flash_fwd_lse_plain(q, k, v, **kw)
                dq_s = fg.flash_bwd_dq_plain(*args, **kw)
                dk_s, dv_s = fg.flash_bwd_dkv_plain(*args, **kw)
            what = "against a causal frontier one key short"
            res["frontier_short_max_abs_err"] = dict(
                o=must_fail_within("flash_fwd_lse", what, o, o_s),
                lse=must_fail_within("flash_fwd_lse_lse", what, lse, lse_s),
                dq=must_fail_within("flash_bwd_dq", what, dq, dq_s),
                dk=must_fail_within("flash_bwd_dkv", what, dk, dk_s),
                dv=must_fail_within("flash_bwd_dkv", what, dv, dv_s))
            del o_s, lse_s, dq_s, dk_s, dv_s
            res["depth_controls"] = k13_depth_controls(fg, (dq, dk, dv), args, kw)
        if name.startswith("llama3-8b"):  # one K/V tile stale at depth must fail K1 and K13a
            res.setdefault("depth_controls", {}).update(
                k1_depth_controls(fa, fg, k1_name, o1, o, q, k, v, kw))
        checks[name] = res
        if name.startswith("llama3-8b"):
            rows[name] = _flash_grad_rows(name, fa, fg, q, k, v, do, o_plain, lse_plain, delta,
                                          res, kw, causal, rate)
        if name == "llama3-8b":
            k1_llama = k1_llama_row(fa, q, k, v, kw, res)
        del q, k, v, do, o1, o1_plain, o, lse, o_plain, lse_plain, dq, dq_plain, dk, dv
        del dk_plain, dv_plain, again
        torch.cuda.empty_cache()
    margins = {}
    for name, outs, cases in (("flash_bwd_dq", ("dq",), None),
                              ("flash_bwd_dkv", ("dk", "dv"), None),
                              ("flash_attention", ("k1_o",), False),
                              ("flash_attention_dropout", ("k1_o",), True),
                              ("flash_fwd_lse", ("k13a_o",), None)):
        limit = ROW_REL_RMS[name]
        # K1's dropout instance answers to flash_attention_dropout's check,
        # its plain instance to flash_attention's (cases: dropout or not, or all)
        picked = {n: c for n, c in checks.items() if cases is None or ("dropout" in n) == cases}
        kernel = max(c["row_rel_rms"][w] for c in picked.values() for w in outs)
        control = min(c["depth_controls"][w]["row_rel_rms"] for c in picked.values()
                      if "depth_controls" in c for w in outs if w in c["depth_controls"])
        margins[name] = dict(limit=limit, kernel_max=kernel, control_min=control,
                             limit_over_kernel=limit / max(kernel, 1e-30),
                             control_over_limit=control / limit)
    emit(dict(phase="flash_grad", checks=checks, row_margins=margins))
    return rows["llama3-8b_dropout"][:1] + rows["llama3-8b"], k1_llama


def k13_depth_controls(fg, outs, args, kw):
    """K13b's dq and K13c's dK and dV (outs) must fail their checks against
    the plain versions with one tile stale at STALE_ROW (stale_tile), a fault
    only the rows that see the tile carry: K and V for dq, q and dO for dK and
    dV. Returns, for each, the control's max-abs, its largest row_rel_rms and
    whether K1's elementwise limit alone would have passed it."""
    q, k, v, do, lse, delta = args
    bad = (fg.flash_bwd_dq_plain(q, stale_tile(k, STALE_ROW), stale_tile(v, STALE_ROW), do, lse,
                                 delta, **kw),
           *fg.flash_bwd_dkv_plain(stale_tile(q, STALE_ROW), k, v, stale_tile(do, STALE_ROW), lse,
                                   delta, **kw))
    out = {}
    for w, name, got, want in zip(("dq", "dk", "dv"), ("flash_bwd_dq", "flash_bwd_dkv",
                                                        "flash_bwd_dkv"), outs, bad):
        what = f"against the plain version with the tile at row {STALE_ROW} stale"
        out[w] = dict(max_abs_err=must_fail_within(name, what, got, want),
                      row_rel_rms=row_rel_rms(got, want, ROW_RMS_FLOOR[name]),
                      within_k1_limit=within("flash_attention", got, want, rows=False)[0])
    return out


def k1_depth_controls(fa, fg, k1_name, o1, o, q, k, v, kw):
    """K1's output o1 (checked as k1_name) and K13a's o must fail their
    checks against the plain versions with the 64-key K/V tile at STALE_ROW
    taken from the tile before (stale_tile), a fault only the rows past it
    carry. Returns, for each, the control's max-abs, its largest row_rel_rms
    and whether K1's elementwise limit alone would have passed it."""
    k_bad, v_bad = stale_tile(k, STALE_ROW), stale_tile(v, STALE_ROW)
    out = {}
    for w, name, got, want in (("k1_o", k1_name, o1,
                                fa.flash_attention_plain(q, k_bad, v_bad, **kw)),
                               ("k13a_o", "flash_fwd_lse", o,
                                fg.flash_fwd_lse_plain(q, k_bad, v_bad, **kw)[0])):
        what = f"against the plain version with the K/V tile at key {STALE_ROW} stale"
        out[w] = dict(max_abs_err=must_fail_within(name, what, got, want),
                      row_rel_rms=row_rel_rms(got, want),
                      within_k1_limit=within("flash_attention", got, want, rows=False)[0])
    return out


def k1_llama_row(fa, q, k, v, kw, res):
    """K1 (no dropout) at llama3-8b's training attention: its errors from
    the flash_grad case, device ms beside its plain version and SDPA's
    forward (K/V repeated to the query heads outside the timing), the bound
    and the rate; the kernels line's flash_attention row carries it."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    pairs = B * Hq * D * causal_pairs(S, S, True)
    qt = q.transpose(1, 2)
    kx, vx = (t.transpose(1, 2).repeat_interleave(Hq // Hkv, dim=1).contiguous() for t in (k, v))
    b_ms, b_by = bound(2 * (2 * q.numel() + 2 * k.numel()), 4 * pairs, BF16_TENSOR_FLOPS)
    row = dict(shape=f"q [{B},{S},{Hq},{D}] k/v [{B},{S},{Hkv},{D}] bf16, causal",
               max_abs_err=res["k1_max_abs_err"], row_rel_rms=res["row_rel_rms"]["k1_o"],
               **timings(lambda i: fa.flash_attention(q, k, v, **kw),
                         lambda i: fa.flash_attention_plain(q, k, v, **kw),
                         lambda i: F.scaled_dot_product_attention(qt, kx, vx, is_causal=True),
                         20),
               library_note="F.scaled_dot_product_attention(is_causal), K/V repeated to the "
                            "query heads outside the timing",
               bound_ms=b_ms, bound_by=b_by)
    row["tflop_per_s"] = 4 * pairs / (row["ms"] * 1e-3) / 1e12
    return row


BACKWARD_PRODUCTS = 7  # matrix products of the backward with its recompute, pairs x 2 each


def _flash_grad_rows(name, fa, fg, q, k, v, do, o, lse, delta, res, kw, causal, rate):
    """The kernels line's rows at llama3-8b's attention: K1's dropout instance
    (the dropout case), or K13a, K13b, K13c and the whole backward."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    pairs = B * Hq * D * causal_pairs(S, S, causal)
    qkv = 2 * (q.numel() + 2 * k.numel())  # bytes of q, k, v
    rowstats = 4 * B * Hq * S  # one fp32 a row: lse or delta
    shape = f"q [{B},{S},{Hq},{D}] k/v [{B},{S},{Hkv},{D}] bf16, causal"
    common = dict(route="cuda", source="mlio_tpu_torch/csrc/flash_bwd.cu", shape=shape,
                  atol=TOL["flash_bwd_dq"][0], rtol=TOL["flash_bwd_dq"][1])
    if rate:
        b_ms, b_by = bound(qkv + 2 * q.numel(), 4 * pairs, BF16_TENSOR_FLOPS)
        return [dict(
            name="flash_attention_dropout", route="cuda",
            source="mlio_tpu_torch/csrc/flash_fwd.cu (flash_fwd.cuh, kDrop)",
            replaces="mlio_tpu/ops/flash_attention.py:37 (dropout branch :140-150)",
            shape=f"{shape}, dropout {rate}, seed {DROP_SEED}", max_abs_err=res["k1_max_abs_err"],
            atol=TOL["flash_attention_dropout"][0], rtol=TOL["flash_attention_dropout"][1],
            seed_off_max_abs_err=res["seed_off_max_abs_err"],
            **timings(lambda i: fa.flash_attention(q, k, v, **kw),
                      lambda i: fa.flash_attention_plain(q, k, v, **kw), None, 20),
            library_note="no PyTorch call drops by this position hash (SDPA's dropout draws "
                         "Philox bits)",
            bound_ms=b_ms, bound_by=b_by)]
    # the library calls take [B, H, S, D]; the flash op wants K/V at Hq heads
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    kx, vx = (t.repeat_interleave(Hq // Hkv, dim=1) for t in (kt, vt))
    sdpa_q, sdpa_k, sdpa_v = (t.clone().requires_grad_() for t in (qt, kt, vt))
    sdpa_o = F.scaled_dot_product_attention(sdpa_q, sdpa_k, sdpa_v, is_causal=True,
                                            enable_gqa=True)
    sdpa_do = do.transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta)
    rows = []
    b_ms, b_by = bound(qkv + 2 * q.numel() + rowstats, 4 * pairs, BF16_TENSOR_FLOPS)
    rows.append(dict(
        name="flash_fwd_lse", replaces="mlio_tpu/ops/flash_attention_grad.py:49",
        max_abs_err=res["o_max_abs_err"], lse_max_abs_err=res["lse_max_abs_err"],
        lse_atol=TOL["flash_fwd_lse_lse"][0],
        **timings(lambda i: fg.flash_fwd_lse(q, k, v, **kw),
                  lambda i: fg.flash_fwd_lse_plain(q, k, v, **kw),
                  lambda i: torch.ops.aten._scaled_dot_product_flash_attention(
                      qt, kx, vx, 0.0, True), 20),
        library_note="aten._scaled_dot_product_flash_attention (o and logsumexp), K/V "
                     "repeated to the query heads outside the timing",
        bound_ms=b_ms, bound_by=b_by, **common))
    b_ms, b_by = bound(qkv + 4 * q.numel() + 2 * rowstats, 6 * pairs, BF16_TENSOR_FLOPS)
    rows.append(dict(
        name="flash_bwd_dq", replaces="mlio_tpu/ops/flash_attention_grad.py:122",
        max_abs_err=res["dq_max_abs_err"],
        **timings(lambda i: fg.flash_bwd_dq(*args, **kw),
                  lambda i: fg.flash_bwd_dq_plain(*args, **kw), None, 20),
        library_note="no single PyTorch call gives dq alone (see flash_attention_backward)",
        bound_ms=b_ms, bound_by=b_by, **common))
    b_ms, b_by = bound(qkv + 2 * q.numel() + 2 * rowstats + 8 * q.numel(), 8 * pairs,
                       BF16_TENSOR_FLOPS)
    rows.append(dict(
        name="flash_bwd_dkv", replaces="mlio_tpu/ops/flash_attention_grad.py:180",
        max_abs_err=max(res["dk_max_abs_err"], res["dv_max_abs_err"]),
        dk_max_abs_err=res["dk_max_abs_err"], dv_max_abs_err=res["dv_max_abs_err"],
        **timings(lambda i: fg.flash_bwd_dkv(*args, **kw),
                  lambda i: fg.flash_bwd_dkv_plain(*args, **kw), None, 20),
        library_note="no single PyTorch call gives per-query-head dK/dV "
                     "(see flash_attention_backward)",
        bound_ms=b_ms, bound_by=b_by, **common))

    def whole(i):  # what the backward of flash_attention_diff runs
        o_, lse_ = fg.flash_fwd_lse(q, k, v, **kw)
        return fg.attention_backward(q, k, v, o_, lse_, do, **kw)

    def whole_plain(i):
        with plain_kernels(fg):
            return whole(i)

    # q, k, v and dO read, dq, dk and dv written; the operations the function
    # needs with the recompute (lse and o, then delta): S and PV, then S, dP,
    # dQ, dK and dV, 2 * pairs each (the kernels' own sum is 18: K13b and
    # K13c each recompute S and dP)
    b_ms, b_by = bound(2 * (3 * q.numel() + 4 * k.numel()), BACKWARD_PRODUCTS * 2 * pairs,
                       BF16_TENSOR_FLOPS)
    rows.append(dict(
        name="flash_attention_backward", bound_operations=f"{2 * BACKWARD_PRODUCTS} * pairs",
        replaces="mlio_tpu/ops/flash_attention_grad.py:463 (_diff_bwd: :49, :122, :180 and "
                 "the glue :363-367, :414-416)",
        max_abs_err=max(res["dq_max_abs_err"], res["dk_max_abs_err"], res["dv_max_abs_err"]),
        **timings(whole, whole_plain,
                  lambda i: torch.autograd.grad(sdpa_o, (sdpa_q, sdpa_k, sdpa_v), sdpa_do,
                                                retain_graph=True), 20),
        library_note="the backward of F.scaled_dot_product_attention(is_causal, enable_gqa), "
                     "which keeps its forward's logsumexp where K13 recomputes it (K13a)",
        bound_ms=b_ms, bound_by=b_by, **common))
    del sdpa_o, sdpa_q, sdpa_k, sdpa_v
    # K13a's, K13b's and K13c's rates; K13b's and K13c's times over SDPA's
    # whole backward
    rows[0]["tflop_per_s"] = 4 * pairs / (rows[0]["ms"] * 1e-3) / 1e12
    for row, products in zip(rows[1:3], (6, 8)):
        row["tflop_per_s"] = products * pairs / (row["ms"] * 1e-3) / 1e12
        row["over_sdpa_backward"] = row["ms"] / rows[3]["library_ms"]
    rows[3]["k13b_k13c_over_sdpa_backward"] = ((rows[1]["ms"] + rows[2]["ms"])
                                              / rows[3]["library_ms"])
    return rows


TRAIN_S, TRAIN_STEPS, TRAIN_LR = 2048, 3, 1e-3
GATE_LAYERS = 2  # a 32-layer fp32 copy of llama3-8b (32 GB, and its grads) does not fit beside it
# llama3-8b's gradients through 2 bf16 layers: each path's relative RMS
# error from an fp32 dense path, a leaf at a time. The kernel path's may lie
# no farther than GRAD_OVER_PLAIN times the bf16 plain path's (generate_8b's
# rule for logits), the plain path taking the same route with K1's and K13's
# plain versions, so that both round p, dS and P~ to bf16 where the TPU
# kernels do (tests/test_torch_flash_grad.py holds those plain versions to
# the JAX kernels on bf16 inputs, within 1e-3 relative RMS, which a rounding
# point left out or added exceeds). The dense bf16 path (Impl()) keeps
# attention in fp32 and lies closer: on the card (NVIDIA H100 80GB HBM3,
# 700 W) the plain path's errors were 1.02-1.05 times the dense path's (wv
# 1.0525), so a gate against it would reject a rounding the JAX kernels
# share; it is reported beside. The kernels lay at 0.98-1.008 times the
# plain path's; dK/dV from one query head a group (the control) at 9-68
# times.
GRAD_OVER_PLAIN = LOGITS_8B_OVER_PLAIN


def _rel_rms(got, want) -> float:
    d = (got.float() - want.float()).square().sum().sqrt()
    return (d / want.float().square().sum().sqrt().clamp_min(1e-30)).item()


def _named_leaves(params, prefix=""):
    for key, val in params.items():
        if isinstance(val, dict):
            yield from _named_leaves(val, f"{prefix}{key}.")
        elif isinstance(val, torch.Tensor) and val.is_floating_point():
            yield prefix + key, val


def _loss_and_grads(params, spec, ids, impl):
    """(loss, {leaf name: its gradient}) of one backward through params."""
    from mlio_tpu_torch.runtime import next_token_loss, trainable

    leaves = trainable(params)
    loss = next_token_loss(params, spec, ids, impl=impl)
    loss.backward()
    grads = {name: leaf.grad for name, leaf in _named_leaves(params)}
    for leaf in leaves:
        leaf.grad = None
    return loss.detach().float(), grads


def one_query_head_a_group(t, num_kv_heads):
    """The control's group sum: each KV head's dK/dV from its first query
    head alone."""
    B, S, Hq, D = t.shape
    return t.view(B, S, num_kv_heads, Hq // num_kv_heads, D)[:, :, :, 0]


def gradient_gate(dev, seed, spec, fa, fg):
    """llama3-8b at full width and GATE_LAYERS layers, bf16 weights from the
    seed: the loss and every gradient leaf of the kernel path (K1, K13), of
    the bf16 plain path (the same route with K1's and K13's plain versions)
    and of the dense bf16 path (Impl()), each against the fp32 dense path;
    the kernel path must lie within GRAD_OVER_PLAIN of the plain path's
    error on every leaf and the loss; the control (K13's dK/dV from one query
    head a group) must fail."""
    from mlio_tpu_torch.models import Impl, init_params

    spec2 = dataclasses.replace(spec, num_layers=GATE_LAYERS)
    params = init_params(spec2, torch.Generator(device=dev).manual_seed(seed + 1),
                         dtype=torch.bfloat16, device=dev)
    ids = torch.from_numpy(np.random.default_rng(seed + 2).integers(
        0, spec.vocab_size, (1, TRAIN_S + 1))).to(dev)
    p32 = {k: ({n: (t.float() if t is not None else None) for n, t in v.items()}
               if isinstance(v, dict) else (v.float() if v is not None else None))
           for k, v in params.items()}
    loss32, ref = _loss_and_grads(p32, spec2, ids, Impl())
    del p32
    torch.cuda.empty_cache()

    def errors(ctx, impl):
        with ctx:
            loss, grads = _loss_and_grads(params, spec2, ids, impl)
        out = {"loss": abs(loss.item() - loss32.item()) / abs(loss32.item())}
        out.update({n: _rel_rms(g, ref[n]) for n, g in grads.items()})
        return out

    flash = Impl(attention="flash")
    for w in (fa.flash_attention, fg.flash_fwd_lse, fg.flash_bwd_dq, fg.flash_bwd_dkv):
        w.launches = 0
    err = dict(kernels=errors(contextlib.nullcontext(), flash))
    launches = {w.__name__: w.launches for w in (fa.flash_attention, fg.flash_fwd_lse,
                                                 fg.flash_bwd_dq, fg.flash_bwd_dkv)}
    if set(launches.values()) != {GATE_LAYERS}:
        raise AssertionError(f"train_8b gate: the kernel path's launches {launches}")
    err["plain"] = errors(plain_kernels(fa, fg), flash)
    err["dense"] = errors(contextlib.nullcontext(), Impl())
    err["control"] = errors(patched(fg, "group_sum", one_query_head_a_group), flash)
    def over(path, base):
        return {n: e / max(err[base][n], 1e-30) for n, e in err[path].items()}

    ratio, control = over("kernels", "plain"), over("control", "plain")
    return dict(layers=GATE_LAYERS, loss_fp32=loss32.item(), rel_rms=err,
                kernels_over_plain=ratio, control_over_plain=control,
                kernels_over_dense=over("kernels", "dense"),
                plain_over_dense=over("plain", "dense"), over_plain=GRAD_OVER_PLAIN,
                passed=max(ratio.values()) <= GRAD_OVER_PLAIN,
                control_rejected=max(control.values()) > GRAD_OVER_PLAIN)


def train_8b_phase(dev, seed, fa, fg, wrappers):
    """The slice's path: llama3-8b at full width and depth, bf16 weights from
    the seed requiring grad, ids [1, TRAIN_S + 1] from the seed; TRAIN_STEPS
    SGD steps (lr TRAIN_LR) of the next-token loss with
    Impl(attention="flash"): forward, backward and step ms, tokens/s, each
    step's loss (finite), peak memory, launches a step (K1, K13a, K13b, K13c
    one a layer each; no other kernel) and attention backward calls (one a
    layer), the idle share (a torch.profiler trace of the last step against
    the previous step's wall). Then the gradient gate at GATE_LAYERS layers.
    Returns the launch counts, the backward calls under
    "flash_attention_backward"."""
    from torch.profiler import ProfilerActivity, profile

    from mlio_tpu_torch.models import Impl, get_spec, init_params
    from mlio_tpu_torch.runtime import next_token_loss, sgd_step, trainable

    spec = get_spec(LLAMA)
    L = spec.num_layers
    params = init_params(spec, torch.Generator(device=dev).manual_seed(seed),
                         dtype=torch.bfloat16, device=dev)
    leaves = trainable(params)
    ids = torch.from_numpy(np.random.default_rng(seed).integers(
        0, spec.vocab_size, (1, TRAIN_S + 1))).to(dev)
    impl = Impl(attention="flash")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers:
        w.launches = 0
    backwards, real_backward = [0], fg.attention_backward

    def counted_backward(*args, **kw):  # flash_attention_diff's backward, a call a layer
        backwards[0] += 1
        return real_backward(*args, **kw)

    steps, busy = [], None
    with patched(fg, "attention_backward", counted_backward):
        for s in range(TRAIN_STEPS):
            before = {w.__name__: w.launches for w in wrappers}
            prof = profile(activities=[ProfilerActivity.CUDA]) if s == TRAIN_STEPS - 1 \
                else contextlib.nullcontext()
            with prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss = next_token_loss(params, spec, ids, impl=impl)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                loss.backward()
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                sgd_step(leaves, TRAIN_LR)
                torch.cuda.synchronize()
                t3 = time.perf_counter()
            if s == TRAIN_STEPS - 1:
                busy = busy_ms(prof.events())
            value = loss.item()
            if not np.isfinite(value):
                raise AssertionError(f"train_8b: step {s} loss {value}")
            steps.append(dict(loss=value, forward_ms=(t1 - t0) * 1e3, backward_ms=(t2 - t1) * 1e3,
                              sgd_ms=(t3 - t2) * 1e3, step_ms=(t3 - t0) * 1e3,
                              profiled=s == TRAIN_STEPS - 1,
                              launches={w.__name__: w.launches - before[w.__name__]
                                        for w in wrappers}))
    launches = {w.__name__: w.launches for w in wrappers}
    want = {n: 0 for n in launches}
    want.update({n: L * TRAIN_STEPS for n in ("flash_attention", "flash_fwd_lse",
                                               "flash_bwd_dq", "flash_bwd_dkv")})
    if launches != want or backwards[0] != L * TRAIN_STEPS:
        raise AssertionError(f"train_8b: launch counts {launches} != expected {want}, or "
                             f"{backwards[0]} attention backward calls")
    launches["flash_attention_backward"] = backwards[0]
    peak = torch.cuda.max_memory_allocated()
    if not busy:
        raise AssertionError("train_8b: the profiler saw no device time in a step")
    wall = steps[-2]["step_ms"]
    result = dict(phase="train_8b", model=spec.name, layers=L, batch=1, seq=TRAIN_S,
                  lr=TRAIN_LR, params=sum(t.numel() for t in leaves), steps=steps,
                  tokens_per_s=TRAIN_S / (wall / 1e3), peak_bytes=peak, launches=launches,
                  device_busy_ms=busy, idle_share=1 - busy / wall)
    del params, leaves, loss
    torch.cuda.empty_cache()
    result["gate"] = gradient_gate(dev, seed, spec, fa, fg)
    emit(result)
    if not result["gate"]["passed"] or not result["gate"]["control_rejected"]:
        raise AssertionError(f"train_8b: the gradient gate {result['gate']}")
    return launches



# The long-context slice (flash_stream, long_context): Mistral-7B-Instruct-v0.2
# as its published config.json gives it, read through the port's
# spec_from_hf_config; no file is read or fetched.
MISTRAL_CONFIG = dict(model_type="mistral", hidden_size=4096, num_hidden_layers=32,
                      num_attention_heads=32, num_key_value_heads=8, intermediate_size=14336,
                      vocab_size=32000, max_position_embeddings=32768, rope_theta=1000000.0,
                      rms_norm_eps=1e-05, sliding_window=None, tie_word_embeddings=False)
LC_PROMPT, LC_CACHE, LC_NEW = 32704, 32768, 64  # a 32,704-token prompt in a 32,768-slot cache
LC_GATE_LAYERS = 2  # the prefill gate's depth: an fp32 copy beside the plain paths
LC_TIMED = 3        # timed prefills (the median), after a warm-up
# K10's cases: (name, B, Sq, K/V slots, Hq, Hkv, D, causal, q_offset, kv_len). Every
# one routes to K10 at the default budget; the first is the long-context path's call.
STREAM_CASES = (
    ("mistral_prefill", 1, LC_PROMPT, LC_CACHE, 32, 8, 128, True, 0, LC_PROMPT),
    ("ragged_offset", 2, 200, 16384, 32, 8, 128, True, 12900, (13100, 3)),
    ("noncausal", 1, 1000, 14000, 16, 4, 128, False, 0, None),
    ("d64", 1, 2048, 16384, 8, 2, 64, True, 14336, 16384),
    ("sq_tail", 1, 1001, 13056, 8, 8, 128, True, 12000, 13001),
)
K1_K10_SKV = (8192, 16384, 32768)  # K1 against K10 on the prefill call (Sq = Skv - 64)
K13A_S = 16384  # the training-shaped call where K10's lse meets K13a's
# K10 rounds q and p to bf16 as K1 does, against a running max, in 64-key
# tiles as its plain version does: K1's limit. Its lse is fp32 throughout
# (the scores' sums in another order, exp as exp2): 1e-4, as K13a's.
TOL.update({"flash_attention_stream": TOL["flash_attention"],
            "flash_attention_stream_lse": (1e-4, 0.0),
            "flash_attention_lse": TOL["flash_attention"], "flash_attention_lse_lse": (1e-4, 0.0)})
# A row that sees n keys of these random inputs averages them nearly alike,
# so |o| falls to about sqrt(e / n), 0.009 at 32K keys, and K1's limit is
# twice a typical value there: a V tile read from the wrong ring slot, or a
# bad PV product deep in the stream, moves o by about 1e-3 and would pass
# it. So each query row (the D values of one (b, s, h)) is also held to its
# own size: the RMS of kernel - plain within 1e-2 of the plain row's RMS
# (kernel and plain differ by a flipped bf16 rounding, 2^-8 of one value;
# one interior tile of 64 keys wrong moves a row by about sqrt(128 / n),
# 0.06-0.09 at 16K-32K keys), and a row with no key must be zero.
ROW_REL_RMS["flash_attention_stream"] = 1e-2
# The depth controls: the V tile at each key taken from the tile before,
# seen by the rows past 16K and, more faintly, by the last 2K rows alone.
STALE_KEYS = (16384, 30720)


def stale_tile(t, at):
    """t ([B, S, H, D]) with the 64 rows at ``at`` replaced by the 64 before
    them: a tile read from a stale ring slot (K10's V; K13b's K and V; K13c's
    q and dO)."""
    t = t.clone()
    t[:, at:at + 64] = t[:, at - 64:at]
    return t


def attention_inputs(gen, B, Sq, Skv, Hq, Hkv, D):
    def r(*shape):
        return torch.randn(*shape, generator=gen, device=gen.device).to(torch.bfloat16)

    return r(B, Sq, Hq, D), r(B, Skv, Hkv, D), r(B, Skv, Hkv, D)


def stream_kw(causal, q_offset, kv_len, dev):
    if isinstance(kv_len, tuple):
        kv_len = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    return dict(causal=causal, q_offset=q_offset, kv_len=kv_len)


def sdpa_flash(q, k, v, n):
    """aten._scaled_dot_product_flash_attention over the first n keys (causal,
    Sq == n), K/V repeated to the query heads: its (o, logsumexp) call."""
    Hq, Hkv = q.shape[2], k.shape[2]
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (t[:, :n].transpose(1, 2).repeat_interleave(Hq // Hkv, dim=1).contiguous()
              for t in (k, v))
    return lambda i: torch.ops.aten._scaled_dot_product_flash_attention(qt, kt, vt, 0.0, True)


def flash_stream_phase(dev, seed, fa, fg):
    """K10 (``ops/flash_attention.py::flash_attention_stream``) against its
    plain version on the card at STREAM_CASES, through ``flash_attention``'s
    route (each case must take K10 and not K1), both instances (o; o and
    lse), o within K1's limit and each row within ROW_REL_RMS; the lse also
    against K13a's at S 16,384; failing the plain version one key short
    (ragged_offset, whose second sequence sees 3 keys), with q_offset one
    off (mistral_prefill: the interior/edge boundary moves and row 0 loses
    its key), with one interior V tile stale (mistral_prefill: STALE_KEYS,
    rows past 16K or 30K) and all-ones V; the same bits twice. K1's new lse
    instance (kv_len, q_offset) against its plain version. Times: K10 at the
    long-context call beside its plain version, SDPA's flash forward and the
    bound; K1 and K10 at Skv 8,192, 16,384 and 32,768. Returns the kernels
    line's rows (K10, K1's lse instance)."""
    gen = torch.Generator(device=dev).manual_seed(seed + 17)
    checks = {}
    row = None
    for name, Bc, Sq, Skv, Hq, Hkv, D, causal, qoff, kvl in STREAM_CASES:
        if not fa.stream_route(Skv, D, 2):
            raise AssertionError(f"flash_stream {name}: the call does not route to K10")
        q, k, v = attention_inputs(gen, Bc, Sq, Skv, Hq, Hkv, D)
        kw = stream_kw(causal, qoff, kvl, dev)
        fa.flash_attention.launches = fa.flash_attention_stream.launches = 0
        o = fa.flash_attention(q, k, v, **kw)
        o_s, lse = fa.flash_attention(q, k, v, return_stats=True, **kw)
        if (fa.flash_attention_stream.launches, fa.flash_attention.launches) != (2, 0):
            raise AssertionError(f"flash_stream {name}: K10 {fa.flash_attention_stream.launches} "
                                 f"and K1 {fa.flash_attention.launches} launches, not 2 and 0")
        o_p, lse_p = fa.flash_stream_plain(q, k, v, return_stats=True, **kw)
        res = dict(o=check_close("flash_attention_stream", o, o_p), row_rel_rms=row_rel_rms(o, o_p),
                   o_lse_instance=check_close("flash_attention_stream", o_s, o_p),
                   lse=check_close("flash_attention_stream_lse", lse, lse_p))
        if name == "mistral_prefill":
            again = fa.flash_attention_stream(q, k, v, **kw)
            if not torch.equal(again, o):
                raise AssertionError("flash_stream: two launches gave different bits")
            res["same_bits_twice"] = True
            o_off = fa.flash_stream_plain(q, k, v, **dict(kw, q_offset=qoff - 1))
            res["q_offset_one_off_max_abs_err"] = must_fail_within(
                "flash_attention_stream", "against the plain version with q_offset one off", o,
                o_off)
            del again, o_off
            res["stale_v_tile"] = depth_control(fa, o, q, k, v, kw)
            pairs = Bc * causal_pairs(Sq, kvl, causal, qoff)
            nbytes = 2 * (2 * q.numel() + 2 * Bc * kvl * Hkv * D)  # q, out, the valid K/V rows
            b_ms, b_by = bound(nbytes, 4 * Hq * D * pairs, BF16_TENSOR_FLOPS)
            lb_ms, lb_by = bound(nbytes + 4 * Bc * Hq * Sq, 4 * Hq * D * pairs, BF16_TENSOR_FLOPS)
            ms = time_ms(lambda i: fa.flash_attention_stream(q, k, v, **kw), 5, warmup=2)[0]
            row = dict(
                name="flash_attention_stream", route="cuda",
                source="mlio_tpu_torch/csrc/flash_stream.cu",
                replaces="mlio_tpu/ops/flash_attention.py:323 (pallas_call :657)",
                shape=f"q [{Bc},{Sq},{Hq},{D}] k/v [{Bc},{Skv},{Hkv},{D}] bf16, kv_len {kvl}, "
                      "causal (Mistral-7B-Instruct-v0.2's prefill at 32K)",
                max_abs_err=res["o"], atol=TOL["flash_attention_stream"][0],
                rtol=TOL["flash_attention_stream"][1], ms=ms, kernel_ms=ms,
                plain_ms=time_ms(lambda i: fa.flash_stream_plain(q, k, v, **kw), 1, warmup=1)[0],
                library_ms=time_ms(sdpa_flash(q, k, v, kvl), 5, warmup=2)[0],
                library_note="aten._scaled_dot_product_flash_attention (o and logsumexp) over "
                             "the kv_len valid keys, K/V repeated to the query heads outside "
                             "the timing",
                bound_ms=b_ms, bound_by=b_by, pairs=pairs,
                lse=dict(max_abs_err=res["lse"], atol=TOL["flash_attention_stream_lse"][0],
                         ms=time_ms(lambda i: fa.flash_attention_stream(
                             q, k, v, return_stats=True, **kw), 5, warmup=2)[0],
                         bound_ms=lb_ms, bound_by=lb_by))
        elif name == "ragged_offset":  # the second sequence sees keys 0, 1, 2
            short = tuple(n - 1 for n in kvl)
            res["one_key_short_max_abs_err"] = must_fail_within(
                "flash_attention_stream", "against the plain version one key short", o,
                fa.flash_stream_plain(q, k, v, **stream_kw(causal, qoff, short, dev)))
        elif name == "sq_tail":
            res["ones_v_max_abs_err"] = must_fail_within(
                "flash_attention_stream", "with all-ones V",
                fa.flash_attention(q, k, torch.ones_like(v), **kw), o_p)
        checks[name] = res
        del q, k, v, o, o_s, lse, o_p, lse_p
        torch.cuda.empty_cache()

    # K10's lse against K13a's (training-shaped: no kv_len)
    q, k, v = attention_inputs(gen, 1, K13A_S, K13A_S, 32, 8, 128)
    o, lse = fa.flash_attention(q, k, v, return_stats=True)
    o13, lse13 = fg.flash_fwd_lse(q, k, v)
    checks[f"vs_k13a_s{K13A_S}"] = dict(o=check_close("flash_attention_stream", o, o13),
                                    lse=check_close("flash_attention_stream_lse", lse, lse13))
    del q, k, v, o, lse, o13, lse13

    # K1 against K10 on the prefill call: Sq = Skv - 64 = kv_len, causal
    versus = {}
    for skv in K1_K10_SKV:
        q, k, v = attention_inputs(gen, 1, skv - 64, skv, 32, 8, 128)
        kw = dict(kv_len=skv - 64)
        versus[str(skv)] = dict(
            routed="k10" if fa.stream_route(skv, 128, 2) else "k1",
            k1_ms=time_ms(lambda i: fa.flash_attention(q, k, v, kv_vmem_budget=1 << 62, **kw),
                          3, warmup=1)[0],
            k10_ms=time_ms(lambda i: fa.flash_attention(q, k, v, kv_vmem_budget=0, **kw),
                           3, warmup=1)[0],
            sdpa_ms=time_ms(sdpa_flash(q, k, v, skv - 64), 3, warmup=1)[0])
        del q, k, v
    row["k1_vs_k10"] = versus
    emit(dict(phase="flash_stream", checks=checks, k1_vs_k10=versus))
    return [row, k1_lse_row(fa, dev, seed)]


def depth_control(fa, o, q, k, v, kw):
    """K10's output o must fail its check against the plain version with
    one interior V tile stale (stale_tile), a fault only rows past the
    tile see, at each of STALE_KEYS. Returns, by key, the control's max-abs,
    its largest row_rel_rms, and whether K1's elementwise limit alone would
    have passed it."""
    out = {}
    for key in STALE_KEYS:
        o_bad = fa.flash_stream_plain(q, k, stale_tile(v, key), **kw)
        err = must_fail_within("flash_attention_stream",
                               f"against the plain version with the V tile at key {key} stale",
                               o, o_bad)
        out[str(key)] = dict(max_abs_err=err, row_rel_rms=row_rel_rms(o, o_bad),
                             within_k1_limit=within("flash_attention", o, o_bad, rows=False)[0])
        del o_bad
    return out


def k1_lse_row(fa, dev, seed):
    """K1's lse instance (``flash_attention(..., return_stats=True)`` below
    the K10 threshold) at GPT-2 small's prefill (8 x 704 queries into a
    1024-slot cache, 12 heads of 64) and at a ragged call with q_offset
    (B 2, 8/2 heads of 128), against its plain version: o, and lse within
    1e-4; failing the plain version one key short; timed at GPT-2's."""
    gen = torch.Generator(device=dev).manual_seed(seed + 19)
    q, k, v = attention_inputs(gen, 2, 100, 256, 8, 2, 128)
    kw = stream_kw(True, 37, (137, 3), dev)
    o, lse = fa.flash_attention(q, k, v, return_stats=True, **kw)
    o_p, lse_p = fa.flash_plain_lse(q, k, v, **kw)
    ragged = dict(o=check_close("flash_attention_lse", o, o_p),
                  lse=check_close("flash_attention_lse_lse", lse, lse_p))
    ragged["one_key_short_max_abs_err"] = must_fail_within(
        "flash_attention_lse", "against the plain version one key short", o,
        fa.flash_plain_lse(q, k, v, **stream_kw(True, 37, (136, 2), dev))[0])
    q, k, v = attention_inputs(gen, B, PROMPT, CACHE, 12, 12, 64)
    kw = dict(causal=True, q_offset=0, kv_len=PROMPT)
    o, lse = fa.flash_attention(q, k, v, return_stats=True, **kw)
    o_p, lse_p = fa.flash_plain_lse(q, k, v, **kw)
    errs = dict(o=check_close("flash_attention_lse", o, o_p),
                lse=check_close("flash_attention_lse_lse", lse, lse_p))
    pairs = B * causal_pairs(PROMPT, PROMPT, True)
    b_ms, b_by = bound(2 * (2 * q.numel() + 2 * B * PROMPT * 12 * 64) + 4 * B * 12 * PROMPT,
                       4 * 12 * 64 * pairs, BF16_TENSOR_FLOPS)
    return dict(
        name="flash_attention_lse", route="cuda",
        source="mlio_tpu_torch/csrc/flash_fwd.cu (flash_fwd.cuh, kLse: mlio_flash_fwd_stats)",
        replaces="mlio_tpu/ops/flash_attention.py:37 (return_stats, :531-535, :889-893)",
        shape=f"q [{B},{PROMPT},12,64] k/v [{B},{CACHE},12,64] bf16, kv_len {PROMPT}",
        max_abs_err=errs["o"], lse_max_abs_err=errs["lse"], atol=TOL["flash_attention_lse"][0],
        rtol=TOL["flash_attention_lse"][1], lse_atol=TOL["flash_attention_lse_lse"][0],
        ragged_q_offset=ragged,
        **timings(lambda i: fa.flash_attention(q, k, v, return_stats=True, **kw),
                  lambda i: fa.flash_plain_lse(q, k, v, **kw), sdpa_flash(q, k, v, PROMPT), 50),
        library_note="aten._scaled_dot_product_flash_attention (o and logsumexp) over the "
                     "kv_len valid keys",
        bound_ms=b_ms, bound_by=b_by)


def lc_positions():
    """The logits the prefill gate compares: positions 0-15 (rows that attend
    over few keys, where attention moves the logits most) and 64 spread over
    the prompt, the last among them."""
    spread = np.linspace(0, LC_PROMPT - 1, 64).round().astype(int).tolist()
    return sorted(set(range(16)) | set(spread))


def lc_prefill(spec, params, ids, impl, dtype, dev, positions=None):
    """A cached prefill of ids into a LC_CACHE-slot cache of ``dtype``:
    (logits, at ``positions`` when given, in fp32; the cache)."""
    from mlio_tpu_torch.models import forward
    from mlio_tpu_torch.runtime import init_cache

    cache = init_cache(spec, ids.shape[0], LC_CACHE, dtype=dtype, device=dev)
    with torch.inference_mode():
        logits, cache = forward(params, spec, ids, impl=impl, cache=cache)
    if positions is not None:
        logits = logits[0, positions].float()
    return logits, cache


def lc_gate(dev, seed, spec, ids, fa, norms, dt):
    """The prefill gate at LC_GATE_LAYERS layers, full width and the whole
    32,704-token context: the kernel path's logits at lc_positions() as far
    from an fp32 path (fp32 weights, activations and cache, K10's and K2's
    plain versions) as the bf16 plain path (K10's and K2's plain versions),
    within LOGITS_8B_OVER_PLAIN in max-abs and RMS; a control (K10 with the
    causal frontier one key short: q_offset - 1) must fail it, and so must
    a fault at depth (K10 with the V tile at key 16,384 stale: only rows past
    16K see it). K10's last call of the kernel prefill, on the model's own
    q, K and V, is held against its plain version (K1's limit and
    ROW_REL_RMS), and both depth controls must fail there. Then K6 at the context
    the prefill leaves (pos 32,704 in the 32,768-slot cache) against its
    plain version at these 2 layers."""
    from mlio_tpu_torch.models import Impl, init_params, rope_cos_sin

    spec2 = dataclasses.replace(spec, num_layers=LC_GATE_LAYERS)
    params = init_params(spec2, torch.Generator(device=dev).manual_seed(seed + 1),
                         dtype=torch.bfloat16, device=dev)
    impl = Impl(attention="flash", norm="fused")
    pos = lc_positions()
    real = fa.flash_attention_stream
    seen = {}

    def recording(q, k, v, **kw):  # keeps the last layer's call
        o = real(q, k, v, **kw)
        seen.update(q=q, k=k.clone(), v=v.clone(), kw=kw, o=o)
        return o

    recording.launches = 0
    fa.flash_attention.launches = 0
    with patched(fa, "flash_attention_stream", recording):
        got, cache = lc_prefill(spec2, params, ids, impl, torch.bfloat16, dev, pos)
    launches = dict(flash_attention_stream=recording.launches,  # K10 counts under its name
                    flash_attention=fa.flash_attention.launches)
    if launches != dict(flash_attention_stream=LC_GATE_LAYERS, flash_attention=0):
        raise AssertionError(f"long_context gate: launches {launches}")
    with plain_kernels(fa, norms):
        plain = lc_prefill(spec2, params, ids, impl, torch.bfloat16, dev, pos)[0]
        p32 = {k: ({n: (t.float() if t is not None else None) for n, t in v.items()}
                   if isinstance(v, dict) else (v.float() if v is not None else None))
               for k, v in params.items()}
        ref = lc_prefill(spec2, p32, ids, impl, torch.float32, dev, pos)[0]
        del p32

    def frontier_short(q, k, v, **kw):
        return real(q, k, v, **dict(kw, q_offset=kw.get("q_offset", 0) - 1))

    def stale_v(q, k, v, **kw):
        return real(q, k, stale_tile(v, STALE_KEYS[0]), **kw)

    frontier_short.launches = stale_v.launches = 0
    with patched(fa, "flash_attention_stream", frontier_short):
        control = lc_prefill(spec2, params, ids, impl, torch.bfloat16, dev, pos)[0]
    with patched(fa, "flash_attention_stream", stale_v):
        depth = lc_prefill(spec2, params, ids, impl, torch.bfloat16, dev, pos)[0]
    errs = dict(kernels_vs_fp32=logit_errors(got, ref), plain_vs_fp32=logit_errors(plain, ref),
                control_vs_fp32=logit_errors(control, ref),
                depth_control_vs_fp32=logit_errors(depth, ref),
                kernels_vs_plain=logit_errors(got, plain),
                depth_control_vs_kernels=logit_errors(depth, got))

    def passes(path):
        return all(errs[path][s] <= LOGITS_8B_OVER_PLAIN * errs["plain_vs_fp32"][s]
                   for s in ("max_abs", "rms"))

    gate = dict(layers=LC_GATE_LAYERS, positions=len(pos), logits=errs,
                over_plain=LOGITS_8B_OVER_PLAIN, passed=passes("kernels_vs_fp32"),
                control="K10 with the causal frontier one key short (q_offset - 1)",
                control_rejected=not passes("control_vs_fp32"),
                depth_control=f"K10 with the V tile at key {STALE_KEYS[0]} stale",
                depth_control_rejected=not passes("depth_control_vs_fp32"), launches=launches)
    del got, plain, ref, control, depth
    with torch.inference_mode():
        q, k, v, kw, o = (seen[n] for n in ("q", "k", "v", "kw", "o"))
        o_p = fa.flash_stream_plain(q, k, v, **kw)
        gate["k10_in_path"] = dict(layer=LC_GATE_LAYERS - 1,
                                   o=check_close("flash_attention_stream", o, o_p),
                                   row_rel_rms=row_rel_rms(o, o_p),
                                   stale_v_tile=depth_control(fa, o, q, k, v, kw))
    del seen, q, k, v, o, o_p
    torch.cuda.empty_cache()
    # K6 one decode step at the context the prefill left, 2 layers
    x = params["tok_embed"][ids[:, -1]]
    cos, sin = rope_cos_sin(torch.arange(LC_PROMPT, LC_PROMPT + 1, device=dev), spec.rope_dim,
                            spec.rope_theta)
    gate["k6_ctx32k"] = tiled_check(dt, spec2, params["blocks"], x, cache["k"], cache["v"],
                                    LC_PROMPT, cos, sin)[2]
    del params, cache
    torch.cuda.empty_cache()
    return gate


def long_context_phase(dev, seed, fa, norms, dt, wrappers):
    """The long-context slice's path: Mistral-7B-Instruct-v0.2 at full width
    and depth (spec_from_hf_config of MISTRAL_CONFIG), random bf16 weights
    from the seed drawn on the card, B 1, a LC_PROMPT-token prompt into a
    LC_CACHE-slot cache, 64 greedy tokens through ``generate`` with
    Impl(attention="flash", norm="fused"): the launch counters around it (K10
    a layer and no K1 in the prefill, the decode on the route "auto" names);
    the prefill by CUDA events (median of LC_TIMED after a warm-up), its idle
    share and K10's share from a torch.profiler trace; a decode step at the
    context the prompt leaves; peak memory, beside what was allocated before
    the generate (the weights and what earlier phases still hold). Then the
    prefill gate (lc_gate).
    Returns the launch counts."""
    from torch.profiler import ProfilerActivity, profile

    from mlio_tpu_torch.models import Impl, forward, init_params, spec_from_hf_config
    from mlio_tpu_torch.models.transformer import decode_route
    from mlio_tpu_torch.runtime import generate

    spec = spec_from_hf_config(MISTRAL_CONFIG, name="mistral-7b-instruct-v0.2")
    L = spec.num_layers
    ids = torch.from_numpy(np.random.default_rng(seed).integers(
        0, spec.vocab_size, (1, LC_PROMPT))).to(dev)
    impl = Impl(attention="flash", norm="fused")
    gate = lc_gate(dev, seed, spec, ids, fa, norms, dt)
    emit(dict(phase="long_context_gate", **gate))
    if not (gate["passed"] and gate["control_rejected"] and gate["depth_control_rejected"]):
        raise AssertionError(f"long_context: the prefill gate {gate}")

    params = init_params(spec, torch.Generator(device=dev).manual_seed(seed),
                         dtype=torch.bfloat16, device=dev)
    picked = decode_route(spec, impl, params["blocks"], 1, smax=LC_CACHE,
                          on_card=dev.type == "cuda")

    def run(new_tokens):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = generate(params, spec, ids, max_new_tokens=new_tokens, impl=impl,
                       cache_len=LC_CACHE, device=dev)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()  # the weights, and what earlier phases still hold
    for w in wrappers:
        w.launches = 0
    out, _ = run(LC_NEW)
    peak = torch.cuda.max_memory_allocated()
    launches = {w.__name__: w.launches for w in wrappers}
    want = route_launches(picked, L, LC_NEW - 1, False)
    want.update(flash_attention=0, flash_attention_stream=L)
    if picked == "scan":
        want["decode_attention"] = L * (LC_NEW - 1)
        want["fused_norm"] += (2 * L + 1) * (LC_NEW - 1)
    want = {k: want.get(k, 0) for k in launches}
    if launches != want:
        raise AssertionError(f"long_context: launch counts {launches} != expected {want}")
    if out.shape != (1, LC_PROMPT + LC_NEW) or not torch.equal(out[:, :LC_PROMPT], ids) \
            or int(out.min()) < 0 or int(out.max()) >= spec.vocab_size:
        raise AssertionError("long_context: wrong shape, prompt changed or token out of range")

    # the decode step by the two-length marginal (1 and LC_NEW new tokens)
    generate_s = {str(n): run(n)[1] for n in (1, LC_NEW)}
    decode_step_ms = (generate_s[str(LC_NEW)] - generate_s["1"]) / (LC_NEW - 1) * 1e3
    # the prefill alone: one cache, rewritten by each run
    from mlio_tpu_torch.runtime import init_cache

    cache = init_cache(spec, 1, LC_CACHE, dtype=torch.bfloat16, device=dev)

    def prefill():
        with torch.inference_mode():
            return forward(params, spec, ids, impl=impl, cache=dict(cache, pos=0))

    logits = prefill()[0]
    if logits.shape != (1, LC_PROMPT, spec.vocab_size) or logits.dtype != torch.bfloat16 \
            or not torch.isfinite(logits).all():
        raise AssertionError(f"long_context: prefill logits {logits.dtype} "
                             f"{tuple(logits.shape)} or not finite")
    del logits
    walls = []
    for _ in range(LC_TIMED):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        logits = prefill()[0]
        end.record()
        end.synchronize()
        walls.append(start.elapsed_time(end))
        del logits
    prefill_ms = float(np.median(walls))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        prefill()
        end.record()
        torch.cuda.synchronize()
    traced_ms = start.elapsed_time(end)  # the traced prefill's own span
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = busy_ms(events)
    k10_ms = sum(e.time_range.end - e.time_range.start for e in events
                 if "flash_stream" in e.name) / 1e3
    if not busy or not k10_ms:
        raise AssertionError("long_context: the profiler saw no device time, or none in K10")
    # a decode step at the context the prompt leaves, rewriting one slot
    tok = out[:, LC_PROMPT:LC_PROMPT + 1]
    with torch.inference_mode():
        step_dev_ms = time_ms(lambda i: forward(params, spec, tok, impl=impl,
                                                cache=dict(cache, pos=LC_PROMPT)), 3)[0]
    result = dict(phase="long_context", model=spec.name, config=MISTRAL_CONFIG, layers=L,
                  batch=1, prompt=LC_PROMPT, cache_len=LC_CACHE, new_tokens=LC_NEW,
                  auto_route=picked, launches=launches, generate_s=generate_s,
                  prefill_ms=prefill_ms, prefill_ms_runs=walls,
                  prefill_tok_per_s=LC_PROMPT / (prefill_ms / 1e3),
                  prefill_traced_ms=traced_ms, prefill_device_busy_ms=busy,
                  prefill_idle_share=1 - busy / traced_ms,
                  prefill_k10_ms=k10_ms, prefill_k10_share=k10_ms / busy,
                  decode_ctx=LC_PROMPT, decode_step_ms=decode_step_ms,
                  decode_step_device_ms=step_dev_ms, peak_bytes=peak,
                  allocated_before_bytes=before,
                  params_bytes=sum(t.numel() * t.element_size()
                                   for _, t in _named_leaves(params)))
    emit(result)
    del params, cache, out
    torch.cuda.empty_cache()
    return launches



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
    from mlio_tpu_torch.ops import decode_tiled as dt
    from mlio_tpu_torch.ops import flash_attention as fa
    from mlio_tpu_torch.ops import flash_attention_grad as fg
    from mlio_tpu_torch.ops import fused_mlp as fm
    from mlio_tpu_torch.ops import ln_qkv as lq
    from mlio_tpu_torch.ops import norms
    from mlio_tpu_torch.ops import paged_attention as pa
    from mlio_tpu_torch.ops import quant as qm
    from mlio_tpu_torch.models import get_spec

    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    emit(dict(phase="device", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
              count=torch.cuda.device_count(), torch=torch.__version__,
              cuda=torch.version.cuda))
    emit(dict(phase="build", seconds=_build.build_all(), ptxas=_build.ptxas_summary()))
    probe_rows = bandwidth_phase(dev, args.seed)

    rng = np.random.default_rng(args.seed)
    rows = kernel_phase(rng, dev, args.seed, fa, norms, da, dl)
    rows += paged_rows(pa, dps, dev, args.seed)
    rows += gemm_rows(dev, args.seed, fm, lq, qm)
    emit(dict(phase="kernels", checked=[r["name"] for r in rows]))
    variant_phase(rng, dev, args.seed, fa, norms, da, dl, pa, dps, fm, lq, qm, dt)
    launches = generate_phase(dev, args.seed, fa, norms, da, dl, qm)
    scan_launches = generate_phase(dev, args.seed, fa, norms, da, dl, qm, decode_stack="scan")
    int8_launches = generate_phase(dev, args.seed, fa, norms, da, dl, qm, int8=True)
    int8_scan_launches = generate_phase(dev, args.seed, fa, norms, da, dl, qm,
                                        decode_stack="scan", int8=True)
    generate_phase(dev, args.seed, fa, norms, da, dl, qm, decode_stack="tiled", dt=dt)
    wrappers = (fa.flash_attention, norms.fused_norm, da.decode_attention, dl.decode_layer_stack,
                pa.paged_attention, dps.decode_paged_stack)
    gen_tok_s = generate_tok_s(dev, args.seed)
    served = engine_phase(dev, args.seed, wrappers, gen_tok_s)
    served8 = engine_phase(dev, args.seed, wrappers + (fa.flash_attention_kvq, qm.quant_matmul),
                           gen_tok_s, int8=True)
    if served8["mega"]["paged_attention"]:
        raise AssertionError("engine_int8: K7 launched on the K8 path")
    ran = runner_phase(dev, args.seed, wrappers + (fm.fused_mlp, lq.fused_norm_matmul,
                                                   qm.quant_matmul), (fa, norms, da, fm, lq, qm))
    # The tiled slice: K6 at llama3-8b's full width and depth, then its path.
    torch.cuda.empty_cache()
    spec8, weights8 = llama_weights(dev, args.seed)
    tiled = tiled_row(dt, dl, dev, args.seed, spec8, weights8)
    emit(dict(phase="tiled", **tiled))
    del weights8["fp8"]  # no later phase runs fp8 weights
    torch.cuda.empty_cache()
    ran8 = generate_8b_phase(dev, args.seed, spec8, weights8,
                             (fa.flash_attention, fa.flash_attention_kvq, norms.fused_norm,
                              qm.quant_matmul, da.decode_attention, dl.decode_layer_stack,
                              dt.decode_layer_tiled), fa, norms, da, qm, dt, dl)
    del weights8
    torch.cuda.empty_cache()
    # The MoE slice: K15, then Mixtral-8x7B through K6's MoE phases.
    widen = widen_phase(dev, args.seed)
    specm = get_spec(MIXTRAL)
    small = moe_small_variants(dt, dev, args.seed, specm)
    paramsm, build = mixtral_weights(dev, args.seed, specm)
    tiled_moe = tiled_moe_row(dt, dev, args.seed, specm, paramsm, small)
    emit(dict(phase="tiled_moe", **tiled_moe))
    ranm = generate_moe_phase(dev, args.seed, specm, paramsm, build,
                              (fa.flash_attention, fa.flash_attention_kvq, norms.fused_norm,
                               qm.quant_matmul, da.decode_attention, dl.decode_layer_stack,
                               dt.decode_layer_tiled), fa, norms, da, qm, dt)
    del paramsm
    torch.cuda.empty_cache()
    rule_phase(dev, args.seed, dt)
    f1 = f1_phase(dev, args.seed, (fa.flash_attention, norms.fused_norm, da.decode_attention,
                                   dl.decode_layer_stack, dt.decode_layer_tiled,
                                   pa.paged_attention, dps.decode_paged_stack),
                  fa, norms, da, qm, dt, pa)
    # The training slice: K1's dropout instance and K13, then llama3-8b's step.
    grad_rows, k1_llama = flash_grad_phase(dev, args.seed, fa, fg)
    trained = train_8b_phase(dev, args.seed, fa, fg,
                             (fa.flash_attention, fg.flash_fwd_lse, fg.flash_bwd_dq,
                              fg.flash_bwd_dkv, norms.fused_norm, fm.fused_mlp,
                              lq.fused_norm_matmul, qm.quant_matmul, fa.flash_attention_kvq))
    # K5's three instances by the configurations that run them (one wrapper
    # launches all three)
    k5 = {"quant_matmul": ("int8_weights", "all"), "quant_matmul_int4": ("int4_per_channel",),
          "quant_matmul_int4_group": ("int4_weights",)}
    for r in rows:  # each kernel's launches on the path that runs it
        if r["name"] in k5:
            r["launches"] = sum(ran[c]["quant_matmul"] for c in k5[r["name"]])
        elif r["name"] in ("fused_mlp", "fused_norm_matmul"):
            r["launches"] = sum(c[r["name"]] for c in ran.values())
        elif r["name"] == "flash_attention_kvq":  # the README quick start's prefill
            r["launches"] = int8_launches[r["name"]]
        else:
            r["launches"] = (launches.get(r["name"]) or scan_launches.get(r["name"])
                             or served["mega"][r["name"]] or served["perop"][r["name"]])
        if not r["launches"]:
            raise AssertionError(f"{r['name']}: no launch on the path that runs it")
    # the int8 instances' launches on the quick start's paths: K4 in its
    # decode, K3 in its scan decode, K8 in the engine with int8 weights
    by_name = {r["name"]: r for r in rows}
    for entry, count in ((by_name["decode_layer_stack"]["int8"]["gpt2_w8kv8"],
                          int8_launches["decode_layer_stack"]),
                         (by_name["decode_attention"]["int8"],
                          int8_scan_launches["decode_attention"]),
                         (by_name["decode_paged_stack"]["int8_weights"],
                          served8["mega"]["decode_paged_stack"])):
        entry["launches"] = count
        if not count:
            raise AssertionError(f"{entry['shape']}: no launch on the path that runs it")
    # K6: the tiled route of generate_8b (bf16; the quick start's int8
    # weights over an INT8 cache); F1's batch-16 generate runs it too
    tiled["launches"] = ran8[("bf16", "tiled")]["decode_layer_tiled"]
    tiled["variants"]["w8kv8"]["launches"] = ran8[("int8", "tiled")]["decode_layer_tiled"]
    tiled["f1_batch16_launches"] = f1["decode_layer_tiled"]
    for v in ("w8", "fp8"):
        tiled["variants"][v]["launches"] = 0
        tiled["variants"][v]["launches_note"] = "no path of this run decodes with these weights"
    if not tiled["launches"] or not tiled["variants"]["w8kv8"]["launches"]:
        raise AssertionError("decode_layer_tiled: no launch on generate_8b's tiled route")
    # K6's MoE instances: generate_moe's tiled route (Mixtral, int8 weights,
    # INT8 cache); the 4-layer variants run on no path of this run
    tiled_moe["launches"] = ranm["decode_layer_tiled"]
    for v in tiled_moe["variants"].values():
        v["launches"] = 0
        v["launches_note"] = "checked at 4 layers; no path of this run decodes with these"
    if not tiled_moe["launches"] or not widen["launches"]:
        raise AssertionError("decode_layer_tiled (MoE) or widen_matmul: no launch on its path")
    # K1 at llama3-8b's attention: train_8b's forwards; K13's rows: their
    # launches in train_8b's steps (one backward a layer a step runs each
    # once); K1's dropout instance runs on no path of this run
    by_name["flash_attention"]["llama3_8b"] = dict(k1_llama,
                                                   launches=trained["flash_attention"])
    for r in grad_rows:
        if r["name"] == "flash_attention_dropout":
            r["launches"] = 0
            r["launches_note"] = ("train_8b's forward takes no attention dropout, as the JAX "
                                  "package's training step; launched in flash_grad only")
        else:
            r["launches"] = trained[r["name"]]
            if r["name"] == "flash_attention_backward":
                r["launches_note"] = ("attention backward calls in train_8b, each launching "
                                      "K13a, K13b and K13c once")
            if not r["launches"]:
                raise AssertionError(f"{r['name']}: no launch on train_8b's path")
    # The long-context slice: K10 alone, then Mistral-7B-Instruct-v0.2 at 32K.
    stream_rows = flash_stream_phase(dev, args.seed, fa, fg)
    long_launches = long_context_phase(dev, args.seed, fa, norms, dt,
                                       (fa.flash_attention, fa.flash_attention_stream,
                                        norms.fused_norm, da.decode_attention,
                                        dl.decode_layer_stack, dt.decode_layer_tiled))
    stream_rows[0]["launches"] = long_launches["flash_attention_stream"]
    stream_rows[0]["lse"]["launches"] = 0
    stream_rows[0]["lse"]["launches_note"] = ("no path of this run asks for the lse; "
                                              "launched in flash_stream only")
    stream_rows[1]["launches"] = 0
    stream_rows[1]["launches_note"] = ("no path of this run asks for K1's lse; launched in "
                                       "flash_stream only")
    if not stream_rows[0]["launches"]:
        raise AssertionError("flash_attention_stream: no launch on long_context's path")
    rows += [tiled, tiled_moe, widen] + grad_rows + stream_rows + probe_rows
    for r in rows:  # every bound beside the one at the spec sheet's rate
        if r.get("bound_by") == "bytes":
            r["bound_ms_spec_sheet"] = r["bound_ms"] * HBM_BYTES_PER_S / SPEC_BYTES_PER_S
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
