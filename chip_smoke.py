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
   checks are shown to catch a context one token short. K3 splits each
   sequence's context across a cluster of blocks: its row gives the split
   (n_split, chunk), the same bits in two launches, contexts on and one slot
   past the chunk edges, at 1 and at 0 (at GPT-2's shape and a grouped one),
   and a row at Mistral-7B-Instruct-v0.2's decode over its 32K cache. K4
   is also held against its plain version over 8 in-kernel steps. K7 and K8 run over the
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
   out of attention at every layer, and (bf16) with one 64-row tile of wq
   set to inf; two runs must give the same bits (bf16, int8 + INT8 cache);
   device ms beside the plain version's, the bound, K4's at the
   same shapes, the phase durations with each GEMV phase's GB/s; the card's
   own GEMV item plan held against ``decode_tiled.item_plan`` (the mirror
   the CPU tests hold), and every K6 instance's registers and spills.
9. generate_8b: the slice's path, llama3-8b (32 layers), B 8, a 704-token
   prompt, a 1024-slot cache, greedy, bf16 weights and then the README quick
   start (int8 weights, ``cache_quant="int8"``): prefill logits held against
   an fp32 path, no farther from it than the bf16 plain path (within 5 %, in
   max-abs and RMS); decode_stack "auto", "tiled" (K6: 63 launches, no K4, no
   K3) and "mega" (K4, a launch a token) with launch counters, the decode
   step by the two-length marginal, tok/s, a step's device ms, the idle
   share, and the K4-or-K6 rule's pick beside both times.
9b. widen: K15 (``utils/fp8_convert.py``), the weight-widening probe: its
   four widenings (int8; fp8 by the e4m3x2 convert; fp8 through
   fp32; fp8 by bit assembly) over a seeded 1 GB slab (256 chunks of 2048 x
   2048), each held against its plain version, failing over 255 of the 256
   chunks and with one chunk's bytes changed, then timed by the two-length
   marginal (2 and 6 passes) beside K14's rate and its bound.
9c. tiled_moe: K6's MoE phases (the router in the kernel, the experts some
   row picks weighted by the rows' routing weights) at Mixtral's widths, 4
   layers, bf16, fp8 and int8 (INT8 cache) weights, B 1, 8 and 32 (fp8 at
   B 8 must fail with one 64-row tile of a picked expert's w_down NaN);
   then at full depth (32 layers), int8 weights drawn on the card
   (``init_quantized_params``: the build's peak must show no wider copy)
   and an INT8 cache, B 8, ctx 896. Each against the plain version that
   follows the kernel's expert picks, the routing itself held by ROUTE_TOL;
   the full-depth x_out must fail with each row's second expert dropped,
   and a context one token short must fail; two runs must give the same
   bits, an unpicked expert's int8 weights all 127 and scales 1e30 must
   leave them as they are, and a 64-row tile of a picked expert's w_down at
   127 must change them; device ms, the bound (the experts this run's rows
   pick, and all of them), the phase durations with each GEMV phase's GB/s.
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
   its plain version (``flash_stream_plain``, K/V streamed in 128-key blocks)
   at Mistral-7B-Instruct-v0.2's prefill (B 1, 32,704 queries over a
   32,768-slot cache, 32/8 heads of 128), a ragged B 2 with a decode-style
   q_offset, a non-causal call, head dim 64 and a ragged Sq tail; o and the
   lse (within 1e-4; also against K13a's at S 16,384); o within K1's limit
   and each query row within 1e-2 of its own RMS (ROW_REL_RMS: a row over
   32K keys has |o| near 0.009); failing the plain version one key short,
   with q_offset one off, with one interior V tile stale (rows past 16K or
   30K), and all-ones V; the same
   bits twice; timed (and its TFLOP/s) beside the plain version, SDPA's
   flash forward and the bound, and against K1 at 8K, 16K and 32K keys. K1's new lse instance
   (kv_len, q_offset) against its plain version.
13b. masks: K1 with user masks (``flash_attention(..., mask=)``): key masks
   (left padding of 0..200 tokens a row; random holes, key 0 kept) at
   llama3-8b's attention heads (B 8 x 704, 32/8 heads of 128, causal) and
   at GPT-2 small's prefill heads (D 64, left padding), a key and a 3-D mask
   at an odd Skv (B 2 x 703, llama3-8b's heads, holes, causal: K1's
   byte-by-byte reads at D 128), a
   3-D prefix-LM mask at GPT-2 small's prefill (not causal) and a 4-D
   per-head mask at llama3-8b's training attention (B 1 x 2,048; the lse
   too); K9 with a key mask and the lse at generate_moe's shape (8 x 704
   over a 1,024-slot INT8 cache; a full mask must raise); K1's lse under
   dropout 0.1 at llama3-8b's training attention (the same bits twice, as
   K13a's forward). Each against its plain version (o within K1's limit and
   each row within 2e-2 of its RMS, the lse within 1e-4 with -inf where a
   row sees no key), each failing a control (one key of a row that sees it
   alone flipped; the dropout seed one off), each through an entry point a
   user calls with the launch counters zeroed around it; the key-mask, K9
   and dropout rows the same bits with q, K/V and out in the bhsd layout;
   timed beside the plain version, SDPA with the boolean mask (over K/V
   dequantized to bf16 for K9; SDPA's flash forward with dropout for the
   last) and the bound. Then K1 with a key mask at Mistral's 32K prefill
   call (K1, no K10; its first, a middle and its last 64-row q block against
   the plain version of those rows) and ring attention's chunk_step_flash
   there: 8,192-key chunks (K1's lse, later chunks at negative relative
   offsets) and 16,384-key chunks (K10's lse) merged and held against one
   K10 call, failing with the last chunk left out.
14. long_context: the long-context slice's path, Mistral-7B-Instruct-v0.2
   (``spec_from_hf_config`` of its published config's values) at full
   width and depth, random bf16 weights from the seed, B 1, a 32,704-token
   prompt into a 32,768-slot cache, 64 greedy tokens through ``generate``
   with ``Impl(attention="flash", norm="fused")``: launch counters (K10 32
   and no K1 in the prefill; the decode on the route "auto" names), the
   prefill (median of 3 by CUDA events, idle share, K10's share and its ms
   a layer from a torch.profiler trace), a decode step at context 32,704, peak memory;
   then the same generate with ``Impl(attention="ring", norm="fused")``:
   the same launches (K10 32 in its prefill), the same prefill logits and
   64 tokens bit for bit (its single-device fold is the flash route's call).
   First its prefill gate at 2 layers and the full context: the kernel
   path's logits at 79 positions as far from an fp32 path as the bf16 plain
   path, within 5 %, two controls (K10 with the causal frontier one key
   short; K10 with the V tile at key 16,384 stale) failing it; K10's last
   call of that prefill against its plain version, the stale-tile controls
   failing; and K6 against its plain version at that context.
15. families: Gemma-7B (head dim 256) and Phi-2 (head dim 80). K1 at each
   one's prefill (B 8 x 704 into a 1024-slot cache, causal; 16 heads of
   256, 32 of 80), K3 at each one's decode (B 8, context 896, one query
   head a KV head) and K6 at gemma-7b's full width (2 layers, bf16), each
   against its plain version, failing a control (K/V keys 64-127 from a
   stale slot; a context one token short; four KV heads' query groups left
   out), the same bits twice (K3, K6), timed beside its plain version,
   SDPA (K1, K3) and the bound, with its registers and spills; the card's
   K6 plan at gemma-7b against the mirror. Then each model at full width
   and depth from ``load_model(name, seed=...)``, bf16, B 8, a 704-token
   prompt, a 1024-slot cache, 64 greedy tokens through ``generate``: the
   prefill logits held against an fp32 plain path (RMS as generate_8b
   holds it, max-abs within the plain path's plus FAMILY_MAX_SIGMAS of its
   RMS error), a control with K1's output rounded to e4m3 failing;
   gemma-7b on its route (K6: K1 28 in the prefill, K6 a step) and on
   "scan" (K3 28 a step), phi-2 on its route, the scan (K1 32, K3 32 a
   step); launch counters, step ms, tok/s, device ms, device-busy ms (a
   profiler trace of one step), idle share, peak memory. Then each model's HF checkpoint at full width and one layer
   (bf16 from the seed, config.json and safetensors written by this
   script under build/families) through ``load_model(dir)`` on the card:
   the spec and every parameter bit for bit; the directory deleted after.
16. speculative: speculative decoding at gpt2-medium's full width and
   depth, bf16, B 1, a 512-token prompt (a 64-token motif tiled 8 times), a
   1024-slot cache, 256 new tokens. First K1 at the verify windows (B 1, 16
   heads, Sq 2, 7 and 25 at q_offset 700, D 64; Sq 7 at D 128) and K4 at B
   1 at the draft model's 8 layers, each against its plain version with a
   control that must fail (kv_len one short; a context one token short),
   timed beside the plain version, SDPA with the boolean mask (K1) and the
   bound; then every drafting mode's ids against ``greedy_generate``'s on
   the fp32 plain route (``Impl()``) at B 1 and B 2, bit for bit. Then the
   legs through ``Impl(attention="flash", norm="fused")``: vanilla
   ``generate`` (K4), n-gram at gamma 6, the external stream (the n-gram
   leg's output) at draft_accept 1.0 / 0.75 / 0.5 with gamma 24 / 6 / 4,
   the draft model (the first 8 layers, gamma 4), self-speculation (gamma
   4), and the induction model (hidden 2048, 12 layers, period 32) under
   ``speculative_generate_auto`` against its vanilla generate: seconds,
   rounds, tokens a round, the speedup, agreement with vanilla's ids, the
   device-busy ms of a traced run and the idle share, the launches a round
   (each held to what the leg's rounds must launch).
17. engine_pipelined: the engine's pipelined loop at GPT-2 small, bf16,
   engine_bench's workload on K8 at 8 and 128 steps a dispatch, each
   through the sync loop, the pipelined loop and the pipelined loop with
   the native scheduler: the same ids and scheduler stats; tok/s, wall s,
   device-busy ms and idle share each. Then the pool-exhaustion geometry
   (2 slots, 5 blocks of 8) on the per-op decode: the pipelined loops give
   the sync loop's ids, with preemptions.

The W8A8 and profiling slice runs in three places: after the runner (7),
7b. w8a8: GPT-2 small at the main path's workload with its weights
   quantized to int8, calibrated on the prompt batch
   (``calibrate_activation_scales``) and scaled
   (``apply_activation_scales``). Each site's product (layer 0's wq, wo,
   w_up, w_down at 5,632 and 8 rows; x seeded at a third of the site's
   amax, so its tail clips): the card's int8 activations equal the CPU's,
   ``w8a8_matmul`` (``torch._int_mm``) equals the float64 plain sums under
   the same fp32 rescale bit for bit, and the plain path fed x quantized
   at twice the scale must not (the control); device ms beside its bound
   at int8's 1,979 TOPS and K14's rate, K5's and a bf16 matmul's. A
   32-token greedy generate with the launch counters zeroed around it: K1
   12, K2 25, ``w8a8_matmul`` 72 in the prefill, one K4 launch for the
   decode; K4 from the W8A8 prefill's cache the same bits as with the same
   int8 weights without act scales; the prefill logits within
   W8A8_LOGITS_RMS of the plain W8A8 forward, and their RMS against the w8
   and bf16 logits; the prefill's device ms in bf16, w8 and W8A8 beside
   each bound (the products' FLOPs as ``ops/cost.py`` counts them).
7c. profile: ``KernelProfiler.profile_function`` over one 32-token
   generate of the workload: the table's K1 and K4 rows (12 and 1 calls),
   K4's traced ms a step within PROFILE_STEP_TOL of generate's
   ``decode_step_device_ms``; the device-busy union of a trace's profiler
   events equal to its Chrome file's (``profiling.device_busy_ms``, which
   every busy figure of this script uses); ``InferenceRunner.profile_model``
   on the fused Impl: 3 wall times, peak memory equal to
   ``torch.cuda.max_memory_allocated``, counted FLOPs within COST_TOL of
   the dense ``Impl()``'s and not within it with K1's count left out; the
   roofline analyzer at K14's rate on the K4 step.
8b. w8a8_8b (after K6's row at llama3-8b, while its trees are alive): the
   bf16 tree calibrated over B 8 x 704 and applied to the int8 tree; the
   prefill's device ms in bf16, w8 and W8A8 beside each bound; 8 K6 steps
   ("tiled") with W8A8 weights the same bits as with the int8 weights;
   then ``transcode_fp8_to_int8`` of the fp8 tree: its seconds and peak
   memory over the trees, layer 0 of every leaf equal to the CPU's
   transcode bit for bit, 8 K6 steps within TRANSCODE_REL_RMS of the fp8
   tree's logits (the same tokens fed to both).

Then the ``{"kernels": [...]}`` summary line, nvidia-smi's line, and last
``{"ok": true, "device": {...}}``. Imports neither JAX nor ``mlio_tpu``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import re
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
# K3's grouped instance (q and p in bf16 on the tensor cores) is also held
# row by row: at Mistral's 32K decode most heads' outputs are about 0.008
# RMS, below the elementwise limit, and one slot of a chunk left out moves a
# row at context 513 by about 0.005; each row's RMS error must stay within
# 2e-2 of its own RMS, as K1's (the kernel's rows lay within 1.2e-4 to 2e-3
# max-abs of the plain version's on the card, NVIDIA H100 80GB HBM3, 700 W).
ROW_REL_RMS["decode_attention_grouped"] = 2e-2
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
# The families' prefills (gemma-7b, phi-2; families phase) take the same
# RMS gate. Their max-abs is the extreme of 0.3-1.4 G errors, which for two
# paths of equal RMS error sigma moves from path to path by about
# sigma * pi / sqrt(6 * 2 ln N), 0.2 sigma at these N, and more where the
# errors' tails are heavier than Gaussian: phi-2's first run on the card
# (NVIDIA H100 80GB HBM3, 700 W) had the kernels' and the plain path's RMS
# equal to 1e-5 relative while their max-abs stood at 0.0790 and 0.0695,
# 1.14x. So the max-abs is held to the plain path's plus
# FAMILY_MAX_SIGMAS of its RMS error: a fault local to a row, a head or a
# tile moves its logits by the order of the logits' own spread (1.1 at
# gemma-7b, about 50 sigma), far past it; a fault spread everywhere moves
# the RMS. The control, K1's output rounded to e4m3, must fail the gate.
FAMILY_MAX_SIGMAS = 2.0


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
    row["phase_us"] = phase_us(spec, stamps, gemv_phase_bytes(spec, blocks))
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
            row["phase_us"] = phase_us(spec, stamps, gemv_phase_bytes(spec, blocks))
            out[f"{model}_{variant}"] = row
        del params, qparams, kc, vc, kq, vq
    return out


def phase_us(spec, stamps, nbytes=None):
    """Phase durations (us) of one single-step launch from its phase probe
    (block 0's timer at each of its waits): the five phases of a layer
    averaged over the layers, and the logits; with ``nbytes``
    (gemv_phase_bytes) each GEMV phase's weight rate (GB/s) beside them."""
    us = (stamps[1:] - stamps[:-1]).double().cpu() / 1e3
    L = spec.num_layers
    layers = dict(zip(("qkv", "attention", "out_proj", "up", "down"),
                      us[1:1 + 5 * L].reshape(L, 5).mean(0).tolist()))
    out = dict(start=us[0].item(), **layers, logits=us[1 + 5 * L].item(),
               launch_total=(stamps[-1] - stamps[0]).item() / 1e3)
    if nbytes is not None:
        out["gb_per_s"] = {k: nbytes[n] / (layers[k] * 1e3) for k, n in (
            ("qkv", "qkv"), ("out_proj", "out_proj"), ("up", "mlp_up"), ("down", "mlp_down"))}
    return out


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
    n_split, chunk = da.split_plan(B, H, CACHE)
    rows[-1].update(
        gb_per_s=nbytes / (rows[-1]["ms"] * 1e-3) / 1e9, n_split=n_split, chunk=chunk,
        same_bits_twice=same_bits_twice("decode_attention",
                                        lambda: da.decode_attention(qd, kc, vc, ctx, layer=5)))
    del kc, vc
    rows[-1]["split_edges"] = decode_split_edges(da, dev, seed)
    rows[-1]["int8"] = decode_attention_int8(da, dev, seed, spec)
    rows[-1]["mistral_decode"] = decode_attention_mistral(da, dev, seed)
    rows.append(flash_kvq_row(fa, dev, seed))
    rows.append(stack_row(dl, dev, seed))
    return rows


def kernel_instances(source, pattern):
    """Registers, stack frame and spill-store bytes of each kernel instance
    of ``source`` (built by this process) whose mangled name matches the
    regular expression ``pattern``, from ptxas's report."""
    from mlio_tpu_torch.ops import _build

    return {name: info for name, info in _build.ptxas_functions(source).items()
            if "registers" in info and re.search(pattern, name)}


# K9's kQuant instances of flash_fwd_kernel<D, kDrop, kLse, kQuant>
K9_INSTANCES = r"flash_fwd_kernelILi(64|128)ELb0ELb0ELb1E"
# generate_moe's prefill attention: Mixtral's 32 query and 8 KV heads of 128
KVQ_MOE = (B, PROMPT, CACHE, 32, 8, 128)


def flash_kvq_row(fa, dev, seed):
    """K9 at GPT-2 small's prefill (8 x 704 queries into a 1024-slot INT8
    cache, 12 heads of 64, G 1), at llama3-8b's head geometry (32 query
    heads, 8 KV heads of 128: 2 x 1024 queries into a 2048-slot cache) and
    at generate_moe's (8 x 704 queries, Mixtral's 32/8 heads of 128, a
    1024-slot cache), each held against its plain version, failing its
    check with all-ones V scales and with a context one token short, giving
    the same bits twice and the same bits with every cache slot past kv_len
    poisoned (int8 127, NaN scales: never read); timed beside SDPA over the
    K/V already dequantized to bf16 (the dequantize not timed). Also a
    kv_len ending mid-tile with q_offset > 0 (a chunked prefill's second
    chunk), and the kQuant instances' registers and spills."""
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    name = "flash_attention_kvq"

    def inputs(b, sq, skv, hq, hkv, d):
        q = torch.randn((b, sq, hq, d), generator=gen, device=dev).to(torch.bfloat16)
        kq, ks = int8_kv(gen, (b, skv, hkv, d), dev)
        vq, vs = int8_kv(gen, (b, skv, hkv, d), dev)
        return q, kq, vq, ks, vs

    def checks(q, kq, vq, ks, vs, args):
        """max-abs, the controls' max-abs, same bits twice and poisoned."""
        kv_len = args["kv_len"]
        got = fa.flash_attention_kvq(q, kq, vq, ks, vs, **args)
        want = fa.flash_attention_kvq_plain(q, kq, vq, ks, vs, **args)
        out = dict(max_abs_err=check_close(name, got, want))
        out["ones_v_scale_max_abs_err"] = must_fail_within(
            name, "with all-ones V scales",
            fa.flash_attention_kvq(q, kq, vq, ks, torch.ones_like(vs), **args), want)
        out["ctx_minus_1_max_abs_err"] = must_fail_within(
            name, "a context one token short",
            fa.flash_attention_kvq(q, kq, vq, ks, vs, **dict(args, kv_len=kv_len - 1)), want)
        out["same_bits_twice"] = same_bits_twice(
            name, lambda: fa.flash_attention_kvq(q, kq, vq, ks, vs, **args))
        # the kernel's check: the plain version, on the CPU, multiplies the
        # masked slots' p = 0 by their NaN scales
        out["poisoned_past_kv_len_same_bits"] = dev.type == "cuda"
        if dev.type == "cuda":
            pk, pv, pks, pvs = kq.clone(), vq.clone(), ks.clone(), vs.clone()
            for t, fill in ((pk, 127), (pv, 127), (pks, float("nan")), (pvs, float("nan"))):
                t[:, kv_len:] = fill
            if not torch.equal(fa.flash_attention_kvq(q, pk, pv, pks, pvs, **args), got):
                raise AssertionError(f"{name}: int8 127 and NaN scales past kv_len changed "
                                     "the output")
            del pk, pv, pks, pvs
        return out

    def case(b, sq, skv, hq, hkv, d, reps):
        q, kq, vq, ks, vs = inputs(b, sq, skv, hq, hkv, d)
        args = dict(causal=True, q_offset=0, kv_len=sq)
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
            **checks(q, kq, vq, ks, vs, args),
            **timings(lambda i: fa.flash_attention_kvq(q, kq, vq, ks, vs, **args),
                      lambda i: fa.flash_attention_kvq_plain(q, kq, vq, ks, vs, **args),
                      None, reps),
            sdpa_dequantized_ms=time_ms(lambda i: F.scaled_dot_product_attention(
                qs, kd, vd, is_causal=True), reps)[0],
            bound_ms=b_ms, bound_by=b_by)
        row["tflop_per_s"] = 4 * b * hq * d * pairs / (row["ms"] * 1e-3) / 1e12
        return row

    row = dict(name=name, route="cuda", source="mlio_tpu_torch/csrc/flash_fwd.cu",
               replaces="mlio_tpu/ops/flash_attention.py:199",
               **case(B, PROMPT, CACHE, 12, 12, 64, 50),
               atol=TOL[name][0], rtol=TOL[name][1], tolerance_of="flash_attention (K1)",
               library_note="no single PyTorch call attends over int8 K/V with per-(token, "
                            "head) scales; sdpa_dequantized_ms is F.scaled_dot_product_attention "
                            "over the K/V already dequantized to bf16, the dequantize not timed "
                            "(a yardstick only)")
    row["llama3_8b"] = case(*KVQ_LLAMA, 20)
    row["generate_moe"] = case(*KVQ_MOE, 20)
    # a chunked prefill's second chunk: 200 queries from position 333, kv_len
    # 533 (mid-tile: 533 = 8 x 64 + 21), grouped heads of 128. The last key
    # is half the last query row of each group's first head, so that the
    # context one token short must fail (it takes about a quarter of that
    # row's weight).
    from mlio_tpu_torch.ops.quant import quantize_kv

    q, kq, vq, ks, vs = inputs(2, 200, 1024, 32, 8, 128)
    kq[:, 532], ks[:, 532] = quantize_kv(0.5 * q[:, 199, ::4].float())
    row["mid_tile"] = dict(
        shape="q [2,200,32,128] bf16, k/v int8 [2,1024,8,128], q_offset 333, kv_len 533",
        **checks(q, kq, vq, ks, vs, dict(causal=True, q_offset=333, kv_len=533)))
    del q, kq, vq, ks, vs
    row["ptxas"] = kernel_instances("flash_fwd", K9_INSTANCES)
    return row


def decode_split_edges(da, dev, seed):
    """K3's context split at its chunk edges, against its plain version: at
    GPT-2 small's shape (B 8, 12 heads of 64, a 1024-slot cache, G 1) and a
    grouped one (B 4, 8 KV heads of 128, G 4, a 4096-slot cache, bf16 and
    INT8), contexts that end on a chunk boundary and one slot past it, the
    whole cache, 1 and 0 (whose output must be all zeros). The one slot past
    a chunk edge is the only slot of its block, so its key is half its
    group's first query head (about a quarter of that head's weight at
    context 513) and the control must fail: the kernel with that slot left
    out (the context one short) against the plain version; the INT8 case
    must also fail with all-ones V scales. Returns each case's plan,
    contexts, max-abs and largest row_rel_rms beside the controls'."""
    from mlio_tpu_torch.ops.quant import quantize_kv

    gen = torch.Generator(device=dev).manual_seed(seed + 23)
    out = {}
    for case, b, hkv, g, d, smax in (("gpt2", B, 12, 1, 64, CACHE),
                                     ("grouped", 4, 8, 4, 128, 4096)):
        n_split, chunk = da.split_plan(b, hkv, smax)
        last = (n_split - 1) * chunk
        ctx = [chunk, chunk + 1, last, last + 1, smax, 2 * chunk - 1, 1, 0][:b - 2] + [1, 0]
        edge = [i for i, c in enumerate(ctx) if c > 1 and c % chunk == 1]
        q = torch.randn((b, hkv * g, d), generator=gen, device=dev).to(torch.bfloat16)
        kc, vc = (torch.randn((2, b, smax, hkv, d), generator=gen, device=dev).to(torch.bfloat16)
                  for _ in range(2))
        for i in edge:
            kc[1, i, ctx[i] - 1] = 0.5 * q[i, ::g]
        c = torch.tensor(ctx, dtype=torch.int32, device=dev)
        short = c.clone()
        short[edge] -= 1
        name = "decode_attention" if g == 1 else "decode_attention_grouped"
        caches = {case: (kc, vc, {})}
        if g > 1:
            (kq, ks), (vq, vs) = (quantize_kv(t.float()) for t in (kc, vc))
            caches[f"{case}_int8"] = (kq, vq, dict(k_scales=ks, v_scales=vs))
        for key, (kt, vt, sc) in caches.items():
            got = da.decode_attention(q, kt, vt, c, layer=1, **sc)
            want = da.decode_attention_plain(q, kt, vt, c, layer=1, **sc)
            err = check_close(name, got, want)
            if got[-1].any():
                raise AssertionError(f"decode_attention {key}: a context of 0 gave a nonzero "
                                     "output")
            bad = da.decode_attention(q, kt, vt, short, layer=1, **sc)
            row = dict(n_split=n_split, chunk=chunk, ctx=ctx, max_abs_err=err,
                       row_rel_rms=row_rel_rms(got, want),
                       edge_slot_left_out_max_abs_err=must_fail_within(
                           name, "the slot past a chunk edge left out", bad, want),
                       edge_slot_left_out_row_rel_rms=row_rel_rms(bad, want))
            if sc:
                bad = da.decode_attention(q, kt, vt, c, layer=1, k_scales=sc["k_scales"],
                                          v_scales=torch.ones_like(sc["v_scales"]))
                row.update(ones_v_scale_max_abs_err=must_fail_within(
                    name, "with all-ones V scales", bad, want),
                    ones_v_scale_row_rel_rms=row_rel_rms(bad, want))
            out[key] = row
        del kc, vc, caches
    return out


def decode_attention_mistral(da, dev, seed):
    """K3 at Mistral-7B-Instruct-v0.2's decode step over its 32K cache: q
    [1, 32, 128] bf16, a 2-layer bf16 cache [2, 1, LC_CACHE, 8, 128] at
    context LC_PROMPT, the timed launches alternating the layers (each
    layer's 134 MB of valid K/V is past the 50 MB L2). Held against its plain
    version (the grouped limit), the same bits twice, and failing with a
    context one token short. At 32K random keys one token moves o by about
    1 / 32,704 of a value, below any bf16 limit, so the last slot's key is
    the first query head of its group, as a decode step's current token often
    leads its own attention: that head puts about half its weight there.
    Timed beside its plain version and SDPA over the valid K/V repeated to
    the query heads (outside the timing). Returns the K3 row's
    ``mistral_decode`` entry."""
    gen = torch.Generator(device=dev).manual_seed(seed + 29)
    L, Hq, Hkv, D, n = 2, 32, 8, 128, LC_PROMPT
    G = Hq // Hkv
    q = torch.randn((1, Hq, D), generator=gen, device=dev).to(torch.bfloat16)
    kc, vc = (torch.randn((L, 1, LC_CACHE, Hkv, D), generator=gen, device=dev).to(torch.bfloat16)
              for _ in range(2))
    kc[:, 0, n - 1] = q[0, ::G]
    ctx = torch.full((1,), n, dtype=torch.int32, device=dev)
    name = "decode_attention_grouped"
    want = da.decode_attention_plain(q, kc, vc, ctx, layer=1)
    got = da.decode_attention(q, kc, vc, ctx, layer=1)
    err = check_close(name, got, want)
    bad = da.decode_attention(q, kc, vc, ctx - 1, layer=1)
    short = must_fail_within(name, "a context one token short", bad, want)
    rel, short_rel = row_rel_rms(got, want), row_rel_rms(bad, want)
    del got, bad
    twice = same_bits_twice("decode_attention",
                            lambda: da.decode_attention(q, kc, vc, ctx, layer=1))
    nbytes = (2 * q.numel() + 2 * n * Hkv * D) * 2
    b_ms, b_by = bound(nbytes, 4 * Hq * n * D, FP32_FLOPS)
    q4 = q[:, :, None, :]
    dense = [tuple(t[l, :, :n].transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
                   for t in (kc, vc)) for l in range(L)]
    n_split, chunk = da.split_plan(1, Hkv, LC_CACHE)
    row = dict(
        shape=f"q [1,{Hq},{D}] cache [{L},1,{LC_CACHE},{Hkv},{D}] bf16, ctx {n} "
              "(Mistral-7B-Instruct-v0.2's decode at 32K)",
        n_split=n_split, chunk=chunk, max_abs_err=err, atol=TOL[name][0], rtol=TOL[name][1],
        tolerance_of=name, row_rel_rms=rel, row_rel_rms_limit=ROW_REL_RMS[name],
        ctx_minus_1_max_abs_err=short, ctx_minus_1_row_rel_rms=short_rel, same_bits_twice=twice,
        **timings(lambda i: da.decode_attention(q, kc, vc, ctx, layer=i % L),
                  lambda i: da.decode_attention_plain(q, kc, vc, ctx, layer=i % L),
                  lambda i: F.scaled_dot_product_attention(q4, *dense[i % L]), 50),
        library_note="F.scaled_dot_product_attention over the valid K/V repeated to the 32 "
                     "query heads outside the timing",
        bound_ms=b_ms, bound_by=b_by, launches=0,
        launches_note="long_context decodes Mistral on the route \"auto\" picks (K6), not "
                      "the scan route")
    row["gb_per_s"] = nbytes / (row["ms"] * 1e-3) / 1e9
    del kc, vc, dense
    torch.cuda.empty_cache()
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
    n_split, chunk = da.split_plan(B, H, CACHE)
    return dict(
        shape=f"q [{B},{H},{D}] bf16, cache int8 [{L},{B},{CACHE},{H},{D}] + fp32 scales, "
              f"ctx {DECODE_CTX}",
        n_split=n_split, chunk=chunk,
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


def paged_split_edges(pa, dev, seed):
    """K7's context split at its chunk and page edges, against its plain
    version: at the engine's geometry (B 10, 12 heads of 64, blocks of 128,
    tables of 8, G 1) and a grouped one (B 10, 8 KV heads of 128, G 4,
    blocks of 16, tables of 256: 4096 slots), bf16 and INT8 pools, permuted
    tables; contexts that end on a chunk edge and one slot past it, on a
    page edge inside the first chunk (where no block merges) and inside the
    second, and one past each, one slot into the last chunk, the whole
    table, 1 and 0 (whose output must be all zeros). The
    one slot past a chunk edge is the only slot of its block, so its key is
    half its group's first query head and the control must fail: the
    kernel with that slot left out (the context one short) against the plain
    version; the INT8 case must also fail with all-ones V scales. The table
    entries past ceil(ctx / bs) then name a block far outside the pool: the
    output's bits must not change (the kernel reads no block past the
    context). Returns each case's plan, contexts, max-abs and largest
    row_rel_rms beside the controls'."""
    from mlio_tpu_torch.ops.quant import quantize_kv

    gen = torch.Generator(device=dev).manual_seed(seed + 31)
    out = {}
    for case, b, hkv, g, d, bs, nblk, nb in (("gpt2", 10, 12, 1, 64, POOL_BS, TABLE_BLOCKS,
                                              POOL_BLOCKS),
                                             ("grouped", 10, 8, 4, 128, 16, 256, 2600)):
        n_split, chunk = pa.paged_split_plan(b, hkv, nblk, bs)
        smax, last = nblk * bs, (n_split - 1) * chunk
        ctx = [chunk, chunk + 1, bs, bs + 1, chunk + bs, chunk + bs + 1, last + 1, smax, 1, 0]
        edge = [i for i, c in enumerate(ctx) if c > 1 and c % chunk == 1]
        q = torch.randn((b, hkv * g, d), generator=gen, device=dev).to(torch.bfloat16)
        kp, vp = (torch.randn((2, nb, bs, hkv, d), generator=gen, device=dev)
                  .to(torch.bfloat16) for _ in range(2))
        tables = paged_tables(gen, dev, b, nblk, nb)
        for i in edge:
            t = ctx[i] - 1
            kp[1, tables[i, t // bs], t % bs] = 0.5 * q[i, ::g]
        c = torch.tensor(ctx, dtype=torch.int32, device=dev)
        short = c.clone()
        short[edge] -= 1
        far = tables.clone()
        for i, n in enumerate(ctx):
            far[i, -(-n // bs):] = nb + (1 << 20)
        name = "paged_attention" if g == 1 else "paged_attention_grouped"
        pools = {case: (kp, vp, {})}
        (kq, ks), (vq, vs) = (quantize_kv(t.float()) for t in (kp, vp))
        pools[f"{case}_int8"] = (kq, vq, dict(k_scale_pool=ks, v_scale_pool=vs))
        for key, (kt, vt, sc) in pools.items():
            got = pa.paged_attention(q, kt, vt, tables, c, layer=1, **sc)
            want = pa.paged_attention_plain(q, kt, vt, tables, c, layer=1, **sc)
            err = check_close(name, got, want)
            if got[-1].any():
                raise AssertionError(f"paged_attention {key}: a context of 0 gave a nonzero "
                                     "output")
            # (the plain version, on the CPU, gathers every entry: the kernel's check)
            if dev.type == "cuda" and not torch.equal(
                    pa.paged_attention(q, kt, vt, far, c, layer=1, **sc), got):
                raise AssertionError(f"paged_attention {key}: table entries past the context "
                                     "changed the output")
            bad = pa.paged_attention(q, kt, vt, tables, short, layer=1, **sc)
            row = dict(n_split=n_split, chunk=chunk, block_size=bs, ctx=ctx, max_abs_err=err,
                       row_rel_rms=row_rel_rms(got, want),
                       far_table_entries_same_bits=dev.type == "cuda",
                       edge_slot_left_out_max_abs_err=must_fail_within(
                           name, "the slot past a chunk edge left out", bad, want),
                       edge_slot_left_out_row_rel_rms=row_rel_rms(bad, want))
            if sc:
                bad = pa.paged_attention(q, kt, vt, tables, c, layer=1,
                                         k_scale_pool=sc["k_scale_pool"],
                                         v_scale_pool=torch.ones_like(sc["v_scale_pool"]))
                row.update(ones_v_scale_max_abs_err=must_fail_within(
                    name, "with all-ones V scales", bad, want),
                    ones_v_scale_row_rel_rms=row_rel_rms(bad, want))
            out[key] = row
        del kp, vp, pools, kq, vq
    return out


def paged_grouped_row(pa, dev, seed):
    """K7's G 4, D 128 instance at llama3-8b's heads (32 query and 8 KV heads
    of 128), B 8, blocks of 128, permuted tables of 8, the ragged contexts:
    held against its plain version, the same bits twice, a context one token
    short failing; timed with the bound. Returns the K7 row's
    ``llama3_8b_heads`` entry."""
    gen = torch.Generator(device=dev).manual_seed(seed + 37)
    L, hkv, g, d = 2, 8, 4, 128
    shape = (L, POOL_BLOCKS, POOL_BS, hkv, d)
    kp, vp = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
    tables = paged_tables(gen, dev, B, TABLE_BLOCKS, POOL_BLOCKS)
    ctx = torch.tensor(RAGGED, dtype=torch.int32, device=dev) + 1
    q = torch.randn((B, hkv * g, d), generator=gen, device=dev).to(torch.bfloat16)
    err, short = paged_attention_check(pa, q, kp, vp, tables, ctx, 1, short=True)
    slots = int(ctx.sum())
    b_ms, b_by = bound((2 * q.numel() + 2 * slots * hkv * d) * 2 + tables.numel() * 4 + B * 4,
                       4 * hkv * g * d * slots, FP32_FLOPS)
    n_split, chunk = pa.paged_split_plan(B, hkv, TABLE_BLOCKS, POOL_BS)
    row = dict(
        shape=f"q [{B},{hkv * g},{d}] bf16, pools [{L},{POOL_BLOCKS},{POOL_BS},{hkv},{d}], "
              f"tables [{B},{TABLE_BLOCKS}] permuted, contexts {ctx.tolist()} (llama3-8b's "
              "heads)",
        n_split=n_split, chunk=chunk, max_abs_err=err,
        atol=TOL["paged_attention_grouped"][0], rtol=TOL["paged_attention_grouped"][1],
        ctx_minus_1_max_abs_err=short,
        same_bits_twice=same_bits_twice("paged_attention", lambda: pa.paged_attention(
            q, kp, vp, tables, ctx, layer=1)),
        **timings(lambda i: pa.paged_attention(q, kp, vp, tables, ctx, layer=i % L),
                  lambda i: pa.paged_attention_plain(q, kp, vp, tables, ctx, layer=i % L),
                  None, 240),
        bound_ms=b_ms, bound_by=b_by, launches=0,
        launches_note="no main path of this run serves a grouped model through K7")
    del kp, vp
    return row


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
    n_split, chunk = pa.paged_split_plan(B, spec.num_kv_heads, TABLE_BLOCKS, POOL_BS)
    k7 = dict(
        name="paged_attention", route="cuda", source="mlio_tpu_torch/csrc/paged_attn.cu",
        replaces="mlio_tpu/ops/paged_attention.py:177",
        shape=f"q [{B},{H},{D}], {shp} (+1 current token)",
        n_split=n_split, chunk=chunk,
        max_abs_err=err, atol=TOL["paged_attention"][0], rtol=TOL["paged_attention"][1],
        ctx_minus_1_max_abs_err=short_err, max_abs_err_ctx896=err896,
        ctx896_minus_1_max_abs_err=short896,
        same_bits_twice=same_bits_twice("paged_attention", lambda: pa.paged_attention(
            q, kp, vp, tables, ctx, layer=5)),
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
    k7["split_edges"] = paged_split_edges(pa, dev, seed)
    k7["llama3_8b_heads"] = paged_grouped_row(pa, dev, seed)

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
    k8["phase_us"] = phase_us(spec, stamps, gemv_phase_bytes(spec, params["blocks"]))

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
    with a bias, learned positions and a past context of 0, each with bf16,
    int8 and mixed (MIXED_SKIP left bf16) weights."""
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
        errs[f"decode_paged_stack_mixed_weights[{name}]"] = paged_stack_check(
            dps, spec, quantize_params(params, spec, "int8", skip=MIXED_SKIP), x, kp, vp, tables,
            past, cos, sin, kw)[1]
    return errs


STACK_REPEATS = 20       # launches each of K4 bf16, K4 w8+kv8 and K8 that must agree bit for bit
HOLD_NS = 20000          # a held-back block's delay before each of its waits
HOLD_BLOCKS = (0, 77)    # the blocks held back, one launch each
# K4/K8's mixed weights: int8 but these (QKV in two formats, the out-projection
# bf16 and down int8; tests/test_torch_decode_stack_plan.py's MIXED)
MIXED_SKIP = ("wk", "wo", "w_up", "w_gate")
CLUSTERS = (2, 4, 8, 16)  # cluster sizes of the cooperative cluster-launch probe


def stack_instances():
    """Registers (kernels), stack frame and spill-store bytes of every
    decode_stack.cuh instance, by source, from ptxas's report: kernels
    stack_kernel<head dim, query heads a KV head, cache>, and the functions
    they call (gemv_phase, one for every phase and format; produce;
    logits_phase<cache>)."""
    from mlio_tpu_torch.ops import _build

    out = {}
    for src in ("decode_layer", "decode_layer_kv8", "paged_stack"):
        fns = {}
        for mangled, v in _build.ptxas_functions(src).items():
            m = re.search(r"\d+(stack_kernel|gemv_phase|produce|finish_group|attention_phase|"
                          r"logits_phase|token_phase|wait_for|row_stats|tile_stats)(.*)$", mangled)
            if m is None:
                continue
            tail, args = m.group(2), []
            if tail.startswith("I"):  # a template's arguments: literals, then the cache
                args = [n for _, n in re.findall(r"L([ib])(\d+)E", tail[1:].split("N")[0])]
                if "PagedCache" in tail:
                    args.append("paged")
                elif "ContiguousCache" in tail:
                    args.append("int8_cache" if "ContiguousCacheILb1E" in tail else "bf16_cache")
            fns[f"{m.group(1)}<{','.join(args)}>" if args else m.group(1)] = v
        out[src] = fns
    return out


def stack_plan_check(dl):
    """The card's own plan of K4 and K8 (mlio_*_stack_items at the blocks
    and ring slots the plan function sizes the launch for) against
    decode_layer.stack_plan and attention_split, the mirror the CPU tests
    hold: GPT-2 small, gpt2-xl and llama3-8b, bf16, int8 and mixed weights
    (MIXED_SKIP left bf16), every GEMV phase, its shape (KB, nk, tiles,
    tile columns, ring slots) and its segments, with and without the
    epilogue (the ring's slots); the waits on part of a phase (the counters
    of every out and down segment and every attention item, segment_wait
    and attention_wait, against block_program's); attention's split (C,
    each sequence's splits and first split) at K4's context and K8's
    ragged ones. Raises where they differ."""
    from mlio_tpu_torch.models import get_spec

    mixed = {n: (None if n in MIXED_SKIP else "int8") for n in dl.PROJECTIONS}
    items, splits, waits = {}, {}, {}
    for name in ("decode_layer", "paged_stack"):
        for model in ("gpt2", "gpt2-xl", LLAMA):
            spec = get_spec(model)
            for label, fmt in (("bf16", None), ("int8", "int8"), ("mixed", mixed)):
                for phase in dl.STACK_PHASES:
                    for epilogue in (True, False):
                        nb, shape, card = dl.card_items(name, spec, fmt, B, phase, epilogue)
                        mirror = dl.stack_plan(spec, fmt, nb=nb, epilogue=epilogue)
                        ph = mirror["phases"][phase]
                        want = (ph["KB"], ph["nk"], ph["ntiles"], ph["tc"], mirror["slots"])
                        if shape != want or card != [tuple(i) for i in ph["items"]]:
                            raise AssertionError(
                                f"{name}: the card's plan of {model} {label} {phase} "
                                f"(epilogue {epilogue}) {shape} differs from stack_plan's {want}")
                        items[f"{name}/{model}/{label}/{phase}/epilogue={int(epilogue)}"] = \
                            [*shape, len(card)]
                # the waits on part of a phase: every out and down segment's
                # and every attention item's counters, the card's against the
                # mirror's (the waits the CPU tests' happens-before walk holds)
                nb, _, _ = dl.card_items(name, spec, fmt, B, "qkv")
                mirror = dl.stack_plan(spec, fmt, nb=nb)
                card = dl.card_waits(name, spec, fmt, B)
                mine = {}
                for b in range(nb):
                    mine.update(dl.program_waits(mirror, spec, B, b))
                segs = {k for k in card if k[0] == "seg"}
                if segs != {k for k in mine if k[0] == "seg"} or any(
                        card[k] != v for k, v in mine.items()):
                    raise AssertionError(f"{name}: the card's waits of {model} {label} differ "
                                         "from block_program's")
                waits[f"{name}/{model}/{label}"] = len(segs)
            for ctx, n in (("ctx_896", [DECODE_CTX + 1] * B),
                           ("ragged", [c + 1 for c in RAGGED]), ("b1_ctx_1", [1])):
                card = dl.card_split(name, spec, n)
                want = dl.attention_split(n, spec.num_kv_heads, card["nb"])
                if {k: card[k] for k in want} != want:
                    raise AssertionError(f"{name}: the card's attention split of {model} at "
                                         f"{ctx} {card} differs from attention_split's {want}")
                splits[f"{name}/{model}/{ctx}"] = dict(C=card["C"], items=card["items"])
    return dict(plan_matches_mirror=True, blocks=nb,
                shape_key="KB, nk, ntiles, tc, slots, segments", phases=items,
                attention_split=splits, waits_segments=waits)


def cluster_launch_probe(dl):
    """Whether the card takes a cooperative launch with a cluster dimension
    at K4's block size and shared memory (decode_layer.cluster_probe), for
    each of CLUSTERS: the design's split-K inside a cluster needs both."""
    from mlio_tpu_torch.models import get_spec

    return [dl.cluster_probe("decode_layer", get_spec("gpt2"), c) for c in CLUSTERS]


def same_bits(name, launch, outs):
    """``launch()`` STACK_REPEATS times, then once with each of
    HOLD_BLOCKS held back HOLD_NS before each of its waits
    (decode_layer.HOLD): every output the same bits as ``outs`` (the
    first launch's). Raises otherwise."""
    from mlio_tpu_torch.ops import decode_layer as dl

    ref = [t.clone() for t in outs]  # the caches are written in place

    def agree(got, what):
        torch.cuda.synchronize()
        for g, w in zip(got, ref):
            if not torch.equal(g, w):
                raise AssertionError(f"{name}: {what} changed the output bits")

    for r in range(STACK_REPEATS):
        agree(launch(), f"launch {r + 1} of {STACK_REPEATS}")
    for blk in HOLD_BLOCKS:
        with patched(dl, "HOLD", (blk, HOLD_NS)):
            agree(launch(), f"holding block {blk} back {HOLD_NS} ns at each wait")
    return dict(repeats=STACK_REPEATS, held_back_blocks=list(HOLD_BLOCKS), hold_ns=HOLD_NS,
                same_bits=True)


def stack_phase(dev, seed, dl, dps):
    """K4's and K8's plan and determinism: the card's plan against the
    mirror (stack_plan_check); the same bits over STACK_REPEATS launches and
    with a held-back block (same_bits) of K4 bf16 and K4 with int8 weights
    over an INT8 cache at GPT-2 small (B 8, context DECODE_CTX) and K8 at the
    ragged contexts; the registers and spills of every instance."""
    from mlio_tpu_torch.models import load_model
    from mlio_tpu_torch.ops.quant import quantize_kv
    from mlio_tpu_torch.runtime import quantize_params

    spec, params = load_model("gpt2", dtype=torch.bfloat16, device=dev, seed=seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    pos = DECODE_CTX - 1
    x, kc, vc, _, _, kw = stack_inputs(spec, params, B, CACHE, pos, 1, gen)
    out = dict(card_plan=stack_plan_check(dl))

    def k4(blocks, caches, sk):
        def launch():
            xo, tok = dl.decode_layer_stack(x, blocks, *caches, pos, **kw, **sk)
            return (xo, tok, *caches, *sk.values())
        return launch

    run = k4(params["blocks"], (kc, vc), {})
    out["decode_layer_stack"] = same_bits("decode_layer_stack", run, run())
    (kq, ks), (vq, vs) = quantize_kv(kc.float()), quantize_kv(vc.float())
    run = k4(quantize_params(params, spec, "int8")["blocks"], (kq, vq),
             dict(k_scales=ks, v_scales=vs))
    out["decode_layer_stack_w8kv8"] = same_bits("decode_layer_stack (w8+kv8)", run, run())
    shape = (spec.num_layers, POOL_BLOCKS, POOL_BS, spec.num_kv_heads, spec.head_size)
    kp = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    vp = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    tables = paged_tables(gen, dev, B, TABLE_BLOCKS, POOL_BLOCKS)
    past = torch.tensor(RAGGED, dtype=torch.int32, device=dev)
    ids = torch.randint(0, spec.vocab_size, (B,), generator=gen, device=dev)
    xp, _, _ = paged_x(spec, params, ids, past)
    pkw = dict(spec=spec, head_norm=(params["final_scale"], params["final_bias"]),
               lm_head=params["tok_embed"], lm_head_bias=None, lm_vmajor=True, emit="logits")

    def k8():
        xo, logits = dps.decode_paged_stack(xp, params["blocks"], kp, vp, tables, past, **pkw)
        return xo, logits, kp, vp

    out["decode_paged_stack"] = same_bits("decode_paged_stack", k8, k8())
    out["ptxas"] = stack_instances()
    out["cluster_launch"] = cluster_launch_probe(dl)
    return out


def stack_variants(dev, seed, dl):
    """K4's other instances against its plain version at small shapes, with
    norm scales and every bias drawn from the seed: bf16 weights, int8
    weights over an INT8 cache, and mixed weights (MIXED_SKIP left bf16)."""
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
        # a mixed set: int8 but MIXED_SKIP
        errs[f"decode_layer_stack_mixed[{name}]"] = stack_check(
            dl, spec, quantize_params(params, spec, "int8", skip=MIXED_SKIP), x, kc, vc, pos,
            cos, sin, kw)[1]
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
         "flash_attention_stream": "flash_stream_plain", "w8a8_matmul": "w8a8_matmul_plain"}


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
    decode step by the two-length marginal and the device time of a step
    (the phase's line, returned).
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
    return result


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


def dispatch_times(run_chunk):
    """(device ms, device-busy ms, wall ms) of one decode dispatch. Device ms
    by CUDA events with the chunk queued behind a sleep kernel; it holds
    only while the chunk's launches fit the launch queue, so a dispatch of
    thousands of small launches (the per-op decode) waits on the host and
    reads high. Device-busy ms is the union of the dispatch's kernels in a
    torch.profiler trace. Wall ms by the host clock around the chunk and the
    fetch of its tokens, without the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from mlio_tpu_torch.profiling import device_busy_ms

    device_ms = time_ms(lambda i: run_chunk(), 2, warmup=1)[0]
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_chunk().cpu()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run_chunk().cpu()
    busy = device_busy_ms(prof.events())
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
            cur, tables, ctx = (eng._upload(a) for a in
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


def tiled_must_fail(dt, spec, blocks, x, kc, vc, at, pos, cos, sin, plain, what, scales=None,
                    x_must_fail=False):
    """K6 run wrongly (at slot ``at``, or over other ``scales``) has to fail
    the check against the plain run at ``pos`` (``plain``: its x_out and
    caches): x_out (the deep tolerance), or the slot written at layer 0
    (values within K6's tolerance, ints within one step); with
    ``x_must_fail``, x_out itself. Returns the two max-abs errors."""
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
    if x_ok and (s_ok or x_must_fail):
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


def gemv_phase_bytes(spec, blocks, picks=None) -> dict:
    """The bytes a layer of each of K6's GEMV phases streams: the weights'
    payloads and scales (an MoE model's experts those some row picks,
    ``picks`` [L, B, E]; None: all of them), averaged over the layers."""
    from mlio_tpu_torch.ops.quant import QTensor

    L, E = spec.num_layers, spec.num_experts

    def per_layer(name, share=1.0):
        w = blocks.get(name)
        if w is None:
            return 0.0
        ts = (w.q, w.scale) if isinstance(w, QTensor) else (w,)
        return sum(t.numel() * t.element_size() for t in ts) / L * share

    share = 1.0
    if E:
        share = (L * E if picks is None else int(picks.any(1).sum())) / (L * E)
    up, gate, down = ("moe_up", "moe_gate", "moe_down") if E else ("w_up", "w_gate", "w_down")
    return dict(qkv=per_layer("wq") + per_layer("wk") + per_layer("wv"), out_proj=per_layer("wo"),
                mlp_up=per_layer(up, share) + per_layer(gate, share),
                mlp_down=per_layer(down, share))


def tiled_phase_us(dt, spec, stamps, nbytes=None):
    """K6's phases (us), averaged over the layers, from its phase probe;
    with ``nbytes`` (gemv_phase_bytes) each GEMV phase's streaming rate
    (GB/s) beside them."""
    us = (stamps[1:] - stamps[:-1]).double().cpu() / 1e3
    per = dict(zip(dt.PHASES, us[1:].reshape(spec.num_layers, len(dt.PHASES)).mean(0).tolist()))
    out = dict(start=us[0].item(), **per, launch_total=(stamps[-1] - stamps[0]).item() / 1e3)
    if nbytes is not None:
        out["gb_per_s"] = {k: v / (per[k] * 1e3) for k, v in nbytes.items()}
    return out


def k6_instances():
    """Registers (kernels), stack frame and spill-store bytes of every K6
    kernel and phase instance, by source, from ptxas's report: kernels
    tiled_kernel<head dim, INT8 cache, query heads a KV head sized for>,
    gemv_phase<batch rows, format, phase, up and gate>, attention_phase<head
    dim, INT8 cache, query heads>."""
    from mlio_tpu_torch.ops import _build

    out = {}
    for src in ("decode_tiled_bf16", "decode_tiled_int8", "decode_tiled_fp8"):
        fns = {}
        for mangled, v in _build.ptxas_functions(src).items():
            m = re.search(r"\d+(tiled_kernel|gemv_phase|attention_phase|moe_route)"
                          r"((?:I(?:L[ib]\d+E)+E)?)", mangled)
            if m is None:
                continue
            args = ",".join(("true" if n == "1" else "false") if t == "b" else n
                            for t, n in re.findall(r"L([ib])(\d+)E", m.group(2)))
            fns[f"{m.group(1)}<{args}>" if args else m.group(1)] = v
        out[src] = fns
    return out


def tiled_plan_check(dt):
    """The card's own GEMV item plan (mlio_decode_tiled_items, at the blocks
    the plan function sizes the launch for) against decode_tiled.item_plan,
    the mirror the CPU tests hold: llama3-8b (bf16, int8) and Mixtral-8x7B
    (int8, 2 and 8 experts picked), every phase. Raises where they differ."""
    from mlio_tpu_torch.models import get_spec

    items = {}
    for model, fmt in ((LLAMA, None), (LLAMA, "int8"), (MIXTRAL, "int8")):
        spec = get_spec(model)
        for npk in ((2, 8) if spec.num_experts else (1,)):
            experts = list(range(npk)) if spec.num_experts else None
            for phase in dt.GEMV_PHASES:
                nb, card = dt.card_items(spec, fmt, B, phase, npk)
                mirror = dt.item_plan(spec, fmt, nb=nb, experts=experts)[phase]["items"]
                if card != [tuple(i) for i in mirror]:
                    raise AssertionError(f"decode_layer_tiled: the card's plan of {model} "
                                         f"{fmt or 'bf16'} {phase} ({npk} experts) differs "
                                         "from item_plan's")
                items[f"{model}/{fmt or 'bf16'}/{npk}/{phase}"] = len(card)
    return dict(plan_matches_mirror=True, blocks=nb, items=items)


def partials_bytes(dt, spec, fmt, batch, nb):
    """The fp32 partials K6's plan sizes: the largest phase's (blocks +
    tiles) slots of a tile's columns by the tier's batch rows."""
    mb = 8 if batch <= 8 else 16 if batch <= 16 else 32
    return max((nb + p["ntiles"]) * p["nm"] * p["tc"] * mb * 4
               for p in dt.item_plan(spec, fmt, nb=nb).values())


@contextlib.contextmanager
def changed_weights(blocks, name, index, value):
    """``blocks[name]`` (its payload for a QTensor) with ``index`` set to
    ``value`` (and, given a (payload, scale) pair, the scales at
    index[:-2] set to value[1]) for the with-block; restored after."""
    from mlio_tpu_torch.ops.quant import QTensor

    w = blocks[name]
    q = w.q if isinstance(w, QTensor) else w
    pv, sv = value if isinstance(value, tuple) else (value, None)
    saved = q[index].clone()
    ssaved = w.scale[index[:-2]].clone() if sv is not None else None
    q[index] = pv
    if sv is not None:
        w.scale[index[:-2]] = sv
    try:
        yield
    finally:
        q[index] = saved
        if sv is not None:
            w.scale[index[:-2]] = ssaved


def tile_read_control(dt, spec, blocks, name, index, value, x, kc, vc, pos, cos, sin,
                      plain_x, what, scales=None):
    """K6 run with one 64-row tile of weight ``name`` changed must fail the
    deep x_out check against the plain run of the unchanged weights: the
    kernel reads that tile. Returns its max-abs."""
    sk = {} if scales is None else dict(k_scales=scales[0].clone(), v_scales=scales[1].clone())
    with changed_weights(blocks, name, index, value):
        xk = dt.decode_layer_tiled(x, blocks, kc.clone(), vc.clone(), pos, cos, sin, spec=spec,
                                   **sk)
        torch.cuda.synchronize()
    return must_fail_within("decode_layer_tiled_deep", what, xk, plain_x)


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
        if variant in ("bf16", "w8kv8"):  # the fixed-order sums: two runs give the same bits
            sk2 = [{} if scales is None else dict(k_scales=scales[0].clone(),
                                                  v_scales=scales[1].clone()) for _ in range(2)]
            twice = [dt.decode_layer_tiled(x, blocks, caches[0].clone(), caches[1].clone(), pos,
                                           cos, sin, spec=spec, **kw) for kw in sk2]
            if not torch.equal(*twice):
                raise AssertionError(f"decode_layer_tiled ({variant}): two runs give different "
                                     "bits")
            row["repeat_bitwise_equal"] = True
            del twice
        if variant == "bf16":  # every tile is read: one 64-row tile of wq set to inf
            r0, c0 = spec.hidden_size // 4, spec.q_dim // 16
            at = (spec.num_layers // 2, slice(r0, r0 + 64), slice(c0, c0 + 128))
            row["wq_tile_inf_max_abs_err"] = tile_read_control(
                dt, spec, blocks, "wq", at, float("inf"), x, *caches, pos, cos, sin, x_plain,
                "one 64-row tile of wq set to inf", scales)
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
        row["phase_us"] = tiled_phase_us(dt, spec, stamps, gemv_phase_bytes(spec, blocks))
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
    """Max-abs and RMS of got - want (fp32, a batch row at a time, on want's
    device), and the values past LOGITS_ATOL."""
    mx, sq, over = 0.0, 0.0, 0
    for g, w in zip(got, want):
        d = (g.to(w.device).float() - w.float()).abs()
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
            x_plain, _, errs, picks = moe_check(dt, spec4, params["blocks"], x, kc, vc, pos, cos,
                                                sin, scales)
            if wname == "fp8" and batch == 8:  # every tile is read: a NaN tile of w_down
                lp, ep = picks.any(1).nonzero().tolist()[0]
                r0, c0 = spec.intermediate_size // 2, spec.hidden_size // 4
                errs["w_down_tile_nan_max_abs_err"] = tile_read_control(
                    dt, spec4, params["blocks"], "moe_down",
                    (lp, ep, slice(r0, r0 + 64), slice(c0, c0 + 256)), float("nan"), x, kc, vc,
                    pos, cos, sin, x_plain, "one 64-row tile of a picked expert's w_down NaN")
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
    def run(**kw):
        return dt.decode_layer_tiled(x, blocks, kq.clone(), vq.clone(), pos, cos, sin, spec=spec,
                                     k_scales=ks.clone(), v_scales=vs.clone(), **kw)

    again = [run() for _ in range(2)]
    if not torch.equal(*again):
        raise AssertionError("decode_layer_tiled (MoE): two runs give different bits")
    tiling = dt.choose_tiling(spec, B)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    workspace = dict(bytes=dt.decode_layer_tiled.workspace_bytes,
                     partials_bytes=partials_bytes(dt, spec, "int8", B, sms))
    # the experts no row picks are never read: one unpicked (layer, expert)'s
    # int8 weights all 127 and its scales 1e30 leave x_out's bits as they are
    unpicked = (~picks.any(1)).nonzero().tolist()
    if not unpicked:
        raise AssertionError("tiled_moe: every (layer, expert) is picked; the unpicked-expert "
                             "control shows nothing")
    lu, eu = unpicked[len(unpicked) // 2]
    whole = (lu, eu, slice(None), slice(None))
    with changed_weights(blocks, "moe_up", whole, (127, 1e30)), \
            changed_weights(blocks, "moe_gate", whole, (127, 1e30)), \
            changed_weights(blocks, "moe_down", whole, (127, 1e30)):
        x_unpicked = run()
        torch.cuda.synchronize()
    if not torch.equal(x_unpicked, again[0]):
        raise AssertionError(f"decode_layer_tiled (MoE): wrecking unpicked expert {eu} of layer "
                             f"{lu} changed x_out: its weights were read")
    unpicked_control = dict(layer=lu, expert=eu, x_out_bitwise_equal=True,
                            unpicked_pairs=len(unpicked))
    # every tile is read: one 64-row tile of a picked expert's int8 w_down at
    # 127 must change x_out's bits (at random weights no int8 tile moves it
    # past the 32-layer tolerance; the 4-layer e4m3 variant's NaN tile must
    # fail it, moe_small_variants)
    lp, ep = picks.any(1).nonzero().tolist()[len(unpicked) % 7]
    r0, c0 = spec.intermediate_size // 2, spec.hidden_size // 4
    with changed_weights(blocks, "moe_down", (lp, ep, slice(r0, r0 + 64), slice(c0, c0 + 256)),
                         127):
        x_tile = run()
        torch.cuda.synchronize()
    if torch.equal(x_tile, again[0]):
        raise AssertionError(f"decode_layer_tiled (MoE): a 64-row tile of expert {ep}'s w_down "
                             f"at layer {lp} set to 127 left x_out's bits as they are")
    down_tile_control = dict(layer=lp, expert=ep, x_out_bits_changed=True,
                             max_abs_vs_unchanged=(x_tile.float() - again[0].float()).abs().max()
                             .item())
    del again, x_unpicked, x_tile
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
        top1_max_abs_err=top1_err, ctx_minus_1_max_abs_err=short,
        unpicked_expert_control=unpicked_control,
        down_tile_control=down_tile_control, **t, bound_ms=b_ms,
        bound_by=b_by, bound_experts_used=used, bound_ms_all_experts=all_ms,
        phase_us=tiled_phase_us(dt, spec, stamps, gemv_phase_bytes(spec, blocks, picks)),
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
        cur, tables, ctx = (eng._upload(a) for a in (eng.sched.cur, eng.sched.tables,
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

    from mlio_tpu_torch.profiling import device_busy_ms

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
                busy = device_busy_ms(prof.events())
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
# K10 rounds q and p to bf16 as K1 does, against a running max, in 128-key
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
# one interior tile of 128 keys wrong moves a row by about sqrt(256 / n),
# 0.09-0.125 at 16K-32K keys), and a row with no key must be zero.
ROW_REL_RMS["flash_attention_stream"] = 1e-2
# The depth controls: the V tile at each key (K10's ring slot,
# STREAM_BLOCK_KV keys) taken from the tile before, seen by the rows past 16K
# and, more faintly, by the last 2K rows alone.
STALE_KEYS = (16384, 30720)


def stale_tile(t, at, rows=64):
    """t ([B, S, H, D]) with the ``rows`` rows at ``at`` replaced by the
    ``rows`` before them: a tile read from a stale ring slot (K13b's K and V,
    K13c's q and dO: 64; K10's V: its 128-key tile)."""
    t = t.clone()
    t[:, at:at + rows] = t[:, at - rows:at]
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
            res["same_bits_twice"] = same_bits_twice(
                "flash_attention_stream", lambda: fa.flash_attention_stream(q, k, v, **kw))
            o_off = fa.flash_stream_plain(q, k, v, **dict(kw, q_offset=qoff - 1))
            res["q_offset_one_off_max_abs_err"] = must_fail_within(
                "flash_attention_stream", "against the plain version with q_offset one off", o,
                o_off)
            del o_off
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
                tflop_per_s=4 * Hq * D * pairs / (ms * 1e-3) / 1e12,
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
        o_bad = fa.flash_stream_plain(q, k, stale_tile(v, key, fa.STREAM_BLOCK_KV), **kw)
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


# The masks slice: K1 with a user mask (key or full), K9 with a key mask and
# the lse, K1's lse under dropout, the bhsd layouts, and ring attention's
# chunk merge at Mistral's 32K. Shapes: (B, S, Hq, Hkv, D).
MASK_KEY = (8, PROMPT, 32, 8, 128)        # llama3-8b's attention heads at the prefill's 8 x 704
MASK_PREFIX = (8, PROMPT, 12, 12, 64)     # GPT-2 small's prefill
MASK_PER_HEAD = (1, 2048, 32, 8, 128)     # llama3-8b's training attention
MASK_ODD = (2, 703, 32, 8, 128)  # llama3-8b's heads at an odd Skv: K1 reads the mask byte by byte
MASK_PAD, MASK_KEEP = 200, 0.8  # left padding of 0..200 tokens a row; the holes' keep rate
MASK_BLOCK = 64                 # the 32K call's q blocks held against the plain version
RING_CHUNKS = (8192, 16384)     # chunk_step_flash's chunks at 32K: K1's route, then K10's
MASK_ROWS = ("flash_attention_key_mask", "flash_attention_full_mask",
             "flash_attention_kvq_mask_lse", "flash_attention_lse_dropout")
# The masked instances round as K1 and K9 do (the mask only sets scores to
# -inf): K1's limits, each query row within 2e-2 of its own RMS (K1's
# ROW_REL_RMS), the lse within 1e-4 (fp32 throughout) and -inf exactly where
# a row sees no key. At 32K keys (``_32k``) |o| falls to about 0.009, under
# the elementwise limit, so the row check carries it: a 64-key tile read
# stale moves a row there by about sqrt(128 / 32768) = 0.06 of its RMS.
# Ring attention's merged output (``ring_merge``) is held against one K10
# call, not a plain version: each chunk's o is rounded to bf16 before the
# merge, and K10 rounds p against its own running max, so the two differ by
# about twice a kernel's own row error (K10 read 3.0e-3 against its plain
# version on the card); K1's limits hold them, and leaving the last chunk
# out moves the rows past it by far more. Its lse, fp32 throughout: 1e-4.
TOL.update({name: TOL["flash_attention"] for name in MASK_ROWS})
TOL.update({f"{name}_lse": (1e-4, 0.0) for name in MASK_ROWS + ("ring_merge",)})
TOL.update({"flash_attention_key_mask_32k": TOL["flash_attention"],
            "ring_merge": TOL["flash_attention"]})
ROW_REL_RMS.update({name: 2e-2 for name in MASK_ROWS + ("flash_attention_key_mask_32k",
                                                        "ring_merge")})


def check_lse(name, got, want):
    """An lse held against the plain version's: -inf exactly where it has
    -inf (a row that sees no key), the rest within name's tolerance."""
    if not torch.equal(got.isneginf(), want.isneginf()):
        raise AssertionError(f"{name}: the rows with no key differ from the plain version's")
    fin = ~want.isneginf()
    return check_close(name, got[fin], want[fin]) if fin.any() else 0.0


def left_pad_mask(gen, B, S, max_pad):
    """tests/test_flash_attention.py's _left_pad_mask: row b masks its
    first pads[b] keys, pads drawn from 0..max_pad. Returns (int8 [B, S],
    pads)."""
    pads = torch.randint(0, max_pad + 1, (B,), generator=gen, device=gen.device)
    return (torch.arange(S, device=gen.device)[None] >= pads[:, None]).to(torch.int8), pads


def holes_mask(gen, shape, keep=MASK_KEEP):
    """A random mask keeping each entry with probability ``keep``, key 0
    kept (every causal row sees a key)."""
    m = (torch.rand(shape, generator=gen, device=gen.device) < keep).to(torch.int8)
    m[..., 0] = 1
    return m


def flipped(m, index):
    """m with the entry at ``index`` flipped (kept <-> masked)."""
    m = m.clone()
    m[index] = 1 - m[index]
    return m


def to_bhsd(*ts):
    """[B, S, H, ...] tensors relaid as [B, H, S, ...] (contiguous)."""
    return [t.transpose(1, 2).contiguous() for t in ts]


def mask_bound(B, Sq, kvl, Hq, Hkv, D, causal, q_offset=0, mask=None, mask_heads=1, lse=False,
               kv_bytes=2, scale_bytes=0):
    """(bound_ms, bound_by, pairs): q and out in bf16, the kv_len valid K/V
    rows (kv_bytes an element, with their scales), the lse and the mask's
    bytes the function needs over the probe's rate; 4 x Hq x D operations a
    (query, key) pair the kernel visits (causal_pairs) over the bf16
    tensor-core peak. The mask's bytes: a "key" mask's of the keys some row
    sees (below kv_len, and under causal below q_offset + Sq); a "full"
    mask's (mask_heads of them a sequence) of the pairs alone, so that a
    causal mask's entries above the diagonal are not counted."""
    pairs = B * causal_pairs(Sq, kvl, causal, q_offset)
    if mask == "key":
        mask_bytes = B * max(0, min(kvl, q_offset + Sq) if causal else kvl)
    else:
        mask_bytes = mask_heads * pairs if mask == "full" else 0
    nbytes = (2 * 2 * B * Sq * Hq * D + 2 * B * kvl * Hkv * (D * kv_bytes + scale_bytes)
              + mask_bytes + (4 * B * Hq * Sq if lse else 0))
    b_ms, b_by = bound(nbytes, 4 * Hq * D * pairs, BF16_TENSOR_FLOPS)
    return b_ms, b_by, pairs


def sdpa_masked(q, k, v, valid, dropout=0.0):
    """A call of F.scaled_dot_product_attention over q and K/V repeated to
    the query heads, head-major, with the boolean attn_mask ``valid``
    (True = attend), all made outside the timing."""
    G = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (t.transpose(1, 2).repeat_interleave(G, dim=1).contiguous() for t in (k, v))
    return lambda i: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=valid,
                                                    dropout_p=dropout)


def library_ms(make, reps):
    """(device ms, None) of the call ``make()`` builds, or (None, the
    reason) where no such call fits the card."""
    try:
        return time_ms(make(), reps)[0], None
    except RuntimeError as e:  # out of memory, or no SDPA kernel takes the call
        torch.cuda.empty_cache()
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"


def path_launches(fa, call, want):
    """Zero K1's, K9's and K10's counters, run ``call`` (one call through
    an entry point a user calls), read them; they must equal ``want``."""
    names = ("flash_attention", "flash_attention_kvq", "flash_attention_stream")
    for n in names:
        getattr(fa, n).launches = 0
    out = call()
    got = {n: getattr(fa, n).launches for n in names}
    if got != dict({n: 0 for n in names}, **want):
        raise AssertionError(f"masks: launches {got}, not {want}")
    return out, got


def mask_case(fa, name, q, k, v, m, flip, causal=True):
    """One masked K1 call held against its plain version, and failing it
    with the mask's entry at ``flip`` flipped (the key a row sees alone)."""
    o_p = fa.flash_plain_lse(q, k, v, mask=m, causal=causal)[0]
    o = fa.flash_attention(q, k, v, mask=m, causal=causal)
    return dict(max_abs_err=check_close(name, o, o_p), row_rel_rms=row_rel_rms(o, o_p),
                flipped_key_max_abs_err=must_fail_within(
                    name, f"with the mask's entry {flip} flipped",
                    fa.flash_attention(q, k, v, mask=flipped(m, flip), causal=causal), o_p))


def odd_mask_cases(fa, gen, name, full):
    """K1's byte-by-byte mask reads at D 128 (MASK_ODD: Skv odd, causal,
    random holes with key 0 kept): a key mask, or with ``full`` a 3-D one;
    row 0 sees key 0 alone, so flipping it must fail the check."""
    B_, S, Hq, Hkv, D = MASK_ODD
    q, k, v = attention_inputs(gen, B_, S, S, Hq, Hkv, D)
    m = holes_mask(gen, (B_, S, S) if full else (B_, S))
    return mask_case(fa, name, q, k, v, m, (0, 0, 0) if full else (0, 0))


def key_mask_row(fa, dev, gen):
    """K1 with key masks at MASK_KEY, causal: left padding of 0..MASK_PAD
    tokens a row and random holes (MASK_KEEP, key 0 kept), each against its
    plain version; failing it with the one key of a row's first kept
    position flipped; the same bits with q, K/V and out in the bhsd layout;
    through ops.attention (K1, no K10); timed beside its plain version and
    SDPA with the boolean mask."""
    from mlio_tpu_torch import ops
    from mlio_tpu_torch.models import Impl

    name = "flash_attention_key_mask"
    B_, S, Hq, Hkv, D = MASK_KEY
    q, k, v = attention_inputs(gen, B_, S, S, Hq, Hkv, D)
    pad, pads = left_pad_mask(gen, B_, S, MASK_PAD)
    checks = {}
    for kind, m in (("left_pad", pad), ("holes", holes_mask(gen, (B_, S)))):
        o = fa.flash_attention(q, k, v, mask=m)
        o_p = fa.flash_plain_lse(q, k, v, mask=m)[0]
        checks[kind] = dict(max_abs_err=check_close(name, o, o_p),
                            row_rel_rms=row_rel_rms(o, o_p))
    o = fa.flash_attention(q, k, v, mask=pad)
    o_p = fa.flash_plain_lse(q, k, v, mask=pad)[0]
    p0 = int(pads[0])  # row p0 of sequence 0 sees key p0 alone
    checks["flipped_key_max_abs_err"] = must_fail_within(
        name, f"with key {p0} of sequence 0 flipped", fa.flash_attention(
            q, k, v, mask=flipped(pad, (0, p0))), o_p)
    qb, kb, vb = to_bhsd(q, k, v)
    ob = fa.flash_attention(qb, kb, vb, mask=pad, q_layout="bhsd", kv_layout="bhsd",
                            out_layout="bhsd")
    checks["bhsd_same_bits"] = bool(torch.equal(ob.transpose(1, 2), o))
    if not checks["bhsd_same_bits"]:
        raise AssertionError(f"{name}: the bhsd layouts gave other bits")
    del qb, kb, vb, ob
    # the other reads of a key mask: bytes at D 64 (GPT-2 small's prefill
    # heads, left padding; row g + 8 takes row g's bits), and at D 128 where
    # Skv is odd
    B2, S2, Hq2, Hkv2, D2 = MASK_PREFIX
    q2, k2, v2 = attention_inputs(gen, B2, S2, S2, Hq2, Hkv2, D2)
    pad2, pads2 = left_pad_mask(gen, B2, S2, MASK_PAD)
    checks["gpt2_d64_left_pad"] = mask_case(fa, name, q2, k2, v2, pad2, (0, int(pads2[0])))
    del q2, k2, v2
    checks["odd_skv_d128_holes"] = odd_mask_cases(fa, gen, name, full=False)
    _, launches = path_launches(fa, lambda: ops.attention(
        q, k, v, mask=pad, impl=Impl(attention="flash")), dict(flash_attention=1))
    b_ms, b_by, pairs = mask_bound(B_, S, S, Hq, Hkv, D, True, mask="key")
    valid = fa.valid_mask(B_, Hq, S, S, causal=True, q_offset=0, kv_len=None, mask=pad,
                          device=dev)
    lib, why = library_ms(lambda: sdpa_masked(q, k, v, valid), 20)
    row = dict(
        name=name, route="cuda",
        source="mlio_tpu_torch/csrc/flash_fwd.cu (flash_fwd.cuh, kMasked tiles with the mask's "
               "bits: mlio_flash_fwd)",
        replaces="mlio_tpu/ops/flash_attention.py:37 (mask_kind 'key', :124-126; the wrapper "
                 ":698-708)",
        shape=f"q/k/v [{B_},{S},{Hq}|{Hkv},{D}] bf16, causal, key mask [{B_},{S}] int8 "
              f"(left padding 0..{MASK_PAD})",
        max_abs_err=checks["left_pad"]["max_abs_err"], atol=TOL[name][0], rtol=TOL[name][1],
        row_rel_rms_limit=ROW_REL_RMS[name], checks=checks, launches=launches["flash_attention"],
        launches_note="one ops.attention(mask=..., impl=Impl(attention='flash')) call, the "
                      "counters zeroed around it",
        **timings(lambda i: fa.flash_attention(q, k, v, mask=pad),
                  lambda i: fa.flash_plain_lse(q, k, v, mask=pad), None, 20),
        bound_ms=b_ms, bound_by=b_by, pairs=pairs)
    row.update(library_ms=lib, library_note=why or "F.scaled_dot_product_attention with the "
               "boolean mask (causal and the key mask), K/V repeated to the query heads outside "
               "the timing",
               unmasked_ms=time_ms(lambda i: fa.flash_attention(q, k, v), 20)[0])
    return row


def full_mask_row(fa, dev, gen):
    """K1 with full masks: a 3-D prefix-LM mask at MASK_PREFIX (causal
    False; sequence 0's prefix is one token, so its row 0 sees key 0 alone)
    and a 4-D per-head random mask at MASK_PER_HEAD (causal, MASK_KEEP, key
    0 kept); each against its plain version (the 4-D one's lse too), each
    failing with the one key of a row flipped; through ops.attention; timed
    beside the plain version and SDPA with the boolean mask."""
    from mlio_tpu_torch import ops
    from mlio_tpu_torch.models import Impl

    name = "flash_attention_full_mask"
    B_, S, Hq, Hkv, D = MASK_PREFIX
    q, k, v = attention_inputs(gen, B_, S, S, Hq, Hkv, D)
    pre = torch.randint(1, S, (B_,), generator=gen, device=dev)
    pre[0] = 1
    i = torch.arange(S, device=dev)
    m = ((i[None, None, :] < pre[:, None, None]) | (i[None, None, :] <= i[None, :, None]))
    m = m.to(torch.int8)  # [B, Sq, Skv]
    o = fa.flash_attention(q, k, v, mask=m, causal=False)
    o_p = fa.flash_plain_lse(q, k, v, mask=m, causal=False)[0]
    checks = dict(prefix_lm=dict(max_abs_err=check_close(name, o, o_p),
                                 row_rel_rms=row_rel_rms(o, o_p)))
    checks["prefix_lm"]["flipped_key_max_abs_err"] = must_fail_within(
        name, "with key 0 of sequence 0's row 0 flipped",
        fa.flash_attention(q, k, v, mask=flipped(m, (0, 0, 0)), causal=False), o_p)
    checks["odd_skv_d128_holes"] = odd_mask_cases(fa, gen, name, full=True)
    _, launches = path_launches(fa, lambda: ops.attention(
        q, k, v, mask=m, causal=False, impl=Impl(attention="flash")), dict(flash_attention=1))
    b_ms, b_by, pairs = mask_bound(B_, S, S, Hq, Hkv, D, False, mask="full")
    valid = m[:, None].bool()
    lib, why = library_ms(lambda: sdpa_masked(q, k, v, valid), 20)
    row = dict(
        name=name, route="cuda",
        source="mlio_tpu_torch/csrc/flash_fwd.cu (flash_fwd.cuh, kMasked tiles with the mask's "
               "bits: mlio_flash_fwd)",
        replaces="mlio_tpu/ops/flash_attention.py:37 (mask_kind 'full', :127-129; the wrapper "
                 ":709-716)",
        shape=f"q/k/v [{B_},{S},{Hq},{D}] bf16, not causal, prefix-LM mask [{B_},{S},{S}] int8",
        max_abs_err=checks["prefix_lm"]["max_abs_err"], atol=TOL[name][0], rtol=TOL[name][1],
        row_rel_rms_limit=ROW_REL_RMS[name], checks=checks, launches=launches["flash_attention"],
        launches_note="one ops.attention(mask=..., causal=False, impl=Impl(attention='flash')) "
                      "call, the counters zeroed around it",
        **timings(lambda i: fa.flash_attention(q, k, v, mask=m, causal=False),
                  lambda i: fa.flash_plain_lse(q, k, v, mask=m, causal=False)[0], None, 20),
        bound_ms=b_ms, bound_by=b_by, pairs=pairs)
    row.update(library_ms=lib, library_note=why or "F.scaled_dot_product_attention with the "
               "boolean mask, K/V repeated to the query heads outside the timing",
               unmasked_ms=time_ms(lambda i: fa.flash_attention(q, k, v, causal=False), 20)[0])
    del q, k, v, m, valid, o, o_p

    B_, S, Hq, Hkv, D = MASK_PER_HEAD
    q, k, v = attention_inputs(gen, B_, S, S, Hq, Hkv, D)
    m = holes_mask(gen, (B_, Hq, S, S))  # 134 MB of int8
    o, lse = fa.flash_attention(q, k, v, mask=m, return_stats=True)
    o_p, lse_p = fa.flash_plain_lse(q, k, v, mask=m)
    per_head = dict(max_abs_err=check_close(name, o, o_p), row_rel_rms=row_rel_rms(o, o_p),
                    lse_max_abs_err=check_lse(f"{name}_lse", lse, lse_p))
    per_head["flipped_key_max_abs_err"] = must_fail_within(
        name, f"with key 0 of head {Hq // 2}'s row 0 flipped",
        fa.flash_attention(q, k, v, mask=flipped(m, (0, Hq // 2, 0, 0))), o_p)
    _, pl = path_launches(fa, lambda: ops.attention(q, k, v, mask=m,
                                                    impl=Impl(attention="flash")),
                          dict(flash_attention=1))
    b_ms, b_by, pairs = mask_bound(B_, S, S, Hq, Hkv, D, True, mask="full", mask_heads=Hq)
    valid = m.bool() & torch.ones(S, S, dtype=torch.bool, device=dev).tril()
    lib, why = library_ms(lambda: sdpa_masked(q, k, v, valid), 10)
    per_head.update(
        shape=f"q [{B_},{S},{Hq},{D}] k/v [{B_},{S},{Hkv},{D}] bf16, causal, per-head mask "
              f"[{B_},{Hq},{S},{S}] int8 ({m.numel() / 1e6:.0f} MB), keep {MASK_KEEP}",
        launches=pl["flash_attention"],
        **timings(lambda i: fa.flash_attention(q, k, v, mask=m),
                  lambda i: fa.flash_plain_lse(q, k, v, mask=m)[0], None, 10),
        bound_ms=b_ms, bound_by=b_by, pairs=pairs)
    per_head.update(library_ms=lib, library_note=why or "F.scaled_dot_product_attention with "
                    "the boolean mask (the per-head mask and causal), K/V repeated",
                    unmasked_ms=time_ms(lambda i: fa.flash_attention(q, k, v), 10)[0])
    row["llama3_8b_per_head"] = per_head
    return row


def mask_32k(fa, dev, gen):
    """K1 with a key mask (random holes, MASK_KEEP, key 0 kept) at
    Mistral's 32K prefill call (STREAM_CASES' first: B 1, 32,704 queries
    over 32,768 slots, kv_len 32,704): ops.attention must launch K1 and no
    K10; the first, a middle and the last MASK_BLOCK-row q blocks against
    the plain version computed for those rows alone (q_offset at the
    block); failing with key 0 flipped (row 0 sees it alone); timed beside
    SDPA with the boolean mask. Returns (the entry, q, k, v)."""
    from mlio_tpu_torch import ops
    from mlio_tpu_torch.models import Impl

    name = "flash_attention_key_mask_32k"
    _, Bc, Sq, Skv, Hq, Hkv, D, causal, _, kvl = STREAM_CASES[0]
    q, k, v = attention_inputs(gen, Bc, Sq, Skv, Hq, Hkv, D)
    m = holes_mask(gen, (Bc, Skv))
    o, launches = path_launches(fa, lambda: ops.attention(
        q, k, v, kv_len=kvl, mask=m, impl=Impl(attention="flash")), dict(flash_attention=1))
    blocks = {}
    for start in (0, (Sq // 2 // MASK_BLOCK) * MASK_BLOCK, Sq - MASK_BLOCK):
        rows = slice(start, start + MASK_BLOCK)
        o_p = fa.flash_plain_lse(q[:, rows], k, v, q_offset=start, kv_len=kvl, mask=m)[0]
        blocks[str(start)] = dict(max_abs_err=check_close(name, o[:, rows], o_p),
                                  row_rel_rms=row_rel_rms(o[:, rows], o_p))
        if start == 0:
            blocks["flipped_key_0_max_abs_err"] = must_fail_within(
                name, "with key 0 flipped", fa.flash_attention(
                    q, k, v, kv_len=kvl, mask=flipped(m, (0, 0)))[:, rows], o_p)
    b_ms, b_by, pairs = mask_bound(Bc, Sq, kvl, Hq, Hkv, D, True, mask="key")
    ms = time_ms(lambda i: fa.flash_attention(q, k, v, kv_len=kvl, mask=m), 3, warmup=1)[0]
    valid = fa.valid_mask(Bc, Hq, Sq, Skv, causal=True, q_offset=0, kv_len=kvl, mask=m,
                          device=dev)
    lib, why = library_ms(lambda: sdpa_masked(q, k, v, valid), 3)
    del valid
    torch.cuda.empty_cache()
    entry = dict(
        shape=f"q [{Bc},{Sq},{Hq},{D}] k/v [{Bc},{Skv},{Hkv},{D}] bf16, kv_len {kvl}, causal, "
              f"key mask [{Bc},{Skv}] (Mistral-7B-Instruct-v0.2's prefill at 32K)",
        launches=launches, blocks=blocks, atol=TOL[name][0], row_rel_rms_limit=ROW_REL_RMS[name],
        ms=ms, plain_ms=None,
        plain_note="the plain version at this size needs 137 GB of scores: its three q blocks "
                   "are checked, not timed", bound_ms=b_ms, bound_by=b_by, pairs=pairs,
        tflop_per_s=4 * Hq * D * pairs / (ms * 1e-3) / 1e12, library_ms=lib,
        library_note=why or "F.scaled_dot_product_attention with the boolean [Sq, Skv] mask")
    return entry, q, k, v


def ring_step(fa, q, k, v):
    """ring_attention.chunk_step_flash at Mistral's 32K call (mask_32k's q,
    K and V, no mask): chunks of RING_CHUNKS keys merged, the first size on
    K1's route (the later chunks at negative relative offsets, kv_len 0 past
    the context), the second on K10's; each finalized result held against
    one K10 call (o within K10's limits, each row by ROW_REL_RMS; the merged
    lse within 1e-4), failing with the last chunk left out. Returns the
    entry (with each size's launches)."""
    from mlio_tpu_torch.ops import ring_attention as ra

    _, Bc, Sq, Skv, Hq, Hkv, D, causal, _, kvl = STREAM_CASES[0]
    want, want_lse = fa.flash_attention_stream(q, k, v, kv_len=kvl, return_stats=True)
    out = {}
    for C in RING_CHUNKS:
        for n in ("flash_attention", "flash_attention_stream"):
            getattr(fa, n).launches = 0
        state = ra.init_stats(Bc, Hq, Sq, D, device=q.device)
        for c0 in range(0, Skv, C):
            before = state
            state = ra.chunk_step_flash(q, k[:, c0:c0 + C], v[:, c0:c0 + C], *state,
                                        scale=D ** -0.5, q_offset=0, k_offset=c0, causal=causal,
                                        kv_len=kvl)
        m, l, acc = state
        got = ra.finalize(m, l, acc, q.dtype)
        lse = (m + torch.log(torch.where(l == 0, 1.0, l)))[..., 0]
        res = dict(launches=dict(flash_attention=fa.flash_attention.launches,
                                 flash_attention_stream=fa.flash_attention_stream.launches),
                   max_abs_err=check_close("ring_merge", got, want),
                   row_rel_rms=row_rel_rms(got, want),
                   lse_max_abs_err=check_lse("ring_merge_lse", lse, want_lse))
        n = -(-Skv // C)
        want_route = (dict(flash_attention=0, flash_attention_stream=n)
                      if fa.stream_route(C, D, 2) else dict(flash_attention=n,
                                                           flash_attention_stream=0))
        if res["launches"] != want_route:
            raise AssertionError(f"ring step C {C}: launches {res['launches']}, "
                                 f"not {want_route}")
        res["last_chunk_left_out_max_abs_err"] = must_fail_within(
            "ring_merge", "with the last chunk left out", ra.finalize(*before, q.dtype), want)
        out[str(C)] = res
        del state, before, got, lse, m, l, acc
        torch.cuda.empty_cache()
    return out


def lse_dropout_row(fa, fg, dev, gen):
    """K1's lse instance under dropout (rate 0.1, DROP_SEED) at
    MASK_PER_HEAD's llama3-8b training attention: o and the lse (l sums p
    before the drop) against the plain version, the same bits twice, the
    same bits as K13a's forward and in the bhsd layouts; failing with the
    seed one off; through flash_attention(..., return_stats=True); timed
    beside the plain version and aten._scaled_dot_product_flash_attention
    with dropout 0.1 (o and logsumexp)."""
    name = "flash_attention_lse_dropout"
    B_, S, Hq, Hkv, D = MASK_PER_HEAD
    q, k, v = attention_inputs(gen, B_, S, S, Hq, Hkv, D)
    kw = dict(dropout_rate=0.1, dropout_seed=DROP_SEED, return_stats=True)
    (o, lse), launches = path_launches(fa, lambda: fa.flash_attention(q, k, v, **kw),
                                       dict(flash_attention=1))
    o_p, lse_p = fa.flash_plain_lse(q, k, v, dropout_rate=0.1, dropout_seed=DROP_SEED)
    checks = dict(row_rel_rms=row_rel_rms(o, o_p),
                  lse_max_abs_err=check_lse(f"{name}_lse", lse, lse_p))
    checks["same_bits_twice"] = same_bits_twice(
        name, lambda: torch.cat([t.flatten().float()
                                 for t in fa.flash_attention(q, k, v, **kw)]))
    o13, lse13 = fg.flash_fwd_lse(q, k, v, dropout_rate=0.1, dropout_seed=DROP_SEED)
    checks["k13a_same_bits"] = bool(torch.equal(o13, o) and torch.equal(lse13, lse))
    qb, kb, vb = to_bhsd(q, k, v)
    ob, lb = fa.flash_attention(qb, kb, vb, q_layout="bhsd", kv_layout="bhsd",
                                out_layout="bhsd", **kw)
    checks["bhsd_same_bits"] = bool(torch.equal(ob.transpose(1, 2), o) and torch.equal(lb, lse))
    if not (checks["k13a_same_bits"] and checks["bhsd_same_bits"]):
        raise AssertionError(f"{name}: other bits than K13a's or in the bhsd layouts {checks}")
    del qb, kb, vb, ob, lb
    checks["seed_one_off_max_abs_err"] = must_fail_within(
        name, "against the plain version with the seed one off", o,
        fa.flash_plain_lse(q, k, v, dropout_rate=0.1, dropout_seed=DROP_SEED + 1)[0])
    b_ms, b_by, pairs = mask_bound(B_, S, S, Hq, Hkv, D, True, lse=True)
    G = Hq // Hkv
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (t.transpose(1, 2).repeat_interleave(G, dim=1).contiguous() for t in (k, v))
    lib, why = library_ms(lambda: lambda i: torch.ops.aten._scaled_dot_product_flash_attention(
        qt, kt, vt, 0.1, True), 10)
    return dict(
        name=name, route="cuda",
        source="mlio_tpu_torch/csrc/flash_fwd.cu (flash_fwd.cuh, kDrop and kLse: "
               "mlio_flash_fwd)",
        replaces="mlio_tpu/ops/flash_attention.py:37 (with_stats and dropout_rate > 0 "
                 "together, :140-150, :166-172)",
        shape=f"q [{B_},{S},{Hq},{D}] k/v [{B_},{S},{Hkv},{D}] bf16, causal, dropout 0.1",
        max_abs_err=check_close(name, o, o_p), atol=TOL[name][0], rtol=TOL[name][1],
        lse_atol=TOL[f"{name}_lse"][0], row_rel_rms_limit=ROW_REL_RMS[name], checks=checks,
        launches=launches["flash_attention"],
        launches_note="one flash_attention(..., dropout_rate=0.1, return_stats=True) call, the "
                      "counters zeroed around it",
        **timings(lambda i: fa.flash_attention(q, k, v, **kw),
                  lambda i: fa.flash_plain_lse(q, k, v, dropout_rate=0.1,
                                               dropout_seed=DROP_SEED), None, 10),
        bound_ms=b_ms, bound_by=b_by, pairs=pairs) | dict(
        library_ms=lib, library_note=why or "aten._scaled_dot_product_flash_attention with "
        "dropout 0.1 (o and logsumexp; its own random bits), K/V repeated to the query heads",
        without_lse_ms=time_ms(lambda i: fa.flash_attention(
            q, k, v, dropout_rate=0.1, dropout_seed=DROP_SEED), 10)[0])


def kvq_mask_lse_row(fa, dev, gen):
    """K9 with a key mask (left padding 0..MASK_PAD) and the lse at
    generate_moe's shape (KVQ_MOE: 8 x 704 queries over a 1024-slot INT8
    cache, kv_len 704, 32/8 heads of 128): o and the lse against the plain
    version; failing with the one key of sequence 0's first kept position
    flipped; the same bits in the bhsd layouts (scales [B, Hkv, Skv]); a
    full mask raises; through flash_attention(..., return_stats=True) (K9,
    no K1); timed beside the plain version and SDPA over the K/V dequantized
    to bf16 with the boolean mask."""
    name = "flash_attention_kvq_mask_lse"
    B_, Sq, Skv, Hq, Hkv, D = KVQ_MOE
    q = torch.randn((B_, Sq, Hq, D), generator=gen, device=dev).to(torch.bfloat16)
    kq, ks = int8_kv(gen, (B_, Skv, Hkv, D), dev)
    vq, vs = int8_kv(gen, (B_, Skv, Hkv, D), dev)
    m, pads = left_pad_mask(gen, B_, Skv, MASK_PAD)
    kw = dict(kv_len=Sq, mask=m, k_scale=ks, v_scale=vs)
    (o, lse), launches = path_launches(fa, lambda: fa.flash_attention(
        q, kq, vq, return_stats=True, **kw), dict(flash_attention_kvq=1))
    o_p, lse_p = fa.flash_attention_kvq_plain(q, kq, vq, ks, vs, kv_len=Sq, mask=m,
                                              return_stats=True)
    checks = dict(row_rel_rms=row_rel_rms(o, o_p),
                  lse_max_abs_err=check_lse(f"{name}_lse", lse, lse_p))
    p0 = int(pads[0])
    checks["flipped_key_max_abs_err"] = must_fail_within(
        name, f"with key {p0} of sequence 0 flipped",
        fa.flash_attention(q, kq, vq, **dict(kw, mask=flipped(m, (0, p0)))), o_p)
    qb, kb, vb, ksb, vsb = to_bhsd(q, kq, vq, ks, vs)
    ob, lb = fa.flash_attention(qb, kb, vb, kv_len=Sq, mask=m, k_scale=ksb, v_scale=vsb,
                                return_stats=True, q_layout="bhsd", kv_layout="bhsd",
                                out_layout="bhsd")
    checks["bhsd_same_bits"] = bool(torch.equal(ob.transpose(1, 2), o) and torch.equal(lb, lse))
    if not checks["bhsd_same_bits"]:
        raise AssertionError(f"{name}: the bhsd layouts gave other bits")
    try:
        fa.flash_attention(q, kq, vq, **dict(kw, mask=torch.ones(B_, Sq, Skv, device=dev)))
    except NotImplementedError:
        checks["full_mask_raises"] = True
    else:
        raise AssertionError(f"{name}: a full mask over an INT8 cache did not raise")
    b_ms, b_by, pairs = mask_bound(B_, Sq, Sq, Hq, Hkv, D, True, mask="key", lse=True,
                                   kv_bytes=1, scale_bytes=4)
    kd, vd = dequant_bf16(kq, ks), dequant_bf16(vq, vs)
    valid = fa.valid_mask(B_, Hq, Sq, Skv, causal=True, q_offset=0, kv_len=Sq, mask=m,
                          device=dev)
    lib, why = library_ms(lambda: sdpa_masked(q, kd, vd, valid), 20)
    return dict(
        name=name, route="cuda",
        source="mlio_tpu_torch/csrc/flash_fwd.cu (flash_fwd.cuh, kQuant and kLse: "
               "mlio_flash_fwd)",
        replaces="mlio_tpu/ops/flash_attention.py:199 (mask_kind 'key', :271-273; with_stats, "
                 ":297-301)",
        shape=f"q [{B_},{Sq},{Hq},{D}] bf16, k/v [{B_},{Skv},{Hkv},{D}] int8 with fp32 scales, "
              f"kv_len {Sq}, causal, key mask [{B_},{Skv}] (generate_moe's prefill heads)",
        max_abs_err=check_close(name, o, o_p), atol=TOL[name][0], rtol=TOL[name][1],
        lse_atol=TOL[f"{name}_lse"][0], row_rel_rms_limit=ROW_REL_RMS[name], checks=checks,
        launches=launches["flash_attention_kvq"],
        launches_note="one flash_attention(..., k_scale=, v_scale=, mask=, return_stats=True) "
                      "call, the counters zeroed around it",
        **timings(lambda i: fa.flash_attention(q, kq, vq, return_stats=True, **kw),
                  lambda i: fa.flash_attention_kvq_plain(q, kq, vq, ks, vs, kv_len=Sq, mask=m,
                                                         return_stats=True), None, 20),
        bound_ms=b_ms, bound_by=b_by, pairs=pairs) | dict(
        library_ms=lib, library_note=why or "F.scaled_dot_product_attention over the K/V "
        "dequantized to bf16 (a yardstick: the dequantize not timed) with the boolean mask",
        unmasked_without_lse_ms=time_ms(lambda i: fa.flash_attention(
            q, kq, vq, kv_len=Sq, k_scale=ks, v_scale=vs), 20)[0])


def masks_phase(dev, seed, fa, fg):
    """The masks slice's kernels (MASK_ROWS) on the card, then the 32K key
    mask and the ring step. Returns the kernels line's rows; the 32K entry
    and the ring step's launches ride on the key-mask row."""
    gen = torch.Generator(device=dev).manual_seed(seed + 23)
    rows = [key_mask_row(fa, dev, gen)]
    torch.cuda.empty_cache()
    rows.append(full_mask_row(fa, dev, gen))
    torch.cuda.empty_cache()
    rows.append(kvq_mask_lse_row(fa, dev, gen))
    torch.cuda.empty_cache()
    rows.append(lse_dropout_row(fa, fg, dev, gen))
    torch.cuda.empty_cache()
    entry, q, k, v = mask_32k(fa, dev, gen)
    rows[0]["mistral_32k"] = entry
    ring = ring_step(fa, q, k, v)
    del q, k, v
    torch.cuda.empty_cache()
    emit(dict(phase="masks", nvidia_smi=nvidia_smi(),
              rows={r["name"]: {k: v for k, v in r.items() if k != "name"} for r in rows},
              ring_step=ring))
    return rows, ring


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
        return real(q, k, stale_tile(v, STALE_KEYS[0], fa.STREAM_BLOCK_KV), **kw)

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

    from mlio_tpu_torch.profiling import device_busy_ms

    from mlio_tpu_torch.models import Impl, forward, init_params, spec_from_hf_config
    from mlio_tpu_torch.models.transformer import decode_route
    from mlio_tpu_torch.runtime import generate

    spec = spec_from_hf_config(MISTRAL_CONFIG, name="mistral-7b-instruct-v0.2")
    L = spec.num_layers
    ids = torch.from_numpy(np.random.default_rng(seed).integers(
        0, spec.vocab_size, (1, LC_PROMPT))).to(dev)
    impl = Impl(attention="flash", norm="fused")
    ring_impl = Impl(attention="ring", norm="fused")
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
    # the ring route: its single-device fold makes the flash route's K10
    # calls, so the same launches and the same tokens, bit for bit
    for w in wrappers:
        w.launches = 0
    out_ring = generate(params, spec, ids, max_new_tokens=LC_NEW, impl=ring_impl,
                        cache_len=LC_CACHE, device=dev)
    ring = dict(launches={w.__name__: w.launches for w in wrappers},
                tokens_same_bits=bool(torch.equal(out_ring, out)))
    if ring["launches"] != want or not ring["tokens_same_bits"]:
        raise AssertionError(f"long_context: the ring route {ring} against the flash route's "
                             f"launches {want}")
    del out_ring

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
    for w in wrappers:
        w.launches = 0
    with torch.inference_mode():
        ring_logits = forward(params, spec, ids, impl=ring_impl, cache=dict(cache, pos=0))[0]
    ring.update(prefill_launches={w.__name__: w.launches for w in wrappers if w.launches},
                prefill_logits_same_bits=bool(torch.equal(ring_logits, logits)))
    if ring["prefill_launches"] != dict(flash_attention_stream=L, fused_norm=2 * L + 1) \
            or not ring["prefill_logits_same_bits"]:
        raise AssertionError(f"long_context: the ring route's prefill {ring}")
    del logits, ring_logits
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
    busy = device_busy_ms(events)
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
                  auto_route=picked, launches=launches, ring=ring, generate_s=generate_s,
                  prefill_ms=prefill_ms, prefill_ms_runs=walls,
                  prefill_tok_per_s=LC_PROMPT / (prefill_ms / 1e3),
                  prefill_traced_ms=traced_ms, prefill_device_busy_ms=busy,
                  prefill_idle_share=1 - busy / traced_ms,
                  prefill_k10_ms=k10_ms, prefill_k10_share=k10_ms / busy,
                  prefill_k10_ms_a_layer=k10_ms / L,
                  decode_ctx=LC_PROMPT, decode_step_ms=decode_step_ms,
                  decode_step_device_ms=step_dev_ms, peak_bytes=peak,
                  allocated_before_bytes=before,
                  params_bytes=sum(t.numel() * t.element_size()
                                   for _, t in _named_leaves(params)))
    emit(result)
    del params, cache, out
    torch.cuda.empty_cache()
    return launches



# ---------------------------------------------------------------------------
# The families slice: Gemma-7B (head dim 256) and Phi-2 (head dim 80)
# ---------------------------------------------------------------------------

GEMMA, PHI = "gemma-7b", "phi-2"
# Each family's decode route at B 8, bf16 (models.transformer.decode_route):
# Gemma's 553 MB layers take K6; Phi-2's parallel residual takes the scan (K3)
FAMILY_ROUTES = {GEMMA: "tiled", PHI: "scan"}
FAMILY_K6_LAYERS = 2  # K6's row at gemma-7b's full width: two layers of its weights
FAMILY_K3_LAYERS = 4  # K3's timed launches walk 4 layers' caches (no layer's K/V left in L2)
FAMILY_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "families")


def second_consumer_rows(q, rows=64):
    """q ([B, S, H, D]) with rows 64-127 of each 128-row tile (the second
    consumer's of K1 at head dim 256) taken from rows 0-63."""
    q = q.clone()
    for t in range(0, q.shape[1], 2 * rows):
        n = min(rows, q.shape[1] - t - rows)
        if n > 0:
            q[:, t + rows:t + rows + n] = q[:, t:t + n]
    return q


def nan_past(t, lens, dim=1):
    """A copy of a cache ([B, S, ...], or [L, B, S, ...] with dim 2) with
    NaN in every slot of sequence b at or past lens[b]."""
    t = t.clone()
    for b, n in enumerate(lens):
        if dim == 1:
            t[b, n:] = float("nan")
        else:
            t[:, b, n:] = float("nan")
    return t


# K1's instance at each family head dim: its source and mangled name (D 256
# has a source of its own)
FAMILY_K1 = {256: ("flash_fwd_d256", r"flash_fwd_d256_kernel"),
             80: ("flash_fwd", r"flash_fwd_kernelILi80E")}


def family_attention_row(fa, gen, model):
    """K1 at a family's prefill: q [8, 704, Hq, D] into a 1024-slot cache
    holding 704 tokens, causal (gemma-7b: 16 heads of 256; phi-2: 32 of 80),
    against its plain version (K1's limits, each row too), failing with the
    keys and values 64-127 taken from 0-63 (a stale ring slot) and with q
    rows 64-127 of each 128-row tile taken from rows 0-63 (the second
    consumer's at D 256); the same bits twice, and over a cache with NaN in
    every slot past kv_len; timed beside the plain version, SDPA over the
    same 704 keys and the bound."""
    from mlio_tpu_torch.models import get_spec

    spec = get_spec(model)
    Hq, Hkv, D = spec.num_heads, spec.num_kv_heads, spec.head_size
    q, k, v = attention_inputs(gen, B, PROMPT, CACHE, Hq, Hkv, D)
    args = dict(causal=True, q_offset=0, kv_len=PROMPT)
    want = fa.flash_attention_plain(q, k, v, **args)
    o = fa.flash_attention(q, k, v, **args)
    err = check_close("flash_attention", o, want)
    rr = row_rel_rms(o, want)
    stale = must_fail_within("flash_attention", "K/V keys 64-127 from a stale slot",
                             fa.flash_attention(q, stale_tile(k, 64), stale_tile(v, 64), **args),
                             want)
    second = must_fail_within("flash_attention",
                              "q rows 64-127 of each 128-row tile from rows 0-63",
                              fa.flash_attention(second_consumer_rows(q), k, v, **args), want)
    twice = same_bits_twice("flash_attention", lambda: fa.flash_attention(q, k, v, **args))
    kn, vn = (nan_past(t, [PROMPT] * B) for t in (k, v))
    if not torch.equal(fa.flash_attention(q, kn, vn, **args), o):
        raise AssertionError(f"flash_attention_d{D}: NaN past kv_len changed the output's bits")
    del o, want, kn, vn
    qs, ks, vs = (t.transpose(1, 2) for t in (q, k[:, :PROMPT], v[:, :PROMPT]))
    pairs = causal_pairs(PROMPT, PROMPT, True)
    flops = 4 * B * Hq * D * pairs
    b_ms, b_by = bound((2 * q.numel() + 2 * B * PROMPT * Hkv * D) * 2, flops, BF16_TENSOR_FLOPS)
    source, pattern = FAMILY_K1[D]
    row = dict(
        name=f"flash_attention_d{D}", route="cuda", source=f"mlio_tpu_torch/csrc/{source}.cu",
        replaces="mlio_tpu/ops/flash_attention.py:37",
        shape=f"{model}'s prefill: q [{B},{PROMPT},{Hq},{D}] k/v [{B},{CACHE},{Hkv},{D}] bf16, "
              f"kv_len {PROMPT}, causal",
        max_abs_err=err, atol=TOL["flash_attention"][0], rtol=TOL["flash_attention"][1],
        row_rel_rms=rr, row_rel_rms_limit=ROW_REL_RMS["flash_attention"],
        stale_kv_tile_max_abs_err=stale, second_consumer_rows_max_abs_err=second,
        same_bits_twice=twice, nan_past_kv_len_same_bits=True,
        **timings(lambda i: fa.flash_attention(q, k, v, **args),
                  lambda i: fa.flash_attention_plain(q, k, v, **args),
                  lambda i: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True), 30),
        bound_ms=b_ms, bound_by=b_by, ptxas=kernel_instances(source, pattern))
    row["tflop_per_s"] = flops / (row["ms"] * 1e-3) / 1e12
    return row


def family_decode_row(da, gen, model):
    """K3 at a family's decode: q [8, Hq, D] over a [4, 8, 1024, Hkv, D]
    cache at context 896 (phi-2: 32 heads of 80, the TMA pass; gemma-7b's
    scan route: 16 of 256), one query head a KV head, against its plain
    version (K3's fp32 limit), failing with a context one token short, at
    the ragged contexts too; the same bits twice, and over a cache with NaN
    in every slot past each context (896 and the ragged ones); timed
    (walking the layers) beside the plain version, SDPA over the same keys
    and the bound."""
    from mlio_tpu_torch.models import get_spec

    spec = get_spec(model)
    Hq, Hkv, D, L = spec.num_heads, spec.num_kv_heads, spec.head_size, FAMILY_K3_LAYERS

    def r(*shape):
        return torch.randn(*shape, generator=gen, device=gen.device).to(torch.bfloat16)

    qd, kc, vc = r(B, Hq, D), r(L, B, CACHE, Hkv, D), r(L, B, CACHE, Hkv, D)
    ctx = torch.full((B,), DECODE_CTX, dtype=torch.int32, device=gen.device)
    want = da.decode_attention_plain(qd, kc, vc, ctx, layer=1)
    err = check_close("decode_attention", da.decode_attention(qd, kc, vc, ctx, layer=1), want)
    short = must_fail_within("decode_attention", "a context one token short",
                             da.decode_attention(qd, kc, vc, ctx - 1, layer=1), want)
    ragged = torch.tensor(RAGGED, dtype=torch.int32, device=gen.device)
    ragged_out = da.decode_attention(qd, kc, vc, ragged, layer=2)
    ragged_err = check_close("decode_attention", ragged_out,
                             da.decode_attention_plain(qd, kc, vc, ragged, layer=2))
    for lens, c, lay, clean in (([DECODE_CTX] * B, ctx, 1, None), (RAGGED, ragged, 2, ragged_out)):
        kn, vn = (nan_past(t, lens, dim=2) for t in (kc, vc))
        clean = da.decode_attention(qd, kc, vc, c, layer=lay) if clean is None else clean
        if not torch.equal(da.decode_attention(qd, kn, vn, c, layer=lay), clean):
            raise AssertionError(f"decode_attention_d{D}: NaN past the context changed the "
                                 "output's bits")
        del kn, vn
    nbytes = (2 * qd.numel() + 2 * B * DECODE_CTX * Hkv * D) * 2
    b_ms, b_by = bound(nbytes, 4 * B * Hq * DECODE_CTX * D, FP32_FLOPS)
    q4 = qd[:, :, None, :]
    n_split, chunk = da.split_plan(B, Hkv, CACHE)
    row = dict(
        name=f"decode_attention_d{D}", route="cuda", source="mlio_tpu_torch/csrc/decode_attn.cu",
        replaces="mlio_tpu/ops/decode_attention.py:50",
        shape=f"{model}'s decode: q [{B},{Hq},{D}] cache [{L},{B},{CACHE},{Hkv},{D}] bf16, "
              f"ctx {DECODE_CTX}",
        max_abs_err=err, atol=TOL["decode_attention"][0], rtol=TOL["decode_attention"][1],
        ctx_minus_1_max_abs_err=short, ragged_max_abs_err=ragged_err,
        nan_past_context_same_bits=True,
        same_bits_twice=same_bits_twice("decode_attention",
                                        lambda: da.decode_attention(qd, kc, vc, ctx, layer=1)),
        **timings(lambda i: da.decode_attention(qd, kc, vc, ctx, layer=i % L),
                  lambda i: da.decode_attention_plain(qd, kc, vc, ctx, layer=i % L),
                  lambda i: F.scaled_dot_product_attention(
                      q4, kc[i % L, :, :DECODE_CTX].transpose(1, 2),
                      vc[i % L, :, :DECODE_CTX].transpose(1, 2)), 200),
        bound_ms=b_ms, bound_by=b_by, n_split=n_split, chunk=chunk,
        ptxas=kernel_instances("decode_attn", rf"decode_tma_kernel.*Li{D}E" if D in
                               da.TMA_HEAD_DIMS else rf"decode_kernel.*Li{D}ELi1E"))
    row["gb_per_s"] = nbytes / (row["ms"] * 1e-3) / 1e9
    return row


# K6's row plants keys along each step's query so that attention peaks:
# the slots pos-1, pos-2 and pos-3 score this far above the logsumexp of the
# other slots' scores, and take about 0.66, 0.24 and 0.09 of each head's
# weight (peaked_keys).
FAMILY_PEAK_OVER = (4.0, 3.0, 2.0)


def peaked_keys(dt, spec, blocks, x, kc, vc, pos, cos, sin):
    """A copy of the K cache in which attention peaks: at every layer, KV
    head (one query head each) and batch row, the keys at slots pos-1, pos-2
    and pos-3 lie along this step's query, their scores FAMILY_PEAK_OVER
    above the logsumexp of the scores of slots 0..pos-4. Random keys alone
    spread the weight near-evenly over the context, and each head's output
    is then near V's mean, too small for x_out to show a head's attention
    gone wrong or a slot left out. Each layer's query is computed as the
    plain version computes it (the RMSNorm, Wq and the rotate-half RoPE in
    fp32) from the layer's input, which the plain version gives by running
    the layers before it over the planted cache."""
    L, H, D = spec.num_layers, spec.num_kv_heads, spec.head_size
    if spec.num_heads != H or spec.norm != "rmsnorm":
        raise ValueError("peaked_keys plants keys for one query head a KV head, after an RMSNorm")
    scale = D ** -0.5
    cs, sn = (t.to(x.dtype).float()[0] for t in (cos, sin))
    R = cs.shape[-1]
    kc = kc.clone()
    xl = x
    for layer in range(L):
        x32 = xl.float()
        h = (x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + spec.norm_eps)
             * blocks["ln1_scale"][layer].float()).to(x.dtype)
        q = (h.float() @ blocks["wq"][layer].float()).reshape(-1, H, D)
        qr = q[..., :R]
        q = torch.cat([qr * cs + torch.cat([-qr[..., R // 2:], qr[..., :R // 2]], -1) * sn,
                       q[..., R:]], -1)
        planted = len(FAMILY_PEAK_OVER)
        scores = scale * torch.einsum("bhd,bthd->bht", q, kc[layer, :, :pos - planted].float())
        lse = torch.logsumexp(scores, -1, keepdim=True)  # [B, H, 1]
        for i, over in enumerate(FAMILY_PEAK_OVER):
            want = lse + over  # scale * q . k = want
            kc[layer, :, pos - 1 - i] = (q * want / (scale * q.square().sum(-1, keepdim=True))
                                         ).to(kc.dtype)
        one = {k: None if v is None else v[layer:layer + 1] for k, v in blocks.items()}
        xl = dt.decode_layer_tiled_plain(xl, one, kc[layer:layer + 1].clone(),
                                         vc[layer:layer + 1].clone(), pos, cos, sin,
                                         spec=dataclasses.replace(spec, num_layers=1))
    return kc


def family_tiled_row(dt, dev, seed):
    """K6 at gemma-7b's full width (3072 hidden, 24576 intermediate, GeGLU,
    16 heads of 256), two layers of random bf16 weights from the seed, B 8,
    context 896 in a 1024-slot bf16 cache whose keys make attention peak on
    the last three slots (peaked_keys): against its plain version (x_out
    and every written slot, K6's limit), its x_out failing the deep check
    with a context one token short and with one KV head's query group left
    out of attention; the same bits twice; the card's GEMV plan against the
    mirror; device ms beside the plain version's, the bound and the phase
    durations."""
    from mlio_tpu_torch.models import get_spec, init_params, rope_cos_sin

    spec = dataclasses.replace(get_spec(GEMMA), num_layers=FAMILY_K6_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(seed + 19)
    params = init_params(spec, gen, dtype=torch.bfloat16, device=dev)
    blocks = params["blocks"]
    for key in ("ln1_scale", "ln2_scale"):  # norm weights off 1
        blocks[key].copy_((1 + 0.1 * torch.randn(blocks[key].shape, generator=gen,
                                                  device=dev)).to(torch.bfloat16))
    pos = DECODE_CTX - 1
    shape = (spec.num_layers, B, CACHE, spec.num_kv_heads, spec.head_size)
    kc = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    vc = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    x = torch.randn((B, spec.hidden_size), generator=gen, device=dev).to(torch.bfloat16)
    cos, sin = rope_cos_sin(torch.arange(pos, pos + 1, device=dev), spec.rope_dim,
                            spec.rope_theta)
    kc = peaked_keys(dt, spec, blocks, x, kc, vc, pos, cos, sin)
    x_plain, pcaches, errs = tiled_check(dt, spec, blocks, x, kc, vc, pos, cos, sin)
    row = dict(errors=errs, max_abs_err=errs["x_out"], ctx_minus_1_max_abs_err=tiled_must_fail(
        dt, spec, blocks, x, kc, vc, pos - 1, pos, cos, sin, (x_plain, pcaches),
        "a context one token short", x_must_fail=True),
        head_group_out_max_abs_err=tiled_x_must_fail(dt, spec, blocks, x, kc, vc, pos, cos, sin,
                                                     x_plain))
    del pcaches
    twice = [dt.decode_layer_tiled(x, blocks, kc.clone(), vc.clone(), pos, cos, sin, spec=spec)
             for _ in range(2)]
    if not torch.equal(*twice):
        raise AssertionError("decode_layer_tiled_d256: two runs give different bits")
    del twice
    plan = {}
    for phase in dt.GEMV_PHASES:
        nb, card = dt.card_items(spec, None, B, phase)
        if card != [tuple(i) for i in dt.item_plan(spec, None, nb=nb)[phase]["items"]]:
            raise AssertionError(f"decode_layer_tiled_d256: the card's plan of {phase} differs "
                                 "from item_plan's")
        plan[phase] = len(card)
    tk, tv = kc.clone(), vc.clone()
    b_ms, b_by = stack_bound(spec, params, B, B * DECODE_CTX, head=False)
    row.update(
        name="decode_layer_tiled_d256", route="cuda",
        source="mlio_tpu_torch/csrc/decode_tiled_d256.cu",
        replaces="mlio_tpu/ops/decode_tiled.py:362", atol=TOL["decode_layer_tiled"][0],
        rtol=TOL["decode_layer_tiled"][1], repeat_bitwise_equal=True,
        card_plan=dict(plan_matches_mirror=True, blocks=nb, items=plan),
        shape=f"{GEMMA} at full width, {spec.num_layers} layers, bf16 weights and cache "
              f"[{spec.num_layers},{B},{CACHE},{spec.num_kv_heads},{spec.head_size}], "
              f"ctx {DECODE_CTX}, no head",
        tiling=list(dt.choose_tiling(spec, B)),
        **timings(lambda i: dt.decode_layer_tiled(x, blocks, tk, tv, pos, cos, sin, spec=spec),
                  lambda i: dt.decode_layer_tiled_plain(x, blocks, tk, tv, pos, cos, sin,
                                                        spec=spec), None, 10),
        bound_ms=b_ms, bound_by=b_by,
        library_note="no single PyTorch call computes a decode step",
        ptxas=kernel_instances("decode_tiled_d256", r"tiled_kernel"))
    stamps = torch.zeros(dt.phase_stamps(spec), dtype=torch.int64, device=dev)
    dt.decode_layer_tiled(x, blocks, tk, tv, pos, cos, sin, spec=spec, phase_times=stamps)
    row["phase_us"] = tiled_phase_us(dt, spec, stamps, gemv_phase_bytes(spec, blocks))
    del params, blocks, kc, vc, tk, tv
    torch.cuda.empty_cache()
    return row


def family_launches(spec, route, steps):
    """The launch counts of a family's generate of ``steps`` decode steps:
    the prefill's K1 a layer and K2 a norm (one a layer under a shared
    LayerNorm, two otherwise, and the final one); then K6 and the head's K2
    a step ("tiled"), or K3 a layer and every norm a step ("scan")."""
    L = spec.num_layers
    norms = (1 if spec.shared_ln else 2) * L + 1
    want = dict(flash_attention=L, fused_norm=norms, decode_attention=0,
                decode_layer_stack=0, decode_layer_tiled=0)
    if route == "tiled":
        want["decode_layer_tiled"] = steps
        want["fused_norm"] += steps
    else:
        want["decode_attention"] = L * steps
        want["fused_norm"] += norms * steps
    return want


def family_generate(dev, seed, model, wrappers, fa, norms, da, qm, dt):
    """A family's path at full width and depth: ``load_model(model,
    seed=seed)`` in bf16, B 8, a 704-token prompt, a 1024-slot cache,
    greedy, Impl(attention="flash", norm="fused"). The prefill logits held
    against an fp32 plain path: their RMS error within LOGITS_8B_OVER_PLAIN
    of the bf16 plain path's, their max-abs within the plain path's plus
    FAMILY_MAX_SIGMAS of its RMS error; the kernel path with K1's output
    rounded to e4m3 must fail that gate. Then, on the
    route decode_route picks (and for gemma-7b also on "scan", K3's path),
    the first decode step's logits (the prefill's greedy token) under the
    same gate: the kernels' step from the kernels' prefill cache, the plain
    path's from its own, the fp32 path's the last row of its prefill over
    the prompt and that token; the step with its decode kernel's output
    (K6's x_out, or K3's attention) rounded to e4m3 must fail it. Then
    the launch counters around a 64-token generate, the decode step by the
    two-length marginal (64 against 320 new tokens), tok/s, a step's device
    ms (CUDA events) and device-busy ms (a torch.profiler trace), and the
    idle share. Returns (launch counts by route, result)."""
    from torch.profiler import ProfilerActivity, profile

    from mlio_tpu_torch.profiling import device_busy_ms

    from mlio_tpu_torch.models import Impl, forward, load_model
    from mlio_tpu_torch.models.transformer import decode_route
    from mlio_tpu_torch.runtime import generate, init_cache

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    spec, params = load_model(model, dtype=torch.bfloat16, device=dev, seed=seed)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    ids = torch.from_numpy(np.random.default_rng(seed).integers(
        0, spec.vocab_size, (B, PROMPT))).to(dev)
    base = Impl(attention="flash", norm="fused")
    picked = decode_route(spec, base, params["blocks"], B, smax=CACHE)
    if picked != FAMILY_ROUTES[model]:
        raise AssertionError(f"{model}: decode route {picked}, not {FAMILY_ROUTES[model]}")

    routes = (picked, "scan") if picked == "tiled" else (picked,)
    impls = {r: dataclasses.replace(base, decode_stack="auto" if r == picked else r)
             for r in routes}

    def prefill(impl=base):
        cache = init_cache(spec, B, CACHE, dtype=torch.bfloat16, device=dev)
        with torch.inference_mode():
            return forward(params, spec, ids, impl=impl, cache=cache)

    def step(route, cache, tok):  # the first decode step's logits [B, V]
        with torch.inference_mode():
            return forward(params, spec, tok, impl=impls[route], cache=dict(cache))[0][:, -1]

    def e4m3(kernel):  # 3 mantissa bits where bf16 keeps 7
        def rounded(*args, **kwargs):
            return kernel(*args, **kwargs).to(qm.FP8).to(torch.bfloat16)

        rounded.launches = 0  # the wrapper counts on the module name it is patched under
        return rounded

    decode_kernel = {"tiled": (dt, "decode_layer_tiled"), "scan": (da, "decode_attention")}
    logits, cache = prefill()
    if logits.shape != (B, PROMPT, spec.vocab_size) or not torch.isfinite(logits).all():
        raise AssertionError(f"{model}: prefill logits shape {tuple(logits.shape)} or not finite")
    tok = logits[:, -1].argmax(-1)[:, None]
    steps = {}
    for route in routes:
        module, name = decode_kernel[route]
        steps[route] = dict(kernels=step(route, cache, tok))
        with patched(module, name, e4m3(getattr(module, name))):
            steps[route]["control"] = step(route, cache, tok)
    del cache
    logits = logits.cpu()  # room for the fp32 path beside the weights
    with patched(fa, "flash_attention", e4m3(fa.flash_attention)):
        logits_ctl = prefill()[0].cpu()
    with plain_kernels(fa, norms, da, qm, dt):
        logits_plain, cache = prefill()
        for route in routes:
            steps[route]["plain"] = step(route, cache, tok)
        del cache
        logits_plain = logits_plain.cpu()
        ref = fp32_prefill(spec, params, torch.cat([ids, tok], 1), base, None, dev)
        logits_ref, step_ref = ref[:, :PROMPT], ref[:, PROMPT]
    errs = dict(kernels_vs_fp32=logit_errors(logits, logits_ref),
                plain_vs_fp32=logit_errors(logits_plain, logits_ref),
                k1_e4m3_control_vs_fp32=logit_errors(logits_ctl, logits_ref))
    logits_std = logits_ref.float().std().item()
    del ref, logits_ref, logits_ctl
    errs["kernels_vs_plain"] = logit_errors(logits, logits_plain.to(dev))
    del logits, logits_plain

    def gate(errs, what, control):
        plain = errs["plain_vs_fp32"]
        limits = dict(max_abs=plain["max_abs"] + FAMILY_MAX_SIGMAS * plain["rms"],
                      rms=LOGITS_8B_OVER_PLAIN * plain["rms"])

        def passes(path):
            return all(errs[path][stat] <= limit for stat, limit in limits.items())

        if not passes("kernels_vs_fp32"):
            raise AssertionError(f"{model}: the kernels' {what} logits lie farther from the fp32 "
                                 f"path than the bf16 plain path's (limits {limits}): {errs}")
        if passes(control):
            raise AssertionError(f"{model}: the {what} gate passes {control}: {errs}")
        return limits

    limits = gate(errs, "prefill", "k1_e4m3_control_vs_fp32")
    step_logits = {}
    for route in routes:
        got = steps.pop(route)
        serrs = {f"{path}_vs_fp32": logit_errors(got[path], step_ref)
                 for path in ("kernels", "plain", "control")}
        serrs["kernels_vs_plain"] = logit_errors(got["kernels"], got["plain"])
        control = serrs.pop("control_vs_fp32")
        serrs[f"{decode_kernel[route][1]}_e4m3_control_vs_fp32"] = control
        step_logits[route] = dict(errors=serrs, limits=gate(
            serrs, f"{route} decode step", f"{decode_kernel[route][1]}_e4m3_control_vs_fp32"))
    del step_ref, got
    result = dict(phase="families_generate", model=model, layers=spec.num_layers,
                  head_dim=spec.head_size, weights="bf16", batch=B, prompt=PROMPT,
                  cache_len=CACHE, load_s=load_s, prefill_logits=errs, prefill_limits=limits,
                  decode_step_logits=step_logits, fp32_logits_std=logits_std,
                  auto_route=picked, routes={})
    counts = {}
    for route in routes:
        impl = impls[route]

        def run(new_tokens):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = generate(params, spec, ids, max_new_tokens=new_tokens, impl=impl,
                           cache_len=CACHE, device=dev)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t

        run(4)  # warm-up
        for w in wrappers:
            w.launches = 0
        out, t_short = run(SHORT)
        launches = {w.__name__: w.launches for w in wrappers}
        want = family_launches(spec, route, SHORT - 1)
        want = {k: want.get(k, 0) for k in launches}
        if launches != want:
            raise AssertionError(f"{model} {route}: launch counts {launches} != expected {want}")
        if out.shape != (B, PROMPT + SHORT) or not torch.equal(out[:, :PROMPT], ids) \
                or int(out.min()) < 0 or int(out.max()) >= spec.vocab_size:
            raise AssertionError(f"{model} {route}: wrong shape, prompt changed or token out "
                                 "of range")
        _, t_long = run(LONG)
        step_s = (t_long - t_short) / (LONG - SHORT)
        cache = prefill(impl)[1]
        tok = out[:, PROMPT:PROMPT + 1]
        with torch.inference_mode():
            def step():  # one forward, rewriting the same cache slot each call
                return forward(params, spec, tok, impl=impl, cache=dict(cache))[0]

            # by CUDA events: an upper bound where a step's launches overflow
            # the launch queue (the scan: hundreds a step), as dispatch_times says
            step_dev_ms = time_ms(lambda i: step(), 3)[0]
            # After the earlier phases' traces, one trace of a K6 step came
            # back empty on the card, where a fresh process traces it whole:
            # an empty trace is taken again.
            for attempt in range(1, 4):
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    step()
                    torch.cuda.synchronize()
                step_busy_ms = device_busy_ms(prof.events())
                if step_busy_ms:
                    break
            else:
                raise AssertionError(f"{model} {route}: three traces of a step saw no device time")
        del cache
        result["routes"][route] = dict(
            launches=launches, generate_s={str(SHORT): t_short, str(LONG): t_long},
            decode_step_ms=step_s * 1e3, decode_tok_per_s=B / step_s,
            decode_step_device_ms=step_dev_ms, decode_step_busy_ms=step_busy_ms,
            busy_trace_attempts=attempt,
            decode_idle_share=1 - step_busy_ms / (step_s * 1e3))
        counts[route] = launches
    result["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
    del params
    torch.cuda.empty_cache()
    emit(result)
    return counts, result


def write_safetensors(path, tensors) -> None:
    """The safetensors layout, written without the ``safetensors`` package:
    an 8-byte little-endian header length, a JSON header of each tensor's
    dtype, shape and byte offsets (padded with spaces to 8 bytes), the raw
    little-endian bytes in the header's order."""
    from mlio_tpu_torch.models.loader import SAFETENSORS_DTYPES

    names = {dt: n for n, dt in SAFETENSORS_DTYPES.items()}
    header, off = {}, 0
    for key, t in tensors.items():
        n = t.numel() * t.element_size()
        header[key] = dict(dtype=names[t.dtype], shape=list(t.shape), data_offsets=[off, off + n])
        off += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for t in tensors.values():
            f.write(t.contiguous().cpu().view(torch.uint8).numpy().data)


def hf_checkpoint(spec, gen):
    """A family's HF checkpoint at the spec's shapes: (config.json's dict,
    its state dict in HF's names and [out, in] layout, bf16 from the seed)."""
    H, L, I = spec.hidden_size, spec.num_layers, spec.intermediate_size

    def r(*shape):
        return (0.02 * torch.randn(*shape, generator=gen, device=gen.device)).to(torch.bfloat16)

    sd = {"model.embed_tokens.weight": r(spec.vocab_size, H)}
    if spec.activation == "geglu":  # Gemma
        cfg = dict(model_type="gemma", vocab_size=spec.vocab_size, hidden_size=H,
                   num_hidden_layers=L, num_attention_heads=spec.num_heads,
                   num_key_value_heads=spec.num_kv_heads, head_dim=spec.head_size,
                   intermediate_size=I, max_position_embeddings=spec.max_seq_len,
                   rms_norm_eps=spec.norm_eps, rope_theta=spec.rope_theta)
        for i in range(L):
            p = f"model.layers.{i}."
            sd.update({p + "input_layernorm.weight": r(H),
                       p + "post_attention_layernorm.weight": r(H),
                       p + "self_attn.q_proj.weight": r(spec.q_dim, H),
                       p + "self_attn.k_proj.weight": r(spec.kv_dim, H),
                       p + "self_attn.v_proj.weight": r(spec.kv_dim, H),
                       p + "self_attn.o_proj.weight": r(H, spec.q_dim),
                       p + "mlp.gate_proj.weight": r(I, H), p + "mlp.up_proj.weight": r(I, H),
                       p + "mlp.down_proj.weight": r(H, I)})
        sd["model.norm.weight"] = r(H)
        return cfg, sd
    cfg = dict(model_type="phi", vocab_size=spec.vocab_size, hidden_size=H, num_hidden_layers=L,
               num_attention_heads=spec.num_heads, num_key_value_heads=spec.num_kv_heads,
               intermediate_size=I, max_position_embeddings=spec.max_seq_len,
               layer_norm_eps=spec.norm_eps, rope_theta=spec.rope_theta,
               partial_rotary_factor=spec.rope_fraction)
    for i in range(L):
        p = f"model.layers.{i}."
        for name, shape in (("input_layernorm", (H,)), ("self_attn.q_proj", (spec.q_dim, H)),
                            ("self_attn.k_proj", (spec.kv_dim, H)),
                            ("self_attn.v_proj", (spec.kv_dim, H)),
                            ("self_attn.dense", (H, spec.q_dim)), ("mlp.fc1", (I, H)),
                            ("mlp.fc2", (H, I))):
            sd[p + name + ".weight"] = r(*shape)
            sd[p + name + ".bias"] = r(shape[0])
    sd.update({"model.final_layernorm.weight": r(H), "model.final_layernorm.bias": r(H),
               "lm_head.weight": r(spec.vocab_size, H), "lm_head.bias": r(spec.vocab_size)})
    return cfg, sd


def checkpoint_roundtrip(dev, seed):
    """For gemma-7b and phi-2 at full width and one layer: an HF checkpoint
    from the seed (hf_checkpoint) written as config.json and safetensors
    (write_safetensors) into a directory under build/ whose path names no
    family (HF's cache lays a checkpoint out as ``snapshots/<sha>``), then
    ``load_model(dir)`` on the card: the spec field for field the preset's
    (one layer, the directory's name), every parameter bit for bit the
    in-memory state dict's conversion by the family's own converter, the
    embedding and layer 0's first projection bit for bit the HF tensors
    themselves. The directory is deleted after."""
    import shutil

    from mlio_tpu_torch.models import get_spec, load_model
    from mlio_tpu_torch.models import loader

    out = {}
    for i, (model, converter) in enumerate(((GEMMA, loader.convert_gemma),
                                            (PHI, loader.convert_phi))):
        preset = dataclasses.replace(get_spec(model), num_layers=1, name=f"3f2a9c{i}")
        gen = torch.Generator(device=dev).manual_seed(seed + 23)
        cfg, sd = hf_checkpoint(preset, gen)
        path = os.path.join(FAMILY_DIR, "snapshots", preset.name)
        os.makedirs(path, exist_ok=True)
        try:
            t0 = time.perf_counter()
            with open(os.path.join(path, "config.json"), "w") as f:
                json.dump(cfg, f)
            write_safetensors(os.path.join(path, "model.safetensors"), sd)
            nbytes = os.path.getsize(os.path.join(path, "model.safetensors"))
            write_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            spec, params = load_model(path, dtype=torch.bfloat16, device=dev)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
        finally:
            shutil.rmtree(os.path.dirname(path))
        if dataclasses.asdict(spec) != dataclasses.asdict(preset):
            raise AssertionError(f"{model}: the checkpoint's spec {spec} is not the preset's")
        want = converter(sd, spec, dtype=torch.bfloat16, device=dev)
        n, stack = 0, [("", params, want)]
        while stack:
            k, g, w = stack.pop()
            if isinstance(w, dict):
                if set(g) != set(w):
                    raise AssertionError(f"{model}: parameter keys differ at {k!r}")
                stack += [(f"{k}.{c}", g[c], w[c]) for c in w]
            elif (g is None) != (w is None) or (w is not None and (
                    g.dtype != w.dtype or not torch.equal(g, w))):
                raise AssertionError(f"{model}: parameter {k} differs from the state dict's "
                                     "conversion")
            else:
                n += w is not None
        p = "model.layers.0.self_attn.q_proj.weight"
        if not (torch.equal(params["tok_embed"], sd["model.embed_tokens.weight"])
                and torch.equal(params["blocks"]["wq"][0], sd[p].T)):
            raise AssertionError(f"{model}: the loaded embedding or wq is not the checkpoint's")
        out[model] = dict(safetensors_bytes=nbytes, tensors=len(sd), parameters=n,
                          write_s=write_s, load_s=load_s, bitwise_equal=True)
        del sd, params, want
        torch.cuda.empty_cache()
    return out


def families_phase(dev, seed, fa, norms, da, dl, dt, qm):
    """The families slice: K1 at gemma-7b's and phi-2's prefill, K3 at their
    decode, K6 at gemma-7b's width; then each model at full width and depth
    through generate (gemma-7b on K6 and on the scan, phi-2 on the scan);
    then the checkpoint directory round trip. Returns the kernel rows with
    their launches on these paths."""
    gen = torch.Generator(device=dev).manual_seed(seed + 17)
    rows = [family_attention_row(fa, gen, GEMMA), family_attention_row(fa, gen, PHI),
            family_decode_row(da, gen, PHI), family_decode_row(da, gen, GEMMA),
            family_tiled_row(dt, dev, seed)]
    emit(dict(phase="families_kernels", checked=[r["name"] for r in rows]))
    wrappers = (fa.flash_attention, norms.fused_norm, da.decode_attention, dl.decode_layer_stack,
                dt.decode_layer_tiled)
    gemma, _ = family_generate(dev, seed, GEMMA, wrappers, fa, norms, da, qm, dt)
    phi, _ = family_generate(dev, seed, PHI, wrappers, fa, norms, da, qm, dt)
    by_name = {r["name"]: r for r in rows}
    by_name["flash_attention_d256"]["launches"] = gemma["tiled"]["flash_attention"]
    by_name["flash_attention_d80"]["launches"] = phi["scan"]["flash_attention"]
    by_name["decode_attention_d80"]["launches"] = phi["scan"]["decode_attention"]
    by_name["decode_attention_d256"]["launches"] = gemma["scan"]["decode_attention"]
    by_name["decode_attention_d256"]["launches_note"] = "gemma-7b's decode_stack='scan' route"
    by_name["decode_layer_tiled_d256"]["launches"] = gemma["tiled"]["decode_layer_tiled"]
    for r in rows:
        if not r["launches"]:
            raise AssertionError(f"{r['name']}: no launch on the path that runs it")
    emit(dict(phase="families_checkpoints", **checkpoint_roundtrip(dev, seed)))
    return rows


# ---------------------------------------------------------------------------
# Speculative decoding and the pipelined engine loop
# ---------------------------------------------------------------------------

SPEC_MODEL = "gpt2-medium"   # bench_extra.py's spec_decode model: full width and depth
SPEC_MOTIF, SPEC_REPEATS = 64, 8  # its prompt: a 64-token motif tiled 8 times
SPEC_NEW, SPEC_CACHE = 256, 1024
SPEC_DRAFT_LAYERS = 8        # the draft model: the target's first 8 layers
SPEC_NGRAM_GAMMA, SPEC_DRAFT_GAMMA = 6, 4
SPEC_STREAMS = ((1.0, 24), (0.75, 6), (0.5, 4))  # (draft_accept, gamma) of the external stream
SPEC_GATE_NEW = 64           # new tokens of the fp32 exactness gate
VERIFY_OFFSET = 700          # K1's verify windows: q_offset inside the legs' 512..800
VERIFY_CASES = ((2, 64), (7, 64), (25, 64), (7, 128))  # (Sq, D): gamma 1, 6, 24; the induction model
INDUCTION = dict(hidden=2048, layers=12, heads=16, vocab=16384, max_seq=1024)
INDUCTION_PERIOD, INDUCTION_CHUNK = 32, 64


def verify_attention_row(fa, dev, seed):
    """K1 at the verify windows' shape: B 1, 16 heads, Sq query tokens at
    q_offset VERIFY_OFFSET over a SPEC_CACHE-slot cache holding
    VERIFY_OFFSET + Sq keys, causal; each case against its plain version
    (K1's limits, each row too) and failing it with kv_len one short (the
    window's last key is planted along its last query, so that attention
    peaks there); timed beside its plain version, SDPA with the boolean mask
    (SDPA has no causal q_offset) and the bound. The row's own numbers are
    the n-gram leg's window (Sq 7, D 64)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    H, cases = 16, {}
    for Sq, D in VERIFY_CASES:
        q, k, v = attention_inputs(gen, 1, Sq, SPEC_CACHE, H, H, D)
        kv_len = VERIFY_OFFSET + Sq
        k[:, kv_len - 1] = q[:, Sq - 1] * 4
        args = dict(causal=True, q_offset=VERIFY_OFFSET, kv_len=kv_len)
        want = fa.flash_attention_plain(q, k, v, **args)
        err = check_close("flash_attention", fa.flash_attention(q, k, v, **args), want)
        short = must_fail_within("flash_attention", "kv_len one short",
                                 fa.flash_attention(q, k, v, **dict(args, kv_len=kv_len - 1)),
                                 want)
        valid = (torch.arange(kv_len, device=dev)[None, :]
                 <= VERIFY_OFFSET + torch.arange(Sq, device=dev)[:, None])
        pairs = causal_pairs(Sq, kv_len, True, VERIFY_OFFSET)
        flops = 4 * H * D * pairs
        b_ms, b_by = bound((2 * q.numel() + 2 * kv_len * H * D) * 2, flops, BF16_TENSOR_FLOPS)
        cases[f"sq{Sq}_d{D}"] = dict(
            shape=f"q [1,{Sq},{H},{D}] k/v [1,{SPEC_CACHE},{H},{D}] bf16, q_offset "
                  f"{VERIFY_OFFSET}, kv_len {kv_len}, causal",
            max_abs_err=err, kv_len_minus_1_max_abs_err=short,
            **timings(lambda i: fa.flash_attention(q, k, v, **args),
                      lambda i: fa.flash_attention_plain(q, k, v, **args),
                      sdpa_masked(q, k[:, :kv_len], v[:, :kv_len], valid), 100),
            bound_ms=b_ms, bound_by=b_by)
    top = cases["sq7_d64"]
    return dict(
        name="flash_attention_verify", route="cuda", source="mlio_tpu_torch/csrc/flash_fwd.cu",
        replaces="mlio_tpu/ops/flash_attention.py:37", shape=top["shape"],
        max_abs_err=top["max_abs_err"], atol=TOL["flash_attention"][0],
        rtol=TOL["flash_attention"][1], row_rel_rms_limit=ROW_REL_RMS["flash_attention"],
        ms=top["ms"], kernel_ms=top["kernel_ms"], call_ms=top["call_ms"],
        plain_ms=top["plain_ms"], library_ms=top["library_ms"],
        library_note="SDPA with the boolean mask over the kv_len keys",
        bound_ms=top["bound_ms"], bound_by=top["bound_by"], cases=cases)


def k4_batch1_row(dl, dev, seed, dspec, dparams, pos):
    """K4 at the draft model's step: B 1, gpt2-medium's widths and the draft's
    SPEC_DRAFT_LAYERS layers, one step at ``pos`` over a SPEC_CACHE-slot
    cache, no epilogue (the head runs after it, as in ``_decode_forward``),
    x carrying its position; against its plain version (K4's limits, every
    slot written) and failing it with the context one token short; timed
    beside the plain version and the bound."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x, kc, vc, _, _, kw = stack_inputs(dspec, dparams, 1, SPEC_CACHE, pos, 1, gen,
                                       epilogue=False)
    kw.pop("pos_embed")
    x_plain, errs = stack_check(dl, dspec, dparams, x, kc, vc, pos, None, None, kw)
    blocks = dparams["blocks"]
    x_short, _ = dl.decode_layer_stack(x, blocks, kc.clone(), vc.clone(), pos - 1, **kw)
    short = must_fail_within("decode_layer_stack", "a context one token short", x_short, x_plain)
    b_ms, b_by = stack_bound(dspec, dparams, 1, pos + 1, head=False)
    return dict(
        name="decode_layer_stack_b1", route="cuda", source="mlio_tpu_torch/csrc/decode_layer.cu",
        replaces="mlio_tpu/ops/decode_layer.py:136",
        shape=f"{dspec.name} bf16 (gpt2-medium's widths, {dspec.num_layers} layers), x "
              f"[1,{dspec.hidden_size}], cache [{dspec.num_layers},1,{SPEC_CACHE},"
              f"{dspec.num_kv_heads},{dspec.head_size}], ctx {pos + 1}, no epilogue",
        max_abs_err=errs["x_out"], errors=errs, atol=TOL["decode_layer_stack"][0],
        rtol=TOL["decode_layer_stack"][1], ctx_minus_1_max_abs_err=short,
        library_note="no single PyTorch call computes a decode step",
        **timings(lambda i: dl.decode_layer_stack(x, blocks, kc, vc, pos, **kw),
                  lambda i: dl.decode_layer_stack_plain(x, blocks, kc, vc, pos, **kw), None, 50),
        bound_ms=b_ms, bound_by=b_by)


def traced_busy_ms(run) -> float:
    """Device-busy ms of one call of ``run`` in a torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    from mlio_tpu_torch.profiling import device_busy_ms

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    busy = device_busy_ms(prof.events())
    if not busy:
        raise AssertionError("the profiler saw no device time")
    return busy


def spec_leg(name, run, wrappers, vocab, vanilla_s=None, vanilla_new=None):
    """One leg: ``run()`` -> (ids, stats: a dict, a list of chunks' or None),
    timed once by the host clock with the launch counters zeroed around it,
    then traced once for its device-busy ms. Returns (ids, stats, the leg's
    report, its launches)."""
    for w in wrappers:
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, st = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in wrappers}
    busy = traced_busy_ms(run)
    new = out[:, -SPEC_NEW:]
    if int(new.min()) < 0 or int(new.max()) >= vocab:
        raise AssertionError(f"speculative {name}: a token out of range")
    rep = dict(s=wall, device_busy_ms=busy, idle_share=1 - busy / (wall * 1e3),
               launches=launches)
    if st is not None:
        rounds = st["rounds"] if isinstance(st, dict) else sum(c["rounds"] for c in st)
        rep.update(rounds=rounds, tokens_per_round=SPEC_NEW / rounds,
                   ms_per_round=wall * 1e3 / rounds,
                   idle_ms_per_round=(wall * 1e3 - busy) / rounds)
        for w, n in launches.items():
            rep[f"{w}_per_round"] = n / rounds
    if vanilla_s is not None:
        rep.update(speedup=vanilla_s / wall,
                   agreement_with_vanilla=(new == vanilla_new).float().mean().item())
    return out, st, rep, launches


def speculative_exactness(dev, spec, params, dspec, dparams, ids):
    """Every drafting mode's ids equal greedy_generate's on the fp32 plain
    route (``Impl()``: dense attention, no kernel), at gpt2-medium's full
    width and depth, B 1 and B 2 (the second row the motif rotated), for
    SPEC_GATE_NEW new tokens; the external stream proposes greedy's own
    continuation, corrupted at 0.5. Returns the rounds of each run."""
    from mlio_tpu_torch.models import Impl
    from mlio_tpu_torch.runtime import greedy_generate, speculative_generate

    f32 = lambda p: {k: (f32(v) if isinstance(v, dict) else  # noqa: E731
                         None if v is None else v.float()) for k, v in p.items()}
    p32, d32 = f32(params), f32(dparams)
    impl = Impl()
    rounds = {}
    for batch in (1, 2):
        bids = torch.cat([ids, ids.roll(7, dims=1)])[:batch]
        ref = greedy_generate(p32, spec, bids, max_new_tokens=SPEC_GATE_NEW, impl=impl, device=dev)
        oracle = ref[:, bids.shape[1]:]
        modes = {"ngram": dict(gamma=SPEC_NGRAM_GAMMA),
                 "stream_1.0": dict(gamma=24, draft_tokens=oracle),
                 "stream_0.5": dict(gamma=4, draft_tokens=oracle, draft_accept=0.5),
                 "draft": dict(gamma=SPEC_DRAFT_GAMMA, draft_params=d32, draft_spec=dspec),
                 "self": dict(gamma=SPEC_DRAFT_GAMMA, draft_params=p32, draft_spec=spec)}
        for mode, kw in modes.items():
            out, st = speculative_generate(p32, spec, bids, max_new_tokens=SPEC_GATE_NEW,
                                           impl=impl, return_stats=True, device=dev,
                                           generator=torch.Generator(device=dev).manual_seed(1),
                                           **kw)
            if not torch.equal(out, ref):
                raise AssertionError(f"speculative exactness: {mode} at B {batch} differs from "
                                     f"greedy_generate on the fp32 plain route at "
                                     f"{int((out != ref).sum())} positions")
            rounds[f"{mode}_b{batch}"] = st["rounds"]
    if rounds["stream_1.0_b1"] != -(-(SPEC_GATE_NEW - 1) // 25):
        raise AssertionError(f"speculative exactness: perfect drafts took "
                             f"{rounds['stream_1.0_b1']} rounds")
    if rounds["self_b1"] != -(-(SPEC_GATE_NEW - 1) // (SPEC_DRAFT_GAMMA + 1)):
        raise AssertionError(f"speculative exactness: self-speculation took {rounds['self_b1']} "
                             "rounds: a draft was rejected")
    del p32, d32
    torch.cuda.empty_cache()
    return rounds


def speculative_phase(dev, seed, fa, norms, da, dl, dt):
    """Speculative decoding at gpt2-medium's full width and depth, bf16,
    random weights from the seed, B 1, a 512-token prompt (a 64-token motif
    tiled 8 times), a 1024-slot cache, 256 new tokens: vanilla ``generate``
    (K4's multi-step launch), n-gram drafting at gamma 6, the external
    stream (the n-gram leg's own output) at draft_accept 1.0 / 0.75 / 0.5
    with gamma 24 / 6 / 4, the draft model (the first 8 layers, gamma 4),
    self-speculation (gamma 4), and the induction model (hidden 2048, 12
    layers, 16 heads, 16,384 tokens, period 32) under
    ``speculative_generate_auto`` beside its vanilla generate; each with
    seconds, rounds, tokens a round, the speedup over vanilla, agreement
    with vanilla's ids, the device-busy ms of a traced run and the idle
    share, and the launches (each leg's counts are held to what its rounds
    must launch). Gates: the fp32 exactness of every mode at B 1 and 2
    (``speculative_exactness``), K1 at the verify shapes and K4 at B 1
    against their plain versions with failing controls. Returns (the K1
    and K4 rows, the launches by leg)."""
    from mlio_tpu_torch.models import (Impl, induction_spec, load_model, make_induction_model,
                                       periodic_prompt)
    from mlio_tpu_torch.runtime import generate, speculative_generate
    from mlio_tpu_torch.runtime.speculative import speculative_generate_auto

    spec, params = load_model(SPEC_MODEL, dtype=torch.bfloat16, device=dev, seed=seed)
    L, S = spec.num_layers, SPEC_MOTIF * SPEC_REPEATS
    dspec = dataclasses.replace(spec, num_layers=SPEC_DRAFT_LAYERS,
                                name=f"{SPEC_MODEL}-draft{SPEC_DRAFT_LAYERS}")
    dparams = dict(params, blocks={k: (v[:SPEC_DRAFT_LAYERS] if v is not None else None)
                                   for k, v in params["blocks"].items()})
    gen = torch.Generator(device=dev).manual_seed(seed)
    ids = torch.randint(0, spec.vocab_size, (1, SPEC_MOTIF), generator=gen,
                        device=dev).repeat(1, SPEC_REPEATS)
    k1_row = verify_attention_row(fa, dev, seed)
    k4_row = k4_batch1_row(dl, dev, seed, dspec, dparams, VERIFY_OFFSET)
    exact_rounds = speculative_exactness(dev, spec, params, dspec, dparams, ids)

    impl = Impl(attention="flash", norm="fused")
    wrappers = (fa.flash_attention, norms.fused_norm, da.decode_attention, dl.decode_layer_stack,
                dt.decode_layer_tiled)
    common = dict(impl=impl, cache_len=SPEC_CACHE, max_new_tokens=SPEC_NEW, return_stats=True,
                  device=dev)

    def spec_run(**kw):
        g = torch.Generator(device=dev).manual_seed(seed)
        return lambda: speculative_generate(params, spec, ids, generator=g, **common, **kw)

    def vanilla():
        return generate(params, spec, ids, max_new_tokens=SPEC_NEW, impl=impl,
                        cache_len=SPEC_CACHE, device=dev), None

    speculative_generate(params, spec, ids, gamma=SPEC_NGRAM_GAMMA, impl=impl,
                         cache_len=SPEC_CACHE, max_new_tokens=16, device=dev)  # warm-up
    vanilla()
    van_ids, _, van, van_l = spec_leg("vanilla", vanilla, wrappers, spec.vocab_size)
    want = {w.__name__: 0 for w in wrappers}
    if van_l != dict(want, flash_attention=L, fused_norm=2 * L + 1, decode_layer_stack=1):
        raise AssertionError(f"speculative vanilla: launches {van_l}")
    legs, launches = {"vanilla": van}, {"vanilla": van_l}
    van_new = van_ids[:, S:]

    def leg(name, run, draft_layers=0):
        out, _, rep, got = spec_leg(name, run, wrappers, spec.vocab_size, van["s"], van_new)
        r = rep["rounds"]
        # K1 a layer in the target's prefill, the draft's and each verify
        # window; K2 a norm of each; K4 the draft steps (gamma a round, one
        # more after a round that accepted every draft); no K3 or K6
        k1 = L * (1 + r) + draft_layers
        k2 = (2 * L + 1) * (1 + r) + (2 * draft_layers + 1 if draft_layers else 0)
        ok = (got["flash_attention"] == k1 and got["decode_attention"] == 0
              and got["decode_layer_tiled"] == 0)
        if draft_layers:
            g = SPEC_DRAFT_GAMMA
            ok = ok and g * r <= got["decode_layer_stack"] <= (g + 1) * r
            k2 += got["decode_layer_stack"]  # the draft's final norm after each K4 step
        else:
            ok = ok and got["decode_layer_stack"] == 0
        if not ok or got["fused_norm"] != k2:
            raise AssertionError(f"speculative {name}: launches {got} over {r} rounds "
                                 f"(K1 {k1}, K2 {k2} expected)")
        legs[name], launches[name] = rep, got
        return out

    ngram_ids = leg("ngram", spec_run(gamma=SPEC_NGRAM_GAMMA))
    oracle = ngram_ids[:, S:]
    for accept, gamma in SPEC_STREAMS:
        out = leg(f"stream_{accept}", spec_run(gamma=gamma, draft_tokens=oracle,
                                              draft_accept=accept))
        legs[f"stream_{accept}"].update(gamma=gamma, agreement_with_ngram=(
            out[:, S:] == oracle).float().mean().item())
    leg("draft", spec_run(gamma=SPEC_DRAFT_GAMMA, draft_params=dparams, draft_spec=dspec),
        SPEC_DRAFT_LAYERS)
    leg("self", spec_run(gamma=SPEC_DRAFT_GAMMA, draft_params=params, draft_spec=spec), L)
    del params, dparams
    torch.cuda.empty_cache()

    ispec = induction_spec(**INDUCTION)
    iparams = make_induction_model(ispec, INDUCTION_PERIOD,
                                   torch.Generator(device=dev).manual_seed(seed),
                                   dtype=torch.bfloat16, device=dev)
    iids = periodic_prompt(INDUCTION_PERIOD, 8, ispec.vocab_size,
                           torch.Generator(device=dev).manual_seed(seed + 7), device=dev)
    ivan = lambda: (generate(iparams, ispec, iids, max_new_tokens=SPEC_NEW,  # noqa: E731
                             impl=impl, cache_len=SPEC_CACHE, device=dev), None)
    ivan()
    ivan_ids, _, ivan_rep, ivan_l = spec_leg("induction_vanilla", ivan, wrappers,
                                             ispec.vocab_size)
    iS, iL = iids.shape[1], ispec.num_layers
    if ivan_l != dict(want, flash_attention=iL, fused_norm=2 * iL + 1, decode_layer_stack=1):
        raise AssertionError(f"speculative induction vanilla: launches {ivan_l}")
    period = iids[0, :INDUCTION_PERIOD].repeat(SPEC_NEW // INDUCTION_PERIOD + 1)[:SPEC_NEW]
    ivan_rep["period_agreement"] = (ivan_ids[0, iS:] == period).float().mean().item()
    auto = lambda: speculative_generate_auto(  # noqa: E731
        iparams, ispec, iids, max_new_tokens=SPEC_NEW, chunk=INDUCTION_CHUNK, impl=impl,
        return_stats=True, device=dev)
    _, ichunks, irep, il = spec_leg("induction", auto, wrappers, ispec.vocab_size,
                                    ivan_rep["s"], ivan_ids[:, iS:])
    irep.update(vanilla=ivan_rep, gamma_trajectory=[c["gamma"] for c in ichunks],
                tokens_per_round_by_chunk=[c["tokens_per_round"] for c in ichunks])
    calls = len(ichunks) + irep["rounds"]  # each chunk's prefill, each verify window
    if il != dict(want, flash_attention=iL * calls, fused_norm=(2 * iL + 1) * calls):
        raise AssertionError(f"speculative induction: launches {il} over {calls} forwards")
    legs["induction"], launches["induction"], launches["induction_vanilla"] = irep, il, ivan_l
    del iparams
    torch.cuda.empty_cache()

    k1_row["launches"] = sum(launches[n]["flash_attention"] for n in launches if n not in
                             ("vanilla", "induction_vanilla"))
    k1_row["launches_note"] = ("K1 in the bf16 speculative legs (prefills and verify windows; "
                               "the windows are 2..25 tokens)")
    k4_row["launches"] = launches["draft"]["decode_layer_stack"]
    k4_row["launches_note"] = "K4 in the draft-model leg's draft steps (B 1, 8 layers)"
    if not (k1_row["launches"] and k4_row["launches"]):
        raise AssertionError("speculative: K1 or K4 not launched on the legs")
    emit(dict(phase="speculative", model=SPEC_MODEL, dtype="bf16", batch=1, prompt=S,
              cache_len=SPEC_CACHE, new_tokens=SPEC_NEW, impl=repr(impl),
              draft_layers=SPEC_DRAFT_LAYERS, induction=dict(INDUCTION, period=INDUCTION_PERIOD,
                                                             chunk=INDUCTION_CHUNK),
              exactness_fp32_rounds=exact_rounds, legs=legs,
              k1_verify={k: {m: c[m] for m in ("max_abs_err", "kv_len_minus_1_max_abs_err",
                                                "ms", "plain_ms", "library_ms", "bound_ms")}
                         for k, c in k1_row["cases"].items()},
              k4_b1=dict(max_abs_err=k4_row["max_abs_err"],
                         ctx_minus_1_max_abs_err=k4_row["ctx_minus_1_max_abs_err"],
                         ms=k4_row["ms"], bound_ms=k4_row["bound_ms"])))
    return [k1_row, k4_row], launches


POOL_EXHAUSTED = dict(max_batch=2, num_blocks=5, block_size=8)  # the geometry of the fault
POOL_EXHAUSTED_PROMPTS = ([5, 9, 2, 7, 1, 3], [11, 3, 6, 1, 8, 4])


def engine_pipelined_phase(dev, seed, wrappers):
    """The engine's pipelined loop at GPT-2 small, bf16: engine_bench's
    workload (24 prompts, 256 new tokens, 8 slots, K8) at steps_per_dispatch
    8 and DISPATCH, each through the sync loop and the pipelined loop with
    the Python scheduler and the pipelined loop with the native one (after
    a warm-up wave of 8 prompts and 32 tokens); the three must give the same
    ids and scheduler stats. Reported: generated tok/s, host wall s,
    device-busy ms of a traced run, idle share, launches. Then the
    pool-exhaustion geometry (2 slots, 5 blocks of 8, 16 new tokens) on the
    per-op decode: the pipelined loops must give the sync loop's ids, with
    preemptions."""
    from mlio_tpu_torch.models import Impl, load_model
    from mlio_tpu_torch.runtime import InferenceEngine

    spec, params = load_model("gpt2", dtype=torch.bfloat16, device=dev, seed=seed)
    prompts = engine_prompts(seed, spec.vocab_size)
    impl = Impl(attention="flash", norm="fused")
    runs = (("sync", False, "python"), ("pipelined", True, "python"),
            ("pipelined_native", True, "native"))
    results, k8 = {}, 0
    for k in (8, DISPATCH):
        setting, ids0, stats0 = {}, None, None
        for name, pipeline, sched in runs:
            eng = InferenceEngine(spec, params, max_batch=B, num_blocks=POOL_BLOCKS,
                                  block_size=POOL_BS, impl=impl, steps_per_dispatch=k,
                                  scheduler=sched, device=dev)
            if eng.decode_stack != "mega" or eng.memory_stats()["scheduler"] != sched:
                raise AssertionError(f"engine_pipelined: {eng.decode_stack}, "
                                     f"{eng.memory_stats()['scheduler']}")
            eng.run(prompts[:B], max_new_tokens=32, pipeline=pipeline)  # warm-up
            for w in wrappers:
                w.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = eng.run(prompts, max_new_tokens=ENGINE_NEW, pipeline=pipeline)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {w.__name__: w.launches for w in wrappers}
            stats = {s: v for s, v in eng.memory_stats().items() if s != "scheduler"}
            busy = traced_busy_ms(lambda: eng.run(prompts, max_new_tokens=ENGINE_NEW,
                                                  pipeline=pipeline))
            if [len(o) for o in outs] != [ENGINE_NEW] * N_PROMPTS or counts["paged_attention"] \
                    or not counts["decode_paged_stack"]:
                raise AssertionError(f"engine_pipelined {name} k {k}: outputs {len(outs)} or "
                                     f"launches {counts}")
            if ids0 is None:
                ids0, stats0 = outs, stats
            elif outs != ids0 or stats != stats0:
                raise AssertionError(f"engine_pipelined {name} k {k}: ids or stats differ from "
                                     f"the sync loop's ({stats} against {stats0})")
            k8 += counts["decode_paged_stack"]
            tok = N_PROMPTS * ENGINE_NEW
            setting[name] = dict(scheduler=sched, pipeline=pipeline, wall_s=wall,
                                 generated_tok_per_s=tok / wall, device_busy_ms=busy,
                                 idle_share=1 - busy / (wall * 1e3), launches=counts,
                                 stats=stats)
            del eng
        results[f"steps_{k}"] = setting
    exhausted = {}
    for name, pipeline, sched in runs:
        eng = InferenceEngine(spec, params, decode_stack="perop", impl=impl, scheduler=sched,
                              device=dev, **POOL_EXHAUSTED)
        outs = eng.run(list(POOL_EXHAUSTED_PROMPTS), max_new_tokens=16, pipeline=pipeline)
        st = eng.memory_stats()
        if st["preempted"] == 0:
            raise AssertionError(f"engine_pipelined pool_exhausted {name}: no preemption")
        if exhausted and outs != exhausted["sync"]["ids"]:
            raise AssertionError(f"engine_pipelined pool_exhausted {name}: {outs} against the "
                                 f"sync loop's {exhausted['sync']['ids']}")
        exhausted[name] = dict(ids=outs, preempted=st["preempted"], scheduler=st["scheduler"])
    emit(dict(phase="engine_pipelined", model="gpt2", dtype="bf16", max_batch=B,
              num_blocks=POOL_BLOCKS, block_size=POOL_BS, prompts=N_PROMPTS,
              new_tokens=ENGINE_NEW, **results,
              pool_exhausted=dict(geometry=POOL_EXHAUSTED, decode_stack="perop", **exhausted)))
    return k8


# ---------------------------------------------------------------------------
# The W8A8 and profiling slice: W8A8 serving at GPT-2 small and llama3-8b,
# the fp8 -> int8 transcode, and the profiling package on the main path.

INT8_TOPS = 1979e12  # NVIDIA H100 SXM data sheet: dense int8 tensor-core rate
W8A8_NEW = 32        # new tokens of the W8A8 generate and of the profiled generate
W8A8_SITE_WEIGHTS = {"attn_in": "wq", "attn_out_in": "wo", "mlp_in": "w_up",
                     "mlp_down_in": "w_down"}  # each site's product checked (layer 0)
W8A8_DECODE_STEPS = 8  # llama3-8b's K6 decode steps (W8A8 against w8; transcode against fp8)
# The kernels' W8A8 prefill logits against the plain W8A8 forward (fp32
# cast, RMS over every logit). The bf16 kernels lie 0.0051 RMS from their
# plain path at GPT-2 small; W8A8 turns some of that bf16 noise into a whole
# int8 step where an activation sits near a rounding boundary (0.0138 in
# the first card run, NVIDIA H100 80GB HBM3, 700.00 W). The control, the
# weight-only int8 model's logits against the same plain W8A8 forward
# (0.025 there), must exceed the limit: W8A8 that silently fell back to
# weight-only int8 fails.
W8A8_LOGITS_RMS = 0.02
# The transcoded tree's K6 logits against the fp8 tree's (RMS over the
# fp8 logits' RMS, the same tokens fed to both): see transcode_leg.
TRANSCODE_REL_RMS = 0.05
K_SYMBOLS = {"flash_attention": "flash_fwd_kernel", "decode_layer_stack": "stack_kernel"}
PROFILE_STEP_TOL = 0.10  # K4's traced ms a step against the main path's device ms a step
COST_TOL = 0.01          # profile_model's FLOPs across Impls


def rms(a, b) -> float:
    return (a.float() - b.float()).square().mean().sqrt().item()


def w8a8_bound(M, K, N):
    """(bound ms, bound_by) of one W8A8 product: x (bf16) and the payload
    and scales read once, the bf16 output written once; 2MKN int8 operations."""
    return bound(M * K * 2 + K * N + 4 * N + M * N * 2, 2 * M * K * N, INT8_TOPS)


def prefill_bound(params, spec, run):
    """(bound ms, bound_by, counted FLOPs) of a prefill: the weights read
    once, the cache and the logits written once; the products' FLOPs as
    ops/cost.py counts them in one run, the W8A8 products at int8's rate and
    the rest at bf16's."""
    from mlio_tpu_torch.ops import cost

    with cost.counting() as c:
        run()
    int8_flops = c.kernels.get("w8a8_matmul", [0.0])[0]
    nbytes = (cost.tensor_bytes(params) + 2 * spec.num_layers * B * PROMPT * spec.kv_dim * 2
              + B * PROMPT * spec.vocab_size * 2)
    t_ops = int8_flops / INT8_TOPS + (c.flops - int8_flops) / BF16_TENSOR_FLOPS
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes", c.flops


def w8a8_products(dev, seed, spec, w, q8, qm):
    """Each site's W8A8 product (layer 0) at the prefill's rows and at a
    decode step's: the card's int8 activations equal to the CPU's, the
    output equal bit for bit to the float64 plain sums under the same fp32
    rescale, and the plain path fed x quantized at twice the act scale
    unequal to it (the control). x is seeded normal at a third of the
    site's calibrated amax, so its tail clips. Device ms of the product
    beside its bound, K5's and a bf16 matmul's; at the prefill's rows also
    its parts (the quantize, the payload's [N, K] copy, ``_int_mm``, the
    rescale) and ``_int_mm`` over the payload as stored ([K, N])."""
    from mlio_tpu_torch.ops.quant import QTensor, dequantize

    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for site, name in W8A8_SITE_WEIGHTS.items():
        wt, w8 = w["blocks"][name].select(0), q8["blocks"][name].select(0)
        K, N = wt.q.shape
        row = dict(weight=name, K=K, N=N)
        for M in (B * PROMPT, DECODE_M):
            x = (torch.randn(M, K, generator=gen, device=dev)
                 * (wt.act_scale * 127 / 3)).to(torch.bfloat16)
            x_q = qm.quantize_activations(x, wt.act_scale)
            if not torch.equal(x_q.cpu(), qm.quantize_activations(x.cpu(), wt.act_scale.cpu())):
                raise AssertionError(f"w8a8 {name} M={M}: the card's int8 activations differ "
                                     "from the CPU's")
            got = qm.w8a8_matmul(x, wt)
            plain = qm.w8a8_rescale(qm.int8_sums_plain(x_q, wt.q), wt, x.dtype)
            if not torch.equal(got, plain):
                raise AssertionError(f"w8a8 {name} M={M}: _int_mm's output differs from the "
                                     "float64 plain sums")
            control = qm.w8a8_rescale(qm.int8_sums_plain(
                qm.quantize_activations(x, 2 * wt.act_scale), wt.q), wt, x.dtype)
            if torch.equal(got, control):
                raise AssertionError(f"w8a8 {name} M={M}: the control (x at twice the act "
                                     "scale) passed")
            b_ms, b_by = w8a8_bound(M, K, N)
            w16 = dequantize(QTensor(w8.q, w8.scale, "int8"), torch.bfloat16)
            row[f"M{M}"] = dict(
                ms=time_ms(lambda i: qm.w8a8_matmul(x, wt), 10)[0], bound_ms=b_ms, bound_by=b_by,
                k5_ms=time_ms(lambda i: qm.quant_matmul(x, w8.q, w8.scale), 10)[0],
                bf16_ms=time_ms(lambda i: x @ w16, 10)[0],
                clipped_share=(x_q.abs() == 127).float().mean().item())
            if M >= qm.INT_MM_MIN_ROWS:  # the product's parts, and _int_mm over the stored layout
                qt = wt.q.t().contiguous().t()
                sums = torch._int_mm(x_q, qt)
                row[f"M{M}"].update(
                    quantize_ms=time_ms(lambda i: qm.quantize_activations(x, wt.act_scale), 10)[0],
                    copy_ms=time_ms(lambda i: wt.q.t().contiguous(), 10)[0],
                    int_mm_ms=time_ms(lambda i: torch._int_mm(x_q, qt), 10)[0],
                    rescale_ms=time_ms(lambda i: qm.w8a8_rescale(sums, wt, x.dtype), 10)[0],
                    int_mm_stored_layout_ms=time_ms(lambda i: torch._int_mm(x_q, wt.q), 10)[0])
        out[site] = row
    return out


def w8a8_phase(dev, seed, fa, norms, da, dl, qm):
    """GPT-2 small at the main path's workload with W8A8 weights:
    ``quantize_params(..., "int8")``, calibrated on the prompt batch
    (``calibrate_activation_scales``) and scaled (``apply_activation_scales``).
    Each site's product against its plain version (w8a8_products); a greedy
    generate of W8A8_NEW tokens with the launch counters zeroed just before
    and read just after: K1 and K2 in the prefill with every projection
    through ``w8a8_matmul`` (``torch._int_mm``), the decode one K4 launch;
    K4's launch from the W8A8 prefill's cache the same bits as the weight-
    only int8 model's; the prefill logits within W8A8_LOGITS_RMS of the
    plain W8A8 forward (every wrapper and the product on its plain version),
    and their RMS against the w8 and bf16 logits; the prefill's device ms in
    bf16, w8 (K5) and W8A8 beside each bound. Returns the launch counts."""
    from mlio_tpu_torch.models import forward
    from mlio_tpu_torch.runtime import (apply_activation_scales, calibrate_activation_scales,
                                        generate, init_cache, quantize_params)

    t0 = time.perf_counter()
    spec, params, ids, impl = workload(seed, dev)
    L = spec.num_layers
    q8 = quantize_params(params, spec, "int8")
    t_cal = time.perf_counter()
    stats = calibrate_activation_scales(params, spec, ids)
    torch.cuda.synchronize()
    cal_s = time.perf_counter() - t_cal
    w = apply_activation_scales(q8, stats)
    products = w8a8_products(dev, seed, spec, w, q8, qm)

    def prefill(p):
        cache = init_cache(spec, B, CACHE, dtype=torch.bfloat16, device=dev)
        with torch.inference_mode():
            return forward(p, spec, ids, impl=impl, cache=cache)

    logits, cache = prefill(w)
    if logits.shape != (B, PROMPT, spec.vocab_size) or not torch.isfinite(logits).all():
        raise AssertionError(f"w8a8 prefill logits: shape {tuple(logits.shape)} or not finite")
    with plain_kernels(fa, norms, qm):
        plain = prefill(w)[0]
        bf16_plain = prefill(params)[0]
    w8_logits = prefill(q8)[0]
    errs = dict(kernels_vs_plain=rms(logits, plain), w8_vs_plain=rms(w8_logits, plain),
                vs_w8=rms(logits, w8_logits), vs_bf16=rms(logits, prefill(params)[0]),
                bf16_kernels_vs_plain=rms(prefill(params)[0], bf16_plain))
    del plain, bf16_plain, w8_logits
    if not errs["kernels_vs_plain"] <= W8A8_LOGITS_RMS < errs["w8_vs_plain"]:
        raise AssertionError(f"w8a8: the kernels' prefill logits lie {errs['kernels_vs_plain']} "
                             f"RMS from the plain W8A8 forward's, the weight-only int8 "
                             f"logits (the control) {errs['w8_vs_plain']}; the limit is "
                             f"{W8A8_LOGITS_RMS}")
    prefill_ms = {}
    for name, p in (("bf16", params), ("w8", q8), ("w8a8", w)):
        b_ms, b_by, flops = prefill_bound(p, spec, lambda: prefill(p))
        prefill_ms[name] = dict(ms=time_ms(lambda i: prefill(p), 2)[0], bound_ms=b_ms,
                                bound_by=b_by, counted_flops=flops)

    # K4 from the W8A8 prefill's cache: the same bits with and without act_scale
    tok = logits[:, -1].argmax(-1)
    x = params["tok_embed"][tok]
    kw = dict(spec=spec, head_norm=(params["final_scale"], params["final_bias"]),
              lm_head=params["tok_embed"], pos_embed=params["pos_embed"], steps=W8A8_NEW - 1)
    runs = []
    with torch.inference_mode():
        for p in (w, q8):
            k, v = cache["k"].clone(), cache["v"].clone()
            runs.append((*dl.decode_layer_stack(x, p["blocks"], k, v, PROMPT, **kw), k, v))
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        raise AssertionError("w8a8: K4 with W8A8 weights differs from K4 with the same int8 "
                             "weights without act_scale")
    del runs, cache, logits

    wrappers = (fa.flash_attention, fa.flash_attention_kvq, norms.fused_norm, qm.quant_matmul,
                qm.w8a8_matmul, da.decode_attention, dl.decode_layer_stack)

    def run():
        return generate(w, spec, ids, max_new_tokens=W8A8_NEW, impl=impl, cache_len=CACHE,
                        device=dev)

    run()  # warm-up
    for f in wrappers:
        f.launches = 0
    out = run()
    launches = {f.__name__: f.launches for f in wrappers}
    want = {f.__name__: 0 for f in wrappers}
    want.update(flash_attention=L, fused_norm=2 * L + 1, w8a8_matmul=6 * L, decode_layer_stack=1)
    if launches != want:
        raise AssertionError(f"w8a8 generate: launch counts {launches} != expected {want}")
    if out.shape != (B, PROMPT + W8A8_NEW) or not torch.equal(out[:, :PROMPT], ids) \
            or int(out.min()) < 0 or int(out.max()) >= spec.vocab_size:
        raise AssertionError("w8a8 generate: wrong shape, prompt changed or token out of range")
    emit(dict(phase="w8a8", model="gpt2", batch=B, prompt=PROMPT, cache_len=CACHE,
              new_tokens=W8A8_NEW, impl=repr(impl), calibrate_s=cal_s,
              act_scales={site: (t / 127).tolist() for site, t in stats.items()},
              products=products, launches=launches, prefill_logits_rms=errs,
              logits_rms_limit=W8A8_LOGITS_RMS, prefill=prefill_ms,
              k4_same_bits_as_w8=True, seconds=time.perf_counter() - t0))
    return launches


def decode_steps(params, spec, cache, tok, impl, steps, feed=None):
    """``steps`` single-token decode steps from a clone of ``cache``, greedy
    from ``tok`` [B] (or fed ``feed`` [steps, B]): (logits [steps, B, V],
    the tokens fed)."""
    from mlio_tpu_torch.models import forward

    c = dict(cache, k=cache["k"].clone(), v=cache["v"].clone())
    out, fed = [], []
    with torch.inference_mode():
        for s in range(steps):
            t = tok if feed is None else feed[s]
            fed.append(t)
            lg, c = forward(params, spec, t[:, None], impl=impl, cache=c)
            out.append(lg[:, 0])
            tok = lg[:, 0].argmax(-1)
    return torch.stack(out), torch.stack(fed)


def transcode_leg(dev, spec, fp8, cache, tok, impl, dt):
    """``transcode_fp8_to_int8`` of llama3-8b's fp8 tree on the card: its
    seconds and its peak memory over the two trees; layer 0 of every leaf
    equal, payload and scales bit for bit, to the same layer transcoded on
    the CPU; W8A8_DECODE_STEPS K6 steps on the transcoded tree against the
    fp8 tree's, the fp8 run's tokens fed to both, within TRANSCODE_REL_RMS
    of the fp8 logits' RMS, where the transcoded tree with every scale 1.5x
    (the control) must not be. The transcode requantizes each fp8 value onto
    its channel's int8 grid (at most half a step, amax / 254, where e4m3
    itself keeps 3 mantissa bits, about amax / 32 at the channel's top), so
    the int8 tree is another rounding of the same weights, as close to the
    fp8 tree as the two formats' own errors: a few per cent of the logits'
    RMS through 32 layers. Returns the leg's line."""
    from mlio_tpu_torch.ops import cost
    from mlio_tpu_torch.ops.quant import QTensor
    from mlio_tpu_torch.runtime import transcode_fp8_to_int8

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    tc = transcode_fp8_to_int8(fp8)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    new = [v for v in tc["blocks"].values() if isinstance(v, QTensor)]
    out_bytes = cost.tensor_bytes(new)
    peak_over = torch.cuda.max_memory_allocated(dev) - before - out_bytes
    leaves = {k: v for k, v in fp8["blocks"].items() if isinstance(v, QTensor)}
    t_cpu = time.perf_counter()
    cpu = transcode_fp8_to_int8({"blocks": {k: QTensor(v.q[:1].cpu(), v.scale[:1].cpu(), "fp8")
                                            for k, v in leaves.items()}})["blocks"]
    for k in leaves:
        if not (torch.equal(cpu[k].q, tc["blocks"][k].q[:1].cpu())
                and torch.equal(cpu[k].scale, tc["blocks"][k].scale[:1].cpu())):
            raise AssertionError(f"transcode: layer 0 of {k} differs from the CPU's transcode")
    cpu_s = time.perf_counter() - t_cpu
    launches = {}
    dt.decode_layer_tiled.launches = 0
    ref, fed = decode_steps(fp8, spec, cache, tok, impl, W8A8_DECODE_STEPS)
    launches["fp8"], dt.decode_layer_tiled.launches = dt.decode_layer_tiled.launches, 0
    got, _ = decode_steps(tc, spec, cache, tok, impl, W8A8_DECODE_STEPS, feed=fed)
    launches["transcoded"] = dt.decode_layer_tiled.launches
    # the control: the transcoded tree with every scale 1.5x must fail
    off = dict(tc, blocks={k: QTensor(v.q, v.scale * 1.5, v.fmt) if isinstance(v, QTensor)
                           else v for k, v in tc["blocks"].items()})
    control = rms(decode_steps(off, spec, cache, tok, impl, W8A8_DECODE_STEPS, feed=fed)[0],
                  ref) / ref.float().square().mean().sqrt().item()
    del off
    if launches != {"fp8": W8A8_DECODE_STEPS, "transcoded": W8A8_DECODE_STEPS}:
        raise AssertionError(f"transcode: K6 launches {launches}, expected "
                             f"{W8A8_DECODE_STEPS} a run")
    rel = rms(got, ref) / ref.float().square().mean().sqrt().item()
    if not (torch.isfinite(got).all() and rel <= TRANSCODE_REL_RMS < control):
        raise AssertionError(f"transcode: K6 logits on the transcoded tree lie {rel} of the fp8 "
                             f"logits' RMS from them, the control (scales 1.5x) {control}; "
                             f"the limit is {TRANSCODE_REL_RMS}")
    del tc
    return dict(seconds=seconds, cpu_check_s=cpu_s, tree_bytes=out_bytes,
                peak_bytes_over_trees=peak_over,
                bytes_before=before, layer0_equal_to_cpu=sorted(leaves),
                decode_rel_rms=rel, decode_rel_rms_limit=TRANSCODE_REL_RMS,
                control_scales_1_5x_rel_rms=control,
                decode_launches_k6=launches)


def w8a8_8b_leg(dev, seed, spec, weights, fa, norms, qm, dt):
    """llama3-8b (32 layers) while its bf16, int8 and fp8 trees are alive:
    calibrated on the bf16 tree over the [B, PROMPT] prompt and applied to
    the int8 tree; the prefill's device ms in bf16, w8 and W8A8 beside each
    bound; W8A8_DECODE_STEPS K6 decode steps (decode_stack "tiled") with
    W8A8 weights, the same bits as with the int8 weights; then the fp8 tree
    transcoded to int8 (transcode_leg). Returns K6's launches by tree
    (each run W8A8_DECODE_STEPS)."""
    import dataclasses as dc

    from mlio_tpu_torch.models import Impl, forward
    from mlio_tpu_torch.runtime import (apply_activation_scales, calibrate_activation_scales,
                                        init_cache)

    t0 = time.perf_counter()
    ids = torch.from_numpy(np.random.default_rng(seed).integers(
        0, spec.vocab_size, (B, PROMPT))).to(dev)
    impl = Impl(attention="flash", norm="fused")
    stats = calibrate_activation_scales(weights["bf16"], spec, ids)
    w = apply_activation_scales(weights["int8"], stats)

    def prefill(p):
        cache = init_cache(spec, B, CACHE, dtype=torch.bfloat16, device=dev)
        with torch.inference_mode():
            return forward(p, spec, ids, impl=impl, cache=cache)

    prefill_ms = {}
    for name, p in (("bf16", weights["bf16"]), ("w8", weights["int8"]), ("w8a8", w)):
        b_ms, b_by, flops = prefill_bound(p, spec, lambda: prefill(p))
        prefill_ms[name] = dict(ms=time_ms(lambda i: prefill(p), 2)[0], bound_ms=b_ms,
                                bound_by=b_by, counted_flops=flops)
    logits, cache = prefill(weights["int8"])
    tok = logits[:, -1].argmax(-1)
    del logits
    tiled = dc.replace(impl, decode_stack="tiled")
    k6 = {}
    dt.decode_layer_tiled.launches = 0
    a, fed = decode_steps(w, spec, cache, tok, tiled, W8A8_DECODE_STEPS)
    k6["w8a8"], dt.decode_layer_tiled.launches = dt.decode_layer_tiled.launches, 0
    b, _ = decode_steps(weights["int8"], spec, cache, tok, tiled, W8A8_DECODE_STEPS, feed=fed)
    k6["w8"] = dt.decode_layer_tiled.launches
    if k6 != {"w8a8": W8A8_DECODE_STEPS, "w8": W8A8_DECODE_STEPS} or not torch.equal(a, b):
        raise AssertionError(f"w8a8_8b: K6's steps with W8A8 weights (launches {k6}) differ "
                             "from the int8 weights'")
    del a, b, w
    transcode = transcode_leg(dev, spec, weights["fp8"], cache, tok, tiled, dt)
    del cache
    torch.cuda.empty_cache()
    emit(dict(phase="w8a8_8b", model=spec.name, layers=spec.num_layers, batch=B, prompt=PROMPT,
              cache_len=CACHE, prefill=prefill_ms, decode_steps=W8A8_DECODE_STEPS,
              decode_launches_k6=k6, decode_same_bits_as_w8=True, transcode=transcode,
              seconds=time.perf_counter() - t0))
    return dict(k6, **transcode["decode_launches_k6"])


def profile_phase(dev, seed, main_step_ms, fa, dl):
    """The profiling package on GPT-2 small (the main path's workload):
    ``KernelProfiler.profile_function`` over one generate of W8A8_NEW tokens
    (prefill and W8A8_NEW - 1 steps in one K4 launch): the table names K1's
    and K4's symbols, and K4's traced ms over its steps lies within
    PROFILE_STEP_TOL of the main path's ``decode_step_device_ms``; the
    device-busy union of a trace's profiler events equals that of its
    exported Chrome trace; ``InferenceRunner.profile_model`` (the runner's
    fused Impl: K1, K11, K2) gives three wall times, memory whose peak is
    ``torch.cuda.max_memory_allocated``, and counted FLOPs within COST_TOL of
    the dense ``Impl()``'s, while leaving K1's count out must miss by more
    (the control); ``BottleneckAnalyzer`` at K14's measured rate on the K4
    step (its weights and cache bytes, decode_work). Returns K4's launches
    in the profiled generate."""
    from torch.profiler import ProfilerActivity, profile

    from mlio_tpu_torch.models import Impl
    from mlio_tpu_torch.ops.decode_layer import decode_work
    from mlio_tpu_torch.profiling import (BottleneckAnalyzer, KernelProfiler, device_busy_ms,
                                          parse_trace)
    from mlio_tpu_torch.runtime import InferenceRunner, generate

    t0 = time.perf_counter()
    spec, params, ids, impl = workload(seed, dev)
    trace_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "profile")
    steps = W8A8_NEW - 1

    def gen(p, i):
        return generate(p, spec, i, max_new_tokens=W8A8_NEW, impl=impl, cache_len=CACHE,
                        device=dev)

    # After the earlier phases' traces, the card's trace of a generate has
    # come back short of one K1 launch (11 of 12 in a full run, whole in a
    # fresh process; the families phase saw an empty one): a trace short of
    # the launches its call made is taken again.
    want, short = {"flash_attention": spec.num_layers, "decode_layer_stack": 1}, []
    for attempt in range(1, 4):
        dl.decode_layer_stack.launches = fa.flash_attention.launches = 0
        res = KernelProfiler(warmup=1, steps=1, trace_dir=trace_dir).profile_function(
            gen, params, ids)
        launches = dict(flash_attention=fa.flash_attention.launches,
                        decode_layer_stack=dl.decode_layer_stack.launches)
        if res is None:
            raise AssertionError("profile: the trace of a generate holds no op")
        rows = {k: res.table.find(sym) for k, sym in K_SYMBOLS.items()}
        counts = {k: sum(o.count for o in r) for k, r in rows.items()}
        if counts == want:
            break
        short.append(counts)
    else:
        raise AssertionError(f"profile: three traces' K1/K4 rows {short}, expected {want} "
                             f"(symbols {K_SYMBOLS})")
    k4_step_ms = sum(o.total_us for o in rows["decode_layer_stack"]) / 1e3 / steps
    if abs(k4_step_ms / main_step_ms - 1) > PROFILE_STEP_TOL:
        raise AssertionError(f"profile: K4's traced {k4_step_ms} ms a step against the main "
                             f"path's {main_step_ms} device ms")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        gen(params, ids)
        torch.cuda.synchronize()
    path = os.path.join(trace_dir, "busy.pt.trace.json")
    prof.export_chrome_trace(path)
    busy_events, busy_trace = device_busy_ms(prof.events()), device_busy_ms(parse_trace(path))
    if not busy_events or abs(busy_trace - busy_events) > 1e-3 * busy_events:
        raise AssertionError(f"profile: device-busy ms {busy_events} from the profiler's events, "
                             f"{busy_trace} from its Chrome trace")

    fused = InferenceRunner(spec, params, precision="bf16")
    res_f = fused.profile_model(ids)
    peak = torch.cuda.max_memory_allocated(dev)
    res_d = InferenceRunner(spec, params, precision="bf16", impl=Impl()).profile_model(ids)
    if len(res_f.wall_times_s) != 3 or res_f.memory["after"]["peak_bytes_in_use"] != peak:
        raise AssertionError(f"profile_model: {len(res_f.wall_times_s)} wall times, peak "
                             f"{res_f.memory['after']['peak_bytes_in_use']} != {peak}")
    f, d = res_f.cost["flops"], res_d.cost["flops"]
    without_k1 = f - res_f.cost.get("flops flash_attention", 0.0)
    if not abs(f - d) <= COST_TOL * d or abs(without_k1 - d) <= COST_TOL * d:
        raise AssertionError(f"profile_model: fused {f} against dense {d} FLOPs (without K1's "
                             f"count {without_k1})")

    ana = BottleneckAnalyzer(hbm_gbps=HBM_BYTES_PER_S / 1e9)
    x = params["tok_embed"][ids[:, 0]]
    k_cache = torch.empty((spec.num_layers, B, CACHE, spec.num_kv_heads, spec.head_size),
                          dtype=torch.bfloat16, device="meta")
    flops, nbytes = decode_work(x, params["blocks"], k_cache, PROMPT + steps // 2, spec,
                                lm_head=params["tok_embed"])
    report = ana.analyze(wall_time_s=k4_step_ms / 1e3, flops=flops, bytes_accessed=nbytes)
    emit(dict(phase="profile", model="gpt2", batch=B, prompt=PROMPT, new_tokens=W8A8_NEW,
              table_top=[dict(name=o.name[:90], count=o.count, total_us=o.total_us, pct=o.pct)
                         for o in res.top(8)],
              wall_ms=res.wall_time_s * 1e3, op_time_fraction=res.op_time_fraction(),
              k4_traced_step_ms=k4_step_ms, main_path_step_device_ms=main_step_ms,
              busy_ms_events=busy_events, busy_ms_trace=busy_trace, launches=launches,
              trace_attempts=attempt, short_traces=short,
              profile_model=dict(fused=res_f.summary(), dense=res_d.summary(),
                                 fused_flops=f, dense_flops=d, fused_without_k1=without_k1,
                                 kernels={k: v for k, v in res_f.cost.items()
                                          if k not in ("flops", "bytes accessed")}),
              k4_step=dict(flops=flops, bytes=nbytes, hbm_bytes_per_s=HBM_BYTES_PER_S,
                           report=json.loads(report.to_json()),
                           primary=report.primary.kind.value if report.primary else None),
              seconds=time.perf_counter() - t0))
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
    stack = stack_phase(dev, args.seed, dl, dps)
    emit(dict(phase="stack", **{k: v for k, v in stack.items() if k != "ptxas"}))
    main_path = generate_phase(dev, args.seed, fa, norms, da, dl, qm)
    launches = main_path["launches"]
    scan_launches = generate_phase(dev, args.seed, fa, norms, da, dl, qm,
                                   decode_stack="scan")["launches"]
    int8_launches = generate_phase(dev, args.seed, fa, norms, da, dl, qm, int8=True)["launches"]
    int8_scan_launches = generate_phase(dev, args.seed, fa, norms, da, dl, qm,
                                        decode_stack="scan", int8=True)["launches"]
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
    # The W8A8 and profiling slice at GPT-2 small: W8A8 serving, then the
    # profiling package over the main path.
    w8a8_launches = w8a8_phase(dev, args.seed, fa, norms, da, dl, qm)
    profiled = profile_phase(dev, args.seed, main_path["decode_step_device_ms"], fa, dl)
    # The tiled slice: K6 at llama3-8b's full width and depth, then its path.
    torch.cuda.empty_cache()
    spec8, weights8 = llama_weights(dev, args.seed)
    tiled = tiled_row(dt, dl, dev, args.seed, spec8, weights8)
    tiled.update(card_plan=tiled_plan_check(dt), ptxas=k6_instances())
    emit(dict(phase="tiled", **tiled))
    # llama3-8b's W8A8 prefill and K6 steps, and the fp8 tree's transcode
    w8a8_k6 = w8a8_8b_leg(dev, args.seed, spec8, weights8, fa, norms, qm, dt)
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
    for name in ("decode_layer_stack", "decode_paged_stack"):  # PR 16's checks of K4 and K8
        by_name[name].update(card_plan=stack["card_plan"]["plan_matches_mirror"],
                             same_bits=stack[name], ptxas=stack["ptxas"],
                             cluster_launch=stack["cluster_launch"])
    by_name["decode_layer_stack"]["int8"]["gpt2_w8kv8"]["same_bits"] = \
        stack["decode_layer_stack_w8kv8"]
    # K4 and K1 on the W8A8 generate and in the profiled generate
    by_name["decode_layer_stack"].update(w8a8_launches=w8a8_launches["decode_layer_stack"],
                                         profiled_launches=profiled["decode_layer_stack"])
    by_name["flash_attention"].update(w8a8_launches=w8a8_launches["flash_attention"],
                                      profiled_launches=profiled["flash_attention"])
    for entry, count in ((by_name["decode_layer_stack"]["int8"]["gpt2_w8kv8"],
                          int8_launches["decode_layer_stack"]),
                         (by_name["decode_attention"]["int8"],
                          int8_scan_launches["decode_attention"]),
                         (by_name["decode_paged_stack"]["int8_weights"],
                          served8["mega"]["decode_paged_stack"])):
        entry["launches"] = count
        if not count:
            raise AssertionError(f"{entry['shape']}: no launch on the path that runs it")
    # K9 at generate_moe's shape: its prefill (Mixtral), and generate_8b's
    # quick-start prefill at llama3-8b's (the same heads and shape)
    kvq = by_name["flash_attention_kvq"]
    kvq["generate_moe"].update(launches=ranm["flash_attention_kvq"],
                               launches_generate_8b=ran8[("int8", "tiled")]["flash_attention_kvq"])
    kvq["llama3_8b"].update(launches=0, launches_note="no path of this run prefills 2 x 1024 "
                            "tokens into a 2048-slot INT8 cache")
    if not kvq["generate_moe"]["launches"]:
        raise AssertionError("flash_attention_kvq: no launch on generate_moe's prefill")
    # K6: the tiled route of generate_8b (bf16; the quick start's int8
    # weights over an INT8 cache); F1's batch-16 generate runs it too
    tiled["launches"] = ran8[("bf16", "tiled")]["decode_layer_tiled"]
    tiled["variants"]["w8kv8"]["launches"] = ran8[("int8", "tiled")]["decode_layer_tiled"]
    tiled["f1_batch16_launches"] = f1["decode_layer_tiled"]
    # int8 weights over a bf16 cache: w8a8_8b's W8A8, int8 and transcoded
    # trees; fp8 weights: its fp8 tree
    tiled["variants"]["w8"]["launches"] = w8a8_k6["w8a8"] + w8a8_k6["w8"] + w8a8_k6["transcoded"]
    tiled["variants"]["fp8"]["launches"] = w8a8_k6["fp8"]
    tiled["w8a8_launches"] = w8a8_k6["w8a8"]
    for v in ("w8", "fp8"):
        tiled["variants"][v]["launches_note"] = "w8a8_8b's decode steps (llama3-8b, B 8)"
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
    # The masks slice: K1's and K9's masked and stats instances, the bhsd
    # layouts and ring attention's chunk merge at 32K.
    mask_rows, ring = masks_phase(dev, args.seed, fa, fg)
    long_launches = long_context_phase(dev, args.seed, fa, norms, dt,
                                       (fa.flash_attention, fa.flash_attention_stream,
                                        norms.fused_norm, da.decode_attention,
                                        dl.decode_layer_stack, dt.decode_layer_tiled))
    stream_rows[0]["launches"] = long_launches["flash_attention_stream"]
    # the lse instances: ring attention's chunk merge at 32K (masks phase)
    k10_ring = ring[str(RING_CHUNKS[1])]["launches"]["flash_attention_stream"]
    k1_ring = ring[str(RING_CHUNKS[0])]["launches"]["flash_attention"]
    stream_rows[0]["lse"]["launches"] = k10_ring
    stream_rows[0]["lse"]["launches_note"] = (f"ring attention's chunk_step_flash over "
                                              f"{RING_CHUNKS[1]}-key chunks at 32K")
    stream_rows[1]["launches"] = k1_ring
    stream_rows[1]["launches_note"] = (f"ring attention's chunk_step_flash over "
                                       f"{RING_CHUNKS[0]}-key chunks at 32K")
    if not (stream_rows[0]["launches"] and k10_ring and k1_ring):
        raise AssertionError("flash_attention_stream or an lse instance: no launch on its path")
    # The families slice: Gemma-7B (head dim 256) and Phi-2 (80) through K1,
    # K3 and K6's new instances, and their checkpoint directories.
    family_rows = families_phase(dev, args.seed, fa, norms, da, dl, dt, qm)
    # The speculative slice: gpt2-medium's drafting legs (K1 at the verify
    # windows, K4 at B 1) and the induction model, then the engine's
    # pipelined loop with both schedulers.
    spec_rows, _ = speculative_phase(dev, args.seed, fa, norms, da, dl, dt)
    by_name["decode_paged_stack"]["pipelined_launches"] = engine_pipelined_phase(
        dev, args.seed, wrappers)
    by_name["decode_paged_stack"]["pipelined_launches_note"] = (
        "K8 in engine_pipelined's timed runs (sync, pipelined, pipelined native; steps a "
        f"dispatch 8 and {DISPATCH})")
    rows += ([tiled, tiled_moe, widen] + grad_rows + stream_rows + mask_rows + family_rows
             + spec_rows + probe_rows)
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
