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
3. kernels: each kernel of the main path (K1 flash prefill, K2 fused norm,
   K3 decode attention, K4 decode megakernel) at the main path's shapes, on
   inputs from the seed: held against its plain PyTorch version on the card
   in bf16 within the stated tolerance, then timed with CUDA events beside
   its plain version, one PyTorch library call of the same function where
   there is one, and the least time the card could take (bound). K3's and
   K4's checks are shown to catch a context one token short; K4 is also
   held against its plain version over 8 in-kernel steps. Then the kernels'
   other instances at small shapes (variants).
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
TOL = {"flash_attention": (2e-2, 2e-2), "fused_norm": (1e-2, 1e-2),
       "decode_attention": (1e-3, 2 ** -7), "decode_attention_grouped": (1e-2, 1e-2),
       "decode_layer_stack": (5e-2, 5e-2)}
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
    hf = dl._norm32(x_out.float(), *kw["head_norm"], spec.norm, spec.norm_eps)
    hf = hf.to(x_out.dtype).float()
    lm = kw["lm_head"].float()
    logits = hf @ (lm.T if kw["lm_vmajor"] else lm)
    if kw["lm_head_bias"] is not None:
        logits = logits + kw["lm_head_bias"].float()
    return logits


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


def stack_bound(spec, params, batch, ctx):
    """(bound ms, bound_by) of one K4 step with the tied-head epilogue: every
    weight, bias and norm, the lm_head and the K/V of ctx slots of every layer
    read once; x, its position row, x_out and the tokens."""
    blocks = [t for t in params["blocks"].values() if t is not None]
    H, L = spec.hidden_size, spec.num_layers
    nbytes = sum(t.numel() * t.element_size() for t in blocks)
    nbytes += sum(params[k].numel() * 2 for k in ("final_scale", "final_bias", "tok_embed")
                  if params[k] is not None)
    nbytes += 2 * L * batch * ctx * spec.kv_dim * 2 + (2 * batch + 1) * H * 2 + batch * 4
    mats = sum(t.numel() for t in blocks if t.ndim == 3)
    flops = (2 * batch * (mats + spec.vocab_size * H)
             + 4 * batch * spec.num_heads * spec.head_size * ctx * L)
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
    b_ms, b_by = stack_bound(spec, params, B, DECODE_CTX)
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
    us = (stamps[1:] - stamps[:-1]).double().cpu() / 1e3
    L = spec.num_layers
    layers = us[1:1 + 5 * L].reshape(L, 5).mean(0).tolist()
    row["phase_us"] = dict(start=us[0].item(), **dict(zip(
        ("qkv", "attention", "out_proj", "up", "down"), layers)),
        logits=us[1 + 5 * L].item(), launch_total=(stamps[-1] - stamps[0]).item() / 1e3)
    return row


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


def variant_phase(rng, dev, seed, fa, norms, da, dl):
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
    emit(dict(phase="variants", max_abs_err=errs))


@contextlib.contextmanager
def plain_kernels(fa, norms, da):
    """Every kernel wrapper of the prefill replaced by its plain version."""
    saved = (fa.flash_attention, norms.fused_norm, da.decode_attention)
    fa.flash_attention = fa.flash_attention_plain
    norms.fused_norm = norms.fused_norm_plain
    da.decode_attention = da.decode_attention_plain
    try:
        yield
    finally:
        fa.flash_attention, norms.fused_norm, da.decode_attention = saved


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
    from mlio_tpu_torch.ops import flash_attention as fa
    from mlio_tpu_torch.ops import norms

    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    emit(dict(phase="device", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
              count=torch.cuda.device_count(), torch=torch.__version__,
              cuda=torch.version.cuda))
    emit(dict(phase="build", seconds=_build.build_all()))

    rng = np.random.default_rng(args.seed)
    rows = kernel_phase(rng, dev, args.seed, fa, norms, da, dl)
    emit(dict(phase="kernels", checked=[r["name"] for r in rows]))
    variant_phase(rng, dev, args.seed, fa, norms, da, dl)
    launches = generate_phase(dev, args.seed, fa, norms, da, dl)
    scan_launches = generate_phase(dev, args.seed, fa, norms, da, dl, decode_stack="scan")
    for r in rows:  # each kernel's launches on the path that runs it
        r["launches"] = launches[r["name"]] or scan_launches[r["name"]]
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
