"""K1, K3, K5, K7, K9, K10, K11, K12 and K13, the runner's configurations,
the quick start's and the 32K prefill and llama3-8b's training step, timed on
one card from one checkout of this repository: one JSON line.

    python3 ab_k13.py [--tree DIR] [--label NAME] [--only attention|masks]

DIR (default: the directory of this script) is the checkout whose
``chip_smoke.py`` and ``mlio_tpu_torch`` are imported and whose kernels are
built. To compare two commits, unpack the other one into a git-ignored
directory (``git archive <commit> | tar -x -C build/parent``) and run, in one
call on the card: the other, this, this, the other.

The line carries the card's name and power limit and the device ms
(``chip_smoke.time_ms``) of: K11 and its library call (matmul, activation,
matmul) at GPT-2's MLP (x [5632, 768], I 3072, gelu_new, biases) and
llama3-8b's (x [2048, 4096], I 14336, SwiGLU); K5 and ``x @
dequantize(q)`` int8 at GPT-2's up projection (M 5632 and M 8), int4 per
channel and with g 128 at llama3-8b's (M 2048, K 4096, N 14336); K12 and
``F.layer_norm``/``F.rms_norm`` then ``torch.matmul`` at GPT-2's and
llama3-8b's QKV projection; K1 and SDPA's
forward at GPT-2 small's prefill (8 x 704 queries into a 1024-slot cache)
and at llama3-8b's attention (B 1, S 2048, 32 query and 8 KV heads of 128,
causal), K1 with dropout 0.1 there; K13a, K13b, K13c, the whole backward
(K13a, K13b, K13c and the glue, as ``flash_attention_diff``'s backward runs
them) and SDPA's backward at llama3-8b's attention; and
``chip_smoke.train_8b_phase``'s line (three SGD steps of llama3-8b at full
width and depth, and its gradient gate); K10 and SDPA's flash forward at
Mistral-7B-Instruct-v0.2's 32K prefill call (B 1, 32,704 queries over a
32,768-slot cache, 32/8 heads of 128, causal). Then the attention part,
which ``--only attention`` runs alone (building only the sources it needs):
K9 alone at GPT-2 small's prefill (8 x 704 queries into a 1024-slot INT8
cache), at chip_smoke's ``KVQ_LLAMA`` (2 x 1024 into 2048, 32/8 heads of
128) and at generate_moe's shape (8 x 704 into 1024, Mixtral's 32/8 heads
of 128); K3 and SDPA at GPT-2 small's decode (B 8, ctx 896) and Mistral's
at 32K (B 1, ctx 32,704), and ``k3_sha256``, a hash of K3's outputs of its
fp32 pass, its grouped (tensor-core) pass and its int8 instances on seeded
inputs, equal across two checkouts exactly where K3 gives the same bits;
K1 and SDPA at gemma-7b's (D 256) and phi-2's (D 80) prefill and at 8 x 704
with GPT-2's and llama3-8b's heads, K3 and SDPA at phi-2's (D 80) and
gemma-7b's (D 256) decode, and the hashes ``k1_d64_d80_d128_sha256`` and
``k3_d256_sha256`` of the instances those rows hold unchanged; K7
at the engine's pools (GPT-2 small, 256 blocks of 128, permuted tables of
8) at the ragged contexts, at context 896, with INT8 pools, and with
llama3-8b's heads (B 8, 32/8 heads of 128), and its output's hash; and
``perop_engine``: the engine's per-op decode (GPT-2 small, B 8,
engine_bench's first 8 prompts, 64 new tokens, 8 steps a dispatch): its
generated tok/s by the host clock and K7's device ms a launch from a
torch.profiler trace of the same run; and the masked calls, which
``--only masks`` runs alone (building only K1's source): K1 with chip_smoke's
key mask (left padding) at GPT-2 small's prefill heads (D 64) and at
llama3-8b's (B 8 x 704, D 128), with its prefix-LM mask at GPT-2 small's
prefill, with its per-head mask at llama3-8b's training attention, and K9
with a key mask and the lse at generate_moe's shape, each beside the same
call without its mask, and ``mask_sha256``, a hash of their outputs on
seeded inputs (skipped in a checkout whose K1 takes no mask). Then ``runner``: the device ms of a
forward of each runner configuration (``chip_smoke.runner_phase``: GPT-2
small, 8 x 704 tokens, its logits held against the plain path),
``quick_start_prefill_ms``: the device ms of the README quick start's
prefill (int8 weights, an INT8 cache; K9, K5 and K2), and
``long_context_prefill``: Mistral's 32K prefill through the model (K10 32
times). Needs a CUDA card.
"""
import argparse
import hashlib
import json
import os
import sys
import time

import torch
import torch.nn.functional as F


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--label", default=None)
    ap.add_argument("--only", choices=("all", "attention", "masks"), default="all")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_k13: no CUDA device is available", file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import chip_smoke as cs
    from mlio_tpu_torch.ops import _build
    from mlio_tpu_torch.ops import decode_attention as da
    from mlio_tpu_torch.ops import decode_layer as dl
    from mlio_tpu_torch.ops import decode_paged_stack as dps
    from mlio_tpu_torch.ops import flash_attention as fa
    from mlio_tpu_torch.ops import flash_attention_grad as fg
    from mlio_tpu_torch.ops import fused_mlp as fm
    from mlio_tpu_torch.ops import ln_qkv as lq
    from mlio_tpu_torch.ops import norms
    from mlio_tpu_torch.ops import paged_attention as pa
    from mlio_tpu_torch.ops import quant as qm

    if not os.path.samefile(_build.CSRC.parents[1], tree):
        raise RuntimeError(f"ab_k13: imported the port from {_build.CSRC}, not from {tree}")
    # K1 at head dim 256 has its own source in newer checkouts
    attention_sources = tuple(n for n in ("flash_fwd", "flash_fwd_d256", "fused_norm",
                                          "decode_attn", "paged_attn") if n in _build.SOURCES)
    sources = {"masks": ("flash_fwd",), "attention": attention_sources}.get(
        args.only, tuple(dict.fromkeys(("flash_fwd", "flash_bwd", "ln_matmul", "fused_mlp",
                                        "quant_matmul", "fused_norm", "flash_stream") +
                                       attention_sources)))
    out = dict(tree=tree, label=args.label or os.path.basename(tree), nvidia_smi=cs.nvidia_smi(),
               build_s=_build.build_all(sources))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(13)
    reps = 30
    ms = out["ms"] = {}

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    if args.only != "all":
        (masks_part if args.only == "masks" else attention_part)(cs, out, dev, gen, rn)
        print(json.dumps(out), flush=True)
        return 0

    # K11 at GPT-2's MLP (gelu_new, biases) and llama3-8b's (SwiGLU)
    x, wu, wd = rn(5632, 768), rn(768, 3072, scale=768 ** -0.5), rn(3072, 768, scale=3072 ** -0.5)
    bu, bd = rn(3072, scale=0.1), rn(768, scale=0.1)
    ms["k11_gpt2"] = cs.time_ms(
        lambda i: fm.fused_mlp(x, wu, wd, b_up=bu, b_down=bd, activation="gelu_new"), reps)[0]
    ms["k11_gpt2_library"] = cs.time_ms(
        lambda i: F.gelu(x @ wu + bu, approximate="tanh") @ wd + bd, reps)[0]
    x, wd = rn(2048, 4096), rn(14336, 4096, scale=14336 ** -0.5)
    wu, wg = (rn(4096, 14336, scale=4096 ** -0.5) for _ in range(2))
    ms["k11_llama3_8b"] = cs.time_ms(
        lambda i: fm.fused_mlp(x, wu, wd, w_gate=wg, activation="swiglu"), 8)[0]
    ms["k11_llama3_8b_library"] = cs.time_ms(lambda i: (F.silu(x @ wg) * (x @ wu)) @ wd, 8)[0]
    del x, wu, wg, wd

    # K5: int8 at GPT-2's up projection (M 5632 and 8), int4 at llama3-8b's
    for key, m, k, n, fmt, gs in (("k5_int8_gpt2", 5632, 768, 3072, "int8", None),
                                  ("k5_int8_m8", 8, 768, 3072, "int8", None),
                                  ("k5_int4_llama3_8b", 2048, 4096, 14336, "int4", None),
                                  ("k5_int4_g128_llama3_8b", 2048, 4096, 14336, "int4", 128)):
        x, w = rn(m, k), torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
        t = qm.quantize_int8(w) if fmt == "int8" else qm.quantize_int4(w, group_size=gs)
        r = reps if m < 2048 else 10
        ms[key] = cs.time_ms(lambda i: qm.quant_matmul(x, t.q, t.scale, fmt=fmt), r)[0]
        ms[key + "_library"] = cs.time_ms(lambda i: x @ qm.dequantize(t, torch.bfloat16), r)[0]
        del x, w, t

    # K12 at GPT-2's (LayerNorm with bias, q/k/v of 768) and llama3-8b's QKV
    # (RMSNorm, 4096 + 1024 + 1024)
    for key, m, h, widths, kind in (("k12_gpt2", 5632, 768, (768,) * 3, "layernorm"),
                                    ("k12_llama3_8b", 2048, 4096, (4096, 1024, 1024), "rmsnorm")):
        x, sc = rn(m, h) + 0.5, 1 + rn(h, scale=0.1)
        b = rn(h, scale=0.1) if kind == "layernorm" else None
        ws = [rn(h, n, scale=h ** -0.5) for n in widths]
        w_cat = torch.cat(ws, dim=1)
        norm = ((lambda: F.layer_norm(x, (h,), sc, b, 1e-5)) if kind == "layernorm"
                else (lambda: F.rms_norm(x, (h,), sc, 1e-5)))
        ms[key] = cs.time_ms(lambda i: lq.fused_norm_matmul(x, None, sc, b, kind=kind, parts=ws),
                             reps)[0]
        ms[key + "_library"] = cs.time_ms(lambda i: norm() @ w_cat, reps)[0]
        del x, ws, w_cat

    # K1 at GPT-2's prefill and at llama3-8b's attention, beside SDPA's forward
    q, k, v = cs.attention_inputs(gen, 8, 704, 1024, 12, 12, 64)
    qs, ks, vs = q.transpose(1, 2), k[:, :704].transpose(1, 2), v[:, :704].transpose(1, 2)
    ms["k1_gpt2"] = cs.time_ms(lambda i: fa.flash_attention(q, k, v, kv_len=704), reps)[0]
    ms["k1_gpt2_sdpa"] = cs.time_ms(
        lambda i: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True), reps)[0]
    q, k, v = cs.attention_inputs(gen, 1, 2048, 2048, 32, 8, 128)
    qt = q.transpose(1, 2)
    kx, vx = (t.transpose(1, 2).repeat_interleave(4, dim=1).contiguous() for t in (k, v))
    ms["k1_llama3_8b"] = cs.time_ms(lambda i: fa.flash_attention(q, k, v), reps)[0]
    ms["k1_llama3_8b_sdpa"] = cs.time_ms(
        lambda i: F.scaled_dot_product_attention(qt, kx, vx, is_causal=True), reps)[0]
    ms["k1_llama3_8b_dropout"] = cs.time_ms(
        lambda i: fa.flash_attention(q, k, v, dropout_rate=0.1, dropout_seed=7), reps)[0]

    # K13 at llama3-8b's attention
    do = torch.randn(q.shape, generator=gen, device=dev).to(torch.bfloat16)
    o, lse = fg.flash_fwd_lse(q, k, v)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    bwd = (q, k, v, do, lse, delta)
    qg, kg, vg = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
    sdpa_o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=True)
    sdpa_do = do.transpose(1, 2).contiguous()

    def whole(i):
        o_, lse_ = fg.flash_fwd_lse(q, k, v)
        return fg.attention_backward(q, k, v, o_, lse_, do)

    ms.update(
        k13a=cs.time_ms(lambda i: fg.flash_fwd_lse(q, k, v), reps)[0],
        k13a_library=cs.time_ms(cs.sdpa_flash(q, k, v, 2048), reps)[0],
        k13b=cs.time_ms(lambda i: fg.flash_bwd_dq(*bwd), reps)[0],
        k13c=cs.time_ms(lambda i: fg.flash_bwd_dkv(*bwd), reps)[0],
        backward=cs.time_ms(whole, reps)[0],
        sdpa_backward=cs.time_ms(lambda i: torch.autograd.grad(
            sdpa_o, (qg, kg, vg), sdpa_do, retain_graph=True), reps)[0])
    del q, k, v, do, o, lse, delta, bwd, qg, kg, vg, sdpa_o, sdpa_do, qt, kx, vx
    torch.cuda.empty_cache()

    # K10 at Mistral-7B-Instruct-v0.2's 32K prefill call, beside SDPA's flash forward
    n = cs.LC_PROMPT
    q, k, v = cs.attention_inputs(gen, 1, n, cs.LC_CACHE, 32, 8, 128)
    ms["k10_mistral"] = cs.time_ms(lambda i: fa.flash_attention_stream(q, k, v, kv_len=n), 5,
                                   warmup=2)[0]
    ms["k10_mistral_sdpa"] = cs.time_ms(cs.sdpa_flash(q, k, v, n), 5, warmup=2)[0]
    del q, k, v
    torch.cuda.empty_cache()

    attention_part(cs, out, dev, gen, rn)

    lines = []
    cs.emit = lines.append  # the phases' lines (train_8b, runner), kept for this one
    cs.train_8b_phase(dev, 0, fa, fg, (fa.flash_attention, fg.flash_fwd_lse, fg.flash_bwd_dq,
                                       fg.flash_bwd_dkv, norms.fused_norm, fm.fused_mlp,
                                       lq.fused_norm_matmul, qm.quant_matmul,
                                       fa.flash_attention_kvq))
    out["train_8b"] = lines[-1]
    torch.cuda.empty_cache()

    # the runner's configurations (the harness's, on GPT-2 small at 8 x 704)
    wrappers = (fa.flash_attention, norms.fused_norm, da.decode_attention,
                dl.decode_layer_stack, pa.paged_attention, dps.decode_paged_stack,
                fm.fused_mlp, lq.fused_norm_matmul, qm.quant_matmul)
    cs.runner_phase(dev, 0, wrappers, (fa, norms, da, fm, lq, qm))
    out["runner_device_ms"] = {name: c["device_ms"] for name, c in lines[-1]["configs"].items()}

    # the README quick start's prefill: int8 weights, an INT8 cache
    from mlio_tpu_torch.models import forward
    from mlio_tpu_torch.runtime import init_cache, quantize_params

    spec, params, ids, impl = cs.workload(0, dev)
    params = quantize_params(params, spec, "int8")

    def prefill(i):
        cache = init_cache(spec, cs.B, cs.CACHE, dtype=torch.bfloat16, quant="int8", device=dev)
        with torch.inference_mode():
            return forward(params, spec, ids, impl=impl, cache=cache)

    ms["quick_start_prefill"] = cs.time_ms(prefill, 5)[0]
    del params
    torch.cuda.empty_cache()

    # the long-context prefill: Mistral-7B-Instruct-v0.2 at full width and
    # depth, 32,704 tokens into a 32,768-slot cache (K10 a layer)
    from mlio_tpu_torch.models import Impl, init_params, spec_from_hf_config

    spec = spec_from_hf_config(cs.MISTRAL_CONFIG, name="mistral-7b-instruct-v0.2")
    params = init_params(spec, torch.Generator(device=dev).manual_seed(0), dtype=torch.bfloat16,
                         device=dev)
    ids = torch.randint(0, spec.vocab_size, (1, cs.LC_PROMPT), generator=gen, device=dev)
    cache = init_cache(spec, 1, cs.LC_CACHE, dtype=torch.bfloat16, device=dev)
    impl = Impl(attention="flash", norm="fused")

    def lc_prefill(i):
        with torch.inference_mode():
            return forward(params, spec, ids, impl=impl, cache=dict(cache, pos=0))[0]

    fa.flash_attention_stream.launches = 0
    ms["long_context_prefill"] = cs.time_ms(lc_prefill, 3, warmup=1)[0]
    out["long_context_k10_launches"] = fa.flash_attention_stream.launches
    print(json.dumps(out), flush=True)
    return 0


def sha(t) -> str:
    """The hash of a tensor's bits."""
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()


def attention_part(cs, out, dev, gen, rn):
    """K9, K3 (and its output hash) and K7 alone, and the per-op engine."""
    from mlio_tpu_torch.ops import decode_attention as da
    from mlio_tpu_torch.ops import flash_attention as fa
    from mlio_tpu_torch.ops import paged_attention as pa

    ms = out["ms"]
    # K9 at GPT-2's prefill, KVQ_LLAMA and generate_moe's shape
    for key, (b, sq, skv, hq, hkv, d) in (("k9_gpt2", (8, 704, 1024, 12, 12, 64)),
                                          ("k9_llama", (2, 1024, 2048, 32, 8, 128)),
                                          ("k9_moe", (8, 704, 1024, 32, 8, 128))):
        q = rn(b, sq, hq, d)
        kq, ks = cs.int8_kv(gen, (b, skv, hkv, d), dev)
        vq, vs = cs.int8_kv(gen, (b, skv, hkv, d), dev)
        ms[key] = cs.time_ms(lambda i: fa.flash_attention_kvq(q, kq, vq, ks, vs, kv_len=sq),
                             30 if d == 64 else 20)[0]
        del q, kq, vq, ks, vs

    # K3 at GPT-2 small's decode (B 8, 12 heads of 64, ctx 896 of 1024 slots,
    # the 12 layers in turn) and Mistral's at 32K (B 1, 32/8 heads of 128, ctx
    # 32,704 of 32,768, 2 layers in turn), beside SDPA over the valid K/V
    # (repeated to the query heads where they are grouped, outside the timing)
    for key, b, hq, hkv, d, L, smax, n in (("k3_gpt2", 8, 12, 12, 64, 12, 1024, 896),
                                           ("k3_mistral", 1, 32, 8, 128, 2, 32768, 32704)):
        qd, kc, vc = rn(b, hq, d), rn(L, b, smax, hkv, d), rn(L, b, smax, hkv, d)
        ctx = torch.full((b,), n, dtype=torch.int32, device=dev)
        g = hq // hkv
        dense = [tuple(t[l, :, :n].transpose(1, 2) if g == 1 else
                       t[l, :, :n].transpose(1, 2).repeat_interleave(g, dim=1).contiguous()
                       for t in (kc, vc)) for l in range(L)]
        reps_d = 240 if L > 2 else 50
        ms[key] = cs.time_ms(lambda i: da.decode_attention(qd, kc, vc, ctx, layer=i % L),
                             reps_d)[0]
        ms[key + "_sdpa"] = cs.time_ms(lambda i: F.scaled_dot_product_attention(
            qd[:, :, None], *dense[i % L]), reps_d)[0]
        del qd, kc, vc, dense
        torch.cuda.empty_cache()
    # K3's bits: its fp32 pass (G 1), its grouped pass (G 4) and their int8
    # instances on inputs from their own seed, hashed together
    from mlio_tpu_torch.ops.quant import quantize_kv

    hgen = torch.Generator(device=dev).manual_seed(17)
    outs = []
    for b, hq, hkv, d, smax in ((8, 12, 12, 64, 1024), (4, 32, 8, 128, 4096)):
        qd = torch.randn((b, hq, d), generator=hgen, device=dev).to(torch.bfloat16)
        kc, vc = (torch.randn((2, b, smax, hkv, d), generator=hgen, device=dev)
                  .to(torch.bfloat16) for _ in range(2))
        ctx = torch.randint(0, smax + 1, (b,), generator=hgen, device=dev).to(torch.int32)
        outs.append(da.decode_attention(qd, kc, vc, ctx, layer=1))
        (kq, ks), (vq, vs) = (quantize_kv(t.float()) for t in (kc, vc))
        outs.append(da.decode_attention(qd, kq, vq, ctx, layer=1, k_scales=ks, v_scales=vs))
        del kc, vc, kq, vq
    out["k3_sha256"] = sha(torch.cat([o.flatten() for o in outs]))
    head_dim_part(cs, out, dev)

    # K7 at the engine's pools (GPT-2 small, 256 blocks of 128, permuted
    # tables of 8 blocks), the 12 layers in turn: the ragged contexts, 896,
    # INT8 pools; then llama3-8b's heads (2 layers)
    kp, vp = (rn(12, cs.POOL_BLOCKS, cs.POOL_BS, 12, 64) for _ in range(2))
    tables = cs.paged_tables(gen, dev, cs.B, cs.TABLE_BLOCKS, cs.POOL_BLOCKS)
    ctx = torch.tensor(cs.RAGGED, dtype=torch.int32, device=dev) + 1
    c896 = torch.full((cs.B,), cs.DECODE_CTX, dtype=torch.int32, device=dev)
    qd = rn(cs.B, 12, 64)

    def k7(c, kt=kp, vt=vp, **sc):
        return lambda i: pa.paged_attention(qd, kt, vt, tables, c, layer=i % 12, **sc)

    ms["k7_gpt2"] = cs.time_ms(k7(ctx), 240)[0]
    ms["k7_gpt2_ctx896"] = cs.time_ms(k7(c896), 240)[0]
    if hasattr(pa, "paged_split_plan"):  # this checkout's split
        out["k7_plan"] = pa.paged_split_plan(cs.B, 12, cs.TABLE_BLOCKS, cs.POOL_BS)
    # the output's bits, to compare across checkouts (the same inputs in each)
    out["k7_sha256"] = sha(k7(ctx)(5))
    (kq, ks), (vq, vs) = (quantize_kv(t.float()) for t in (kp, vp))
    ms["k7_gpt2_int8"] = cs.time_ms(k7(ctx, kq, vq, k_scale_pool=ks, v_scale_pool=vs), 240)[0]
    del kp, vp, kq, vq, ks, vs
    kp, vp = (rn(2, cs.POOL_BLOCKS, cs.POOL_BS, 8, 128) for _ in range(2))
    qd = rn(cs.B, 32, 128)
    ms["k7_llama3_8b_heads"] = cs.time_ms(
        lambda i: pa.paged_attention(qd, kp, vp, tables, ctx, layer=i % 2), 240)[0]
    del kp, vp
    torch.cuda.empty_cache()
    out["perop_engine"] = perop_engine(cs, dev)
    masks_part(cs, out, dev, gen, rn)


def head_dim_part(cs, out, dev):
    """K1 and K3 at the families' head dims beside SDPA, and the output
    hashes of the instances whose code must not change. K1 at 8 x 704
    queries into a 1024-slot cache holding 704 tokens, causal: gemma-7b's
    prefill (16 heads of 256), phi-2's (32 of 80), GPT-2 small's (12 of 64)
    and llama3-8b's heads (32/8 of 128); ``k1_d64_d80_d128_sha256`` hashes
    the last three outputs. K3 at B 8, context 896 of 1024 slots, 4 layers
    in turn: phi-2's decode (32 heads of 80) and gemma-7b's (16 of 256);
    ``k3_d256_sha256`` hashes gemma-7b's output at seeded ragged contexts."""
    from mlio_tpu_torch.ops import decode_attention as da
    from mlio_tpu_torch.ops import flash_attention as fa

    ms = out["ms"]
    hgen = torch.Generator(device=dev).manual_seed(19)
    kept = []
    for key, (hq, hkv, d) in (("k1_d256_gemma", (16, 16, 256)), ("k1_d80_phi2", (32, 32, 80)),
                              ("k1_d64_gpt2", (12, 12, 64)), ("k1_d128_llama", (32, 8, 128))):
        q, k, v = cs.attention_inputs(hgen, cs.B, cs.PROMPT, cs.CACHE, hq, hkv, d)
        if d != 256:
            kept.append(fa.flash_attention(q, k, v, kv_len=cs.PROMPT))
        qt = q.transpose(1, 2)
        kx, vx = (t[:, :cs.PROMPT].transpose(1, 2).repeat_interleave(hq // hkv, dim=1)
                  .contiguous() for t in (k, v))
        ms[key] = cs.time_ms(lambda i: fa.flash_attention(q, k, v, kv_len=cs.PROMPT), 30)[0]
        ms[key + "_sdpa"] = cs.time_ms(
            lambda i: F.scaled_dot_product_attention(qt, kx, vx, is_causal=True), 30)[0]
        del q, k, v, kx, vx
    out["k1_d64_d80_d128_sha256"] = sha(torch.cat([o.flatten() for o in kept]))
    L = 4
    for key, (h, d) in (("k3_d80_phi2", (32, 80)), ("k3_d256_gemma", (16, 256))):
        qd = torch.randn((cs.B, h, d), generator=hgen, device=dev).to(torch.bfloat16)
        kc, vc = (torch.randn((L, cs.B, cs.CACHE, h, d), generator=hgen, device=dev)
                  .to(torch.bfloat16) for _ in range(2))
        ctx = torch.full((cs.B,), cs.DECODE_CTX, dtype=torch.int32, device=dev)
        ms[key] = cs.time_ms(lambda i: da.decode_attention(qd, kc, vc, ctx, layer=i % L), 200)[0]
        ms[key + "_sdpa"] = cs.time_ms(lambda i: F.scaled_dot_product_attention(
            qd[:, :, None], kc[i % L, :, :cs.DECODE_CTX].transpose(1, 2),
            vc[i % L, :, :cs.DECODE_CTX].transpose(1, 2)), 200)[0]
        if d == 256:
            ragged = torch.randint(0, cs.CACHE + 1, (cs.B,), generator=hgen,
                                   device=dev).to(torch.int32)
            out["k3_d256_sha256"] = sha(da.decode_attention(qd, kc, vc, ragged, layer=1))
        del qd, kc, vc
    torch.cuda.empty_cache()


def masks_part(cs, out, dev, gen, rn):
    """K1's and K9's masked calls at chip_smoke's masks shapes, each beside
    the same call without its mask, on inputs from their own seed, and the
    hash of their outputs."""
    import inspect

    from mlio_tpu_torch.ops import flash_attention as fa

    if "mask" not in inspect.signature(fa.flash_attention).parameters:
        out["masks"] = "this checkout's K1 takes no mask"
        return
    ms = out["ms"]
    mgen = torch.Generator(device=dev).manual_seed(18)
    outs = []

    def timed(key, call, reps):
        outs.append(call(0))
        ms[key] = cs.time_ms(call, reps)[0]

    for key, shape in (("gpt2", cs.MASK_PREFIX), ("llama3_8b", cs.MASK_KEY)):
        b, s, hq, hkv, d = shape
        q, k, v = cs.attention_inputs(mgen, b, s, s, hq, hkv, d)
        pad = cs.left_pad_mask(mgen, b, s, cs.MASK_PAD)[0]
        timed(f"k1_key_mask_{key}", lambda i: fa.flash_attention(q, k, v, mask=pad), 30)
        ms[f"k1_unmasked_{key}"] = cs.time_ms(lambda i: fa.flash_attention(q, k, v), 30)[0]
        if key == "gpt2":  # the prefix-LM mask (not causal)
            pre = torch.randint(1, s, (b,), generator=mgen, device=dev)
            i_ = torch.arange(s, device=dev)
            m = ((i_[None, None] < pre[:, None, None]) | (i_[None, None] <= i_[None, :, None]))
            m = m.to(torch.int8)
            timed("k1_prefix_lm_gpt2", lambda i: fa.flash_attention(q, k, v, mask=m,
                                                                    causal=False), 30)
            ms["k1_unmasked_noncausal_gpt2"] = cs.time_ms(
                lambda i: fa.flash_attention(q, k, v, causal=False), 30)[0]
        del q, k, v
    b, s, hq, hkv, d = cs.MASK_PER_HEAD
    q, k, v = cs.attention_inputs(mgen, b, s, s, hq, hkv, d)
    m = cs.holes_mask(mgen, (b, hq, s, s))
    timed("k1_per_head_mask_llama3_8b", lambda i: fa.flash_attention(q, k, v, mask=m), 20)
    ms["k1_unmasked_llama3_8b_2k"] = cs.time_ms(lambda i: fa.flash_attention(q, k, v), 20)[0]
    del q, k, v, m
    b, s, hq, hkv, d = cs.MASK_KEY
    q = cs.attention_inputs(mgen, b, s, s, hq, hkv, d)[0]
    kq, ks = cs.int8_kv(mgen, (b, 1024, hkv, d), dev)
    vq, vs = cs.int8_kv(mgen, (b, 1024, hkv, d), dev)
    pad = cs.left_pad_mask(mgen, b, 1024, cs.MASK_PAD)[0]
    kw = dict(kv_len=s, k_scale=ks, v_scale=vs)
    timed("k9_key_mask_lse_moe", lambda i: fa.flash_attention(q, kq, vq, mask=pad,
                                                              return_stats=True, **kw)[0], 20)
    ms["k9_unmasked_moe"] = cs.time_ms(lambda i: fa.flash_attention(q, kq, vq, **kw), 20)[0]
    out["mask_sha256"] = sha(torch.cat([o.flatten() for o in outs]))
    torch.cuda.empty_cache()


def perop_engine(cs, dev):
    """The engine's per-op decode (K7 a layer a step): GPT-2 small, B 8,
    engine_bench's first 8 prompts, 64 new tokens, 8 steps a dispatch, after
    a warm-up; generated tok/s by the host clock, then K7's device ms a
    launch from a torch.profiler trace of a second run."""
    from torch.profiler import ProfilerActivity, profile

    from mlio_tpu_torch.models import Impl, load_model
    from mlio_tpu_torch.runtime import InferenceEngine

    spec, params = load_model("gpt2", dtype=torch.bfloat16, device=dev, seed=0)
    prompts = cs.engine_prompts(0, spec.vocab_size)[:cs.B]
    eng = InferenceEngine(spec, params, max_batch=cs.B, num_blocks=cs.POOL_BLOCKS,
                          block_size=cs.POOL_BS, impl=Impl(attention="flash", norm="fused"),
                          device=dev, steps_per_dispatch=8, decode_stack="perop")
    eng.run(prompts, max_new_tokens=8)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(prompts, max_new_tokens=64)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.run(prompts, max_new_tokens=64)
        torch.cuda.synchronize()
    k7 = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
          and "paged" in e.name.lower() and "stack" not in e.name.lower()]
    us = sum(e.time_range.end - e.time_range.start for e in k7)
    return dict(prompts=len(prompts), max_new_tokens=64, wall_s=wall,
                generated_tok_per_s=len(prompts) * 64 / wall, k7_launches=len(k7),
                k7_device_ms_per_launch=us / 1e3 / max(1, len(k7)))


if __name__ == "__main__":
    sys.exit(main())
