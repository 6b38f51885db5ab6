"""K1, K5, K11, K12 and K13, the runner's configurations, the quick start's
prefill and llama3-8b's training step, timed on one card from one checkout
of this repository: one JSON line.

    python3 ab_k13.py [--tree DIR] [--label NAME]

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
width and depth, and its gradient gate). Then ``runner``: the device ms of
a forward of each runner configuration (``chip_smoke.runner_phase``: GPT-2
small, 8 x 704 tokens, its logits held against the plain path), and
``quick_start_prefill_ms``: the device ms of the README quick start's
prefill (int8 weights, an INT8 cache; K9, K5 and K2). Needs a CUDA card.
"""
import argparse
import json
import os
import sys

import torch
import torch.nn.functional as F


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--label", default=None)
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
    out = dict(tree=tree, label=args.label or os.path.basename(tree), nvidia_smi=cs.nvidia_smi(),
               build_s=_build.build_all(("flash_fwd", "flash_bwd", "ln_matmul", "fused_mlp",
                                         "quant_matmul", "fused_norm")))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(13)
    reps = 30
    ms = out["ms"] = {}

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

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
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
