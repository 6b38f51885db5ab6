"""K1, K12 and K13 and llama3-8b's training step, timed on one card from one
checkout of this repository: one JSON line.

    python3 ab_k13.py [--tree DIR] [--label NAME]

DIR (default: the directory of this script) is the checkout whose
``chip_smoke.py`` and ``mlio_tpu_torch`` are imported and whose kernels are
built. To compare two commits, unpack the other one into a git-ignored
directory (``git archive <commit> | tar -x -C build/parent``) and run, in one
call on the card: the other, this, this, the other.

The line carries the card's name and power limit and the device ms
(``chip_smoke.time_ms``) of: K12 and ``F.layer_norm``/``F.rms_norm`` then
``torch.matmul`` at GPT-2's and llama3-8b's QKV projection; K1 and SDPA's
forward at GPT-2 small's prefill (8 x 704 queries into a 1024-slot cache)
and at llama3-8b's attention (B 1, S 2048, 32 query and 8 KV heads of 128,
causal), K1 with dropout 0.1 there; K13a, K13b, K13c, the whole backward
(K13a, K13b, K13c and the glue, as ``flash_attention_diff``'s backward runs
them) and SDPA's backward at llama3-8b's attention; and
``chip_smoke.train_8b_phase``'s line (three SGD steps of llama3-8b at full
width and depth, and its gradient gate). Needs a CUDA card.
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
    from mlio_tpu_torch.ops import flash_attention as fa
    from mlio_tpu_torch.ops import flash_attention_grad as fg
    from mlio_tpu_torch.ops import fused_mlp as fm
    from mlio_tpu_torch.ops import ln_qkv as lq
    from mlio_tpu_torch.ops import norms
    from mlio_tpu_torch.ops import quant as qm

    if not os.path.samefile(_build.CSRC.parents[1], tree):
        raise RuntimeError(f"ab_k13: imported the port from {_build.CSRC}, not from {tree}")
    out = dict(tree=tree, label=args.label or os.path.basename(tree), nvidia_smi=cs.nvidia_smi(),
               build_s=_build.build_all(("flash_fwd", "flash_bwd", "ln_matmul")))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(13)
    reps = 30
    ms = out["ms"] = {}

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

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
    cs.emit = lines.append  # train_8b_phase's line, kept for this one
    cs.train_8b_phase(dev, 0, fa, fg, (fa.flash_attention, fg.flash_fwd_lse, fg.flash_bwd_dq,
                                       fg.flash_bwd_dkv, norms.fused_norm, fm.fused_mlp,
                                       lq.fused_norm_matmul, qm.quant_matmul,
                                       fa.flash_attention_kvq))
    out["train_8b"] = lines[-1]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
