"""K13's backward kernels and llama3-8b's training step, timed on one card
from one checkout of this repository: one JSON line.

    python3 ab_k13.py [--tree DIR] [--label NAME]

DIR (default: the directory of this script) is the checkout whose
``chip_smoke.py`` and ``mlio_tpu_torch`` are imported and whose kernels are
built. To compare two commits, unpack the other one into a git-ignored
directory (``git archive <commit> | tar -x -C build/parent``) and run, in one
call on the card: the other, this, this, the other. The line carries the
card's name and power limit; the device ms (``chip_smoke.time_ms``) of K13a,
K13b, K13c, the whole backward (K13a, K13b, K13c and the glue, as
``flash_attention_diff``'s backward runs them) and SDPA's backward at
llama3-8b's attention (B 1, S 2048, 32 query and 8 KV heads of 128, causal);
and ``chip_smoke.train_8b_phase``'s line (three SGD steps of llama3-8b at full
width and depth, and its gradient gate). Needs a CUDA card.
"""
import argparse
import json
import os
import sys

import torch


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
               build_s=_build.build_all(("flash_fwd", "flash_bwd")))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(13)
    q, k, v = cs.attention_inputs(gen, 1, 2048, 2048, 32, 8, 128)
    do = torch.randn(q.shape, generator=gen, device=dev).to(torch.bfloat16)
    o, lse = fg.flash_fwd_lse(q, k, v)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    bwd = (q, k, v, do, lse, delta)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
    sdpa_o = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                              enable_gqa=True)
    sdpa_do = do.transpose(1, 2).contiguous()

    def whole(i):
        o_, lse_ = fg.flash_fwd_lse(q, k, v)
        return fg.attention_backward(q, k, v, o_, lse_, do)

    reps = 30
    out["ms"] = dict(
        k13a=cs.time_ms(lambda i: fg.flash_fwd_lse(q, k, v), reps)[0],
        k13b=cs.time_ms(lambda i: fg.flash_bwd_dq(*bwd), reps)[0],
        k13c=cs.time_ms(lambda i: fg.flash_bwd_dkv(*bwd), reps)[0],
        backward=cs.time_ms(whole, reps)[0],
        sdpa_backward=cs.time_ms(lambda i: torch.autograd.grad(
            sdpa_o, (qt, kt, vt), sdpa_do, retain_graph=True), reps)[0])
    del q, k, v, do, o, lse, delta, bwd, qt, kt, vt, sdpa_o, sdpa_do
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
