"""K10 beside variants of its own source at Mistral-7B-Instruct-v0.2's 32K
prefill call (B 1, 32,704 queries over a 32,768-slot cache, 32/8 heads of
128, causal), timed in turn in one process on one card: one JSON line.

    python3 ab_k10.py

The variants are ``csrc/flash_stream.cu`` with one change each, built with
the port's nvcc flags into ``build/k10_variants/``: ``turns`` adds named
barriers that hand the tensor cores from one consumer warpgroup to the
other at each issue (ping-pong), ``bkv64`` takes 64-key K/V tiles.
``kernel`` is the source as it stands, built the same way. The line carries
the card's name and power limit, each build's registers and spills, the
device ms of each round (``chip_smoke.time_ms``, 10 launches; ROUNDS
rounds, the order forward and backward in turn) with their medians, and
each variant's output against the kernel's: ``turns`` must give the same
bits, ``bkv64`` (p rounded against the running max of other tiles) K10's
limits. Needs a CUDA card; exits 1 if a variant disagrees.
"""
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
ROUNDS = 8
ARRIVE = ('__device__ __forceinline__ void named_arrive(int id, int threads) {\n'
          '  asm volatile("bar.arrive %0, %1;\\n" ::"r"(id), "r"(threads) : "memory");\n}\n')
HAND_OVER = r"\g<0>\1named_arrive(kTurn + 1 - w, 2 * kWg);\n"
# (pattern, replacement, matches): consumer w waits at kTurn + w before each
# issue and hands over at kTurn + 1 - w after it; consumer 0 goes first, and
# only consumer 0 hands over after its last issue, since consumer 1 waits
# for no later turn.
TURNS = (
    (r"^constexpr int kQReady = 1;\n", r"\g<0>constexpr int kTurn = 3;\n", 1),
    (r"^__device__ __forceinline__ void named_sync\(", lambda m: ARRIVE + m.group(0), 1),
    (r"^( *)named_sync\(kQReady \+ w, kWg\);\n",
     r"\g<0>\1if (w == 1) named_arrive(kTurn, 2 * kWg);\n", 1),
    (r"^( *)wgmma_fence\(\);\n", r"\1named_sync(kTurn + w, 2 * kWg);\n\g<0>", 3),
    (r"^( *)s_product<D>\(s, q_t, sK\);\n *wgmma_commit\(\);\n", HAND_OVER, 1),
    (r"^( *)wgmma_commit\(\);\n(?= *wgmma_wait<1>)", HAND_OVER, 1),
    (r"^( *)pv_product<D>\(o, pa, sV \+ sv \* BKV \* D\);\n *wgmma_commit\(\);\n"
     r"(?= *wgmma_wait<0>)", r"\g<0>\1if (w == 0) named_arrive(kTurn + 1, 2 * kWg);\n", 1),
)
VARIANTS = {"turns": TURNS,
            "bkv64": ((r"^constexpr int BKV = 128;", "constexpr int BKV = 64;", 1),)}


def edited(src, subs):
    """src with each (pattern, replacement, matches) applied, line-anchored;
    raises where a pattern does not match exactly that many times."""
    for pattern, repl, count in subs:
        src, n = re.subn(pattern, repl, src, flags=re.M)
        if n != count:
            raise RuntimeError(f"ab_k10: {pattern!r} matched {n} times in flash_stream.cu, "
                               f"not {count}")
    return src


def build(names_sources, out_dir, _build):
    """Every source built at once; returns each one's library path."""
    procs = {}
    for name, text in names_sources.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
               str(out_dir / f"{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"ab_k10: nvcc failed for {name}:\n{log}")
        _build.BUILD_LOGS[name] = log
    return {name: out_dir / f"{name}.so" for name in procs}


def main() -> int:
    if not torch.cuda.is_available():
        print("ab_k10: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from mlio_tpu_torch.ops import _build

    src = (_build.CSRC / "flash_stream.cu").read_text()
    sources = {"kernel": src}
    for name, subs in VARIANTS.items():
        sources[name] = edited(src, subs)
    out_dir = ROOT / "build" / "k10_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = build(sources, out_dir, _build)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(10)
    n, skv, hq, hkv, d = cs.LC_PROMPT, cs.LC_CACHE, 32, 8, 128
    q, k, v = cs.attention_inputs(gen, 1, n, skv, hq, hkv, d)
    P, I, F, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    outs, ms = {}, {name: [] for name in sources}
    calls = {}
    for name, path in libs.items():
        fn = ctypes.CDLL(str(path)).mlio_flash_stream
        fn.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, I, I, F, I, LL, LL, LL, P]
        out = torch.empty_like(q)

        def call(i, fn=fn, out=out, name=name):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None, None, n, 1,
                     n, skv, hq, hkv, d, 0, d ** -0.5, 1, *out.stride()[:3],
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"ab_k10: {name} failed with CUDA error {err}")

        call(0)
        torch.cuda.synchronize()
        outs[name], calls[name] = out, call
    order = [name for r in range(ROUNDS) for name in (list(sources)[::(-1) ** r])]
    for name in order:
        ms[name].append(cs.time_ms(calls[name], 10, warmup=2)[0])
    median = {name: statistics.median(t) for name, t in ms.items()}
    base = outs["kernel"]
    checks = dict(turns_same_bits=bool(torch.equal(outs["turns"], base)))
    ok, err = cs.within("flash_attention_stream", outs["bkv64"], base)
    checks.update(bkv64_within_k10_limits=ok, bkv64_max_abs_err=err,
                  bkv64_row_rel_rms=cs.row_rel_rms(outs["bkv64"], base))
    print(json.dumps(dict(nvidia_smi=cs.nvidia_smi(), ptxas=_build.ptxas_summary(),
                          call=f"q [1,{n},{hq},{d}] k/v [1,{skv},{hkv},{d}] bf16, causal",
                          order=order, ms=ms, median_ms=median, checks=checks)))
    return 0 if checks["turns_same_bits"] and ok else 1


if __name__ == "__main__":
    sys.exit(main())
