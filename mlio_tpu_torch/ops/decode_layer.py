"""The decode megakernel (K4): every layer of a decode step in one launch.

Replaces ``mlio_tpu/ops/decode_layer.py::_decode_stack_kernel`` and its body
``_decode_layer_body`` (entry ``decode_layer_stack``). The kernel is CUDA
C++ in ``mlio_tpu_torch/csrc/decode_layer.cu``: one persistent cooperative
launch per call that runs, for every step and every layer, norm → QKV →
RoPE → cache write → attention → out-projection → norm → MLP, then
optionally the greedy epilogue (final norm, lm_head, first-index argmax)
and, with ``steps > 1``, the next step's embedding and position. A producer
warp a block streams the weights by TMA ahead of the phases; each consumer
waits on readiness counters of what it reads, not on a grid barrier; the
residual stays in fp32 across layers. Its source note gives the H100 bound
and the design; :func:`stack_plan` mirrors its plan for the CPU tests.

On CPU tensors :func:`decode_layer_stack` runs
:func:`decode_layer_stack_plain`; on CUDA tensors it launches the kernel or
raises. The cache is the port's ``[L, B, Smax, Hkv, D]`` (the JAX package's
flat ``[L, B, Smax, Hkv*D]`` is the same memory) and is updated in place.
The TPU's layout and tuning knobs (``interpret``, ``vocab_chunk``,
``cache_block``, ``kv_combined``, ``kv_depth``) and its scale layout
(``pad_scales_for_mega``: the port keeps the scan layout [L, B, Smax, Hkv])
have no counterpart here.

INT8 weights (:class:`~mlio_tpu_torch.ops.quant.QTensor` with ``fmt ==
"int8"``: a payload [L, in, out] and per-output-channel fp32 scales
[L, out]) stream as int8 and are widened in registers; the scale multiplies
the finished fp32 sum before the bias, as ``_mm`` does. An INT8 KV cache
(int8 caches with fp32 ``k_scales``/``v_scales`` [L, B, Smax, Hkv]) is read
with its scales fused into the score and PV products, and the current
token's K/V are quantized in the kernel exactly as ``_quantize_heads``
(``quantize_kv``) does.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from mlio_tpu_torch.ops import _build, cost
from mlio_tpu_torch.ops.quant import QTensor, dequantize_kv, quantize_kv
from mlio_tpu_torch.ops.reference import activate

_ACTIVATIONS = ("gelu_new", "gelu_tanh", "gelu", "relu", "swiglu", "geglu")
_GROUPS = (1, 2, 4, 8)
_HEAD_DIMS = (64, 128)
MAX_BATCH = 8      # rows of the kernel's register accumulators
MAX_HIDDEN = 8192  # the epilogue keeps [MAX_BATCH, H] bf16 in shared memory


def supports_decode_stack(spec, cache_quant: bool = False, blocks=None,
                          smax: Optional[int] = None, B: Optional[int] = None,
                          on_card: bool = True) -> bool:
    """Whether K4 applies to ``spec``: the JAX package's feature conditions
    (sequential residual, no experts, a supported activation, floating or
    int8 weights in the per-projection layout, each projection in its own
    format, not int4 or fp8; an INT8 cache needs a 128-aligned length
    there), a gated MLP's w_up and w_gate in one format (the kernels' up
    phase shares their column tiles) and, given the batch ``B``, the
    CUDA instances' shape limits (:func:`kernel_limit`): B <= 8 always, the
    head and width limits ``on_card`` (the plain version on the CPU takes any
    head geometry).

    The JAX package also asks that one layer's weights fit the TPU's VMEM
    budget and sends larger dense models to the tiled kernel (K6). That rule
    is a TPU budget and is not kept: ``decode_route`` in
    ``models.transformer`` picks K4 or K6 by the port's own rule."""
    if spec.parallel_residual or spec.num_experts:
        return False
    if cache_quant and smax is not None and smax % 128:
        return False
    if spec.activation not in _ACTIVATIONS:
        return False
    if blocks is not None:
        if blocks.get("wq") is None:  # the per-projection layout
            return False
        for name in PROJECTIONS:
            w = blocks.get(name)
            if isinstance(w, QTensor):
                if w.fmt != "int8":
                    return False
            elif w is not None and (not isinstance(w, torch.Tensor) or not w.is_floating_point()):
                return False
        if _pair_mix(blocks, spec):
            return False
    return B is None or route_limit(spec, B, on_card) is None


def _pair_mix(blocks, spec) -> bool:
    """A gated MLP whose w_up and w_gate differ in format: the kernels' up
    phase sums the two over shared column tiles, so it takes one format."""
    return (spec.activation in ("swiglu", "geglu")
            and isinstance(blocks.get("w_up"), QTensor) != isinstance(blocks.get("w_gate"),
                                                                       QTensor))


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def _norm32(x32, scale, bias, kind, eps):
    """``_norm`` of the JAX kernel: fp32 statistics and affine; RMSNorm takes
    no bias."""
    if kind == "rmsnorm":
        return x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps) * scale.float()
    xc = x32 - x32.mean(-1, keepdim=True)
    y = xc * torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps) * scale.float()
    return y if bias is None else y + bias.float()


def _mm(h, w, b, s=None):
    """``_mm`` of the JAX kernel: the fp32 product, times the int8 weight's
    per-output-channel scale ``s``, plus the bias."""
    y = h.float() @ w.float()
    if s is not None:
        y = y * s.float()
    return y if b is None else y + b.float()


def _rope(x, cos, sin, D):
    """Rotate-half over the first ``len(cos)`` lanes of each head of a flat
    [B, heads*D] fp32 tensor; the tail passes through."""
    B = x.shape[0]
    x = x.reshape(B, -1, D)
    R = cos.shape[-1]
    xr = x[..., :R]
    rot = torch.cat([-xr[..., R // 2:], xr[..., :R // 2]], dim=-1)
    return torch.cat([xr * cos + rot * sin, x[..., R:]], dim=-1).reshape(B, -1)


def _attend_plain(qs, keys, vals, valid=None):
    """Attention of the bf16-rounded scaled queries qs [B, Hkv, G, D] (fp32)
    over keys/vals [B, T, Hkv, D] in the cache's dtype → [B, Hkv, G, D]
    fp32, the probabilities fp32 for the PV product. ``valid`` [B, T] masks
    slots out before either product, so what they hold (NaN included) never
    reaches the output.

    The TPU kernels round the probabilities to bf16 for their MXU. The CUDA
    kernels take a running max where this takes the final one, so the two
    would round p at different values: on the card, at GPT-2 small's full
    width, that put K8's x_out past the 5e-2 + 5e-2·|plain| check after 12
    layers (0.0664 off, chip_smoke.py), while the summation order alone
    leaves it well inside. Keeping p in fp32 removes that noise; in fp32
    (the CPU tests against the JAX package) nothing changes."""
    sc = torch.einsum("bkgd,btkd->bkgt", qs, keys.float())
    if valid is not None:
        sc = sc.masked_fill(~valid[:, None, None, :], float("-inf"))
        vals = vals.masked_fill(~valid[:, :, None, None], 0)
    m = sc.amax(-1, keepdim=True)
    pr = torch.exp(sc - torch.where(m.isneginf(), 0.0, m))
    l = pr.sum(-1, keepdim=True)
    o = torch.einsum("bkgt,btkd->bkgd", pr, vals.float())
    return o / torch.where(l == 0, 1.0, l)


def layer_plain(x32, blocks, layer, *, spec, dtype, scale, rope, attend):
    """One layer of the decode megakernels' function (K4 and K8) on the fp32
    residual x32 [B, H], with their rounding points: the norm outputs,
    ``q * scale``, the attention output and the activation are rounded to
    the compute dtype ``dtype``; projections accumulate in fp32.

    ``rope(t)`` rotates a flat [B, heads*D] fp32 projection (None: learned
    positions). ``attend(layer, qs, k, v)`` writes k, v [B, Hkv, D] (fp32,
    after RoPE) into the cache, rounded or quantized as the cache stores
    them, and returns the attention [B, Hkv, G, D] fp32 of qs. An int8
    QTensor weight's scale multiplies the fp32 product before the bias."""
    bp, cd = blocks, dtype
    B = x32.shape[0]
    Hq, Hkv, D = spec.num_heads, spec.num_kv_heads, spec.head_size
    norm, eps = spec.norm, spec.norm_eps
    gated = spec.activation in ("swiglu", "geglu")

    def bias(name):
        b = bp.get(name)
        return None if b is None else b[layer]

    def mm(x, name, bname):
        w = bp[name]
        if isinstance(w, QTensor):
            return _mm(x, w.q[layer], bias(bname), w.scale[layer])
        return _mm(x, w[layer], bias(bname))

    h = _norm32(x32, bp["ln1_scale"][layer], bias("ln1_bias"), norm, eps).to(cd)
    q, k, v = mm(h, "wq", "bq"), mm(h, "wk", "bk"), mm(h, "wv", "bv")
    if rope is not None:
        q, k = rope(q), rope(k)
    qs = (q * scale).to(cd).float().reshape(B, Hkv, Hq // Hkv, D)
    attn = attend(layer, qs, k.reshape(B, Hkv, D), v.reshape(B, Hkv, D))
    x32 = x32 + mm(attn.reshape(B, Hq * D).to(cd), "wo", "bo")
    h2 = _norm32(x32, bp["ln2_scale"][layer], bias("ln2_bias"), norm, eps).to(cd)
    u = mm(h2, "w_up", "b_up")
    g = mm(h2, "w_gate", "b_gate") if gated else None
    act = activate(u, g, spec.activation).to(cd)
    return x32 + mm(act, "w_down", "b_down")


def logits_plain(x32, head_norm, lm_head, lm_head_bias=None, *, spec, lm_vmajor=True,
                 vocab_size=None, dtype=None):
    """The epilogue's fp32 logits [B, V]: the final norm of the residual
    rounded to the compute dtype (``dtype``, default lm_head's), times the
    tied [V, H] table or the untied [H, V] head, plus the head bias."""
    V = vocab_size or (lm_head.shape[0] if lm_vmajor else lm_head.shape[1])
    hf = _norm32(x32.float(), head_norm[0], head_norm[1], spec.norm, spec.norm_eps)
    hf = hf.to(dtype or lm_head.dtype).float()
    logits = hf @ (lm_head[:V].float().T if lm_vmajor else lm_head[:, :V].float())
    if lm_head_bias is not None:
        logits = logits + lm_head_bias[:V].float()
    return logits


def decode_layer_stack_plain(
    x: torch.Tensor,
    blocks,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    pos: int,
    cos: Optional[torch.Tensor] = None,
    sin: Optional[torch.Tensor] = None,
    *,
    spec,
    scale: Optional[float] = None,
    head_norm=None,
    lm_head: Optional[torch.Tensor] = None,
    lm_head_bias: Optional[torch.Tensor] = None,
    lm_vmajor: bool = True,
    vocab_size: Optional[int] = None,
    pos_embed: Optional[torch.Tensor] = None,
    steps: int = 1,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The kernel's function in plain PyTorch, with K4's rounding points
    (:func:`layer_plain`); the residual stays fp32 across layers and the
    RoPE tables are rounded to x's dtype first. The softmax takes the row's
    final max where the kernel takes a running one (fp32 noise only: the
    probabilities are not rounded, :func:`_attend_plain`).

    Writes slot ``pos + s`` of every layer of the caches in place. With
    ``k_scales``/``v_scales`` the caches are INT8: the current token's fp32
    K/V are quantized per head (``quantize_kv``, as ``_quantize_heads``),
    written with their scales, and attention runs over the dequantized
    slots, the current token's included."""
    cd = x.dtype
    D = k_cache.shape[4]
    if scale is None:
        scale = D ** -0.5
    if cos is not None:
        cos, sin = cos.to(cd).float(), sin.to(cd).float()
    x32 = x.float()
    if pos_embed is not None:
        x32 = x32 + pos_embed[pos].float()
    tokens = []
    for s in range(steps):
        p = pos + s

        def attend(layer, qs, k, v):
            if k_scales is None:
                k_cache[layer, :, p] = k.to(k_cache.dtype)
                v_cache[layer, :, p] = v.to(v_cache.dtype)
                return _attend_plain(qs, k_cache[layer, :, :p + 1], v_cache[layer, :, :p + 1])
            for cache, scales, new in ((k_cache, k_scales, k), (v_cache, v_scales, v)):
                cache[layer, :, p], scales[layer, :, p] = quantize_kv(new)
            return _attend_plain(
                qs, dequantize_kv(k_cache[layer, :, :p + 1], k_scales[layer, :, :p + 1]),
                dequantize_kv(v_cache[layer, :, :p + 1], v_scales[layer, :, :p + 1]))

        rope = None if cos is None else (lambda t: _rope(t, cos[s], sin[s], D))
        for layer in range(k_cache.shape[0]):
            x32 = layer_plain(x32, blocks, layer, spec=spec, dtype=cd, scale=scale,
                              rope=rope, attend=attend)
        if lm_head is None:
            continue
        logits = logits_plain(x32, head_norm, lm_head, lm_head_bias, spec=spec,
                              lm_vmajor=lm_vmajor, vocab_size=vocab_size, dtype=cd)
        tok = logits.argmax(-1).to(torch.int32)  # the first index of the max
        tokens.append(tok)
        if s + 1 < steps:
            x32 = lm_head[tok.long()].float()
            if spec.embed_scale is not None:
                x32 = x32 * spec.embed_scale
            if pos_embed is not None:
                x32 = x32 + pos_embed[p + 1].float()
    if lm_head is None:
        return x32.to(cd), None
    toks = torch.stack(tokens)
    return x32.to(cd), (toks[0] if steps == 1 else toks)


def phase_stamps(spec, steps: int = 1, epilogue: bool = True) -> int:
    """Timer stamps one launch writes (block 0's, after each wait): the
    start, the first step's input, five phases a layer, and per step the
    logits and, before a next step, the token."""
    return 2 + steps * 5 * spec.num_layers + (2 * steps - 1 if epilogue else 0)


# ---------------------------------------------------------------------------
# The kernels' plan (mirror of csrc/decode_stack.cuh's make_phase, make_plan,
# consumer_bytes and each block's order of units and waits)
# ---------------------------------------------------------------------------

SMS = 132             # the H100's SMs: one block each
STACK_PHASES = ("qkv", "out_proj", "mlp_up", "mlp_down")
# the projections in the order of the kernels' wfmt bits
PROJECTIONS = ("wq", "wk", "wv", "wo", "w_up", "w_gate", "w_down")
BOX = 128             # bytes of a unit row: one 128-byte-swizzled TMA box
SLOT_BYTES = 16384    # a ring slot
MAX_KB, MIN_KB = SLOT_BYTES // BOX, 32
MAX_SLOTS = 13
ACT_UNITS = 2         # units whose activations are staged at once
ACT_ROW = MAX_KB + 8  # a staged bf16 activation row
SMEM_LIMIT = 232448   # 227 KB a block
STATIC_SMEM = 4096    # the kernel's static shared memory, at most
ALIGN = 1024
WARPS = 8             # consumer warps


def _up64(x: int) -> int:
    return -(-x // 64) * 64


def unit_begin(U: int, nb: int, b: int) -> int:
    """The first of block b's units: blocks take equal runs of the U units."""
    return U * b // nb


def unit_owner(U: int, nb: int, u: int) -> int:
    """The block whose run holds unit u."""
    return -(-((u + 1) * nb) // U) - 1


def weight_bits(fmt) -> int:
    """The kernels' ``wfmt`` of the weights' formats ``fmt``: None (bf16),
    "int8" (every projection), or a mapping of projection name to either:
    bit i set where projection i of :data:`PROJECTIONS` is int8."""
    if fmt is None or isinstance(fmt, str):
        fmt = dict.fromkeys(PROJECTIONS, fmt)
    return sum(1 << i for i, n in enumerate(PROJECTIONS) if fmt.get(n) == "int8")


def _phase(kind: str, H: int, Qd: int, KVd: int, I: int, gated: bool, bits: int,
           nb: int) -> dict:
    """make_phase: a GEMV phase's matrices (matrix m as column tiles of
    ``tcm[m]`` columns, 128 bytes: 64 bf16 or 128 int8 as its format
    ``fm[m]``; a tile's partial ``tc``, the widest, columns), its units
    (``nk`` of ``KB`` rows over ``K``) and sum groups (a tile; a gated up:
    the pair (c, c + ct[0]))."""
    if kind == "qkv":
        K, N, names = H, [Qd, KVd, KVd], ["wq", "wk", "wv"]
    elif kind == "out_proj":
        K, N, names = Qd, [H], ["wo"]
    elif kind == "mlp_up":
        K, N, names = H, ([I, I] if gated else [I]), (["w_up", "w_gate"] if gated else ["w_up"])
    else:
        K, N, names = I, [H], ["w_down"]
    fm = [(bits >> PROJECTIONS.index(n)) & 1 for n in names]
    tcm = [BOX if f else BOX // 2 for f in fm]
    ct = [-(-n // t) for n, t in zip(N, tcm)]
    t0 = [sum(ct[:m]) for m in range(len(N))]
    ntiles = sum(ct)
    KB = MAX_KB
    while KB > MIN_KB and ntiles * -(-K // KB) < nb:
        KB //= 2
    return dict(K=K, KB=KB, nk=-(-K // KB), ntiles=ntiles, tc=max(tcm), tcm=tcm, fm=fm,
                nm=len(N), N=N, ct=ct, t0=t0, names=names,
                groups=ct[0] if kind == "mlp_up" and gated else ntiles)


def tile_matrix(ph: dict, i: int) -> int:
    """The matrix (index into the phase's ``names``) of tile i."""
    return max(m for m in range(ph["nm"]) if ph["t0"][m] <= i)


def consumer_bytes(spec, epilogue: bool = True) -> dict:
    """consumer_bytes: the shared memory the consumers own after the ring,
    by use (the largest is the region's size)."""
    G, D, H = spec.num_heads // spec.num_kv_heads, spec.head_size, spec.hidden_size
    head_row = -(-H // MAX_KB) * MAX_KB + 8  # normed rows, zeros to whole units, 8 more
    uses = dict(gemv=ACT_UNITS * 8 * ACT_ROW * 2 + 4 * 32 * 8 * 4,
                attention=((G + 2) * D + G * D + 2 * WARPS * G + WARPS * G * D + 2 * D) * 4,
                epilogue=(_up64(8 * head_row * 2) + 4 * 32 * 8 * 4 + WARPS * 8 * 8
                          if epilogue else 0))
    return dict(uses, region=_up64(max(uses.values())))


def stack_plan(spec, fmt=None, nb: int = SMS, epilogue: bool = True) -> dict:
    """K4's and K8's plan at ``nb`` blocks for weights of formats ``fmt``
    (:func:`weight_bits`), as the card makes it: the
    shared memory (``slots`` 16 KB ring slots at ``ring`` = [0, slots *
    16 KB) after the 1 KB alignment, the consumers' ``region`` after it,
    ``smem`` in all), and for each of :data:`STACK_PHASES` its shape
    (:func:`_phase`), ``items`` (segments ``(block, tile, first unit, end
    unit)`` in block order; unit u is tile u // nk at k rows (u % nk) * KB),
    ``need`` (a sum group's segments) and ``order`` (the partial slots,
    block + tile, in the order the group's sum adds them, whatever the order
    of arrival: w_up's then w_gate's, each in block, that is k, order); with
    the epilogue, ``head``: the head's vocabulary ``tiles`` (block b takes
    tiles [unit_begin(tiles, nb, b), unit_begin(tiles, nb, b + 1))) of
    ``nk`` units each (the spec's tie_embeddings picks the tied layout)."""
    H, I = spec.hidden_size, spec.intermediate_size
    Qd, KVd = spec.num_heads * spec.head_size, spec.num_kv_heads * spec.head_size
    gated = spec.activation in ("swiglu", "geglu")
    bits = weight_bits(fmt)
    if gated and (bits >> 4 & 1) != (bits >> 5 & 1):
        raise ValueError("stack_plan: a gated MLP's w_up and w_gate take one format")
    cons = consumer_bytes(spec, epilogue)
    slots = min(MAX_SLOTS, (SMEM_LIMIT - STATIC_SMEM - ALIGN - cons["region"]) // SLOT_BYTES)
    out = dict(nb=nb, slots=slots, consumer=cons, ring=(0, slots * SLOT_BYTES),
               region=(slots * SLOT_BYTES, slots * SLOT_BYTES + cons["region"]),
               smem=ALIGN + slots * SLOT_BYTES + cons["region"], phases={}, head=None)
    if epilogue:  # tied [V, H]: 128-row tiles of 64-column units; untied [H, V]: 64 by 128
        V, tied = spec.vocab_size, spec.tie_embeddings
        out["head"] = dict(tied=tied, tiles=-(-V // (MAX_KB if tied else 64)),
                           nk=-(-H // (64 if tied else MAX_KB)))
    for kind in STACK_PHASES:
        ph = _phase(kind, H, Qd, KVd, I, gated, bits, nb)
        U = ph["ntiles"] * ph["nk"]
        items = []
        for b in range(nb):
            u, end = unit_begin(U, nb, b), unit_begin(U, nb, b + 1)
            while u < end:
                stop = min((u // ph["nk"] + 1) * ph["nk"], end)
                items.append((b, u // ph["nk"], u, stop))
                u = stop

        def blocks_of(i):  # the blocks that stream units of tile i, in order
            first = unit_owner(U, nb, i * ph["nk"])
            last = unit_owner(U, nb, (i + 1) * ph["nk"] - 1)
            return [b for b in range(first, last + 1)
                    if unit_begin(U, nb, b) < unit_begin(U, nb, b + 1)]

        pair = ph["groups"] != ph["ntiles"]
        order = {}
        for gi in range(ph["groups"]):
            tiles = [gi, gi + ph["ct"][0]] if pair else [gi]
            order[gi] = [b + t for t in tiles for b in blocks_of(t)]
        ph.update(items=items, order=order, need={gi: len(o) for gi, o in order.items()})
        out["phases"][kind] = ph
    # the readiness counters in the sync buffer, as make_plan lays them out
    ctr = 0
    for kind in STACK_PHASES:
        g = out["phases"][kind]["groups"]
        out["phases"][kind].update(arrive=ctr, done=ctr + g)
        ctr += 2 * g
    Hkv = spec.num_kv_heads
    out["counters"] = dict(phase=ctr, attn=ctr + 4, att_arrive=ctr + 4 + Hkv,
                           init=ctr + 4 + Hkv + 8 * Hkv, logits=ctr + 5 + 9 * Hkv,
                           token=ctr + 6 + 9 * Hkv, total=ctr + 7 + 9 * Hkv)
    return out


def counter_offset(plan: dict, counter: tuple) -> int:
    """The sync buffer index of a :func:`block_program` counter."""
    c = plan["counters"]
    if counter[0] == "done":
        return plan["phases"][counter[1]]["done"] + counter[2]
    if counter[0] == "phase":
        return c["phase"] + STACK_PHASES.index(counter[1])
    if counter[0] == "attn":
        return c["attn"] + counter[1]
    return c[counter[0]]


def program_waits(plan: dict, spec, B: int, block: int) -> dict:
    """The counters (sync buffer indices, sorted) block ``block`` waits on
    before each out or down segment, keyed ("seg", phase, block, tile,
    first unit, end unit), and before each attention item, keyed ("attn",
    KV head), in
    one step of :func:`block_program`: what the card's segment_wait and
    attention_wait give (``card_waits``)."""
    out, prev = {}, None
    for ev in block_program(plan, spec, B, 1, block):
        if ev[0] == "seg" and ev[1] in ("out_proj", "mlp_down"):
            key = ("seg", ev[1], block, *ev[3:])
        elif ev[0] == "attn":
            key = ("attn", ev[3])
        else:
            prev = ev
            continue
        assert prev[0] == "wait"
        out[key] = sorted(counter_offset(plan, c) for c, _ in prev[1])
        prev = ev
    return out


def attention_split(n: list, Hkv: int, nb: int = SMS) -> dict:
    """attention_split: each (sequence b, KV head) item over n[b] slots cut
    into ``ns[b]`` splits of ``C`` slots (a multiple of 128: the smallest,
    from an even share of all slots a block up, whose splits fit the
    blocks, or each item whole past that), numbered (sequence, KV head,
    split) from ``off[b]``; ``items`` in all."""
    T = sum(n)
    C = max(128, -(-(-(-(T * Hkv) // nb)) // 128) * 128)
    while sum(-(-x // C) * Hkv for x in n) > nb and C < max(n):
        C += 128
    ns = [-(-x // C) for x in n]
    off = [Hkv * sum(ns[:b]) for b in range(len(n))]
    return dict(C=C, ns=ns, off=off, items=Hkv * sum(ns))


def segment_group(ph: dict, tile: int) -> int:
    """The sum group of a segment of ``tile``."""
    return tile - ph["ct"][0] if ph["groups"] != ph["ntiles"] and tile >= ph["ct"][0] else tile


def block_program(plan: dict, spec, B: int, steps: int, block: int,
                  epilogue: bool = True, slots=None) -> list:
    """What block ``block`` of the plan's launch does, in order, as the
    kernel's consumers do it (the producer warp issues the units of the
    ``seg`` events in the same order). Events (tuples):
      ("init",) / ("token", s): that part of the step input (a release of
          init_done / token_done);
      ("logits", s, first tile, end tile): the epilogue's vocabulary tiles
          (a release of logits_done);
      ("wait", ((counter, target), ...)): one wait of the consumers, until
          every counter reaches its target; counters are ("done", phase,
          group), ("phase", phase), ("attn", hk), ("init",), ("logits",),
          ("token",);
      ("seg", phase, it, tile, first unit, end unit): a segment of
          iteration it = s * L + layer (its arrival completes group
          segment_group(tile) after need[group] arrivals; the completing
          segment sums it and releases ("done", phase, group) and ("phase",
          phase));
      ("attn", it, b, hk, j, ns): split j of ns of the attention of sequence
          b, KV head hk (attention_split): a whole item (ns 1) releases
          ("attn", hk); a split's arrival completes the item after ns, and
          the completing split merges them and releases ("attn", hk).
    ``slots(s)`` gives each sequence's slots to attend at step s (default:
    K4's 896 + s, a context of 896 at step 0). The waits are the kernel's:
    each names the counter and the target it spins on."""
    L, nb = spec.num_layers, plan["nb"]
    Hq, Hkv, D = spec.num_heads, spec.num_kv_heads, spec.head_size
    G = Hq // Hkv
    ph = plan["phases"]
    prog = [("init",)]

    def segs(kind, it):
        p = ph[kind]
        run = [i for i in p["items"] if i[0] == block]
        for _, tile, u0, u1 in run:
            if kind == "out_proj":
                lo = (u0 % p["nk"]) * p["KB"]
                hi = min(p["K"], (u1 - tile * p["nk"]) * p["KB"]) - 1
                prog.append(("wait", tuple((("attn", hk), (it + 1) * B)
                                           for hk in range(lo // (G * D), hi // (G * D) + 1))))
            elif kind == "mlp_down":
                lo = (u0 % p["nk"]) * p["KB"]
                hi = min(p["K"], (u1 - tile * p["nk"]) * p["KB"]) - 1
                tc = ph["mlp_up"]["tcm"][0]
                prog.append(("wait", tuple((("done", "mlp_up", c), it + 1)
                                           for c in range(lo // tc, hi // tc + 1))))
            prog.append(("seg", kind, it, tile, u0, u1))

    pq = ph["qkv"]
    tcm = pq["tcm"]
    slots = slots or (lambda s: [896 + s] * B)
    for s in range(steps):
        split = attention_split(slots(s), Hkv, nb)
        for l in range(L):
            it = s * L + l
            if l > 0:
                prog.append(("wait", ((("phase", "mlp_down"), it * ph["mlp_down"]["groups"]),)))
            elif s == 0:
                prog.append(("wait", ((("init",), nb),)))
            else:
                prog.append(("wait", ((("token",), s * nb),)))
            segs("qkv", it)
            for idx in range(block, split["items"], nb):
                b = max(x for x in range(B) if split["off"][x] <= idx)
                ns = split["ns"][b]
                hk, j = divmod(idx - split["off"][b], ns)
                tiles = (list(range(hk * G * D // tcm[0], ((hk + 1) * G * D - 1) // tcm[0] + 1))
                         + [pq["t0"][m] + t for m in (1, 2)
                            for t in range(hk * D // tcm[m], ((hk + 1) * D - 1) // tcm[m] + 1)])
                prog.append(("wait", tuple((("done", "qkv", t), it + 1) for t in tiles)))
                prog.append(("attn", it, b, hk, j, ns))
            segs("out_proj", it)
            prog.append(("wait", ((("phase", "out_proj"),
                                   (it + 1) * ph["out_proj"]["groups"]),)))
            segs("mlp_up", it)
            segs("mlp_down", it)
        prog.append(("wait", ((("phase", "mlp_down"), (s + 1) * L * ph["mlp_down"]["groups"]),)))
        if epilogue:
            hd = plan["head"]
            prog.append(("logits", s, unit_begin(hd["tiles"], nb, block),
                         unit_begin(hd["tiles"], nb, block + 1)))
            prog.append(("wait", ((("logits",), (s + 1) * nb),)))
            if s + 1 < steps:
                prog.append(("token", s))
    return prog


def unit_stream(plan: dict, block: int, steps: int, L: int) -> list:
    """The units block ``block``'s producer warp issues, in order: (step,
    layer, phase, tile, k row), and after each step's layers the head's
    (step, L, "head", tile, unit); unit i goes to ring slot i % slots once
    unit i - slots has left it."""
    out, nb, hd = [], plan["nb"], plan["head"]
    for s in range(steps):
        for l in range(L):
            for kind in STACK_PHASES:
                p = plan["phases"][kind]
                U = p["ntiles"] * p["nk"]
                for u in range(unit_begin(U, nb, block), unit_begin(U, nb, block + 1)):
                    out.append((s, l, kind, u // p["nk"], (u % p["nk"]) * p["KB"]))
        if hd is not None:
            out += [(s, L, "head", vt, kc)
                    for vt in range(unit_begin(hd["tiles"], nb, block),
                                    unit_begin(hd["tiles"], nb, block + 1))
                    for kc in range(hd["nk"])]
    return out


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

# int8 QTensor weights: the payload goes in the weight's field, the scales in
# the JAX kernel's scale ref names
_QSCALES = {"wq": "sq", "wk": "sk", "wv": "sv", "wo": "so", "w_up": "s_up",
            "w_gate": "s_gate", "w_down": "s_down"}
_PTRS = ("x", "x_out", "k_cache", "v_cache", "ln1_scale", "ln1_bias", "wq", "bq", "wk", "bk",
         "wv", "bv", "wo", "bo", "ln2_scale", "ln2_bias", "w_up", "b_up", "w_gate", "b_gate",
         "w_down", "b_down", "cos", "sin", "pos_embed", "final_scale", "final_bias",
         "lm_head", "lm_bias", "tokens", "work", "sync", "stamps", "tables", "ctx", "logits",
         *_QSCALES.values(), "k_scale", "v_scale")
_INTS = ("B", "H", "Hq", "Hkv", "D", "I", "L", "Smax", "pos", "steps", "rope_dim",
         "rmsnorm", "activation", "epilogue", "lm_vmajor", "V", "nblocks", "smem", "bs",
         "max_blocks", "num_blocks", "wfmt", "slots", "hold_block", "hold_ns", "lm_ld")
_FLOATS = ("eps", "scale", "embed_scale")


class _Params(ctypes.Structure):
    """Mirror of ``StackParams`` in ``csrc/decode_stack.cuh``, shared by K4
    and K8 (``ops/decode_paged_stack.py``)."""
    _fields_ = ([(n, ctypes.c_void_p) for n in _PTRS]
                + [(n, ctypes.c_int) for n in _INTS]
                + [(n, ctypes.c_float) for n in _FLOATS])


def _entry(name):
    """The library of ``csrc/<name>.cu``, whose C entries are
    ``mlio_<stem>_plan``, ``_maps``, ``_maps_bytes``, ``_items`` and
    ``mlio_<stem>``: K4 and K8 share the interface."""
    lib = _build.library(name)
    stem = _STEMS[name]
    run = getattr(lib, f"mlio_{stem}")
    if run.argtypes is None:
        pp, i, vp = ctypes.POINTER(_Params), ctypes.c_int, ctypes.c_void_p
        for fn, args in ((f"mlio_{stem}_plan",
                          [pp, ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(i)]),
                         (f"mlio_{stem}", [pp, vp, vp]),
                         (f"mlio_{stem}_maps", [pp, vp]),
                         (f"mlio_{stem}_maps_bytes", []),
                         (f"mlio_{stem}_items", [pp, i, ctypes.POINTER(i), i]),
                         (f"mlio_{stem}_cluster_probe", [pp, i, ctypes.POINTER(i)])):
            f = getattr(lib, fn)
            f.argtypes, f.restype = args, i
    return lib


_STEMS = {"decode_layer": "decode_stack", "decode_layer_kv8": "decode_stack",
          "paged_stack": "paged_stack"}

# A check's probe (chip_smoke.py): (block, ns) holds that block back ns
# nanoseconds before each of its waits; None in normal use.
HOLD: Optional[Tuple[int, int]] = None


def _tensor_maps(lib, name: str, prm: "_Params") -> ctypes.Array:
    """The weights' tensor maps (mlio_*_stack_maps), built once per set of
    weight tensors: keyed by the library and every field a map encodes (the
    tensors' addresses, the widths, the formats and the blocks that size the
    units)."""
    stem = _STEMS[name]
    key = (name, *(getattr(prm, f) for f in ("wq", "wk", "wv", "wo", "w_up", "w_gate", "w_down",
                                             "lm_head", "lm_ld", "H", "I", "Hq", "Hkv", "D", "L",
                                             "V", "activation", "wfmt", "nblocks", "epilogue",
                                             "lm_vmajor")))
    return _build.tensor_maps(key, getattr(lib, f"mlio_{stem}_maps_bytes")(),
                              lambda buf: getattr(lib, f"mlio_{stem}_maps")(ctypes.byref(prm), buf),
                              lib, f"{name} (tensor maps)")


def launch(name: str, prm: _Params, dev: torch.device, what: str) -> None:
    """Plan and launch the cooperative kernel of ``csrc/<name>.cu`` with the
    filled ``prm`` on the current stream of ``dev``: allocates its fp32
    workspace and its zeroed counters, builds (or reuses) the weights'
    tensor maps; raises on any CUDA error the plan, the maps or the launch
    returns."""
    lib = _entry(name)
    stem = _STEMS[name]
    if HOLD is not None:
        prm.hold_block, prm.hold_ns = HOLD
    work_floats, sync_ints = ctypes.c_longlong(), ctypes.c_int()
    with torch.cuda.device(dev):
        _build.check(lib, getattr(lib, f"mlio_{stem}_plan")(
            ctypes.byref(prm), ctypes.byref(work_floats), ctypes.byref(sync_ints)),
            f"{what} (plan)")
        maps = _tensor_maps(lib, name, prm)
        work = torch.empty(work_floats.value, dtype=torch.float32, device=dev)
        sync = torch.zeros(sync_ints.value, dtype=torch.int32, device=dev)
        prm.work, prm.sync = work.data_ptr(), sync.data_ptr()
        err = getattr(lib, f"mlio_{stem}")(ctypes.byref(prm), maps, _build.stream_handle(dev))
    _build.check(lib, err, what)


def _card_params(name: str, spec, fmt, B: int, epilogue: bool = True):
    """(the library, its stem, a ``_Params`` that ``mlio_<stem>_plan`` has
    sized) for K4 (``name`` "decode_layer") or K8 ("paged_stack") over a
    bf16 cache with weights of formats ``fmt`` (:func:`weight_bits`)."""
    lib = _entry(name)
    stem = _STEMS[name]
    prm = _Params(**base_params(spec, B, spec.hidden_size, spec.num_layers, spec.vocab_size,
                                True, None, 0, epilogue),
                  Smax=128, steps=1, wfmt=weight_bits(fmt), bs=16, max_blocks=8,
                  num_blocks=64)
    work, sync = ctypes.c_longlong(), ctypes.c_int()
    _build.check(lib, getattr(lib, f"mlio_{stem}_plan")(
        ctypes.byref(prm), ctypes.byref(work), ctypes.byref(sync)), f"{name} (plan)")
    return lib, stem, prm


def card_items(name: str, spec, fmt, B: int, phase: str, epilogue: bool = True):
    """The card's own plan of one GEMV phase of K4 (``name`` "decode_layer")
    or K8 ("paged_stack"), from ``mlio_<stem>_items`` at the blocks and ring
    the plan function sizes the launch for: ``(nblocks, shape, items)``
    with shape (KB, nk, ntiles, tc, slots) and items ``(block, tile, first
    unit, end unit)``, for holding :func:`stack_plan` against."""
    lib, stem, prm = _card_params(name, spec, fmt, B, epilogue)
    cap = 1 << 16
    buf = (ctypes.c_int * (5 + 4 * cap))()
    n = getattr(lib, f"mlio_{stem}_items")(ctypes.byref(prm), STACK_PHASES.index(phase), buf,
                                           cap)
    if n < 0:
        raise RuntimeError(f"card_items: {phase} has more than {cap} items")
    return prm.nblocks, tuple(buf[:5]), [tuple(buf[5 + 4 * i:9 + 4 * i]) for i in range(n)]


def card_waits(name: str, spec, fmt, B: int) -> dict:
    """The card's own partial waits (the kernel's segment_wait and
    attention_wait, through ``mlio_<stem>_items``) in
    :func:`program_waits`' form, at the blocks the plan function sizes the
    launch for."""
    lib, stem, prm = _card_params(name, spec, fmt, B)
    items = getattr(lib, f"mlio_{stem}_items")
    out = {}
    buf = (ctypes.c_int * (6 * spec.num_kv_heads))()
    if items(ctypes.byref(prm), 5, buf, len(buf)) != spec.num_kv_heads:
        raise RuntimeError(f"card_waits: {name} refused the attention waits")
    for hk in range(spec.num_kv_heads):
        r = buf[6 * hk:6 * hk + 6]
        out[("attn", hk)] = sorted(o + i for o, n in zip(r[0::2], r[1::2]) for i in range(n))
    cap = 6 << 16
    seg = (ctypes.c_int * cap)()
    for kind in ("out_proj", "mlp_down"):
        n = items(ctypes.byref(prm), 6 + STACK_PHASES.index(kind), seg, cap)
        if n < 0:
            raise RuntimeError(f"card_waits: {kind} has more than {cap // 6} segments")
        for i in range(n):
            b, tile, u0, u1, first, count = seg[6 * i:6 * i + 6]
            out[("seg", kind, b, tile, u0, u1)] = list(range(first, first + count))
    return out


def card_split(name: str, spec, n: list) -> dict:
    """The card's own attention split (the kernel's split_contexts, through
    ``mlio_<stem>_items``) of sequences attending over ``n[b]`` slots, at the
    launch's blocks, in :func:`attention_split`'s form."""
    lib, stem, prm = _card_params(name, spec, None, len(n))
    buf = (ctypes.c_int * (1 + 2 * len(n)))(*n)
    items = getattr(lib, f"mlio_{stem}_items")(ctypes.byref(prm), 4, buf, len(buf))
    if items < 0:
        raise RuntimeError(f"card_split: {name} refused the contexts {n}")
    B = len(n)
    return dict(C=buf[0], ns=list(buf[1:1 + B]), off=list(buf[1 + B:1 + 2 * B]), items=items,
                nb=prm.nblocks)


def cluster_probe(name: str, spec, cluster: int) -> dict:
    """Whether the card takes the launch a cluster split-K would need (the
    kernel's stack_cluster_probe at K4's or K8's block size and shared
    memory for ``spec`` at B 8): ``clusters`` of ``cluster`` blocks that
    cudaOccupancyMaxActiveClusters gives the kernel (0 where the query
    refuses the size: its error in ``launch``), the error (name) of a
    cudaLaunchKernelEx with the cooperative and cluster attributes at
    ``blocks`` = that many clusters' blocks, and the blocks that saw the
    whole grid resident (``blocks`` when it was)."""
    lib, stem, prm = _card_params(name, spec, None, MAX_BATCH)
    out = (ctypes.c_int * 4)()
    _build.check(lib, getattr(lib, f"mlio_{stem}_cluster_probe")(ctypes.byref(prm), cluster, out),
                 f"{name} (cluster probe)")
    return dict(cluster=cluster, clusters=out[0], blocks=out[3],
                launch=lib.mlio_error_string(out[1]).decode() if out[1] else "accepted",
                saw_whole_grid=out[2], sms=prm.nblocks)


def check_weights(what: str, kernel: str, blocks, spec) -> None:
    """Raise unless ``kernel`` (K4 or K8) runs ``spec`` with these weights:
    floating tensors, or int8 QTensors for the projections (W8A8 ones
    included: the kernels ignore ``act_scale`` and decode with weight-only
    int8, as the JAX megakernels do)."""
    for name, w in blocks.items():
        if isinstance(w, QTensor):
            if w.fmt != "int8" or name not in _QSCALES:
                raise ValueError(f"{what}: {kernel} takes int8 projection weights only, got "
                                 f"{w.fmt} {name!r} (int4 and fp8 take the scan decode)")
        elif w is not None and (not isinstance(w, torch.Tensor) or not w.is_floating_point()):
            raise ValueError(f"{what}: weight {name!r} must be a floating tensor or an int8 "
                             "QTensor")
    if not supports_decode_stack(spec):
        raise ValueError(f"{what}: {spec.name} is not a model {kernel} runs "
                         "(parallel residual, experts or activation)")
    if _pair_mix(blocks, spec):
        raise ValueError(f"{what}: {kernel} takes a gated MLP's w_up and w_gate in one format "
                         "(both bf16 or both int8)")


def kernel_limit(spec, B: int) -> Optional[str]:
    """The first shape limit of the megakernels' template instances (K4 and
    K8) that (spec, B) breaks, or None."""
    G, D, I = spec.num_heads // spec.num_kv_heads, spec.head_size, spec.intermediate_size
    H = spec.hidden_size
    if G not in _GROUPS or D not in _HEAD_DIMS:
        return (f"group {G} not in {_GROUPS} or head dim {D} not in {_HEAD_DIMS} (other head dims "
                "are not built: ROADMAP.md A4)")
    if not 1 <= B <= MAX_BATCH or H > MAX_HIDDEN or H % 8 or I % 8:
        return (f"batch {B} must be 1..{MAX_BATCH}, hidden {H} at most {MAX_HIDDEN}, "
                "hidden and intermediate multiples of 8")
    return None


def route_limit(spec, B: int, on_card: bool, limit=kernel_limit,
                max_batch: int = MAX_BATCH) -> Optional[str]:
    """The shape limit that a decode megakernel's route refuses on at batch
    B, or None: ``limit(spec, B)`` (a kernel's ``kernel_limit``; K4/K8's by
    default) where its CUDA instances run (``on_card``), else only its batch
    limit ``max_batch`` (the plain version on the CPU takes any head
    geometry)."""
    if on_card:
        return limit(spec, B)
    return None if 1 <= B <= max_batch else f"batch {B} must be 1..{max_batch}"


def kernel_shapes(what: str, spec, B: int, H: int) -> None:
    """Raise on the shapes the megakernels' template instances do not take."""
    limit = kernel_limit(spec, B) if H == spec.hidden_size else f"hidden {H} is not the spec's"
    if limit is not None:
        raise ValueError(f"{what}: {limit}")


def head_operand(lm_head, lm_vmajor: bool, V: int):
    """(the head the kernels read, its row stride): the head itself, except
    an untied [H, V] head whose rows are not 16-byte multiples (V % 8), which
    the TMA cannot map: then a copy [H, V rounded up to 8] made for this
    launch."""
    if lm_head is None or lm_vmajor:
        return lm_head, 0
    ld = -(-V // 8) * 8
    if ld == lm_head.shape[1]:
        return lm_head, ld
    pad = lm_head.new_zeros((lm_head.shape[0], ld))
    pad[:, :V] = lm_head
    return pad, ld


def check_head(what: str, lm_head, lm_vmajor: bool, V: int, H: int) -> None:
    if (lm_head.shape[1 if lm_vmajor else 0] != H or V > lm_head.shape[0 if lm_vmajor else 1]
            or not lm_vmajor and V != lm_head.shape[1]):
        raise ValueError(f"{what}: lm_head must be [V, H] (tied) or [H, V] with "
                         "vocab_size at most its rows (tied) or equal to its columns (untied)")


def weight_format(blocks) -> int:
    """The kernels' ``wfmt`` of the projection weights (check_weights has
    checked them): bit i set where projection i of :data:`PROJECTIONS` is
    an int8 QTensor."""
    return weight_bits({n: "int8" for n in PROJECTIONS if isinstance(blocks.get(n), QTensor)})


def stack_tensors(blocks, spec, head_norm, lm_head, lm_head_bias):
    """The kernel's tensor operands by ``_Params`` field name (w_gate and
    b_gate dropped for ungated activations): (the bf16 ones, the int8
    weights' payloads and fp32 scales)."""
    bp = dict(blocks)
    if spec.activation not in ("swiglu", "geglu"):
        bp["w_gate"] = bp["b_gate"] = None
    quant = {}
    for name, sname in _QSCALES.items():
        w = bp.get(name)
        if isinstance(w, QTensor):
            quant[name], quant[sname] = w.q, w.scale
            bp[name] = None
    fin_scale, fin_bias = head_norm if lm_head is not None else (None, None)
    return dict(final_scale=fin_scale, final_bias=fin_bias, lm_head=lm_head,
                lm_bias=lm_head_bias, **{k: v for k, v in bp.items() if v is not None}), quant


def check_operands(what: str, bf16, quant) -> None:
    """The bf16 operands bf16; the int8 weights and caches int8, their
    scales fp32; all contiguous and 16-byte aligned."""
    _build.require_bf16(what, **bf16)
    for name, t in quant.items():
        want = torch.int8 if name in _QSCALES or name.endswith("cache") else torch.float32
        if t.dtype != want:
            raise ValueError(f"{what}: {name} must be {want}, got {t.dtype}")
    _build.require_contiguous_aligned(what, **bf16, **quant)


def base_params(spec, B: int, H: int, L: int, V: int, lm_vmajor: bool, scale, rope_dim: int,
                epilogue: bool) -> dict:
    """The ``_Params`` integers and floats K4 and K8 share."""
    D = spec.head_size
    return dict(B=B, H=H, Hq=spec.num_heads, Hkv=spec.num_kv_heads, D=D,
                I=spec.intermediate_size, L=L, rope_dim=rope_dim,
                rmsnorm=int(spec.norm == "rmsnorm"),
                activation=_ACTIVATIONS.index(spec.activation), epilogue=int(epilogue),
                lm_vmajor=int(lm_vmajor), V=V, eps=spec.norm_eps,
                scale=D ** -0.5 if scale is None else scale,
                embed_scale=1.0 if spec.embed_scale is None else spec.embed_scale)


def decode_work(x, blocks, k_cache, pos, spec, steps=1, lm_head=None, kv8=False):
    """(FLOPs, bytes) of ``steps`` decode steps of every layer for the
    profiler's count (``ops/cost.py``): each step's products (every
    projection, the head's when given, the attention over the step's
    context of ``pos + s + 1`` slots a row) and bytes (every weight and the
    head read once a step, the K/V of the context's slots, one byte an
    element and an fp32 scale a row of a head for an INT8 cache, x in and
    out). An MoE model's expert stacks count their top-k share."""
    B, H, L = x.shape[0], spec.hidden_size, spec.num_layers
    share = spec.num_experts_per_tok / spec.num_experts if spec.num_experts else 1.0
    mats = wbytes = 0.0
    for name, w in blocks.items():
        if w is None:
            continue
        part = share if name.startswith("moe_") else 1.0
        q = w.q if isinstance(w, QTensor) else w
        mats += part * (q.numel() if q.ndim >= 3 else 0)
        wbytes += part * cost.tensor_bytes(w)
    head = 0 if lm_head is None else lm_head.numel()
    Hkv, D = k_cache.shape[-2:]
    kv_row = Hkv * (D * k_cache.element_size() + (4 if kv8 else 0))
    slots = B * (steps * (pos + 1) + steps * (steps - 1) // 2)  # the steps' contexts, summed
    flops = steps * 2 * B * (mats + head) + 4 * spec.num_heads * D * slots * L
    nbytes = (steps * (wbytes + cost.tensor_bytes(lm_head)) + 2 * L * slots * kv_row
              + 2 * steps * B * H * x.element_size())
    return flops, nbytes


def stack_work(x, blocks, k_cache, v_cache, pos, cos=None, sin=None, *, spec, k_scales=None,
               lm_head=None, steps=1, **_):
    return decode_work(x, blocks, k_cache, pos, spec, steps, lm_head, k_scales is not None)


@cost.counts(stack_work)
def decode_layer_stack(
    x: torch.Tensor,
    blocks,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    pos: int,
    cos: Optional[torch.Tensor] = None,
    sin: Optional[torch.Tensor] = None,
    *,
    spec,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    head_norm=None,
    lm_head: Optional[torch.Tensor] = None,
    lm_head_bias: Optional[torch.Tensor] = None,
    lm_vmajor: bool = True,
    vocab_size: Optional[int] = None,
    pos_embed: Optional[torch.Tensor] = None,
    steps: int = 1,
    phase_times: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Run every layer of ``steps`` decode steps → ``(x_out [B, H], tokens)``.

    x [B, H] is the current token's hidden state (without its position when
    ``pos_embed`` is given: the kernel adds ``pos_embed[pos]`` in fp32);
    blocks hold the stacked ``[L, in, out]`` weights; k_cache/v_cache are
    ``[L, B, Smax, Hkv, D]`` and get slot ``pos + s`` of every layer in
    place; cos/sin are ``[steps, rope_dim]`` tables for RoPE models.

    With ``head_norm`` = (final_scale, final_bias) and ``lm_head`` (a tied,
    vocab-major ``[V, H]`` table, or ``[H, V]`` with ``lm_vmajor=False``)
    the greedy epilogue returns the next token ids: ``[B]`` int32, or
    ``[steps, B]`` when ``steps > 1``, which needs the tied head (step s+1
    starts from the embedding row of step s's token, times
    ``spec.embed_scale``, plus its position). Without it tokens is None.

    ``phase_times``, a CUDA int64 tensor of at least
    :func:`phase_stamps` elements, receives block 0's global timer (ns) at
    the kernel's start and after each of its waits (the inputs of the next
    phase ready): successive differences are the phases' durations (a
    port-only probe; the CPU ignores it).

    ``k_scales``/``v_scales`` (fp32 [L, B, Smax, Hkv]) make the caches an
    INT8 cache (int8 k_cache/v_cache): slot ``pos + s`` gets the current
    token quantized per head, its scales beside it. int8 QTensor weights
    take K4's int8 weight path.
    """
    check_weights("decode_layer_stack", "K4", blocks, spec)
    B, H = x.shape
    if k_cache.ndim != 5 or k_cache.shape[1] != B or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode_layer_stack: caches must be [L, {B}, Smax, Hkv, D] alike, "
                         f"got {tuple(k_cache.shape)} and {tuple(v_cache.shape)}")
    L, _, Smax, Hkv, D = k_cache.shape
    if (L, Hkv, D) != (spec.num_layers, spec.num_kv_heads, spec.head_size) \
            or H != spec.hidden_size:
        raise ValueError("decode_layer_stack: x and the caches do not match the spec")
    quant = _build.check_kv_scales("decode_layer_stack", k_cache, v_cache, k_scales, v_scales)
    if steps < 1 or pos < 0 or pos + steps > Smax:
        raise ValueError(f"decode_layer_stack: slots {pos}..{pos + steps - 1} outside the "
                         f"{Smax}-slot cache")
    if pos_embed is not None and pos + steps > pos_embed.shape[0]:
        raise ValueError(f"decode_layer_stack: position {pos + steps - 1} past pos_embed's "
                         f"{pos_embed.shape[0]} rows")
    epilogue = lm_head is not None
    if epilogue and head_norm is None:
        raise ValueError("decode_layer_stack: the epilogue needs head_norm")
    if steps > 1 and not (epilogue and lm_vmajor):
        raise ValueError("decode_layer_stack: steps > 1 needs the greedy epilogue with a "
                         "tied vocab-major lm_head")
    if (cos is None) != (spec.positional == "learned"):
        raise ValueError("decode_layer_stack: cos/sin are given for RoPE models, and only them")
    if cos is not None and (cos.ndim != 2 or cos.shape[0] != steps or sin.shape != cos.shape):
        raise ValueError(f"decode_layer_stack: cos/sin must be [{steps}, rope_dim]")
    V = (vocab_size or (lm_head.shape[0] if lm_vmajor else lm_head.shape[1])) if epilogue else 0
    kw = dict(spec=spec, scale=scale, head_norm=head_norm, lm_head=lm_head,
              lm_head_bias=lm_head_bias, lm_vmajor=lm_vmajor, vocab_size=vocab_size,
              pos_embed=pos_embed, steps=steps)
    _build.refuse_grad("decode_layer_stack (K4)", x, blocks, k_cache, v_cache, k_scales,
                       v_scales, cos, sin, head_norm, lm_head, lm_head_bias, pos_embed)
    if x.device.type == "cpu":
        return decode_layer_stack_plain(x, blocks, k_cache, v_cache, pos, cos, sin,
                                        k_scales=k_scales, v_scales=v_scales, **kw)

    tensors, qt = stack_tensors(blocks, spec, head_norm, lm_head, lm_head_bias)
    tensors.update(x=x, pos_embed=pos_embed)
    caches = dict(k_cache=k_cache, v_cache=v_cache)
    if quant:
        qt.update(caches, k_scale=k_scales, v_scale=v_scales)
    else:
        tensors.update(caches)
    dev = _build.require_cuda("decode_layer_stack",
                              *[t for t in (*tensors.values(), *qt.values()) if t is not None])
    kernel_shapes("decode_layer_stack", spec, B, H)
    if epilogue:
        check_head("decode_layer_stack", lm_head, lm_vmajor, V, H)
    check_operands("decode_layer_stack", tensors, qt)
    lm_ld = 0
    if epilogue:
        tensors["lm_head"], lm_ld = head_operand(lm_head, lm_vmajor, V)
    if cos is not None:
        # the tables are rounded to the compute dtype first, as _rope_consts does
        cos = cos.to(dev, x.dtype).float().contiguous()
        sin = sin.to(dev, x.dtype).float().contiguous()
    x_out = torch.empty_like(x)
    tokens = torch.empty((steps, B), dtype=torch.int32, device=dev) if epilogue else None
    if phase_times is not None and (phase_times.dtype != torch.int64
                                    or phase_times.device != dev
                                    or phase_times.numel() < phase_stamps(spec, steps, epilogue)):
        raise ValueError("decode_layer_stack: phase_times must be int64 on the card, "
                         f"with {phase_stamps(spec, steps, epilogue)} elements")
    prm = _Params(
        **{n: _build.ptr(t) for n, t in (*tensors.items(), *qt.items())},
        stamps=_build.ptr(phase_times), x_out=x_out.data_ptr(), cos=_build.ptr(cos),
        sin=_build.ptr(sin), tokens=_build.ptr(tokens),
        Smax=Smax, pos=pos, steps=steps, wfmt=weight_format(blocks),
        lm_ld=lm_ld,
        **base_params(spec, B, H, L, V, lm_vmajor, scale,
                      0 if cos is None else cos.shape[1], epilogue))
    launch("decode_layer_kv8" if quant else "decode_layer", prm, dev, "decode_layer_stack")
    decode_layer_stack.launches += 1
    if tokens is not None and steps == 1:
        tokens = tokens[0]
    return x_out, tokens


decode_layer_stack.launches = 0
