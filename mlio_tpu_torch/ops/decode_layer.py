"""The decode megakernel (K4): every layer of a decode step in one launch.

Replaces ``mlio_tpu/ops/decode_layer.py::_decode_stack_kernel`` and its body
``_decode_layer_body`` (entry ``decode_layer_stack``). The kernel is CUDA
C++ in ``mlio_tpu_torch/csrc/decode_layer.cu``: one persistent cooperative
launch per call that runs, for every step and every layer, norm → QKV →
RoPE → cache write → attention → out-projection → norm → MLP, then
optionally the greedy epilogue (final norm, lm_head, first-index argmax)
and, with ``steps > 1``, the next step's embedding and position. Phases
are separated by grid-wide barriers; the residual stays in fp32 across
layers. Its source note gives the H100 bound and the design.

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

from mlio_tpu_torch.ops import _build
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
    int8 weights in the per-projection layout, not int4 or fp8; an INT8
    cache needs a 128-aligned length there) and, given the batch ``B``, the
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
        w = blocks.get("wq")
        if isinstance(w, QTensor):
            if w.fmt != "int8":
                return False
        elif not isinstance(w, torch.Tensor) or not w.is_floating_point():
            return False
    return B is None or route_limit(spec, B, on_card) is None


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
    """Timer stamps one launch writes: the start, the first step's input,
    five phases a layer, and per step the logits and, before a next step,
    the token."""
    return 2 + steps * 5 * spec.num_layers + (2 * steps - 1 if epilogue else 0)


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
         "max_blocks", "num_blocks")
_FLOATS = ("eps", "scale", "embed_scale")


class _Params(ctypes.Structure):
    """Mirror of ``StackParams`` in ``csrc/decode_stack.cuh``, shared by K4
    and K8 (``ops/decode_paged_stack.py``)."""
    _fields_ = ([(n, ctypes.c_void_p) for n in _PTRS]
                + [(n, ctypes.c_int) for n in _INTS]
                + [(n, ctypes.c_float) for n in _FLOATS])


def _entry(name):
    """(library, plan, run) of ``csrc/<name>.cu``, whose C entries are
    ``mlio_<stem>_plan`` and ``mlio_<stem>``: K4 and K8 share the interface."""
    lib = _build.library(name)
    stem = {"decode_layer": "decode_stack", "paged_stack": "paged_stack"}[name]
    plan, run = getattr(lib, f"mlio_{stem}_plan"), getattr(lib, f"mlio_{stem}")
    if plan.argtypes is None:
        pp = ctypes.POINTER(_Params)
        plan.argtypes = [pp, ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int)]
        plan.restype = ctypes.c_int
        run.argtypes = [pp, ctypes.c_void_p]
        run.restype = ctypes.c_int
    return lib, plan, run


def launch(name: str, prm: _Params, dev: torch.device, what: str) -> None:
    """Plan and launch the cooperative kernel of ``csrc/<name>.cu`` with the
    filled ``prm`` on the current stream of ``dev``: allocates its fp32
    workspace and its zeroed barrier and tile counters; raises on any CUDA
    error the plan or the launch returns."""
    lib, plan, run = _entry(name)
    work_floats, sync_ints = ctypes.c_longlong(), ctypes.c_int()
    with torch.cuda.device(dev):
        _build.check(lib, plan(ctypes.byref(prm), ctypes.byref(work_floats),
                               ctypes.byref(sync_ints)), f"{what} (plan)")
        work = torch.empty(work_floats.value, dtype=torch.float32, device=dev)
        sync = torch.zeros(sync_ints.value, dtype=torch.int32, device=dev)
        prm.work, prm.sync = work.data_ptr(), sync.data_ptr()
        err = run(ctypes.byref(prm), _build.stream_handle(dev))
    _build.check(lib, err, what)


def check_weights(what: str, kernel: str, blocks, spec) -> None:
    """Raise unless ``kernel`` (K4 or K8) runs ``spec`` with these weights:
    floating tensors, or int8 QTensors for the projections."""
    for name, w in blocks.items():
        if isinstance(w, QTensor):
            if w.fmt != "int8" or name not in _QSCALES:
                raise ValueError(f"{what}: {kernel} takes int8 projection weights only, got "
                                 f"{w.fmt} {name!r} (int4 and fp8 take the scan decode)")
            if w.act_scale is not None:
                raise NotImplementedError(f"{what}: W8A8 weights (act_scale) are not ported yet")
        elif w is not None and (not isinstance(w, torch.Tensor) or not w.is_floating_point()):
            raise ValueError(f"{what}: weight {name!r} must be a floating tensor or an int8 "
                             "QTensor")
    if not supports_decode_stack(spec):
        raise ValueError(f"{what}: {spec.name} is not a model {kernel} runs "
                         "(parallel residual, experts or activation)")


def kernel_limit(spec, B: int) -> Optional[str]:
    """The first shape limit of the megakernels' template instances (K4 and
    K8) that (spec, B) breaks, or None."""
    G, D, I = spec.num_heads // spec.num_kv_heads, spec.head_size, spec.intermediate_size
    H = spec.hidden_size
    if G not in _GROUPS or D not in _HEAD_DIMS:
        return f"group {G} not in {_GROUPS} or head dim {D} not in {_HEAD_DIMS}"
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


def check_head(what: str, lm_head, lm_vmajor: bool, V: int, H: int) -> None:
    if (lm_head.shape[1 if lm_vmajor else 0] != H or V > lm_head.shape[0 if lm_vmajor else 1]
            or not lm_vmajor and V != lm_head.shape[1]):
        raise ValueError(f"{what}: lm_head must be [V, H] (tied) or [H, V] with "
                         "vocab_size at most its rows (tied) or equal to its columns (untied)")


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
    :func:`phase_stamps` elements, receives the kernel's global timer (ns)
    at its start and after each grid barrier: successive differences are
    the phases' durations (a port-only probe; the CPU ignores it).

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
        Smax=Smax, pos=pos, steps=steps,
        **base_params(spec, B, H, L, V, lm_vmajor, scale,
                      0 if cos is None else cos.shape[1], epilogue))
    launch("decode_layer", prm, dev, "decode_layer_stack")
    decode_layer_stack.launches += 1
    if tokens is not None and steps == 1:
        tokens = tokens[0]
    return x_out, tokens


decode_layer_stack.launches = 0
