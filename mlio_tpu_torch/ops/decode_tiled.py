"""The tiled decode megakernel (K6): one decode step of every layer of a
large dense or sparse-MoE model in one launch, no head epilogue.

Replaces ``mlio_tpu/ops/decode_tiled.py::_tiled_kernel`` (entry
``decode_layer_tiled``). The kernel is CUDA C++ in
``mlio_tpu_torch/csrc/decode_tiled.cuh``, built once per weight format
(``decode_tiled_{bf16,int8,fp8}.cu``), and once more for head dim 256 with
bf16 weights and cache and at most 4 query heads a KV head (Gemma,
``decode_tiled_d256.cu``): one persistent cooperative launch a
step whose phases, a layer at a time, are the QKV projections, attention by
(sequence, head group, context split) with the cache write, the
out-projection into the fp32 residual, up (and gate) with the activation,
and down into the residual. The four GEMV phases load their weight tiles by
TMA into a shared-memory ring and multiply on the tensor cores; their units
(tile, k rows) are cut into one equal run a block (:func:`item_plan`
mirrors the card's plan), and the partials are summed in a fixed order.
Its source note gives the H100 bound and the design.

Sparse-MoE models (Mixtral) run the JAX kernel's MoE phases: at the fold
each block routes every row itself from the normed rows (an fp32 softmax
over the E experts of ``hn @ router[l]``, the top-k by repeated max with the
lowest index first, renormalized), then streams only the experts some row
picks, each expert's down product scaled by its per-channel scales and the
rows' routing weights. An expert no row picks would add exactly 0, so it is
never read.

The final norm and the lm_head run after it, in ``models.transformer``, as
the JAX package runs them after its kernel.

On CPU tensors :func:`decode_layer_tiled` runs
:func:`decode_layer_tiled_plain`; on CUDA tensors it launches the kernel or
raises. The cache is the port's ``[L, B, Smax, Hkv, D]`` and is written in
place; an INT8 cache keeps its scales in the scan layout ``[L, B, Smax,
Hkv]``, so the JAX package's ``pad_scales_for_tiled`` has no counterpart.
:class:`Tiling` is the JAX package's view (head groups and intermediate
chunks), which the plain version walks; the kernel takes its head groups
and plans its GEMVs itself. The port has no autotune table.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from mlio_tpu_torch.ops import _build, cost
from mlio_tpu_torch.ops.decode_layer import (_ACTIVATIONS, _attend_plain, _norm32, _rope,
                                             decode_work, route_limit)
from mlio_tpu_torch.ops.moe import topk_mask
from mlio_tpu_torch.ops.quant import QTensor, dequantize_kv, quantize_kv
from mlio_tpu_torch.ops.reference import activate

# The CUDA instances' limits.
MAX_BATCH = 32     # rows of the widest GEMV tier (four n-tiles of 8 batch rows)
MAX_HIDDEN = 8192
MAX_GROUP = 8      # query heads a KV head: the attention item's register arrays
MAX_EXPERTS = 16   # the router's register array (the kernel's kMaxE)
_HEAD_DIMS = (64, 128)
# Gemma's head dim: its own source, one instance (bf16 weights and cache, G <= 4)
D256, D256_MAX_GROUP = 256, 4
_WIDTH_ALIGN = 16  # hidden and intermediate widths: 16-byte int8 weight rows (TMA strides)
# Hopper's budgets that the tiling is chosen from (hopper-kernels guide §1).
SMS = 132
L2_BYTES = 50 << 20
MAX_CHUNK = 256    # intermediate columns a chunk of the plain version's tiling, at most
_THREADS = 256
_ACT_BYTES = 32 << 10  # the chunk's [ic, batch rows] fp32 activations (the tiling's rule)
# The kernel's GEMV plan (csrc/decode_tiled.cuh, mirrored by item_plan).
TILE_BYTES = 256   # a matrix's bytes in a tile row: two 128-byte TMA boxes
SLOT_BYTES = 32768  # a unit's weights: 128 rows of one matrix, 64 of up and gate
GEMV_PHASES = ("qkv", "out_proj", "mlp_up", "mlp_down")


class Tiling(NamedTuple):
    """``ka`` head groups of ``hg`` query heads (attention items) and ``km``
    intermediate chunks of ``ic`` columns (the plain version's MLP chunks;
    the kernel plans its GEMVs itself, :func:`item_plan`). The JAX package's
    ``ws`` (VMEM weight-pool slots) has no counterpart."""

    hg: int
    ic: int
    ka: int
    km: int


def _tier(B: int):
    """(batch rows, columns a thread) of the tier that sizes the plain
    version's intermediate chunks for B (:func:`choose_tiling`'s rule)."""
    return (8, 8) if B <= 8 else (16, 4) if B <= 16 else (32, 2)


def choose_tiling(spec, B: int) -> Optional[Tiling]:
    """Hopper's tiling for a batch of B (None for a model K6 does not run).

    - ``ka``: the fewest head groups (a divisor of the KV heads) whose
      ``B * ka`` attention items fill the SMs, else one KV head a group;
      context splits fill the rest.
    - ``ic``: the plain version's intermediate chunk: as many chunks as SMs
      while ``km * B * H`` fp32 partials stay within half of L2; a multiple
      of 16, at most 256 (:data:`MAX_CHUNK`), ``256 * columns a thread``
      (up and gate side by side) and what ``_ACT_BYTES`` holds. The kernel
      does not take it: its GEMV units are :func:`item_plan`'s.

    Unlike the TPU's, the tiling does not depend on the weights' or the
    cache's itemsize."""
    if spec.num_heads % spec.num_kv_heads:
        return None
    Hkv, H, I = spec.num_kv_heads, spec.hidden_size, spec.intermediate_size
    ka = next((k for k in range(1, Hkv + 1) if Hkv % k == 0 and B * k >= SMS), Hkv)
    mb, cpt = _tier(B)
    gated = spec.activation in ("swiglu", "geglu")
    km = max(1, min(SMS, (L2_BYTES // 2) // (B * H * 4)))
    ic = -(-I // km)
    ic = -(-ic // _WIDTH_ALIGN) * _WIDTH_ALIGN
    ic = min(ic, MAX_CHUNK, _THREADS * cpt // (2 if gated else 1), _ACT_BYTES // (4 * mb))
    return Tiling(hg=spec.num_heads // ka, ic=ic, ka=ka, km=-(-I // ic))


def _valid(spec, t: Tiling) -> bool:
    """The JAX package's checks of a given tiling, with Hopper's alignment
    (16 columns) for the TPU's 128 lanes."""
    Hq, Hkv, I = spec.num_heads, spec.num_kv_heads, spec.intermediate_size
    return (t.ka >= 1 and Hq % t.ka == 0 and Hkv % t.ka == 0 and t.hg == Hq // t.ka
            and t.ic >= 1 and t.km == -(-I // t.ic))


def resolve_tiling(spec, B: int, tiling: Optional[Tiling] = None) -> Optional[Tiling]:
    """:func:`choose_tiling`, or the given ``tiling`` validated as the JAX
    package validates an autotuned one (heads divisible by ``ka``, ``km``
    chunks of ``ic`` covering the intermediate width). The port has no
    autotune table."""
    if tiling is None:
        return choose_tiling(spec, B)
    if not _valid(spec, tiling):
        raise ValueError(f"resolve_tiling: {tiling} does not tile {spec.name}")
    return tiling


def _mlp_names(spec):
    """The MLP's weight names: the expert stacks of an MoE model, else the
    dense ones."""
    return ("moe_up", "moe_gate", "moe_down") if spec.num_experts else ("w_up", "w_gate", "w_down")


def _weight_itemsize(blocks) -> Optional[int]:
    """Bytes a weight element streams (None: a layout K6 does not take)."""
    if blocks is None:
        return 2
    if "wq" not in blocks:  # the fused-projection layout
        return None
    w = blocks["wq"]
    if isinstance(w, QTensor):
        return 1 if w.fmt in ("int8", "fp8") else None
    return w.element_size()


def kernel_limit(spec, B: int, cache_quant: bool = False,
                 weight_itemsize: int = 2) -> Optional[str]:
    """The first limit of the CUDA instances that (spec, B) breaks, or None;
    with the cache's quantization and the weights' bytes an element, which
    the head-dim-256 instance limits."""
    G, D = spec.num_heads // spec.num_kv_heads, spec.head_size
    H, I = spec.hidden_size, spec.intermediate_size
    if not 1 <= B <= MAX_BATCH:
        return f"batch {B} must be 1..{MAX_BATCH}"
    if not 1 <= G <= MAX_GROUP or spec.num_heads % spec.num_kv_heads:
        return f"query heads per KV head {G} must be 1..{MAX_GROUP}"
    if D == D256:
        if G > D256_MAX_GROUP or cache_quant or weight_itemsize != 2:
            return (f"head dim {D} runs with at most {D256_MAX_GROUP} query heads a KV head, "
                    "bf16 weights and a bf16 cache (other instances are not built: ROADMAP.md "
                    "A4)")
    elif D not in _HEAD_DIMS:
        return f"head dim {D} not in {_HEAD_DIMS + (D256,)} (ROADMAP.md A4)"
    if H > MAX_HIDDEN or H % _WIDTH_ALIGN or I % _WIDTH_ALIGN:
        return (f"hidden {H} at most {MAX_HIDDEN}, hidden and intermediate "
                f"multiples of {_WIDTH_ALIGN}")
    if spec.num_experts > MAX_EXPERTS:
        return f"{spec.num_experts} experts, at most {MAX_EXPERTS}"
    return None


def tiled_route_limit(spec, B: int, on_card: bool, cache_quant: bool = False,
                      blocks=None) -> Optional[str]:
    """``decode_layer.route_limit`` with K6's :func:`kernel_limit` for this
    cache and these weights: the limit the tiled route refuses on, or None."""
    isz = _weight_itemsize(blocks) or 2
    return route_limit(spec, B, on_card, lambda s, b: kernel_limit(s, b, cache_quant, isz),
                       MAX_BATCH)


def supports_decode_tiled(spec, B: int = 8, cache_quant: bool = False, blocks=None,
                          smax: Optional[int] = None, on_card: bool = True) -> bool:
    """Whether K6 runs this model, layout and batch: the JAX package's
    feature conditions (sequential residual, a supported activation, floating,
    int8 or fp8 weights in the per-projection layout, an INT8 cache 128-aligned
    long; for an MoE model a router and the up and down expert stacks, stored
    as the attention weights are) and B <= 32. The TPU's VMEM and lane
    clauses are not kept; with ``on_card`` the CUDA instances' head, width and
    expert limits (:func:`kernel_limit`) are, while the plain version on the
    CPU takes any head geometry."""
    if spec.parallel_residual:
        return False
    if cache_quant and smax is not None and smax % 128:
        return False
    if spec.activation not in _ACTIVATIONS or _weight_itemsize(blocks) is None:
        return False
    if spec.num_experts:
        if blocks is None or any(blocks.get(n) is None for n in ("router", "moe_up", "moe_down")):
            return False
        mu, wq = blocks["moe_up"], blocks["wq"]
        if isinstance(mu, QTensor) != isinstance(wq, QTensor):
            return False
        if isinstance(mu, QTensor) and mu.fmt != wq.fmt:
            return False
    if tiled_route_limit(spec, B, on_card, cache_quant, blocks) is not None:
        return False
    return choose_tiling(spec, B) is not None


# The K4-or-K6 rule of "auto" (models.transformer.decode_route): K4, with its
# fused greedy epilogue and multi-step launch, where one layer's weights take
# at most this many bytes; K6 and the head after it above. A whole greedy
# decode step at B 8, context 705-1023, K4 with its epilogue against K6 plus
# the head (chip_smoke.py's generate, generate_tiled, rule and generate_8b
# phases; NVIDIA H100 80GB HBM3, 700.00 W), in ms:
#   GPT-2 small, 13.5 MiB a layer (bf16)         0.986 against  1.590
#   gpt2-xl, 58.6 MiB (bf16) / 29.3 MiB (int8)   8.70 / 8.55 against 10.04 / 10.39
#   opt-1.3b, 96 MiB (bf16) / 48 MiB (int8)      4.87 / 4.73 against  5.59 /  5.64
#   llama3-8b, 208 MiB (int8, INT8 cache)       24.34 against 13.17
#   llama3-8b, 416 MiB (bf16)                   24.57 against 13.97
# The crossover lies between 96 and 208 MiB a layer; no preset that both
# kernels run falls between them, so the threshold sits at 128 MiB.
MEGA_MAX_LAYER_BYTES = 128 << 20


def layer_weight_bytes(spec, weight_itemsize: int) -> int:
    """Bytes of one layer's projection weights at ``weight_itemsize``: all
    E experts' MLPs and the bf16 router of an MoE model."""
    H, I, E = spec.hidden_size, spec.intermediate_size, spec.num_experts
    n_up = 2 if spec.activation in ("swiglu", "geglu") else 1
    return (weight_itemsize * (H * (spec.q_dim + 2 * spec.kv_dim) + spec.q_dim * H
                               + max(E, 1) * (n_up + 1) * H * I) + 2 * H * E)


def prefer_mega(spec, weight_itemsize: int) -> bool:
    """The K4-or-K6 rule: K4 for models whose layer weights stay within
    :data:`MEGA_MAX_LAYER_BYTES` (the batch enters through K4's own limit)."""
    return layer_weight_bytes(spec, weight_itemsize) <= MEGA_MAX_LAYER_BYTES


# ---------------------------------------------------------------------------
# The kernel's GEMV plan (mirror of csrc/decode_tiled.cuh's make_job,
# unit_begin, unit_owner and finish_group's order)
# ---------------------------------------------------------------------------

def _job(phase: str, H: int, Qd: int, KVd: int, I: int, isz: int, gated: bool,
         npicked: int) -> dict:
    """One GEMV phase's shape: ``ntiles`` tiles of ``tc`` columns of each of
    its ``nm`` matrices (up and gate side by side), ``nk`` units of ``kb``
    weight rows each over its ``K`` rows, ``ct`` column tiles a matrix (an
    expert's)."""
    tc = TILE_BYTES // isz
    nm = 2 if phase == "mlp_up" and gated else 1
    kb = SLOT_BYTES // (nm * TILE_BYTES)
    tiles = lambda n: -(-n // tc)  # noqa: E731
    if phase == "qkv":
        ct, K = tiles(Qd), H
        ntiles = ct + 2 * tiles(KVd)
    elif phase == "out_proj":
        ct = ntiles = tiles(H)
        K = Qd
    elif phase == "mlp_up":
        ct, K = tiles(I), H
        ntiles = npicked * ct
    else:
        ct, K = tiles(H), I
        ntiles = npicked * ct
    return dict(ntiles=ntiles, nk=-(-K // kb), kb=kb, K=K, tc=tc, ct=ct, nm=nm)


def unit_begin(U: int, nb: int, b: int) -> int:
    """The first of block b's units: blocks take equal runs of the U units."""
    return U * b // nb


def unit_owner(U: int, nb: int, u: int) -> int:
    """The block whose run holds unit u."""
    return -(-((u + 1) * nb) // U) - 1


def item_plan(spec, fmt: Optional[str] = None, nb: int = SMS,
              experts: Optional[list] = None) -> dict:
    """K6's GEMV plan at ``nb`` blocks, as the card walks it: for each of
    :data:`GEMV_PHASES`, the phase's shape (:func:`_job`), its ``tiles``
    (``matrix``, ``expert``, first column ``col0``, ``width`` in columns,
    the matrix's row stride ``stride`` in bytes), its ``items`` (segments:
    ``(block, tile, first unit, end unit)``, unit u of tile u // nk at k rows
    (u % nk) * kb) and, for each sum group (a tile; mlp_down: a column tile
    over the experts), ``order``: the partial slots (block + tile) in the
    order the last segment to arrive adds them, whatever the order of
    arrival. ``experts``: the experts some row picks at this layer, in
    order (an MoE model; None: all of them); a dense MLP is expert 0."""
    isz = 2 if fmt is None else 1
    H, I = spec.hidden_size, spec.intermediate_size
    Qd, KVd = spec.num_heads * spec.head_size, spec.num_kv_heads * spec.head_size
    gated = spec.activation in ("swiglu", "geglu")
    if spec.num_experts:
        picks = list(range(spec.num_experts)) if experts is None else sorted(experts)
    else:
        picks = [0]
    out = {}
    for phase in GEMV_PHASES:
        j = _job(phase, H, Qd, KVd, I, isz, gated, len(picks) if phase.startswith("mlp") else 1)
        tiles = []
        for i in range(j["ntiles"]):
            if phase == "qkv":
                tq, tk = -(-Qd // j["tc"]), -(-KVd // j["tc"])
                m = 0 if i < tq else 1 if i < tq + tk else 2
                tt = i - (0, tq, tq + tk)[m]
                tiles.append(dict(matrix=("wq", "wk", "wv")[m], expert=None, col0=tt * j["tc"],
                                  N=Qd if m == 0 else KVd))
            elif phase == "out_proj":
                tiles.append(dict(matrix="wo", expert=None, col0=i * j["tc"], N=H))
            else:
                up = phase == "mlp_up"
                tiles.append(dict(matrix=("w_up+w_gate" if j["nm"] == 2 else "w_up") if up
                                  else "w_down", expert=picks[i // j["ct"]],
                                  col0=(i % j["ct"]) * j["tc"], N=I if up else H))
        for t in tiles:
            t["width"] = min(j["tc"], t.pop("N") - t["col0"])
            t["stride"] = (Qd if t["matrix"] == "wq" else KVd if t["matrix"] in ("wk", "wv")
                           else I if t["matrix"].startswith("w_up") else H) * isz
        U = j["ntiles"] * j["nk"]
        items = []
        for b in range(nb):
            u, end = unit_begin(U, nb, b), unit_begin(U, nb, b + 1)
            while u < end:
                stop = min((u // j["nk"] + 1) * j["nk"], end)
                items.append((b, u // j["nk"], u, stop))
                u = stop

        def slots(i):  # the blocks between the tile's first and last that stream units
            first = unit_owner(U, nb, i * j["nk"])
            last = unit_owner(U, nb, (i + 1) * j["nk"] - 1)
            return [b + i for b in range(first, last + 1)
                    if unit_begin(U, nb, b) < unit_begin(U, nb, b + 1)]

        if phase == "mlp_down":
            order = [[s for r in range(len(picks)) for s in slots(r * j["ct"] + h)]
                     for h in range(j["ct"])]
        else:
            order = [slots(i) for i in range(j["ntiles"])]
        out[phase] = dict(j, tiles=tiles, items=items, order=order)
    return out


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def _mm(h, w, rows, cols, layer):
    """h @ w[layer][rows, cols] in fp32, an int8/fp8 weight's per-output
    scale applied to the product (the JAX kernel's ``_mmvv``); ``layer`` is
    an index or a (layer, expert) pair."""
    if isinstance(w, QTensor):
        return (h.float() @ w.q[layer][rows, cols].float()) * w.scale[layer][cols].float()
    return h.float() @ w[layer][rows, cols].float()


def _bias(blocks, name, layer, cols):
    b = blocks.get(name)
    return 0.0 if b is None else b[layer][cols].float()


def decode_layer_tiled_plain(
    x: torch.Tensor,
    blocks,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    pos: int,
    cos: Optional[torch.Tensor] = None,
    sin: Optional[torch.Tensor] = None,
    *,
    spec,
    tiling: Optional[Tiling] = None,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    router_probs: Optional[torch.Tensor] = None,
    experts: Optional[torch.Tensor] = None,
    every_expert: bool = False,
) -> torch.Tensor:
    """``_tiled_kernel``'s function in plain PyTorch, phase by phase as the
    JAX kernel runs it, with the decode megakernels' rounding points (the
    norm outputs, ``q * scale``, the attention and the activation rounded to
    x's dtype; the residual fp32 across layers; the probabilities fp32, as
    :func:`~mlio_tpu_torch.ops.decode_layer._attend_plain` says why).

    For each layer: norm1; per head group of ``tiling``, the group's q/k/v
    (+ bias, RoPE), its slot ``pos`` written (rounded to the cache's dtype,
    or quantized per head with its scales beside it), attention over slots
    ``0..pos`` of the group's KV heads (an INT8 cache dequantized), and the
    group's out-projection partial added to an fp32 accumulator; the fold
    (residual + accumulator + out bias) and norm2; per intermediate chunk of
    ``ic`` columns (the last masked at the intermediate width), up (and gate)
    + activation and the chunk's partial down-projection; the final fold.
    int8 and fp8 weights are dequantized per output channel on the product.
    The result does not depend on the tiling beyond fp32 rounding.

    An MoE model's MLP is the JAX kernel's: the router's fp32 logits
    ``h2 @ router[l]``, their softmax (``exp(l - max) / sum``), the top-k by
    repeated max with the lowest index first and the kept weights
    renormalized into ``comb [B, E]`` (0 for the rest); then for each expert
    in order and each chunk, the chunk's down product times the expert's
    scales and ``comb[:, e]``. ``router_probs`` (fp32 [L, B, E]) receives
    each layer's softmax; ``experts`` ([L, B, E] bool, top_k per row) makes
    the rows take those experts instead of their own top-k, the weights
    still renormalized from this run's softmax: a run can follow the
    kernel's routing where two experts' probabilities are nearly tied. An
    expert no row picks at a layer is skipped, as the kernel skips it (it
    would add comb 0 x a finite product); ``every_expert`` adds every
    expert's product, as the TPU kernel streams them: the same bits.

    Writes slot ``pos`` of every layer in place; returns x_out [B, H].
    ``tiling`` defaults to :func:`choose_tiling`'s."""
    cd = x.dtype
    B = x.shape[0]
    if tiling is None:
        tiling = choose_tiling(spec, B)
    L, _, _, Hkv, D = k_cache.shape
    Hq, I = spec.num_heads, spec.intermediate_size
    G, ka, ic = Hq // Hkv, tiling.ka, tiling.ic
    hkvg = Hkv // ka
    if scale is None:
        scale = D ** -0.5
    gated = spec.activation in ("swiglu", "geglu")
    E = spec.num_experts
    bp = blocks
    if cos is not None:  # the tables are rounded to the compute dtype first
        cos, sin = cos.to(cd).float()[0], sin.to(cd).float()[0]
    x32 = x.float()
    everything = slice(None)
    for layer in range(L):
        h = _norm32(x32, bp["ln1_scale"][layer], None if bp.get("ln1_bias") is None
                    else bp["ln1_bias"][layer], spec.norm, spec.norm_eps).to(cd)
        acc = torch.zeros_like(x32)
        for g in range(ka):
            qc = slice(g * hkvg * G * D, (g + 1) * hkvg * G * D)
            kc = slice(g * hkvg * D, (g + 1) * hkvg * D)
            heads = slice(g * hkvg, (g + 1) * hkvg)
            q = _mm(h, bp["wq"], everything, qc, layer) + _bias(bp, "bq", layer, qc)
            k = _mm(h, bp["wk"], everything, kc, layer) + _bias(bp, "bk", layer, kc)
            v = _mm(h, bp["wv"], everything, kc, layer) + _bias(bp, "bv", layer, kc)
            if cos is not None:
                q, k = _rope(q, cos, sin, D), _rope(k, cos, sin, D)
            k, v = k.reshape(B, hkvg, D), v.reshape(B, hkvg, D)
            if k_scales is None:
                k_cache[layer, :, pos, heads] = k.to(k_cache.dtype)
                v_cache[layer, :, pos, heads] = v.to(v_cache.dtype)
                keys = k_cache[layer, :, :pos + 1, heads]
                vals = v_cache[layer, :, :pos + 1, heads]
            else:
                k_cache[layer, :, pos, heads], k_scales[layer, :, pos, heads] = quantize_kv(k)
                v_cache[layer, :, pos, heads], v_scales[layer, :, pos, heads] = quantize_kv(v)
                keys = dequantize_kv(k_cache[layer, :, :pos + 1, heads],
                                     k_scales[layer, :, :pos + 1, heads])
                vals = dequantize_kv(v_cache[layer, :, :pos + 1, heads],
                                     v_scales[layer, :, :pos + 1, heads])
            qs = (q * scale).to(cd).float().reshape(B, hkvg, G, D)
            attn = _attend_plain(qs, keys, vals).reshape(B, hkvg * G * D).to(cd)
            acc = acc + _mm(attn, bp["wo"], qc, everything, layer)
        x32 = x32 + acc + _bias(bp, "bo", layer, everything)
        h2 = _norm32(x32, bp["ln2_scale"][layer], None if bp.get("ln2_bias") is None
                     else bp["ln2_bias"][layer], spec.norm, spec.norm_eps).to(cd)
        acc = torch.zeros_like(x32)
        if E:
            logits = h2.float() @ bp["router"][layer].float()
            pp = torch.exp(logits - logits.amax(-1, keepdim=True))
            pp = pp / pp.sum(-1, keepdim=True)
            if router_probs is not None:
                router_probs[layer] = pp
            picks = (experts[layer] if experts is not None
                     else topk_mask(pp, spec.num_experts_per_tok))
            comb = torch.where(picks, pp, torch.zeros_like(pp))
            comb = comb / comb.sum(-1, keepdim=True)
        up, gate, down = (bp[n] if n in bp else None for n in _mlp_names(spec))
        for e in range(max(E, 1)):  # a dense MLP is one "expert"
            if E and not every_expert and not bool(picks[:, e].any()):
                continue
            at = (layer, e) if E else layer
            for kk in range(-(-I // ic)):
                cols = slice(kk * ic, min((kk + 1) * ic, I))
                u = _mm(h2, up, everything, cols, at) + _bias(bp, "b_up", layer, cols)
                gt = None
                if gated:
                    gt = _mm(h2, gate, everything, cols, at) + _bias(bp, "b_gate", layer, cols)
                act = activate(u, gt, spec.activation).to(cd)
                d = _mm(act, down, cols, everything, at)
                acc = acc + (d * comb[:, e:e + 1] if E else d)
        x32 = x32 + acc + _bias(bp, "b_down", layer, everything)
    return x32.to(cd)


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

PHASES = ("qkv", "attention", "out_proj", "mlp_up", "mlp_down")


def phase_stamps(spec) -> int:
    """Timer stamps one launch writes: the start, the input, and one after
    each of the :data:`PHASES` of every layer."""
    return 2 + len(PHASES) * spec.num_layers


_WEIGHTS = ("wq", "wk", "wv", "wo", "w_up", "w_gate", "w_down")
_SCALES = ("sq", "sk", "sv", "so", "s_up", "s_gate", "s_down")
_VECTORS = ("ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias", "bq", "bk", "bv", "bo", "b_up",
            "b_gate", "b_down")
_PTRS = ("x", "x_out", "k_cache", "v_cache", "k_scale", "v_scale", *_VECTORS, *_WEIGHTS,
         *_SCALES, "cos", "sin", "work", "sync", "stamps", "router", "router_probs")
_INTS = ("B", "H", "Hq", "Hkv", "D", "I", "L", "Smax", "pos", "rope_dim", "rmsnorm",
         "activation", "wfmt", "ka", "splits", "nblocks", "smem", "E", "top_k")
_FLOATS = ("eps", "scale")
_FMTS = {None: 0, "int8": 1, "fp8": 2}
_PAYLOAD = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


class _Params(ctypes.Structure):
    """Mirror of ``TiledParams`` in ``csrc/decode_tiled.cuh``."""
    _fields_ = ([(n, ctypes.c_void_p) for n in _PTRS]
                + [(n, ctypes.c_int) for n in _INTS]
                + [(n, ctypes.c_float) for n in _FLOATS])


def _entry(fmt: Optional[str], D: int = 128):
    """K6's library for the weights' format and head dim
    (``csrc/decode_tiled_{bf16,int8,fp8,d256}.cu``), its entry points typed."""
    lib = _build.library("decode_tiled_d256" if D == D256 else f"decode_tiled_{fmt or 'bf16'}")
    if lib.mlio_decode_tiled_plan.argtypes is None:
        pp, i, vp = ctypes.POINTER(_Params), ctypes.c_int, ctypes.c_void_p
        for fn, args in ((lib.mlio_decode_tiled_plan,
                          [pp, ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(i)]),
                         (lib.mlio_decode_tiled, [pp, vp, vp]),
                         (lib.mlio_decode_tiled_maps, [pp, vp]),
                         (lib.mlio_decode_tiled_maps_bytes, []),
                         (lib.mlio_decode_tiled_items, [pp, i, i, ctypes.POINTER(i), i])):
            fn.argtypes, fn.restype = args, i
    return lib


def card_items(spec, fmt: Optional[str], B: int, phase: str, npicked: int = 1):
    """The card's own plan of one GEMV phase (``mlio_decode_tiled_items`` at
    the blocks the plan function sizes the launch for): a list of ``(block,
    tile, first unit, end unit)``, for holding :func:`item_plan` against."""
    lib = _entry(fmt, spec.head_size)
    prm = _Params(B=B, H=spec.hidden_size, Hq=spec.num_heads, Hkv=spec.num_kv_heads,
                  D=spec.head_size, I=spec.intermediate_size, L=spec.num_layers, Smax=128,
                  pos=0, activation=_ACTIVATIONS.index(spec.activation), wfmt=_FMTS[fmt], ka=1,
                  E=spec.num_experts, top_k=spec.num_experts_per_tok,
                  router=1 if spec.num_experts else None)
    work, sync = ctypes.c_longlong(), ctypes.c_int()
    _build.check(lib, lib.mlio_decode_tiled_plan(ctypes.byref(prm), ctypes.byref(work),
                                                 ctypes.byref(sync)), "card_items (plan)")
    cap = 1 << 16
    buf = (ctypes.c_int * (4 * cap))()
    n = lib.mlio_decode_tiled_items(ctypes.byref(prm), GEMV_PHASES.index(phase), npicked, buf,
                                    cap)
    if n < 0:
        raise RuntimeError(f"card_items: {phase} has more than {cap} items")
    return prm.nblocks, [tuple(buf[4 * i:4 * i + 4]) for i in range(n)]


def _weight_names(spec):
    """The projection weights K6 streams, in the order of ``_WEIGHTS``
    (an MoE model's expert stacks in the MLP's places)."""
    return _WEIGHTS[:4] + _mlp_names(spec)


def _weight_format(blocks, spec) -> Optional[str]:
    """The one storage format of the projection weights: None (floating
    tensors), "int8" or "fp8" QTensors (a W8A8 weight's ``act_scale`` is
    ignored: K6 decodes it with weight-only int8, as the JAX kernel does).
    Raises on anything else."""
    gated = spec.activation in ("swiglu", "geglu")
    fmts = set()
    for name in _weight_names(spec):
        w = blocks.get(name)
        if w is None:
            if name not in ("w_gate", "moe_gate") or gated:
                raise ValueError(f"decode_layer_tiled: weight {name!r} is missing (the "
                                 "per-projection layout is needed)")
            continue
        if isinstance(w, QTensor):
            if w.fmt not in _PAYLOAD:
                raise ValueError(f"decode_layer_tiled: K6 takes int8 or fp8 weights, got {w.fmt}")
            fmts.add(w.fmt)
        elif isinstance(w, torch.Tensor) and w.is_floating_point():
            fmts.add(None)
        else:
            raise ValueError(f"decode_layer_tiled: weight {name!r} must be a floating tensor "
                             "or an int8/fp8 QTensor")
    if len(fmts) != 1:
        raise ValueError("decode_layer_tiled: the projection weights must share one format")
    return fmts.pop()


def tiled_work(x, blocks, k_cache, v_cache, pos, cos=None, sin=None, *, spec, k_scales=None,
               **_):
    """(FLOPs, bytes) of one step, no head (``decode_layer.decode_work``)."""
    return decode_work(x, blocks, k_cache, pos, spec, kv8=k_scales is not None)


@cost.counts(tiled_work)
def decode_layer_tiled(
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
    tiling: Optional[Tiling] = None,
    phase_times: Optional[torch.Tensor] = None,
    router_probs: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One decode step of every layer → x_out [B, H] (no head).

    x [B, H] is the current token's hidden state (a learned position already
    added); blocks hold the stacked ``[L, in, out]`` weights, bf16 or int8 /
    fp8 QTensors with per-output-channel scales; k_cache/v_cache are
    ``[L, B, Smax, Hkv, D]`` and get slot ``pos`` of every layer in place,
    and with fp32 ``k_scales``/``v_scales`` [L, B, Smax, Hkv] they are an
    INT8 cache (its length a multiple of 128); cos/sin are the ``[1,
    rope_dim]`` tables of position ``pos`` for RoPE models. ``tiling``
    defaults to :func:`choose_tiling`'s.

    An MoE model's blocks hold a bf16 ``router`` [L, H, E] and the expert
    stacks ``moe_up``/``moe_gate`` [L, E, H, I] and ``moe_down`` [L, E, I, H]
    (per-expert per-channel scales [L, E, out] for int8/fp8), without MLP
    biases, as the JAX kernel takes them.

    ``phase_times``, a CUDA int64 tensor of at least :func:`phase_stamps`
    elements, receives the kernel's global timer (ns) at its start and after
    each grid barrier (a port-only probe; the CPU ignores it).
    ``router_probs``, an fp32 [L, B, E] tensor beside x, receives each
    layer's router softmax (the plain version's on the CPU)."""
    if spec.parallel_residual or spec.activation not in _ACTIVATIONS:
        raise ValueError(f"decode_layer_tiled: {spec.name} is not a model K6 runs "
                         "(parallel residual or activation)")
    E = spec.num_experts
    if E:
        if blocks.get("router") is None:
            raise ValueError("decode_layer_tiled: an MoE model's blocks need a router")
        if any(blocks.get(n) is not None for n in ("b_up", "b_gate", "b_down")):
            raise ValueError("decode_layer_tiled: expert MLP biases are not supported (as in "
                             "the JAX kernel)")
    fmt = _weight_format(blocks, spec)
    B, H = x.shape
    if k_cache.ndim != 5 or k_cache.shape[1] != B or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode_layer_tiled: caches must be [L, {B}, Smax, Hkv, D] alike, "
                         f"got {tuple(k_cache.shape)} and {tuple(v_cache.shape)}")
    L, _, Smax, Hkv, D = k_cache.shape
    if (L, Hkv, D) != (spec.num_layers, spec.num_kv_heads, spec.head_size) \
            or H != spec.hidden_size:
        raise ValueError("decode_layer_tiled: x and the caches do not match the spec")
    quant = _build.check_kv_scales("decode_layer_tiled", k_cache, v_cache, k_scales, v_scales)
    if quant and Smax % 128:
        raise ValueError(f"decode_layer_tiled: an INT8 KV cache needs a 128-aligned cache "
                         f"length (cache_len={Smax})")
    if not 0 <= pos < Smax:
        raise ValueError(f"decode_layer_tiled: slot {pos} outside the {Smax}-slot cache")
    if (cos is None) != (spec.positional == "learned"):
        raise ValueError("decode_layer_tiled: cos/sin are given for RoPE models, and only them")
    if cos is not None and (cos.ndim != 2 or cos.shape[0] != 1 or sin.shape != cos.shape):
        raise ValueError("decode_layer_tiled: cos/sin must be [1, rope_dim]")
    tiling = resolve_tiling(spec, B, tiling)
    if router_probs is not None and (router_probs.shape != (L, B, E) or router_probs.dtype
                                     != torch.float32 or router_probs.device != x.device):
        raise ValueError(f"decode_layer_tiled: router_probs must be fp32 [{L}, {B}, {E}] beside x")
    _build.refuse_grad("decode_layer_tiled (K6)", x, blocks, k_cache, v_cache, k_scales,
                       v_scales, cos, sin)
    if x.device.type == "cpu":
        return decode_layer_tiled_plain(x, blocks, k_cache, v_cache, pos, cos, sin, spec=spec,
                                        tiling=tiling, k_scales=k_scales, v_scales=v_scales,
                                        scale=scale, router_probs=router_probs)

    gated = spec.activation in ("swiglu", "geglu")
    tensors = {n: blocks.get(n) for n in _VECTORS}
    if not gated:
        tensors["b_gate"] = None
    quant_t = {}
    for name, src, sname in zip(_WEIGHTS, _weight_names(spec), _SCALES):
        w = blocks.get(src) if gated or name != "w_gate" else None
        if isinstance(w, QTensor):
            if w.q.dtype != _PAYLOAD[fmt]:
                raise ValueError(f"decode_layer_tiled: {name} payload must be {_PAYLOAD[fmt]}")
            quant_t[name], quant_t[sname] = w.q, w.scale
        else:
            tensors[name] = w
    tensors["x"] = x
    if E:
        tensors["router"] = blocks["router"]
    caches = dict(k_cache=k_cache, v_cache=v_cache)
    if quant:
        caches.update(k_scale=k_scales, v_scale=v_scales)
    else:
        tensors.update(caches)
    dev = _build.require_cuda("decode_layer_tiled", *[t for t in (
        *tensors.values(), *quant_t.values(), *caches.values()) if t is not None])
    limit = kernel_limit(spec, B, quant, 1 if fmt else 2)
    if limit is not None:
        raise ValueError(f"decode_layer_tiled: {limit}")
    _build.require_bf16("decode_layer_tiled", **tensors)
    for name, t in {**quant_t, **(caches if quant else {})}.items():
        want = (torch.float32 if name.startswith("s") or name.endswith("scale")
                else torch.int8 if name.endswith("cache") else _PAYLOAD[fmt])
        if t.dtype != want:
            raise ValueError(f"decode_layer_tiled: {name} must be {want}, got {t.dtype}")
    _build.require_contiguous_aligned("decode_layer_tiled", **tensors, **quant_t,
                                      **(caches if quant else {}))
    if E:
        H_, I_ = spec.hidden_size, spec.intermediate_size
        want = {"router": (L, H_, E), "moe_up": (L, E, H_, I_), "moe_gate": (L, E, H_, I_),
                "moe_down": (L, E, I_, H_)}
        for name, shape in want.items():
            w = blocks.get(name)
            if w is None or (name == "moe_gate" and not gated):
                continue
            got = tuple((w.q if isinstance(w, QTensor) else w).shape)
            if got != shape or (isinstance(w, QTensor) and tuple(w.scale.shape)
                                != shape[:2] + shape[-1:]):
                raise ValueError(f"decode_layer_tiled: {name} must be {shape} (scales "
                                 f"{shape[:2] + shape[-1:]}), got {got}")
        if router_probs is not None:
            _build.require_contiguous_aligned("decode_layer_tiled", router_probs=router_probs)
    if cos is not None:
        cos = cos.to(dev, x.dtype).float().contiguous()
        sin = sin.to(dev, x.dtype).float().contiguous()
    if phase_times is not None and (phase_times.dtype != torch.int64 or phase_times.device != dev
                                    or phase_times.numel() < phase_stamps(spec)):
        raise ValueError("decode_layer_tiled: phase_times must be int64 on the card, with "
                         f"{phase_stamps(spec)} elements")
    x_out = torch.empty_like(x)
    prm = _Params(
        **{n: _build.ptr(t) for n, t in (*tensors.items(), *quant_t.items(), *caches.items())},
        x_out=x_out.data_ptr(), cos=_build.ptr(cos), sin=_build.ptr(sin),
        stamps=_build.ptr(phase_times), router_probs=_build.ptr(router_probs), E=E,
        top_k=spec.num_experts_per_tok if E else 0, B=B, H=H, Hq=spec.num_heads, Hkv=Hkv, D=D,
        I=spec.intermediate_size, L=L, Smax=Smax, pos=pos,
        rope_dim=0 if cos is None else cos.shape[1],
        rmsnorm=int(spec.norm == "rmsnorm"), activation=_ACTIVATIONS.index(spec.activation),
        wfmt=_FMTS[fmt], ka=tiling.ka, eps=spec.norm_eps,
        scale=D ** -0.5 if scale is None else scale)
    lib = _entry(fmt, D)
    work_floats, sync_ints = ctypes.c_longlong(), ctypes.c_int()
    weights = [quant_t.get(n, tensors.get(n)) for n in _WEIGHTS]
    # the tensor maps (built once per set of weight tensors): keyed by the
    # format, the MLP's gating and each tensor's address, shape and dtype
    key = ("decode_tiled", fmt, gated, L, E, H, spec.num_heads, Hkv, D, spec.intermediate_size,
           *((w.data_ptr(), w.dtype) if w is not None else None for w in weights))
    with torch.cuda.device(dev):
        _build.check(lib, lib.mlio_decode_tiled_plan(ctypes.byref(prm), ctypes.byref(work_floats),
                                                     ctypes.byref(sync_ints)),
                     "decode_layer_tiled (plan)")
        maps = _build.tensor_maps(key, lib.mlio_decode_tiled_maps_bytes(),
                                  lambda buf: lib.mlio_decode_tiled_maps(ctypes.byref(prm), buf),
                                  lib, "decode_layer_tiled (tensor maps)")
        decode_layer_tiled.workspace_bytes = 4 * (work_floats.value + sync_ints.value)
        work = torch.empty(work_floats.value, dtype=torch.float32, device=dev)
        sync = torch.zeros(sync_ints.value, dtype=torch.int32, device=dev)
        prm.work, prm.sync = work.data_ptr(), sync.data_ptr()
        err = lib.mlio_decode_tiled(ctypes.byref(prm), maps, _build.stream_handle(dev))
    _build.check(lib, err, "decode_layer_tiled")
    decode_layer_tiled.launches += 1
    return x_out


decode_layer_tiled.launches = 0
decode_layer_tiled.workspace_bytes = 0  # the last launch's plan: work and sync buffers
