"""Continuous-batching inference engine over the paged KV pools
(``mlio_tpu/runtime/engine.py``).

Split of responsibilities, as in the JAX package:

* device: prompt-bucketed prefill (``paged_forward.prefill_paged``: K1 and
  K2) and batched decode chunks of up to ``steps_per_dispatch`` steps. The
  default decode backend, ``"mega"``, runs each step as an embedding gather
  plus ONE launch of the paged decode megakernel K8
  (``ops/decode_paged_stack.py``); ``"perop"`` runs the per-op step of
  ``paged_forward.decode_paged`` (K2, the projections, the K/V write and K7
  a layer) and serves every model K8 does not run, and every ``max_batch``
  past K8's 8 slots (the JAX K8 takes any batch). Within a chunk the
  tokens, contexts and tables stay on the device; the chunk's tokens are
  fetched once, after it.
* host: admission, incremental block allocation, preemption by recompute,
  prefix caching and finish checks in ``runtime/scheduler.py``.

Divergences from the JAX engine: ``run`` always takes the synchronous
``step`` loop (``pipeline=True`` raises until the pipelined loop is ported;
for every geometry where the pool is not exhausted the JAX package
documents the same greedy outputs for both loops); the native scheduler is
not ported; both backends keep ``[L, NB, bs, Hkv, D]`` pools
(``kv_combined`` is always False); sampling draws from a
``torch.Generator`` on the engine's device, once per sampled step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from mlio_tpu_torch.device import resolve_device
from mlio_tpu_torch.models.spec import ModelSpec
from mlio_tpu_torch.models.transformer import Impl
from mlio_tpu_torch.ops.decode_layer import route_limit as _route_limit
from mlio_tpu_torch.ops.decode_paged_stack import decode_paged_stack, supports_paged_stack
from mlio_tpu_torch.ops.paged_attention import init_kv_pools
from mlio_tpu_torch.runtime import paged_forward
from mlio_tpu_torch.runtime.sampling import SamplingMethod, sample
from mlio_tpu_torch.runtime.scheduler import make_scheduler

_DECODE_STACKS = ("auto", "mega", "perop")


@dataclasses.dataclass
class Request:
    req_id: int
    prompt: List[int]
    max_new_tokens: int = 32
    eos_token: Optional[int] = None
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds largest bucket {buckets[-1]}")


def _mega_step(params, spec: ModelSpec, lm_w, lm_vmajor: bool, cur, k_pool, v_pool, tables,
               ctx, emit: str):
    """One decode step through K8 for tokens ``cur`` [B] whose contexts
    ``ctx`` [B] int32 count the current token: the embedding row (times
    ``embed_scale``, plus the learned position at ``ctx - 1``, in the
    compute dtype) and one launch over the pools, which get each sequence's
    K/V at slot ``ctx - 1``. Returns K8's tokens [B] int32 or logits [B, V]."""
    past = ctx - 1
    x, cos, sin = paged_forward.embed(params, spec, cur.long(), past.long())
    _, out = decode_paged_stack(
        x, params["blocks"], k_pool, v_pool, tables, past, cos, sin, spec=spec,
        head_norm=(params["final_scale"], params["final_bias"]), lm_head=lm_w,
        lm_head_bias=params.get("lm_head_bias"), lm_vmajor=lm_vmajor, emit=emit)
    return out


def _decode_mega_steps(params, lm_w, cur, k_pool, v_pool, tables, ctx, generator, *, spec,
                       k, method, lm_vmajor):
    """k decode steps, each :func:`_mega_step`: greedy decoding takes K8's
    argmax; other methods sample K8's logits. Returns the tokens [k, B]
    int32 on the device, unread."""
    greedy = method.temperature == 0.0
    toks = []
    for _ in range(k):
        out = _mega_step(params, spec, lm_w, lm_vmajor, cur, k_pool, v_pool, tables, ctx,
                         "greedy" if greedy else "logits")
        cur = out if greedy else sample(out, generator, method).to(torch.int32)
        toks.append(cur)
        ctx = ctx + 1
    return torch.stack(toks)


def _decode_multi_steps(params, cur, k_pool, v_pool, tables, ctx, generator, *, spec, impl,
                        k, method):
    """k per-op decode steps (``paged_forward.decode_paged`` and a sample
    each). Returns the tokens [k, B] int32 on the device, unread."""
    toks = []
    for _ in range(k):
        logits = paged_forward.decode_paged(params, spec, cur, k_pool, v_pool, tables, ctx,
                                            impl=impl)
        cur = sample(logits, generator, method).to(torch.int32)
        toks.append(cur)
        ctx = ctx + 1
    return torch.stack(toks)


class _ManagerView:
    """Block accounting of the scheduler."""

    def __init__(self, sched, num_blocks: int):
        self._sched = sched
        self.num_blocks = num_blocks

    @property
    def num_free(self) -> int:
        return self._sched.num_free_blocks


class InferenceEngine:
    """Continuous batching over paged KV pools."""

    def __init__(
        self,
        spec: ModelSpec,
        params,
        *,
        max_batch: int = 8,
        max_seq_len: Optional[int] = None,
        num_blocks: Optional[int] = None,
        block_size: int = 16,
        impl: Impl = Impl(),
        method: SamplingMethod = SamplingMethod(),
        prefill_buckets: Sequence[int] = (32, 128, 512, 2048),
        dtype=torch.bfloat16,
        generator: Optional[torch.Generator] = None,
        scheduler: str = "auto",
        prefix_caching: bool = True,
        steps_per_dispatch: int = 8,
        decode_stack: str = "auto",
        device: Union[str, torch.device] = "cuda",
    ):
        spec.validate()
        self.device = resolve_device(device)
        if params["tok_embed"].device.type != self.device.type:
            raise ValueError(f"InferenceEngine: params lie on {params['tok_embed'].device}, "
                             f"not {self.device}")
        # multi-step scheduling: up to this many decode steps run on the
        # device per host interaction (rounded down to a power of two)
        self.steps_per_dispatch = steps_per_dispatch
        self.spec = spec
        self.params = params
        self.impl = impl
        self.method = method
        self.max_batch = max_batch
        self.max_seq_len = max_seq_len or spec.max_seq_len
        self.block_size = block_size
        self.max_blocks_per_seq = -(-self.max_seq_len // block_size)
        self.prefill_buckets = [b for b in prefill_buckets
                                if b <= self.max_seq_len] or [self.max_seq_len]
        if self.prefill_buckets[-1] < self.max_seq_len:
            self.prefill_buckets.append(self.max_seq_len)
        if num_blocks is None:
            num_blocks = max_batch * self.max_blocks_per_seq + 1
        if decode_stack not in _DECODE_STACKS:
            raise ValueError(f"decode_stack must be one of {_DECODE_STACKS}, got {decode_stack!r}")
        # K8's limits, the batch of max_batch slots included, decided before
        # any launch: past them "auto" takes the per-op decode (K7)
        on_card = self.device.type == "cuda"
        supported = supports_paged_stack(spec, params.get("blocks"), B=max_batch, on_card=on_card)
        if decode_stack == "mega" and not supported:
            why = (_route_limit(spec, max_batch, on_card)
                   or "parallel residual, experts or activation")
            raise ValueError(f"decode_stack='mega': K8 does not run {spec.name} with "
                             f"max_batch {max_batch} ({why})")
        self.decode_stack = "mega" if decode_stack == "mega" or (
            decode_stack == "auto" and supported) else "perop"
        self.kv_combined = False
        self.k_pool, self.v_pool = init_kv_pools(
            spec.num_layers, num_blocks, spec.num_kv_heads, block_size, spec.head_size,
            dtype=dtype, device=self.device)
        self._lm_vmajor = params.get("lm_head") is None
        self._lm_w = params["tok_embed"] if self._lm_vmajor else params["lm_head"]
        self.sched = make_scheduler(max_batch, num_blocks, block_size, self.max_blocks_per_seq,
                                    prefix_caching, backend=scheduler)
        self.manager = _ManagerView(self.sched, num_blocks)
        self.requests: Dict[int, Request] = {}
        self.finished: List[Request] = []
        self.generator = (generator if generator is not None
                          else torch.Generator(device=self.device).manual_seed(0))

    # -- request lifecycle ---------------------------------------------------

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 32,
               eos_token: Optional[int] = None) -> int:
        prompt = [int(t) for t in prompt]  # numpy ints overflow the prefix hash
        if len(prompt) < 1:
            raise ValueError("submit: empty prompt")
        if len(prompt) + max_new_tokens > self.max_seq_len:
            raise ValueError("submit: prompt + generation exceeds max_seq_len")
        rid = self.sched.submit(prompt, max_new_tokens, eos_token)
        self.requests[rid] = Request(rid, prompt, max_new_tokens, eos_token)
        return rid

    def _tensor(self, a) -> torch.Tensor:
        return torch.tensor(np.asarray(a), device=self.device)

    def _prefill_batch(self, admitted: List[tuple]) -> None:
        """Batched ragged prefill: the admissions sharing a length bucket run
        as ONE padded prefill call, the batch padded to a power of two. Pad
        rows have all-scratch tables, so their writes land in the scratch
        block, and their samples are dropped. The group's tokens are fetched
        once, after its sample."""
        by_bucket: Dict[int, List[tuple]] = {}
        for slot, prompt, _num_cached in admitted:
            b = _bucket(len(prompt), self.prefill_buckets)
            by_bucket.setdefault(b, []).append((slot, prompt))
        for bucket, group in sorted(by_bucket.items()):
            pb = 1 << (len(group) - 1).bit_length()  # next power of two
            ids = np.zeros((pb, bucket), np.int64)
            lens = np.ones((pb,), np.int32)
            tables = np.zeros((pb, self.max_blocks_per_seq), np.int32)
            for i, (slot, prompt) in enumerate(group):
                ids[i, :len(prompt)] = prompt
                lens[i] = len(prompt)
                tables[i] = self.sched.tables[slot]
            logits = paged_forward.prefill_paged(
                self.params, self.spec, self._tensor(ids), self.k_pool, self.v_pool,
                self._tensor(tables), self._tensor(lens),
                torch.zeros((pb,), dtype=torch.int32, device=self.device), impl=self.impl)
            toks = sample(logits, self.generator, self.method).cpu().numpy()
            for i, (slot, _prompt) in enumerate(group):
                self.sched.commit_prefill(slot, int(toks[i]))

    def _drain_finished(self) -> None:
        while True:
            item = self.sched.pop_finished()
            if item is None:
                break
            rid, output = item
            req = self.requests.pop(rid)
            req.output = output
            req.done = True
            self.finished.append(req)

    # -- stepping ------------------------------------------------------------

    @property
    def num_active(self) -> int:
        return self.sched.num_active

    @torch.inference_mode()
    def step(self) -> None:
        """Admit (and prefill) queued requests, then one decode chunk of up
        to ``steps_per_dispatch`` steps on the device, with the blocks for
        all of them preallocated by ``plan_multi_step``."""
        admitted = list(self.sched.admit())
        if admitted:
            self._prefill_batch(admitted)
        if self.sched.num_active:
            k = 1
            if self.steps_per_dispatch > 1:
                k = max(1, self.sched.plan_multi_step(self.steps_per_dispatch))
                k = 1 << (k.bit_length() - 1)  # a power of two, as the JAX engine
            cur, tables, ctx = (self._tensor(a) for a in
                                (self.sched.cur, self.sched.tables, self.sched.ctx))
            if self.decode_stack == "mega":
                toks = _decode_mega_steps(
                    self.params, self._lm_w, cur, self.k_pool, self.v_pool, tables, ctx,
                    self.generator, spec=self.spec, k=k, method=self.method,
                    lm_vmajor=self._lm_vmajor)
            else:
                toks = _decode_multi_steps(
                    self.params, cur, self.k_pool, self.v_pool, tables, ctx, self.generator,
                    spec=self.spec, impl=self.impl, k=k, method=self.method)
            self.sched.commit_tokens_multi(toks.cpu().numpy())
        self._drain_finished()

    def run(self, prompts: Sequence[Sequence[int]], max_new_tokens: int = 32,
            eos_token: Optional[int] = None, pipeline="auto") -> List[List[int]]:
        """Submit all prompts, run until completion, return outputs in order.

        ``pipeline``: ``"auto"`` and False run the synchronous ``step`` loop;
        True (the JAX engine's async one-chunk-lookahead loop) raises."""
        if pipeline is True:
            raise NotImplementedError(
                "run(pipeline=True): the pipelined engine loop (_run_pipelined) is not "
                "ported yet (ROADMAP queue 1, item 7: serving); 'auto' runs the sync loop")
        if pipeline not in ("auto", False):
            raise ValueError(f"run: pipeline must be 'auto', False or True, got {pipeline!r}")
        ids = [self.submit(p, max_new_tokens, eos_token) for p in prompts]
        guard = 0
        while self.sched.num_queued or self.sched.num_active:
            self.step()
            guard += 1
            if guard > 100_000:
                raise RuntimeError("engine did not converge")
        by_id = {r.req_id: r.output for r in self.finished}
        return [by_id[i] for i in ids]

    def memory_stats(self) -> Dict[str, float]:
        used = self.manager.num_blocks - self.manager.num_free
        return {
            "num_blocks": self.manager.num_blocks,
            "used_blocks": used,
            "utilization": used / self.manager.num_blocks,
            "active_slots": self.num_active,
            "queued": self.sched.num_queued,
            "scheduler": self.sched.name,
            **self.sched.stats(),
        }
