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
  prefix caching and finish checks in a scheduler (``runtime/scheduler.py``:
  the native C++ one where it builds, its Python twin otherwise).

Two loops: the synchronous ``step`` loop, and the pipelined loop
(``_run_pipelined``), which plans and launches chunk N+1 from chunk N's
device-resident last tokens before chunk N's tokens reach the host. On
CUDA a ``.cpu()`` of chunk N's tokens after chunk N+1 is queued would wait
for chunk N+1 as well; so each chunk's tokens are copied to pinned host
memory without blocking right after its launches, an event is recorded
behind the copy, and the commit waits on that event alone. Every launch
and copy stays on the current stream: a chunk still in flight may write to
blocks that a lagged commit has freed, and their reuse is launched after
it in stream order (the JAX loop's argument, which rests on device-queue
order). Where the pool is short of even one step's blocks
(``plan_multi_step`` returns -1) the pipelined loop commits the chunk in
flight and takes one synchronous step, whose commit preempts; the JAX
package's pipelined loop dispatches that chunk past the pool and its
tokens go wrong.

Divergences from the JAX engine: both backends keep ``[L, NB, bs, Hkv, D]``
pools (``kv_combined`` is always False); sampling draws from a
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


class _Fetch:
    """A device tensor's copy to the host, started when made and waited on
    alone: on CUDA into pinned memory without blocking, with an event
    recorded behind the copy; on the CPU a copy."""

    def __init__(self, t: torch.Tensor):
        self.event = None
        if t.device.type == "cuda":
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = t.clone()

    def get(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


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

    def _upload(self, a, dtype=np.int32) -> torch.Tensor:
        """A copy of a host array on the device, taken now (the scheduler's
        arrays change under later plans, the native ones in place); on CUDA
        through pinned memory without blocking, so that the host does not
        wait for the work queued before it."""
        t = torch.from_numpy(np.array(a, dtype=dtype))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _prefill_batch(self, admitted: List[tuple], defer: bool = False) -> List[tuple]:
        """Batched ragged prefill: the admissions sharing a length bucket run
        as ONE padded prefill call, the batch padded to a power of two. Pad
        rows have all-scratch tables, so their writes land in the scratch
        block, and their samples are dropped. The group's tokens are fetched
        once, after its sample.

        ``defer=True`` (the pipelined loop) leaves the sampled tokens on the
        device and returns ``(slots, fetch, device tokens)`` a group: the
        scheduler advances ctx through ``commit_prefill_pending`` and gets
        the values later through ``resolve_prefill``."""
        by_bucket: Dict[int, List[tuple]] = {}
        for slot, prompt, _num_cached in admitted:
            b = _bucket(len(prompt), self.prefill_buckets)
            by_bucket.setdefault(b, []).append((slot, prompt))
        groups: List[tuple] = []
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
                self.params, self.spec, self._upload(ids, np.int64), self.k_pool, self.v_pool,
                self._upload(tables), self._upload(lens),
                torch.zeros((pb,), dtype=torch.int32, device=self.device), impl=self.impl)
            dev_toks = sample(logits, self.generator, self.method)
            if defer:
                for slot, _prompt in group:
                    self.sched.commit_prefill_pending(slot)
                groups.append(([s for s, _p in group], _Fetch(dev_toks), dev_toks))
                continue
            toks = dev_toks.cpu().numpy()
            for i, (slot, _prompt) in enumerate(group):
                self.sched.commit_prefill(slot, int(toks[i]))
        return groups

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
            self._decode_sync()
        self._drain_finished()

    def _decode_sync(self) -> int:
        """One decode chunk from the committed state, its tokens committed
        before it returns: the JAX sync loop's k (a power of two; 1 where
        the plan could not cover more, the write at ctx - 1 being covered
        by the last commit). Returns k."""
        k = 1
        if self.steps_per_dispatch > 1:
            k = max(1, self.sched.plan_multi_step(self.steps_per_dispatch))
            k = 1 << (k.bit_length() - 1)  # a power of two, as the JAX engine
        toks = self._dispatch_chunk(k, self._upload(self.sched.cur), 0)
        self.sched.commit_tokens_multi(toks.cpu().numpy())
        return k

    def _dispatch_chunk(self, k: int, cur: torch.Tensor, ctx_off: int) -> torch.Tensor:
        """Launch ONE k-step decode chunk from tokens ``cur`` [B] int32 on the
        device; returns its tokens [k, B] int32 on the device, unread.

        ``ctx_off`` is the pipelined loop's count of positions dispatched but
        not committed: the chunk decodes positions ctx + ctx_off onward,
        whose blocks ``plan_multi_step(reserve=ctx_off)`` preallocated. The
        tables and contexts are copied when the chunk is launched."""
        tables = self._upload(self.sched.tables)
        ctx = self._upload(np.asarray(self.sched.ctx, np.int32) + np.int32(ctx_off))
        if self.decode_stack == "mega":
            return _decode_mega_steps(
                self.params, self._lm_w, cur, self.k_pool, self.v_pool, tables, ctx,
                self.generator, spec=self.spec, k=k, method=self.method,
                lm_vmajor=self._lm_vmajor)
        return _decode_multi_steps(
            self.params, cur, self.k_pool, self.v_pool, tables, ctx, self.generator,
            spec=self.spec, impl=self.impl, k=k, method=self.method)

    @torch.inference_mode()
    def _run_pipelined(self) -> None:
        """Drive every submitted request to completion with one chunk of
        lookahead: chunk N+1 is planned (``plan_multi_step(reserve=k_N)``)
        and launched from chunk N's last tokens on the device before chunk
        N's tokens are committed, so the host's commit runs under the
        device's next chunk. Commits lag one chunk (EOS and length
        overshoot are trimmed at commit, as in the sync loop); admission and
        prefill are sync points, so a slot's membership is known on the
        host when a prompt enters. Where the pool cannot cover even one
        step (plan -1), the chunk in flight is committed and one
        synchronous step runs. Greedy outputs are the sync loop's."""
        pend: Optional[tuple] = None  # (fetch of [k, B] tokens, device tokens, k)
        rem: Dict[int, int] = {}      # slot -> tokens still to dispatch
        deferred: List[tuple] = []    # (slots, fetch, device prefill tokens)

        def flush():
            nonlocal pend
            if pend is not None:
                fetch, pend = pend[0], None
                self.sched.commit_tokens_multi(fetch.get())
                self._drain_finished()

        def resolve_prefills():
            # the device-sampled prefill tokens, delivered after the first
            # chunk behind them was launched
            for slots, fetch, _ in deferred:
                vals = fetch.get()
                for i, slot in enumerate(slots):
                    self.sched.resolve_prefill(slot, int(vals[i]))
            deferred.clear()
            self._drain_finished()

        def active_slots():
            return [s for s in range(self.max_batch) if self.sched.slot_req_id(s) >= 0]

        guard = 0
        while self.sched.num_queued or self.sched.num_active or pend is not None:
            guard += 1
            if guard > 100_000:
                raise RuntimeError("engine did not converge")
            if self.sched.num_queued and self.sched.num_active < self.max_batch:
                resolve_prefills()
                flush()  # finishes must be known on the host for admission
            admitted = list(self.sched.admit())
            if admitted:
                flush()  # a prefill resets its slot's state on the host
                deferred += self._prefill_batch(admitted, defer=True)
                for slot, _prompt, _nc in admitted:
                    rid = self.sched.slot_req_id(slot)
                    if rid >= 0:
                        rem[slot] = self.requests[rid].max_new_tokens - 1
            if not self.sched.num_active:
                resolve_prefills()
                flush()
                continue
            active = active_slots()
            # every active slot's budget already in flight: another chunk
            # would be a pure-waste tail, so drain
            if max((rem.get(s, 0) for s in active), default=0) <= 0:
                resolve_prefills()
                flush()
                continue
            k = self.sched.plan_multi_step(self.steps_per_dispatch,
                                           reserve=pend[2] if pend else 0)
            if k < 0:
                # the pool is short of one step's blocks past the positions
                # in flight: commit them, then one synchronous step
                resolve_prefills()
                flush()
                active = active_slots()
                if active:
                    k = self._decode_sync()
                    for s in active:
                        rem[s] = rem.get(s, 0) - k
                    self._drain_finished()
                continue
            if k == 0:
                resolve_prefills()
                flush()
                continue
            k = 1 << (k.bit_length() - 1)  # a power of two, as the JAX engine
            if pend is not None:
                cur = pend[1][-1]
            else:
                cur = self._upload(self.sched.cur)
                # the prefill samples the host has not seen yet go into cur
                # by slot; the pad rows' samples are left out here
                for slots, _fetch, dev_toks in deferred:
                    cur[self._upload(slots).long()] = dev_toks[:len(slots)].to(torch.int32)
            toks = self._dispatch_chunk(k, cur, pend[2] if pend else 0)
            for s in active:
                rem[s] = rem.get(s, 0) - k
            prev, pend = pend, (_Fetch(toks), toks, k)
            # commit everything outstanding while the new chunk runs
            resolve_prefills()
            if prev is not None:
                self.sched.commit_tokens_multi(prev[0].get())
                self._drain_finished()
        resolve_prefills()
        flush()

    def run(self, prompts: Sequence[Sequence[int]], max_new_tokens: int = 32,
            eos_token: Optional[int] = None, pipeline="auto") -> List[List[int]]:
        """Submit all prompts, run until completion, return outputs in order.

        ``pipeline``: True runs the pipelined loop (``_run_pipelined``),
        False the synchronous ``step`` loop, ``"auto"`` the pipelined loop
        when ``steps_per_dispatch > 1``, as the JAX engine."""
        if pipeline not in ("auto", False, True):
            raise ValueError(f"run: pipeline must be 'auto', False or True, got {pipeline!r}")
        ids = [self.submit(p, max_new_tokens, eos_token) for p in prompts]
        if pipeline is True or (pipeline == "auto" and self.steps_per_dispatch > 1):
            self._run_pipelined()
        else:
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
