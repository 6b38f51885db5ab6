"""Continuous-batching scheduler (``mlio_tpu/runtime/scheduler.py``).

A copy of the JAX package's pure-Python scheduler, which is plain numpy:
incremental block allocation, preempt-youngest-by-recompute, chained-hash
prefix caching with cache-held refcounts and lazy FIFO eviction, and
multi-step planning. Its native C++ twin is ``mlio_tpu_torch/native`` (the
same policy, held to this one step by step). One change from the JAX
package's: :meth:`PyScheduler.plan_multi_step` returns -1 when even a
one-step chunk's blocks cannot all be allocated, where the JAX package's
returns 1 and its pipelined loop dispatches that chunk past an exhausted
pool.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

SCRATCH_BLOCK = 0  # inactive slots write here; pinned, never freed

_FNV_OFFSET = 1469598103934665603
_FNV_PRIME = 1099511628211
_MASK64 = (1 << 64) - 1


def chain_hash(prev: int, tokens: Sequence[int]) -> int:
    """Position-sensitive chained FNV-1a (must match the C++ exactly)."""
    h = (_FNV_OFFSET ^ prev) & _MASK64
    for t in tokens:
        h = ((h ^ (t & 0xFFFFFFFF)) * _FNV_PRIME) & _MASK64
    return h or 1


class CachingBlockManager:
    """Free list + refcounts + prefix cache holding its own refcounts."""

    def __init__(self, num_blocks: int, block_size: int):
        self.num_blocks = num_blocks
        self.block_size = block_size
        # LIFO popped from the back; pushed num_blocks-1 .. 1 so block 1 is
        # allocated first (identical order to the C++ free list)
        self.free_list = list(range(num_blocks - 1, 0, -1))
        self.refcounts = np.zeros(num_blocks, np.int32)
        self.refcounts[SCRATCH_BLOCK] = 1
        self.prefix_map: Dict[int, int] = {}
        self.block_hash = np.zeros(num_blocks, np.uint64)
        self.evict_fifo: Deque[int] = deque()

    @property
    def num_free(self) -> int:
        return len(self.free_list)

    def _evict_cached(self) -> int:
        while self.evict_fifo:
            b = self.evict_fifo.popleft()
            if self.refcounts[b] == 1 and self.block_hash[b]:
                del self.prefix_map[int(self.block_hash[b])]
                self.block_hash[b] = 0
                self.refcounts[b] = 0
                return b
        return -1

    def allocate(self) -> int:
        if self.free_list:
            b = self.free_list.pop()
        else:
            b = self._evict_cached()
            if b < 0:
                return -1
        self.refcounts[b] = 1
        return b

    def fork(self, b: int) -> int:
        if b < 0 or b >= self.num_blocks or self.refcounts[b] <= 0:
            return -1
        self.refcounts[b] += 1
        return b

    def free(self, b: int) -> None:
        if self.refcounts[b] <= 0:
            raise ValueError(f"double free of block {b}")
        self.refcounts[b] -= 1
        if self.refcounts[b] == 0:
            self.free_list.append(b)
        elif self.refcounts[b] == 1 and self.block_hash[b]:
            self.evict_fifo.append(b)

    def publish(self, b: int, h: int) -> None:
        if self.refcounts[b] <= 0 or not h or self.block_hash[b]:
            return
        if h in self.prefix_map:
            return
        self.prefix_map[h] = b
        self.block_hash[b] = h
        self.refcounts[b] += 1

    def lookup(self, h: int) -> int:
        return self.prefix_map.get(h, -1)


@dataclasses.dataclass
class _Req:
    id: int
    prompt: List[int]
    max_new: int
    eos: int  # -1 = none
    output: List[int] = dataclasses.field(default_factory=list)
    num_cached: int = 0


@dataclasses.dataclass
class _Slot:
    req: Optional[_Req] = None
    blocks: List[int] = dataclasses.field(default_factory=list)
    admit_seq: int = 0

    @property
    def active(self) -> bool:
        return self.req is not None


class PyScheduler:
    """Pure-Python continuous-batching scheduler (policy == native)."""

    name = "python"

    def __init__(self, max_batch: int, num_blocks: int, block_size: int,
                 max_blocks_per_seq: int, prefix_caching: bool = True):
        self.max_batch = max_batch
        self.block_size = block_size
        self.max_blocks_per_seq = max_blocks_per_seq
        self.prefix_caching = prefix_caching
        self.mgr = CachingBlockManager(num_blocks, block_size)
        self.slots = [_Slot() for _ in range(max_batch)]
        self.queue: Deque[_Req] = deque()
        self.finished: Deque[_Req] = deque()
        self.tables = np.full((max_batch, max_blocks_per_seq), SCRATCH_BLOCK,
                              np.int32)
        self.ctx = np.ones(max_batch, np.int32)
        self.cur = np.zeros(max_batch, np.int32)
        self._next_id = 0
        self._admit_counter = 0
        self._stats = {"preempted": 0, "prefills": 0, "generated_tokens": 0,
                       "prefix_hit_blocks": 0}

    # -- request lifecycle ---------------------------------------------------

    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               eos_token: Optional[int] = None) -> int:
        if len(prompt) < 1 or max_new_tokens < 1:
            raise ValueError("bad request (empty prompt or max_new_tokens<1)")
        # admission control: a request whose worst case cannot fit in the
        # pool would preempt forever (recompute livelock) — reject up front.
        # Final context is n+max_new; the post-final-token grow never runs
        # (finish fires first), so the true worst is ceil((n+max_new)/bs).
        worst = -(-(len(prompt) + max_new_tokens) // self.block_size)
        if worst > self.max_blocks_per_seq or worst > self.mgr.num_blocks - 1:
            raise ValueError(
                f"request needs up to {worst} blocks; capacity is "
                f"min({self.max_blocks_per_seq} per-seq, "
                f"{self.mgr.num_blocks - 1} pool)")
        r = _Req(self._next_id, list(prompt), max_new_tokens,
                 -1 if eos_token is None else eos_token)
        self._next_id += 1
        self.queue.append(r)
        return r.id

    def _reset_slot(self, s: int) -> None:
        sl = self.slots[s]
        for b in sl.blocks:
            self.mgr.free(b)
        sl.blocks = []
        sl.req = None
        self.tables[s, :] = SCRATCH_BLOCK
        self.ctx[s] = 1
        self.cur[s] = 0

    def _try_prefix_reuse(self, r: _Req, blocks: List[int]) -> int:
        if not self.prefix_caching:
            return 0
        full = len(r.prompt) // self.block_size
        if full * self.block_size == len(r.prompt):
            full -= 1  # last prompt token must be recomputed for its logits
        h, reused = 0, 0
        for i in range(full):
            h = chain_hash(h, r.prompt[i * self.block_size:
                                       (i + 1) * self.block_size])
            b = self.mgr.lookup(h)
            if b < 0 or self.mgr.fork(b) < 0:
                break
            blocks.append(b)
            reused += 1
        self._stats["prefix_hit_blocks"] += reused
        return reused

    def _publish_prompt_blocks(self, sl: _Slot) -> None:
        if not self.prefix_caching:
            return
        r = sl.req
        full = len(r.prompt) // self.block_size
        if full * self.block_size == len(r.prompt):
            full -= 1
        h = 0
        for i in range(min(full, len(sl.blocks))):
            h = chain_hash(h, r.prompt[i * self.block_size:
                                       (i + 1) * self.block_size])
            self.mgr.publish(sl.blocks[i], h)

    def admit(self) -> List[Tuple[int, List[int], int]]:
        out = []
        for s in range(self.max_batch):
            if not self.queue:
                break
            if self.slots[s].active:
                continue
            r = self.queue[0]
            # prompt positions 0..n-1 plus the first decode write at n
            prompt_blocks = len(r.prompt) // self.block_size + 1
            if prompt_blocks > self.max_blocks_per_seq:
                raise ValueError(
                    "request longer than max_blocks_per_seq allows")
            blocks: List[int] = []
            reused = self._try_prefix_reuse(r, blocks)
            ok = True
            for _ in range(prompt_blocks - reused):
                b = self.mgr.allocate()
                if b < 0:
                    ok = False
                    break
                blocks.append(b)
            if not ok:
                for b in blocks:
                    self.mgr.free(b)
                break  # wait for completions
            self.queue.popleft()
            r.num_cached = reused * self.block_size
            sl = self.slots[s]
            sl.req = r
            sl.blocks = blocks
            sl.admit_seq = self._admit_counter
            self._admit_counter += 1
            self.tables[s, :] = SCRATCH_BLOCK
            self.tables[s, : len(blocks)] = blocks
            self.ctx[s] = 1
            self.cur[s] = 0
            out.append((s, list(r.prompt), r.num_cached))
        return out

    def slot_req_id(self, slot: int) -> int:
        sl = self.slots[slot]
        return sl.req.id if sl.active else -1

    def _finish_if_done(self, s: int) -> bool:
        sl = self.slots[s]
        r = sl.req
        done = (len(r.output) >= r.max_new
                or (r.eos >= 0 and r.output and r.output[-1] == r.eos))
        if not done:
            return False
        self._publish_prompt_blocks(sl)
        self.finished.append(r)
        self._reset_slot(s)
        return True

    def commit_prefill(self, slot: int, token: int) -> None:
        sl = self.slots[slot]
        if not sl.active:
            raise ValueError(f"slot {slot} not active")
        sl.req.output.append(int(token))
        self.cur[slot] = token
        self.ctx[slot] = len(sl.req.prompt) + 1
        self._stats["prefills"] += 1
        self._stats["generated_tokens"] += 1
        self._finish_if_done(slot)

    def commit_prefill_pending(self, slot: int) -> None:
        """Record a prefill whose sampled token is still ON DEVICE: ctx
        advances now (decode planning needs it) while the token itself
        arrives later via resolve_prefill — the engine's pipelined mode
        chains prefill -> first decode chunk without a host fetch."""
        sl = self.slots[slot]
        if not sl.active:
            raise ValueError(f"slot {slot} not active")
        self.ctx[slot] = len(sl.req.prompt) + 1
        self._stats["prefills"] += 1

    def resolve_prefill(self, slot: int, token: int) -> None:
        """Deliver the device-sampled prefill token for a pending slot
        (see commit_prefill_pending); runs the finish check the immediate
        commit would have run."""
        sl = self.slots[slot]
        if not sl.active:
            raise ValueError(f"slot {slot} not active")
        sl.req.output.append(int(token))
        self.cur[slot] = token
        self._stats["generated_tokens"] += 1
        self._finish_if_done(slot)

    def _preempt(self, s: int) -> None:
        """Requeue slot s at the FRONT with prompt+output as the new prompt.

        `output` is KEPT: the regenerated continuation appends to it, so the
        tokens already produced still count toward max_new and are returned.
        """
        sl = self.slots[s]
        r = sl.req
        r.prompt = r.prompt + r.output
        r.num_cached = 0
        self.queue.appendleft(r)
        self._reset_slot(s)
        self._stats["preempted"] += 1

    def _preempt_youngest(self, except_slot: int) -> int:
        victim, best = -1, -1
        for s in range(self.max_batch):
            if not self.slots[s].active or s == except_slot:
                continue
            if self.slots[s].admit_seq > best:
                best, victim = self.slots[s].admit_seq, s
        if victim >= 0:
            self._preempt(victim)
        return victim

    def commit_tokens(self, tokens) -> int:
        tokens = np.asarray(tokens, np.int32)
        done = 0
        for s in range(self.max_batch):
            sl = self.slots[s]
            if not sl.active:
                continue
            sl.req.output.append(int(tokens[s]))
            self.cur[s] = tokens[s]
            self.ctx[s] += 1
            self._stats["generated_tokens"] += 1
            if self._finish_if_done(s):
                done += 1
                continue
            # the next decode writes at position ctx-1 -> need ceil(ctx/bs)
            needed = (int(self.ctx[s]) + self.block_size - 1) // self.block_size
            while len(sl.blocks) < needed:
                if needed > self.max_blocks_per_seq:
                    self.finished.append(sl.req)
                    self._reset_slot(s)
                    done += 1
                    break
                b = self.mgr.allocate()
                if b < 0:
                    if self._preempt_youngest(s) < 0:
                        self._preempt(s)  # self-preempt: last resort
                        break
                    continue  # retry allocation
                self.tables[s, len(sl.blocks)] = b
                sl.blocks.append(b)
        return done

    def plan_multi_step(self, k_max: int, reserve: int = 0) -> int:
        """Largest k <= k_max every active slot can decode WITHOUT host
        intervention (vLLM-style multi-step scheduling): bounded by each
        slot's remaining-token budget, with the KV blocks for the next k
        tokens PREALLOCATED here so the device can run k decode steps in
        one dispatch. EOS finishes mid-chunk are exact — commit trims at
        the EOS and discards the overshoot. Never preempts to create
        speculative headroom: on block shortage k shrinks instead.

        ``reserve``: extra uncommitted positions already dispatched to the
        device (the engine's pipelined mode plans chunk N+1 before chunk
        N's tokens are fetched, so blocks must cover ctx + reserve + k).

        Returns the chunk's k; 0 when no slot is active; -1 when even k = 1
        could not be covered (the blocks it did allocate stay with their
        slots): the caller must then not dispatch past the committed
        positions, and takes a synchronous step, whose commit preempts."""
        active = [s for s in range(self.max_batch) if self.slots[s].active]
        if not active:
            return 0
        # No remaining-budget cap: a slot that hits its max_new (or EOS)
        # mid-chunk is trimmed at commit, so k stays CONSTANT across the
        # request lifetime — one jit variant instead of a shrinking tail
        # (k, k/2, ..., 1), at the cost of <= k-1 discarded device steps
        # per finishing sequence.
        k = max(k_max, 1)
        while True:
            ok = True
            for s in active:
                sl = self.slots[s]
                needed = min((int(self.ctx[s]) + reserve + k
                              + self.block_size - 1)
                             // self.block_size, self.max_blocks_per_seq)
                while len(sl.blocks) < needed:
                    b = self.mgr.allocate()
                    if b < 0:
                        ok = False
                        break
                    self.tables[s, len(sl.blocks)] = b
                    sl.blocks.append(b)
                if not ok:
                    break
            if ok:
                return k
            if k == 1:
                return -1
            k = max(1, k // 2)

    def commit_tokens_multi(self, tokens_steps) -> int:
        """Commit k decode steps' tokens [k, max_batch]: row by row through
        the single-step commit, so a slot that finishes (length or EOS) at
        step j skips its rows > j (overshoot trim)."""
        done = 0
        for row in np.asarray(tokens_steps, np.int32):
            done += self.commit_tokens(row)
        return done

    # -- introspection ---------------------------------------------------------

    @property
    def num_active(self) -> int:
        return sum(sl.active for sl in self.slots)

    @property
    def num_queued(self) -> int:
        return len(self.queue)

    @property
    def num_finished(self) -> int:
        return len(self.finished)

    @property
    def num_free_blocks(self) -> int:
        return self.mgr.num_free

    def pop_finished(self) -> Optional[Tuple[int, List[int]]]:
        if not self.finished:
            return None
        r = self.finished.popleft()
        return r.id, r.output

    def stats(self) -> dict:
        return dict(self._stats)


def make_scheduler(max_batch: int, num_blocks: int, block_size: int,
                   max_blocks_per_seq: int, prefix_caching: bool = True,
                   backend: str = "auto"):
    """The scheduler for ``backend``: ``"native"`` the C++ scheduler
    (``mlio_tpu_torch.native``, built with the host's C++ compiler at first
    use; raises with the compiler's message when it does not build),
    ``"python"`` :class:`PyScheduler`, ``"auto"`` the native one where it
    builds, else :class:`PyScheduler`. Each has a ``name``."""
    if backend not in ("auto", "python", "native"):
        raise ValueError(f"unknown scheduler backend {backend!r}")
    if backend != "python":
        from mlio_tpu_torch import native

        if backend == "native" or native.available():
            return native.NativeScheduler(max_batch, num_blocks, block_size,
                                          max_blocks_per_seq, prefix_caching)
    return PyScheduler(max_batch, num_blocks, block_size, max_blocks_per_seq,
                       prefix_caching)
