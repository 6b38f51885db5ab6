// mlio_tpu_torch native runtime: paged-KV block allocator + continuous-
// batching scheduler (the port's copy of mlio_tpu/native/src/mlio_runtime.cc).
//
// Between decode dispatches the host's bookkeeping (block accounting, table
// assembly, token commit, finish and preemption decisions) is the
// serialisation point of the engine; this library does it in one C call over
// flat buffers that numpy wraps zero-copy. The policy is the Python
// scheduler's (mlio_tpu_torch/runtime/scheduler.py), which the tests hold it
// to step by step.
//
// One change from the JAX package's copy: plan_multi_step returns -1 when even
// a one-step chunk's blocks could not all be allocated (the JAX copy returns
// 1 and its pipelined loop dispatches that chunk past an exhausted pool).
//
// Pure C ABI (ctypes-friendly): no exceptions across the boundary, no C++
// types in signatures. Errors return negative codes.

#include <cstdint>
#include <cstring>
#include <deque>
#include <unordered_map>
#include <vector>

namespace {

constexpr int kScratchBlock = 0;  // inactive slots write here, never freed

// ---------------------------------------------------------------------------
// Block allocator: free list + refcounts + prefix-hash reuse
// ---------------------------------------------------------------------------

struct BlockManager {
  int num_blocks = 0;
  int block_size = 0;
  std::vector<int> free_list;           // LIFO for cache locality
  std::vector<int32_t> refcounts;
  // Prefix cache: chained hash of a full block's token ids -> block id.
  // The cache HOLDS ONE REFCOUNT on every published block, so cached KV
  // content stays valid after the owning request finishes; cache-only
  // blocks (refcount==1) are lazily evicted when allocation runs dry.
  std::unordered_map<uint64_t, int> prefix_map;
  std::vector<uint64_t> block_hash;     // 0 = unhashed
  std::deque<int> evict_fifo;           // cache-only candidates, oldest first

  explicit BlockManager(int blocks, int bsize)
      : num_blocks(blocks), block_size(bsize),
        refcounts(blocks, 0), block_hash(blocks, 0) {
    free_list.reserve(blocks);
    for (int i = blocks - 1; i >= 1; --i) free_list.push_back(i);
    refcounts[kScratchBlock] = 1;  // pinned scratch
  }

  int num_free() const { return static_cast<int>(free_list.size()); }

  // Drop the oldest cache-only block (entries are validated lazily — a
  // block re-forked since being queued is skipped). Returns it with
  // refcount 0, or -1 if nothing is evictable.
  int evict_cached() {
    while (!evict_fifo.empty()) {
      int b = evict_fifo.front();
      evict_fifo.pop_front();
      if (refcounts[b] == 1 && block_hash[b]) {
        prefix_map.erase(block_hash[b]);
        block_hash[b] = 0;
        refcounts[b] = 0;
        return b;
      }
    }
    return -1;
  }

  int allocate() {
    int b;
    if (!free_list.empty()) {
      b = free_list.back();
      free_list.pop_back();
    } else {
      b = evict_cached();
      if (b < 0) return -1;
    }
    refcounts[b] = 1;
    return b;
  }

  int fork(int b) {                  // copy-on-write share
    if (b < 0 || b >= num_blocks || refcounts[b] <= 0) return -1;
    ++refcounts[b];
    return b;
  }

  int free_block(int b) {
    if (b < 0 || b >= num_blocks || refcounts[b] <= 0) return -1;
    if (--refcounts[b] == 0) {
      free_list.push_back(b);
    } else if (refcounts[b] == 1 && block_hash[b]) {
      evict_fifo.push_back(b);       // now cache-only: eviction candidate
    }
    return 0;
  }

  // FNV-1a over the chained (prev_hash, tokens) — position-sensitive so the
  // same token block at a different depth hashes differently.
  static uint64_t chain_hash(uint64_t prev, const int32_t* toks, int n) {
    uint64_t h = 1469598103934665603ull ^ prev;
    for (int i = 0; i < n; ++i) {
      h ^= static_cast<uint64_t>(static_cast<uint32_t>(toks[i]));
      h *= 1099511628211ull;
    }
    return h ? h : 1;  // reserve 0 for "unhashed"
  }

  // Register a full block's content for prefix reuse; the cache takes a
  // refcount so the KV content outlives the publishing request.
  void publish(int b, uint64_t hash) {
    if (refcounts[b] <= 0 || !hash || block_hash[b]) return;
    auto it = prefix_map.find(hash);
    if (it != prefix_map.end()) return;  // first writer wins
    prefix_map[hash] = b;
    block_hash[b] = hash;
    ++refcounts[b];
  }

  // Look up a published block; returns -1 on miss.
  int lookup(uint64_t hash) const {
    auto it = prefix_map.find(hash);
    return it == prefix_map.end() ? -1 : it->second;
  }
};

// ---------------------------------------------------------------------------
// Continuous-batching scheduler
// ---------------------------------------------------------------------------

struct Req {
  int64_t id = -1;
  std::vector<int32_t> prompt;     // tokens to prefill (incl. regenerated)
  std::vector<int32_t> output;     // generated tokens (kept across preempt)
  int max_new = 0;                 // total generation budget
  int32_t eos = -1;                // -1 = none
  int num_cached = 0;              // prompt tokens already in reused blocks
};

struct Slot {
  Req req;
  std::vector<int> blocks;
  bool active = false;
  int64_t admit_seq = 0;           // admission order, for preemption policy
};

struct Scheduler {
  int max_batch, block_size, max_blocks_per_seq;
  BlockManager mgr;
  bool prefix_caching;

  std::vector<Slot> slots;
  std::deque<Req> queue;           // preempted requests go to the FRONT
  std::deque<Req> finished;
  int64_t next_id = 0;
  int64_t admit_counter = 0;

  // flat per-slot device-mirror state (numpy wraps these zero-copy)
  std::vector<int32_t> tables;     // [max_batch, max_blocks_per_seq]
  std::vector<int32_t> ctx;        // [max_batch] context length (>=1)
  std::vector<int32_t> cur;        // [max_batch] last sampled token

  // per-admit scratch: slots admitted this call
  std::vector<int32_t> admitted;

  // counters
  int64_t n_preempted = 0, n_prefills = 0, n_generated = 0;
  int64_t n_prefix_hits = 0;       // blocks reused via prefix cache

  Scheduler(int mb, int blocks, int bsize, int mbps, bool prefix)
      : max_batch(mb), block_size(bsize), max_blocks_per_seq(mbps),
        mgr(blocks, bsize), prefix_caching(prefix),
        slots(mb), tables(static_cast<size_t>(mb) * mbps, kScratchBlock),
        ctx(mb, 1), cur(mb, 0) {}

  int32_t* table_row(int slot) {
    return tables.data() + static_cast<size_t>(slot) * max_blocks_per_seq;
  }

  int64_t submit(const int32_t* prompt, int n, int max_new, int32_t eos) {
    // admission control: a request whose worst case cannot fit in the pool
    // would preempt forever (recompute livelock) — reject up front.
    // Final context length is n+max_new; the post-final-token grow never
    // runs (finish fires first), so the true worst is ceil((n+max_new)/bs).
    int worst = (n + max_new + block_size - 1) / block_size;
    if (worst > max_blocks_per_seq || worst > mgr.num_blocks - 1) return -1;
    Req r;
    r.id = next_id++;
    r.prompt.assign(prompt, prompt + n);
    r.max_new = max_new;
    r.eos = eos;
    queue.push_back(std::move(r));
    return queue.back().id;
  }

  void reset_slot(int s) {
    Slot& sl = slots[s];
    for (int b : sl.blocks) mgr.free_block(b);
    sl.blocks.clear();
    sl.active = false;
    sl.req = Req{};
    std::fill(table_row(s), table_row(s) + max_blocks_per_seq, kScratchBlock);
    ctx[s] = 1;
    cur[s] = 0;
  }

  // Try to serve a prompt prefix from the prefix cache. Returns the number
  // of leading FULL blocks reused (their ids appended to `blocks`, forked).
  int try_prefix_reuse(const Req& r, std::vector<int>& blocks) {
    if (!prefix_caching) return 0;
    int full = static_cast<int>(r.prompt.size()) / block_size;
    // never reuse every block: the last prompt token must be recomputed so
    // prefill produces its logits
    if (full * block_size == static_cast<int>(r.prompt.size())) --full;
    uint64_t h = 0;
    int reused = 0;
    for (int i = 0; i < full; ++i) {
      h = BlockManager::chain_hash(h, r.prompt.data() + i * block_size,
                                   block_size);
      int b = mgr.lookup(h);
      if (b < 0 || mgr.fork(b) < 0) break;
      blocks.push_back(b);
      ++reused;
    }
    n_prefix_hits += reused;
    return reused;
  }

  // Publish the full prompt blocks a slot just prefilled.
  void publish_prompt_blocks(const Slot& sl) {
    if (!prefix_caching) return;
    const Req& r = sl.req;
    int full = static_cast<int>(r.prompt.size()) / block_size;
    if (full * block_size == static_cast<int>(r.prompt.size())) --full;
    uint64_t h = 0;
    for (int i = 0; i < full && i < static_cast<int>(sl.blocks.size()); ++i) {
      h = BlockManager::chain_hash(h, r.prompt.data() + i * block_size,
                                   block_size);
      mgr.publish(sl.blocks[i], h);
    }
  }

  // Admit queued requests into free slots. Fills `admitted` with slot ids
  // needing prefill. Allocates blocks for the prompt plus ONE growth block
  // (incremental allocation: decode grows block-by-block, preempting on
  // exhaustion, instead of reserving the worst case up front).
  int admit() {
    admitted.clear();
    for (int s = 0; s < max_batch && !queue.empty(); ++s) {
      if (slots[s].active) continue;
      Req& r = queue.front();
      // Blocks for prompt positions 0..n-1 PLUS the first decode write at
      // position n: floor(n/bs)+1 (== ceil(n/bs) unless n divides evenly).
      int prompt_blocks = static_cast<int>(r.prompt.size()) / block_size + 1;
      if (prompt_blocks > max_blocks_per_seq) return -2;  // too long
      std::vector<int> blocks;
      int reused = try_prefix_reuse(r, blocks);
      int need = prompt_blocks - reused;
      // try-allocate (free list + cache eviction), roll back on shortfall
      bool ok = true;
      for (int i = 0; i < need; ++i) {
        int b = mgr.allocate();
        if (b < 0) { ok = false; break; }
        blocks.push_back(b);
      }
      if (!ok) {
        for (int b : blocks) mgr.free_block(b);
        break;  // wait for completions
      }
      Slot& sl = slots[s];
      sl.req = std::move(r);
      queue.pop_front();
      sl.req.num_cached = reused * block_size;
      sl.blocks = std::move(blocks);
      sl.active = true;
      sl.admit_seq = admit_counter++;
      std::fill(table_row(s), table_row(s) + max_blocks_per_seq,
                kScratchBlock);
      for (size_t i = 0; i < sl.blocks.size(); ++i)
        table_row(s)[i] = sl.blocks[i];
      ctx[s] = 1;   // updated by commit_prefill
      cur[s] = 0;
      admitted.push_back(s);
    }
    return static_cast<int>(admitted.size());
  }

  bool finish_if_done(int s) {
    Slot& sl = slots[s];
    const Req& r = sl.req;
    bool done = static_cast<int>(r.output.size()) >= r.max_new ||
                (r.eos >= 0 && !r.output.empty() && r.output.back() == r.eos);
    if (!done) return false;
    publish_prompt_blocks(sl);
    finished.push_back(std::move(sl.req));
    reset_slot(s);
    return true;
  }

  // Record the sampled first token after a slot's prefill.
  int commit_prefill(int s, int32_t token) {
    Slot& sl = slots[s];
    if (!sl.active) return -1;
    sl.req.output.push_back(token);
    cur[s] = token;
    ctx[s] = static_cast<int32_t>(sl.req.prompt.size()) + 1;
    ++n_prefills;
    ++n_generated;
    finish_if_done(s);
    return 0;
  }

  // Pipelined prefill: ctx advances now (decode planning needs it), the
  // device-sampled token arrives later via resolve_prefill.
  int commit_prefill_pending(int s) {
    Slot& sl = slots[s];
    if (!sl.active) return -1;
    ctx[s] = static_cast<int32_t>(sl.req.prompt.size()) + 1;
    ++n_prefills;
    return 0;
  }
  int resolve_prefill(int s, int32_t token) {
    Slot& sl = slots[s];
    if (!sl.active) return -1;
    sl.req.output.push_back(token);
    cur[s] = token;
    ++n_generated;
    finish_if_done(s);
    return 0;
  }

  // Preempt the youngest active slot (recompute policy): its blocks are
  // freed and the request re-queued at the FRONT with prompt+output as the
  // new prompt, so no generated tokens are lost.
  int preempt_youngest(int except_slot) {
    int victim = -1;
    int64_t best = -1;
    for (int s = 0; s < max_batch; ++s) {
      if (!slots[s].active || s == except_slot) continue;
      if (slots[s].admit_seq > best) { best = slots[s].admit_seq; victim = s; }
    }
    if (victim < 0) return -1;
    Slot& sl = slots[victim];
    Req r = std::move(sl.req);
    r.prompt.insert(r.prompt.end(), r.output.begin(), r.output.end());
    r.num_cached = 0;
    queue.push_front(std::move(r));
    reset_slot(victim);
    ++n_preempted;
    return victim;
  }

  // One decode step's bookkeeping for ALL slots: append sampled tokens,
  // grow block tables across boundaries (preempting on exhaustion), finish
  // EOS/max-token requests. `tokens` is [max_batch]; inactive slots ignored.
  // Returns number of finished requests this call, or negative error.
  int commit_tokens(const int32_t* tokens) {
    int done = 0;
    for (int s = 0; s < max_batch; ++s) {
      Slot& sl = slots[s];
      if (!sl.active) continue;
      sl.req.output.push_back(tokens[s]);
      cur[s] = tokens[s];
      ctx[s] += 1;
      ++n_generated;
      if (finish_if_done(s)) { ++done; continue; }
      // grow: the next decode writes at position ctx-1, so we need
      // floor((ctx-1)/bs)+1 = ceil(ctx/bs) blocks.
      int needed = (ctx[s] + block_size - 1) / block_size;
      while (static_cast<int>(sl.blocks.size()) < needed) {
        if (needed > max_blocks_per_seq) {  // hit table capacity: finish
          finished.push_back(std::move(sl.req));
          reset_slot(s);
          ++done;
          break;
        }
        int b = mgr.allocate();
        if (b < 0) {
          // out of memory: preempt someone else, or self as last resort
          if (preempt_youngest(s) < 0) {
            Req r = std::move(sl.req);
            r.prompt.insert(r.prompt.end(), r.output.begin(), r.output.end());
            r.num_cached = 0;
            queue.push_front(std::move(r));
            reset_slot(s);
            ++n_preempted;
            break;
          }
          continue;  // retry allocation
        }
        table_row(s)[sl.blocks.size()] = b;
        sl.blocks.push_back(b);
      }
    }
    return done;
  }

  // Multi-step scheduling plan: largest k <= k_max every active slot can
  // decode WITHOUT host intervention — bounded by each slot's remaining
  // generation budget, with the chunk's KV blocks PREALLOCATED here so
  // the device can scan k paged-decode steps in one dispatch. EOS
  // finishes mid-chunk stay exact: commit (called per row) trims at the
  // EOS. Never preempts for speculative headroom — on block shortage k
  // shrinks instead. Returns 0 when nothing is active.
  // `reserve`: uncommitted positions already dispatched (the engine's
  // pipelined mode plans chunk N+1 before chunk N's tokens arrive, so
  // blocks must cover ctx + reserve + k). Returns -1 when even k = 1 could
  // not be covered (the blocks it did allocate stay with their slots): the
  // caller must not dispatch past the committed positions, and takes a
  // synchronous step, whose commit preempts.
  int plan_multi_step(int k_max, int reserve = 0) {
    bool any = false;
    for (int s = 0; s < max_batch; ++s) {
      if (slots[s].active) { any = true; break; }
    }
    if (!any) return 0;
    // no remaining-budget cap: length/EOS finishes are trimmed at commit,
    // so k stays constant (one chunk shape) at the cost of <= k-1
    // discarded device steps per finishing sequence
    int k = k_max > 0 ? k_max : 1;
    for (;;) {
      bool ok = true;
      for (int s = 0; s < max_batch && ok; ++s) {
        Slot& sl = slots[s];
        if (!sl.active) continue;
        int needed = (ctx[s] + reserve + k + block_size - 1) / block_size;
        if (needed > max_blocks_per_seq) needed = max_blocks_per_seq;
        while (static_cast<int>(sl.blocks.size()) < needed) {
          int b = mgr.allocate();
          if (b < 0) { ok = false; break; }
          table_row(s)[sl.blocks.size()] = b;
          sl.blocks.push_back(b);
        }
      }
      if (ok) return k;
      if (k == 1) return -1;
      k = k / 2 > 0 ? k / 2 : 1;
    }
  }

  int num_active() const {
    int n = 0;
    for (const Slot& s : slots) n += s.active;
    return n;
  }
};

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

// ---- block manager --------------------------------------------------------

void* mlio_bm_create(int num_blocks, int block_size) {
  return new BlockManager(num_blocks, block_size);
}
void mlio_bm_destroy(void* h) { delete static_cast<BlockManager*>(h); }
int mlio_bm_num_free(void* h) {
  return static_cast<BlockManager*>(h)->num_free();
}
int mlio_bm_allocate(void* h) {
  return static_cast<BlockManager*>(h)->allocate();
}
int mlio_bm_fork(void* h, int b) {
  return static_cast<BlockManager*>(h)->fork(b);
}
int mlio_bm_free(void* h, int b) {
  return static_cast<BlockManager*>(h)->free_block(b);
}
int mlio_bm_refcount(void* h, int b) {
  BlockManager* m = static_cast<BlockManager*>(h);
  return (b < 0 || b >= m->num_blocks) ? -1 : m->refcounts[b];
}

// ---- scheduler --------------------------------------------------------------

void* mlio_sched_create(int max_batch, int num_blocks, int block_size,
                        int max_blocks_per_seq, int prefix_caching) {
  if (max_batch <= 0 || num_blocks <= 1 || block_size <= 0 ||
      max_blocks_per_seq <= 0)
    return nullptr;
  return new Scheduler(max_batch, num_blocks, block_size, max_blocks_per_seq,
                       prefix_caching != 0);
}
void mlio_sched_destroy(void* h) { delete static_cast<Scheduler*>(h); }

long long mlio_sched_submit(void* h, const int32_t* prompt, int n,
                            int max_new, int32_t eos) {
  if (n <= 0 || max_new <= 0) return -1;
  return static_cast<Scheduler*>(h)->submit(prompt, n, max_new, eos);
}

int mlio_sched_admit(void* h) { return static_cast<Scheduler*>(h)->admit(); }

// slots admitted by the last admit() call
const int32_t* mlio_sched_admitted(void* h) {
  return static_cast<Scheduler*>(h)->admitted.data();
}

// prompt of the request occupying `slot` (for prefill); returns length,
// copies up to cap tokens. `num_cached_out` gets the prefix-reused count.
int mlio_sched_slot_prompt(void* h, int slot, int32_t* out, int cap,
                           int32_t* num_cached_out) {
  Scheduler* s = static_cast<Scheduler*>(h);
  if (slot < 0 || slot >= s->max_batch || !s->slots[slot].active) return -1;
  const Req& r = s->slots[slot].req;
  int n = static_cast<int>(r.prompt.size());
  if (out) std::memcpy(out, r.prompt.data(),
                       sizeof(int32_t) * (n < cap ? n : cap));
  if (num_cached_out) *num_cached_out = r.num_cached;
  return n;
}

long long mlio_sched_slot_req_id(void* h, int slot) {
  Scheduler* s = static_cast<Scheduler*>(h);
  if (slot < 0 || slot >= s->max_batch || !s->slots[slot].active) return -1;
  return s->slots[slot].req.id;
}

int mlio_sched_commit_prefill(void* h, int slot, int32_t token) {
  return static_cast<Scheduler*>(h)->commit_prefill(slot, token);
}
int mlio_sched_commit_prefill_pending(void* h, int slot) {
  return static_cast<Scheduler*>(h)->commit_prefill_pending(slot);
}
int mlio_sched_resolve_prefill(void* h, int slot, int32_t token) {
  return static_cast<Scheduler*>(h)->resolve_prefill(slot, token);
}
// the chunk's k; 0 when nothing is active; -1 when even k = 1 is not covered
int mlio_sched_plan_multi_step(void* h, int k_max) {
  return static_cast<Scheduler*>(h)->plan_multi_step(k_max);
}
int mlio_sched_plan_multi_step_r(void* h, int k_max, int reserve) {
  return static_cast<Scheduler*>(h)->plan_multi_step(k_max, reserve);
}

int mlio_sched_commit_tokens(void* h, const int32_t* tokens) {
  return static_cast<Scheduler*>(h)->commit_tokens(tokens);
}

// zero-copy views of the per-slot device-mirror state
int32_t* mlio_sched_tables(void* h) {
  return static_cast<Scheduler*>(h)->tables.data();
}
int32_t* mlio_sched_ctx(void* h) {
  return static_cast<Scheduler*>(h)->ctx.data();
}
int32_t* mlio_sched_cur(void* h) {
  return static_cast<Scheduler*>(h)->cur.data();
}

int mlio_sched_num_active(void* h) {
  return static_cast<Scheduler*>(h)->num_active();
}
int mlio_sched_num_queued(void* h) {
  return static_cast<int>(static_cast<Scheduler*>(h)->queue.size());
}
int mlio_sched_num_finished(void* h) {
  return static_cast<int>(static_cast<Scheduler*>(h)->finished.size());
}
int mlio_sched_num_free_blocks(void* h) {
  return static_cast<Scheduler*>(h)->mgr.num_free();
}

// pop the oldest finished request: returns req id, copies its generated
// tokens (up to cap) into out, stores count in n_out. -1 when none.
long long mlio_sched_pop_finished(void* h, int32_t* out, int cap,
                                  int32_t* n_out) {
  Scheduler* s = static_cast<Scheduler*>(h);
  if (s->finished.empty()) return -1;
  Req r = std::move(s->finished.front());
  s->finished.pop_front();
  int n = static_cast<int>(r.output.size());
  if (out) std::memcpy(out, r.output.data(),
                       sizeof(int32_t) * (n < cap ? n : cap));
  if (n_out) *n_out = n;
  return r.id;
}

// counters: [preempted, prefills, generated, prefix_hit_blocks]
void mlio_sched_stats(void* h, long long* out4) {
  Scheduler* s = static_cast<Scheduler*>(h);
  out4[0] = s->n_preempted;
  out4[1] = s->n_prefills;
  out4[2] = s->n_generated;
  out4[3] = s->n_prefix_hits;
}

}  // extern "C"
