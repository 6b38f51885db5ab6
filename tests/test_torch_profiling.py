"""The port's profiling package (``mlio_tpu_torch/profiling``) against the
JAX package's and against known answers, on the CPU.

The roofline analyzer, the per-layer memory model and the max-batch search
are held against the JAX package's with the same explicit peak and rates
(the port's own constants are the H100's; its NVLink case is checked at its
own constant). The trace reader is held against hand-written Chrome traces
(known kernel rows and busy unions) and a real ``torch.profiler`` trace of
a small CPU forward. The counted cost of a forward must not depend on the
``Impl`` that runs it: each kernel wrapper counts the products its plain
version computes, so the fused and dense forwards of a tiny model count
the same FLOPs, equal to the analytic count.
"""
import dataclasses
import gzip
import json
import os
import time
import types

import numpy as np
import pytest
import torch

import mlio_tpu.profiling as jprof
from mlio_tpu.models import PRESETS as JAX_PRESETS
from mlio_tpu_torch.models import Impl, load_model
from mlio_tpu_torch.models.spec import ModelSpec
from mlio_tpu_torch.ops import cost
from mlio_tpu_torch.ops import norms
from mlio_tpu_torch.profiling import (BottleneckAnalyzer, BottleneckType, DeviceMemoryTracker,
                                      KernelProfiler, ProfileResults, ProfilerConfig,
                                      ProfilerWrapper, detect_memory_leak, device_busy_ms,
                                      find_max_batch_size, op_table_from_trace, parse_trace,
                                      per_layer_memory, visualizer)
from mlio_tpu_torch.profiling import bottleneck as tb
from mlio_tpu_torch.profiling.trace import OpStats, OpTable
from mlio_tpu_torch.runtime import InferenceRunner

# (wall s, flops, bytes, devices) without comm bytes, at the JAX test's rates
ANALYZE_CASES = {
    "memory_bound": (1e-3, 1e9, 5e8, 1),
    "compute_bound": (1e-3, 2e11, 1e8, 1),
    "overhead": (0.1, 1e9, 1e6, 1),
    "two_devices": (2e-3, 4e11, 2e9, 2),
    "no_flops": (1e-3, 0.0, 3e8, 1),
}
PEAK, GBPS = 197e12, 819.0  # explicit, so both analyzers run at one roofline


@pytest.mark.parametrize("case", list(ANALYZE_CASES), ids=list(ANALYZE_CASES))
def test_analyze_matches_jax(case):
    wall, flops, nbytes, n = ANALYZE_CASES[case]
    want = jprof.BottleneckAnalyzer(peak_flops=PEAK, hbm_gbps=GBPS).analyze(
        wall_time_s=wall, flops=flops, bytes_accessed=nbytes, num_devices=n)
    got = BottleneckAnalyzer(peak_flops=PEAK, hbm_gbps=GBPS).analyze(
        wall_time_s=wall, flops=flops, bytes_accessed=nbytes, num_devices=n)
    assert [b.kind.value for b in got.bottlenecks] == [b.kind.value for b in want.bottlenecks]
    np.testing.assert_allclose([b.severity for b in got.bottlenecks],
                               [b.severity for b in want.bottlenecks], rtol=1e-12)
    assert got.metrics.keys() == want.metrics.keys()
    np.testing.assert_allclose(list(got.metrics.values()), list(want.metrics.values()),
                               rtol=1e-12)
    assert got.to_text() and json.loads(got.to_json())["metrics"]


def test_analyzer_h100_constants_and_nvlink():
    """The defaults are the H100 SXM's; comm bytes cross NVLink at 900 GB/s;
    the suggestions name the card's levers."""
    ana = BottleneckAnalyzer()
    assert ana.peak_flops == 989.4e12 and ana.hbm_bps == 3.35e12
    assert tb.PEAK_FLOPS["int8"] == 1979e12 and tb.PEAK_FLOPS["fp32"] == 66.9e12
    rep = ana.analyze(wall_time_s=2e-3, flops=1e9, bytes_accessed=1e8, comm_bytes=9e8)
    comm = [b for b in rep.bottlenecks if b.kind == BottleneckType.COMMUNICATION][0]
    assert rep.metrics["comm_time_ms"] == pytest.approx(1.0)
    assert comm.severity == pytest.approx(0.5) and "NVLink" in comm.detail
    memory = ana.analyze(wall_time_s=1e-3, flops=1e9, bytes_accessed=3e9)
    assert memory.primary.kind == BottleneckType.MEMORY
    assert "quantize" in " ".join(memory.primary.suggestions)
    over = ana.analyze(wall_time_s=0.1, flops=1e9, bytes_accessed=1e6)
    text = " ".join(b for x in over.bottlenecks for b in x.suggestions)
    assert "CUDA graph" in text and "MXU" not in text and "ICI" not in text


def test_per_op_bound_classifiers_on_table():
    mk = lambda name, fl, by, pct: OpStats(name=name, count=1, total_us=100.0,  # noqa: E731
                                           avg_us=100.0, pct=pct, line="stream 7", flops=fl,
                                           bytes_accessed=by)
    table = OpTable(device="GPU 0", total_us=300.0, ops=[
        mk("big_matmul", 1e12, 1e9, 50.0),       # intensity 1000 > ridge 295
        mk("cache_copy", 0.0, 1e9, 45.0),
        mk("tiny_op", 1e12, 1e9, 0.2),           # below min_pct
        mk("no_stats_op", 0.0, 0.0, 4.8),
    ])
    assert tb.identify_compute_bound_ops(table) == ["big_matmul"]
    assert tb.identify_memory_bound_ops(table) == ["cache_copy"]
    assert tb.identify_compute_bound_ops({"flops": 1e15, "bytes accessed": 1e9}) == ["executable"]
    assert tb.identify_memory_bound_ops({"flops": 1e9, "bytes accessed": 1e9}) == ["executable"]


GATED = dataclasses.replace(JAX_PRESETS["gemma-7b"], name="geglu-gated")


@pytest.mark.parametrize("jspec", [JAX_PRESETS["gpt2"], JAX_PRESETS["llama3-8b"], GATED],
                         ids=["gpt2", "llama3-8b", "geglu"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_per_layer_memory_matches_jax(jspec, dtype):
    import jax.numpy as jnp

    want = jprof.per_layer_memory(jspec, batch_size=2, seq_len=64, dtype=getattr(jnp, dtype))
    spec = ModelSpec(**dataclasses.asdict(jspec))
    got = per_layer_memory(spec, batch_size=2, seq_len=64, dtype=getattr(torch, dtype))
    assert got == {k: int(v) for k, v in want.items()}


def test_find_max_batch_size_matches_jax():
    def make(oom):
        def make_fn(b):
            if b > 37:
                def boom():
                    raise oom("out of memory")
                return boom
            return lambda: torch.zeros(b)
        return make_fn

    assert jprof.find_max_batch_size(make(MemoryError), low=1, high=64) == 37
    assert find_max_batch_size(make(MemoryError), low=1, high=64) == 37
    assert find_max_batch_size(make(torch.cuda.OutOfMemoryError), low=1, high=64) == 37
    assert find_max_batch_size(make(MemoryError), low=40, high=64) == 0
    with pytest.raises(ValueError, match="out of memory"):  # not an OOM: raised
        find_max_batch_size(make(ValueError), low=1, high=64)


def _kernel(name, ts, dur, stream=7, device=0, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "pid": device, "tid": stream, "ts": ts,
            "dur": dur, "args": {"device": device, "stream": stream}}


# name: (intervals in us, their union in ms)
BUSY_CASES = {
    "disjoint": ([(0, 10), (20, 25), (40, 41)], 0.016),
    "overlapping": ([(0, 10), (5, 15), (14, 30)], 0.030),
    "nested": ([(0, 100), (10, 20), (30, 40), (99, 100)], 0.100),
    "mixed": ([(50, 60), (0, 10), (5, 8), (55, 70), (80, 81)], 0.031),
}


@pytest.mark.parametrize("case", list(BUSY_CASES), ids=list(BUSY_CASES))
def test_device_busy_ms_is_the_union(case):
    spans, want = BUSY_CASES[case]
    # Chrome-trace events over two streams, with a host event that must not
    # count, and the same intervals as profiler FunctionEvents
    events = [_kernel("k", s, e - s, stream=7 + i % 2) for i, (s, e) in enumerate(spans)]
    events.append({"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": -50.0, "dur": 500.0,
                   "pid": 1, "tid": 1})
    assert device_busy_ms(events) == pytest.approx(want, abs=1e-12)
    cuda = types.SimpleNamespace(name="CUDA")
    fevents = [types.SimpleNamespace(device_type=cuda, time_range=types.SimpleNamespace(
        start=s, end=e)) for s, e in spans]
    fevents.append(types.SimpleNamespace(device_type=types.SimpleNamespace(name="CPU"),
                                         time_range=types.SimpleNamespace(start=0, end=1e6)))
    assert device_busy_ms(fevents) == pytest.approx(want, abs=1e-12)


def test_op_table_from_synthetic_trace(tmp_path):
    """Known kernels on two streams of GPU 0 and one of GPU 1, a memcpy and
    host events: the table's rows, counts, totals and shares, the filters,
    and the reader on a gzipped file."""
    events = [
        _kernel("void flash_fwd<128>(Args)", 0.0, 40.0),
        _kernel("void flash_fwd<128>(Args)", 100.0, 40.0),
        _kernel("norm_kernel", 50.0, 5.0, stream=8),
        _kernel("norm_kernel", 60.0, 5.0, stream=8),
        _kernel("decode_stack_kernel", 10.0, 100.0, device=1, stream=3),
        _kernel("Memcpy HtoD", 200.0, 10.0, cat="gpu_memcpy"),
        {"ph": "X", "cat": "cpu_op", "name": "aten::empty", "ts": 0.0, "dur": 3.0, "pid": 9,
         "tid": 9},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 5.0},  # not a complete event
    ]
    path = tmp_path / "run" / "trace.pt.trace.json.gz"
    path.parent.mkdir()
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events, "schemaVersion": 1}, f)
    assert len(parse_trace(str(path))) == 7
    table = op_table_from_trace(str(tmp_path))
    assert table.device == "GPU 0,GPU 1" and table.total_us == pytest.approx(200.0)
    rows = {(o.line, o.name): o for o in table.ops}
    flash = rows[("stream 7", "void flash_fwd<128>(Args)")]
    assert (flash.count, flash.total_us, flash.avg_us) == (2, 80.0, 40.0)
    assert flash.pct == pytest.approx(40.0)
    assert rows[("stream 8", "norm_kernel")].count == 2
    assert table.ops[0].name == "decode_stack_kernel"  # the most device time first
    assert [o.name for o in table.slow_ops(threshold_us=30.0)] == [
        "decode_stack_kernel", "void flash_fwd<128>(Args)"]
    assert [o.name for o in table.find("flash")] == ["void flash_fwd<128>(Args)"]
    gpu0 = op_table_from_trace(str(path), device_substr="GPU 0")
    assert gpu0.total_us == pytest.approx(100.0) and len(gpu0.ops) == 3
    assert device_busy_ms(parse_trace(str(path))) == pytest.approx(0.150)  # [0, 140], [200, 210]
    assert "flash_fwd" in table.summary() and table.to_json()["ops"]
    assert op_table_from_trace(str(tmp_path / "none")) is None


def _mlp(x, w1, w2):
    return torch.mm(torch.relu(torch.mm(x, w1)), w2)


def test_cpu_trace_counts_the_calls_made(tmp_path):
    """A real torch.profiler trace of a small CPU forward (two products a
    call): no device events, so the table is the top-level host ops, and
    aten::mm's count is the calls made."""
    g = torch.Generator().manual_seed(0)
    x, w1, w2 = (torch.randn(s, generator=g) for s in ((8, 32), (32, 64), (64, 16)))
    prof = KernelProfiler(warmup=1, steps=3, trace_dir=str(tmp_path / "t"))
    res = prof.profile_function(_mlp, x, w1, w2)
    assert res is not None and res.source == "trace" and res.table.device == "CPU"
    mm = [o for o in res.ops if o.name == "aten::mm"]
    assert len(mm) == 1 and mm[0].count == 2 * 3
    assert [o.name for o in res.ops if o.name == "aten::relu"] == ["aten::relu"]
    assert res.summary() and res.to_json()["ops"] and 0 < res.op_time_fraction() <= 1.0
    report = BottleneckAnalyzer().analyze_op_table(res, top_k=3)
    assert any("aten::mm" in b.detail for b in report.bottlenecks)
    events = parse_trace(str(tmp_path / "t" / "kernels.pt.trace.json"))
    assert device_busy_ms(events) == 0.0
    p = visualizer.plot_op_timeline(events, tmp_path / "tl.png")
    assert os.path.getsize(p) > 1000


def test_profile_segments_table_shape():
    """The two-length marginal fallback on the host clock: one row a
    segment, shares summing to 100. The slow segment sleeps 2 ms a unit, the
    fast one does nothing: a margin no scheduler noise closes."""
    def sleeper(seconds):
        def make(n):
            return lambda: time.sleep(n * seconds)
        return make

    res = KernelProfiler().profile_segments({"fast": sleeper(0.0), "slow": sleeper(2e-3)},
                                            lo=2, hi=10, reps=2, device="cpu")
    assert res.source == "segments" and res.table.device == "CPU"
    assert sorted(o.name for o in res.ops) == ["fast", "slow"]
    assert res.ops[0].name == "slow" and res.ops[0].avg_us > 1000.0
    assert abs(sum(o.pct for o in res.ops) - 100.0) < 1e-6


def test_profile_results_save_load(tmp_path):
    res = ProfileResults(wall_times_s=[0.01, 0.02], cost={"flops": 1e9}, memory={})
    res.save(tmp_path / "res.json")
    back = ProfileResults.load(tmp_path / "res.json")
    assert back.wall_times_s == [0.01, 0.02] and back.cost == {"flops": 1e9}
    res.save(tmp_path / "res.pkl")
    assert ProfileResults.load(tmp_path / "res.pkl").cost["flops"] == 1e9
    assert res.percentile(50) == pytest.approx(0.015) and res.top_costs(1) == [("flops", 1e9)]


def test_visualizer_writes_pngs(tmp_path):
    res = ProfileResults(wall_times_s=[0.01, 0.012, 0.011],
                         cost={"flops": 1e9, "bytes accessed": 1e8}, memory={})
    tracker = DeviceMemoryTracker(device="cpu")
    tracker.start()
    tracker.sample("mid")
    tracker.stop()
    table = OpTable(device="GPU 0", total_us=30.0, ops=[
        OpStats("a", 1, 20.0, 20.0, 66.7, "stream 7"), OpStats("b", 2, 10.0, 5.0, 33.3, "s")])
    paths = visualizer.save_all(res, tmp_path, memory_samples=tracker.samples, op_table=table)
    paths.append(visualizer.plot_op_comparison(table, table, tmp_path / "cmp.png"))
    assert len(paths) == 5
    for p in paths:
        assert os.path.getsize(p) > 1000


def test_memory_tools_on_the_cpu():
    tracker = DeviceMemoryTracker(device="cpu")
    tracker.start()
    tracker.sample("alloc")
    stats = tracker.stop()
    assert stats["num_samples"] == 3 and stats["peak_bytes"] == 0
    report = detect_memory_leak(lambda t: t * 2, torch.ones(64), iterations=4)
    assert report["leaking"] is False and report["readings"] == [0, 0, 0, 0]


def test_counting_an_aten_product_and_a_wrapper():
    """FLOPs and bytes of a plain product; a kernel wrapper on the CPU counts
    its own work once (its plain version's aten ops are not counted)."""
    x, w = torch.randn(8, 32), torch.randn(32, 16)
    with cost.counting() as c:
        x @ w
    assert c.flops == 2 * 8 * 32 * 16 and c.bytes_accessed == (8 * 32 + 32 * 16 + 8 * 16) * 4
    h, s = torch.randn(6, 64), torch.ones(64)
    with cost.counting() as c:
        norms.fused_norm(h, s, s)
    assert c.flops == 0 and c.bytes_accessed == (2 * 6 * 64 + 2 * 64) * 4
    assert c.kernels == {"fused_norm": [0.0, float(c.bytes_accessed)]}


def _analytic_flops(spec, B, S):
    """The products of a cache-free forward: projections, attention's two
    products over every (query, key) pair, the head."""
    H, I, L = spec.hidden_size, spec.intermediate_size, spec.num_layers
    gated = spec.activation in ("swiglu", "geglu")
    proj = H * (spec.q_dim + 2 * spec.kv_dim) + spec.q_dim * H + H * I * (3 if gated else 2)
    attn = 4 * B * spec.num_heads * S * S * spec.head_size
    return L * (2 * B * S * proj + attn) + 2 * B * S * H * spec.vocab_size


FUSED = {"flash+fusion": Impl(attention="flash", mlp="fused", norm="fused"),
         "fused_ln_qkv": Impl(attention="flash", norm="fused", fused_ln_qkv=True)}


@pytest.mark.parametrize("name", ["gpt2-tiny", "llama-tiny"])
def test_profile_model_cost_does_not_depend_on_impl(name, tmp_path):
    """profile_model's counted FLOPs: the analytic count for Impl(), the
    same for the fused Impls (K1, K2, K11, K12 count themselves), and K1's
    count is a share past 1 % (so a missing count would show)."""
    spec, params = load_model(name, dtype=torch.float32, device="cpu", seed=0)
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, spec.vocab_size, (2, 24)))
    want = _analytic_flops(spec, 2, 24)
    prof = ProfilerWrapper(ProfilerConfig(warmup_steps=1, active_steps=3,
                                          trace_dir=str(tmp_path / "trace")))
    dense = prof.profile_model(params, spec, ids, impl=Impl(), name="dense")
    assert len(dense.wall_times_s) == 3 and dense.summary()["mean_ms"] > 0
    assert dense.cost["flops"] == want and dense.cost["bytes accessed"] > 0
    assert len(dense.to_dataframe()) > 0
    assert op_table_from_trace(str(tmp_path / "trace")).ops  # the timed calls' trace
    for impl in FUSED.values():
        fused = prof.profile_model(params, spec, ids, impl=impl)
        assert fused.cost["flops"] == pytest.approx(want, rel=1e-9)
        assert fused.cost["flops flash_attention"] > 0.01 * want
    rep = BottleneckAnalyzer().analyze_profile(dense)
    assert rep.metrics["wall_time_ms"] > 0 and rep.bottlenecks


def test_runner_profile_model():
    spec, params = load_model("gpt2-tiny", dtype=torch.float32, device="cpu", seed=0)
    res = InferenceRunner(spec, params, precision="fp32").profile_model(
        np.zeros((1, 8), np.int64))
    assert len(res.wall_times_s) == 3 and res.cost["flops"] > 0
    assert res.memory["after"]["bytes_in_use"] == 0  # the CPU: no allocator stats
