"""Profile plots: step timeline, cost and per-op breakdowns, memory trace,
op comparison and a trace's timeline (``mlio_tpu/profiling/visualizer.py``).

``matplotlib`` is imported inside the functions only: the card's machine
does not have it, and nothing else of the port needs it.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_step_timeline(wall_times_s: Sequence[float], path, title: str = "Step latency") -> str:
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 3))
    t = np.asarray(wall_times_s) * 1e3
    ax.plot(t, marker="o", lw=1)
    ax.set_xlabel("step")
    ax.set_ylabel("latency (ms)")
    ax.set_title(f"{title} (p50 {np.percentile(t, 50):.2f} ms, "
                 f"p99 {np.percentile(t, 99):.2f} ms)")
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return str(path)


def plot_cost_breakdown(costs: Dict[str, float], path, title: str = "Cost breakdown") -> str:
    plt = _plt()
    items = sorted(costs.items(), key=lambda kv: -abs(kv[1]))[:12]
    fig, ax = plt.subplots(figsize=(8, 4))
    names = [k for k, _ in items]
    vals = [v for _, v in items]
    ax.barh(names[::-1], vals[::-1])
    ax.set_title(title)
    ax.set_xlabel("value")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return str(path)


def plot_memory_trace(samples: List[Dict], path, title: str = "Device memory") -> str:
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 3))
    if samples:
        t0 = samples[0]["t"]
        ax.plot([s["t"] - t0 for s in samples],
                [s["bytes_in_use"] / 1e9 for s in samples], label="in use")
        ax.plot([s["t"] - t0 for s in samples],
                [s["peak_bytes_in_use"] / 1e9 for s in samples], label="peak", ls="--")
    ax.set_xlabel("time (s)")
    ax.set_ylabel("GB")
    ax.set_title(title)
    ax.legend()
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return str(path)


def plot_op_breakdown(op_table, path, k: int = 15, title: str = "Per-op device time") -> str:
    """Top-k measured ops of an OpTable as a horizontal bar chart."""
    plt = _plt()
    ops = op_table.top(k)
    fig, ax = plt.subplots(figsize=(9, max(3, 0.35 * len(ops) + 1)))
    names = [o.name[:48] for o in ops][::-1]
    vals = [o.total_us / 1e3 for o in ops][::-1]
    bars = ax.barh(names, vals)
    for bar, o in zip(bars, ops[::-1]):
        ax.text(bar.get_width(), bar.get_y() + bar.get_height() / 2, f" {o.pct:.1f}%",
                va="center", fontsize=8)
    ax.set_xlabel("device time (ms)")
    ax.set_title(f"{title} (total {op_table.total_us / 1e3:.2f} ms)")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return str(path)


def plot_op_comparison(table_a, table_b, path, k: int = 12, label_a: str = "A",
                       label_b: str = "B") -> str:
    """Grouped bars of the union of two tables' top ops, each pair labelled
    with the A/B time ratio."""
    plt = _plt()
    a = {o.name: o.total_us for o in table_a.top(k)}
    b = {o.name: o.total_us for o in table_b.top(k)}
    names = list(dict.fromkeys(list(a) + list(b)))[:k]
    ya = [a.get(n, 0.0) / 1e3 for n in names]
    yb = [b.get(n, 0.0) / 1e3 for n in names]
    x = np.arange(len(names))
    fig, ax = plt.subplots(figsize=(10, 4.5))
    ax.bar(x - 0.2, ya, width=0.4, label=label_a)
    ax.bar(x + 0.2, yb, width=0.4, label=label_b)
    for i, n in enumerate(names):
        if a.get(n) and b.get(n):
            ax.text(i, max(ya[i], yb[i]), f"{a[n] / b[n]:.2f}x", ha="center", fontsize=8)
    ax.set_xticks(x)
    ax.set_xticklabels([n[:24] for n in names], rotation=35, ha="right", fontsize=8)
    ax.set_ylabel("device time (ms)")
    ax.set_title(f"Per-op comparison ({label_a} vs {label_b}; labels = A/B speedup)")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return str(path)


def plot_op_timeline(events: List[dict], path, max_events: int = 400,
                     title: str = "Device op timeline") -> str:
    """Gantt-style timeline of a trace's events (``trace.parse_trace``): one
    row a device stream, or, with no device events, a host thread's
    top-level ops."""
    from mlio_tpu_torch.profiling.trace import device_events, host_op_events

    plt = _plt()
    evs = device_events(events) or host_op_events(events)
    t0 = min((e["ts"] for e in evs), default=0.0)
    rows: Dict[str, list] = {}
    for e in evs:
        key = f"{e.get('pid')}/{e.get('tid')}"
        if len(rows.setdefault(key, [])) < max_events and e.get("dur", 0) > 0:
            rows[key].append(((e["ts"] - t0) / 1e3, e["dur"] / 1e3, e.get("name", "?")))
    fig, ax = plt.subplots(figsize=(10, max(2.5, 0.5 * len(rows) + 1)))
    cmap = plt.get_cmap("tab20")
    name_color: Dict[str, tuple] = {}
    for y, spans in enumerate(rows.values()):
        for off, dur, name in spans:
            c = name_color.setdefault(name, cmap(len(name_color) % 20))
            ax.barh(y, dur, left=off, height=0.6, color=c)
    ax.set_yticks(range(len(rows)))
    ax.set_yticklabels(list(rows), fontsize=7)
    ax.set_xlabel("time (ms)")
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return str(path)


def save_all(profile_results, out_dir, memory_samples=None, op_table=None) -> List[str]:
    """The step timeline and cost breakdown of a ProfileResults, and the
    memory trace and per-op breakdown when given."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    paths = [
        plot_step_timeline(profile_results.wall_times_s, out / "timeline.png"),
        plot_cost_breakdown(profile_results.cost, out / "cost_breakdown.png"),
    ]
    if memory_samples:
        paths.append(plot_memory_trace(memory_samples, out / "memory.png"))
    if op_table is not None:
        paths.append(plot_op_breakdown(op_table, out / "op_breakdown.png"))
    return paths
