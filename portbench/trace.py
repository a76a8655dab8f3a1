"""Reduce a torch.profiler trace of the measured window to what the
per-layer readers and the result's breakdown need: the device operations
(kernels, copies, memsets) and the benchmark's own spans, on one clock."""

from __future__ import annotations

import numpy as np


def reduce(prof, span_names) -> dict:
    """{"ops": [(name, start_us, end_us)], "spans": [(name, start_us,
    end_us)]} from a finished torch.profiler.profile: the device's
    operations, and the benchmark's spans named `span_names`."""
    from torch.autograd import DeviceType

    ops, spans = [], []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            ops.append((e.name, float(tr.start), float(tr.end)))
        elif e.name in span_names:
            spans.append((e.name, float(tr.start), float(tr.end)))
    ops.sort(key=lambda o: o[1])
    spans.sort(key=lambda s: s[1])
    return {"ops": ops, "spans": spans}


def device_time(prof) -> dict:
    """The device's time in a finished CUDA-only torch.profiler.profile:
    the union of its kernels', copies' and memsets' intervals (busy_s),
    their summed durations (op_s) and their count.  Read straight from
    the profiler's own events, which a whole window's trace needs: the
    per-event objects of prof.events() take longer to build than a run
    may last."""
    from torch.autograd import DeviceType

    iv = [(e.start_ns(), e.start_ns() + e.duration_ns())
          for e in prof.profiler.kineto_results.events()
          if e.device_type() == DeviceType.CUDA]
    if not iv:
        return {"busy_s": 0.0, "op_s": 0.0, "n_ops": 0}
    iv = np.array(iv, np.float64)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    # union of the intervals: a new run starts where an interval begins
    # after every earlier one has ended
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    stops = ends[np.r_[np.flatnonzero(new)[1:] - 1, len(iv) - 1]]
    return {"busy_s": float((stops - starts).sum()) * 1e-9,
            "op_s": float((iv[:, 1] - iv[:, 0]).sum()) * 1e-9,
            "n_ops": int(len(iv))}


def summarise(tr: dict) -> dict:
    """The traced window (first span's start to last span's end), the
    device's busy time in it (the union of operation intervals), the
    summed time of each operation name, and the idle gaps, each labelled
    by the span open at its middle ("between" where none is)."""
    spans = tr["spans"]
    if not spans:
        return {}
    w0 = min(s[1] for s in spans)
    w1 = max(s[2] for s in spans)
    iv = np.array([(a, b) for _, a, b in tr["ops"]], np.float64)\
        .reshape(-1, 2)
    iv = np.clip(iv, w0, w1)
    iv = iv[iv[:, 1] > iv[:, 0]]
    merged = []
    for a, b in iv[np.argsort(iv[:, 0], kind="stable")]:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    gaps, cur = [], w0
    for a, b in merged + [[w1, w1]]:
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    s_start = np.array([s[1] for s in spans])
    s_end = np.array([s[2] for s in spans])
    labelled = []
    for a, b in gaps:
        mid = 0.5 * (a + b)
        k = np.flatnonzero((s_start <= mid) & (s_end >= mid))
        labelled.append((spans[k[-1]][0] if k.size else "between",
                         (b - a) * 1e-6))
    by_name = {}
    for name, a, b in tr["ops"]:
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy * 1e-6,
            "op_s": by_name, "gaps": labelled,
            "device_s": sum(by_name.values())}


def breakdown(summary: dict, top: int = 10) -> dict:
    """The device operations that took most time and the longest idle
    gaps, each list at most `top` long."""
    ops = sorted(summary["op_s"].items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(summary["gaps"], key=lambda g: -g[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps]}


def matching_s(summary: dict, patterns) -> float:
    """Device seconds of the operations whose name holds any pattern."""
    return sum(v for k, v in summary["op_s"].items()
               if any(p in k for p in patterns))
