"""What a traced window's ``torch.profiler`` record says.

- ``busy_s``: the length of the union of the device's activity intervals
  (kernels, copies, fills) inside the window; the copies of the spans that
  the profiler lays on the device's timeline are not activity;
- ``device_ops``: the device operations that took most time, summed by
  name;
- ``idle_gaps``: the longest stretches of the window in which the device
  ran nothing, each named by what the host was doing at its middle: the
  innermost span of the benchmark's own (``record_function``) and the
  innermost operation under it.

The events are read from the profiler's raw Kineto list, which is cheaper
than its event tree for the hundreds of thousands of launches a window
holds.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

SPAN_PREFIX = "bench."
_TOP = 10


class Summary(NamedTuple):
    busy_s: float
    window_s: float
    device_ops: list
    idle_gaps: list
    n_device_events: int


def merge(intervals: np.ndarray) -> np.ndarray:
    """Sorted, disjoint union of [start, end] rows."""
    if len(intervals) == 0:
        return intervals.reshape(0, 2)
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    run_end = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), dtype=bool)
    new[1:] = iv[1:, 0] > run_end[:-1]
    starts = iv[new, 0]
    ends = run_end[np.r_[np.nonzero(new)[0][1:] - 1, len(iv) - 1]]
    return np.stack([starts, ends], 1)


def _host_name(t: float, hs: np.ndarray, he: np.ndarray, names: list) -> str:
    span, op = "host", None
    best_span, best_op = -np.inf, -np.inf
    for i in np.nonzero((hs <= t) & (he >= t))[0]:
        name = names[i]
        if name.startswith(SPAN_PREFIX):
            if hs[i] > best_span:
                best_span, span = hs[i], name
        elif hs[i] > best_op and not name.startswith("cuda"):
            best_op, op = hs[i], name
    return f"{span}:{op}" if op else span


def summarize(prof) -> Summary:
    """Read ``prof`` over the window: from the start of the first span of
    the benchmark's own to the end of the last, in the profiler's clock."""
    from torch.autograd import DeviceType

    dev, hs, he, names, by_name = [], [], [], [], {}
    for e in prof.profiler.kineto_results.events():
        s, t = e.start_ns(), e.end_ns()
        if e.device_type() == DeviceType.CUDA:
            if e.name().startswith(SPAN_PREFIX) or e.is_user_annotation():
                continue                  # a span's copy on the device's timeline, not work
            dev.append((s, t))
            by_name[e.name()] = by_name.get(e.name(), 0) + (t - s)
        elif e.device_type() == DeviceType.CPU:
            hs.append(s)
            he.append(t)
            names.append(e.name())
    spans = [(s, t) for s, t, n in zip(hs, he, names) if n.startswith(SPAN_PREFIX)]
    if not spans:
        raise RuntimeError("the trace holds none of the benchmark's spans")
    t_start_ns, t_end_ns = min(s for s, _ in spans), max(t for _, t in spans)
    iv = np.asarray(dev, dtype=np.float64).reshape(-1, 2)
    iv = np.clip(iv, t_start_ns, t_end_ns)
    u = merge(iv[iv[:, 1] > iv[:, 0]])
    busy_ns = float(np.sum(u[:, 1] - u[:, 0])) if len(u) else 0.0
    edges = np.concatenate([[t_start_ns], u.reshape(-1), [t_end_ns]]).reshape(-1, 2)
    gaps = edges[:, 1] - edges[:, 0]
    top = np.argsort(-gaps, kind="stable")[:_TOP]
    hs, he = np.asarray(hs, dtype=np.float64), np.asarray(he, dtype=np.float64)
    idle = [[_host_name(0.5 * (edges[i, 0] + edges[i, 1]), hs, he, names), float(gaps[i]) / 1e9]
            for i in top if gaps[i] > 0]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:_TOP]
    return Summary(busy_s=busy_ns / 1e9, window_s=(t_end_ns - t_start_ns) / 1e9,
                   device_ops=[[name[:96], ns / 1e9] for name, ns in ops],
                   idle_gaps=idle, n_device_events=len(dev))
