"""The traced run's device record: ``torch.profiler`` over the window, kept in memory.

``Trace.collect`` reads the profiler's raw events once: the device's
operations (kernels, copies, fills) inside the window's span, and the host's
operations and the benchmark's own spans, to say what the host was doing in
each gap. Nothing is written to disk.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

import torch

WINDOW_SPAN = "bench.window"
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _kinds(events) -> list:
    """(name, start_ns, dur_ns, kind, correlation) of every event. The kind is
    kineto's where this PyTorch gives it; else it follows from the device,
    the name and whether the event is an annotation (a ``record_function``
    span appears on the device too)."""
    if not events:
        return []
    first = events[0]
    has_kind, has_annotation = hasattr(first, "activity_type"), hasattr(first, "is_user_annotation")
    in_ns = hasattr(first, "start_ns")
    cuda = torch.autograd.DeviceType.CUDA
    rows = []
    for e in events:
        name = e.name()
        start, dur = (e.start_ns(), e.duration_ns()) if in_ns else (e.start_us() * 1000, e.duration_us() * 1000)
        on_device = e.device_type() == cuda
        kind = e.activity_type() if has_kind else ""
        if not kind:
            annotation = name.startswith("bench.") or (has_annotation and e.is_user_annotation())
            if not on_device:
                kind = "user_annotation" if annotation else "cuda_runtime" if name.startswith("cuda") else "cpu_op"
            elif annotation:
                kind = "gpu_user_annotation"
            else:
                kind = "gpu_memcpy" if name.startswith("Memcpy") else "gpu_memset" if name.startswith(
                    "Memset") else "kernel"
        corr = e.correlation_id() if kind in DEVICE_ACTIVITIES or kind == "cuda_runtime" else 0
        rows.append((name, start, dur, kind, corr))
    return rows


@dataclass
class Trace:
    window_ns: tuple[int, int] = (0, 0)
    device_ops: list = field(default_factory=list)  # (name, start_ns, dur_ns, activity, correlation)
    host_ops: list = field(default_factory=list)  # (start_ns, end_ns, name), sorted by start
    spans: list = field(default_factory=list)  # the benchmark's spans: (start_ns, end_ns, name)
    launches: dict = field(default_factory=dict)  # correlation -> launch start_ns

    @classmethod
    def collect(cls, prof) -> "Trace":
        tr = cls()
        rows = _kinds(prof.profiler.kineto_results.events())
        for name, start, dur, kind, _ in rows:
            if name == WINDOW_SPAN and kind == "user_annotation":
                tr.window_ns = (start, start + dur)
        lo, hi = tr.window_ns
        for name, start, dur, kind, corr in rows:
            if start + dur < lo or start > hi:
                continue
            if kind in DEVICE_ACTIVITIES:
                tr.device_ops.append((name, start, dur, kind, corr))
            elif kind == "cuda_runtime":
                tr.launches[corr] = start
            elif kind == "user_annotation" and name.startswith("bench."):
                tr.spans.append((start, start + dur, name))
            elif kind == "cpu_op":
                tr.host_ops.append((start, start + dur, name))
        tr.device_ops.sort(key=lambda o: o[1])
        tr.host_ops.sort()
        tr.spans.sort()
        return tr

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    def kernels(self, part: str | None = None) -> list:
        """The kernels in the window, or those whose name holds ``part``."""
        return [o for o in self.device_ops if o[3] == "kernel" and (part is None or part in o[0])]

    def busy_intervals(self) -> list[tuple[int, int]]:
        """The union of the device's operations, clipped to the window."""
        lo, hi = self.window_ns
        merged: list[list[int]] = []
        for _, start, dur, _, _ in self.device_ops:
            s, e = max(start, lo), min(start + dur, hi)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def top_device_ops(self, n: int = 10) -> list:
        """The device operations that took the most time, by name, seconds."""
        total: dict = defaultdict(int)
        for name, _, dur, _, _ in self.device_ops:
            total[name[:160]] += dur
        return [[name, ns / 1e9] for name, ns in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def _host_at(self, t: int) -> str:
        """The innermost host operation running at ``t`` (its start the latest
        among those that contain t)."""
        i = bisect.bisect_right(self.host_ops, (t, float("inf"), "")) - 1
        for j in range(i, max(i - 512, -1), -1):
            s, e, name = self.host_ops[j]
            if s <= t <= e:
                return name
        return "no host operation"

    def _span_at(self, t: int) -> str:
        inner = "outside any request"
        for s, e, name in self.spans:
            if s > t:
                break
            if e >= t:
                inner = name
        return inner

    def top_idle_gaps(self, n: int = 10) -> list:
        """The longest stretches with nothing on the device, each named by the
        benchmark's span around it and the host operation that launched the
        device's next operation (or ran when the gap began)."""
        busy = self.busy_intervals()
        lo, hi = self.window_ns
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:n]
        starts = [o[1] for o in self.device_ops]
        out = []
        for dur, g0, g1 in gaps:
            k = bisect.bisect_left(starts, g1)
            launched = self.launches.get(self.device_ops[k][4]) if k < len(self.device_ops) else None
            host = self._host_at(launched if launched is not None else g0)
            out.append([f"{self._span_at(g0)} / {host}", dur / 1e9])
        return out
