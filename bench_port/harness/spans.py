"""The program's own spans set against the traced window's device record.

The program records its spans (``qwen3_tts_tpu_torch.profiling.annotate``:
name, request, parent, start and end on the clock of the profiler's events)
while ``torch.profiler`` runs, and ``profiling.recorded_spans()`` returns
them. Here they meet ``Trace``: the window's idle time is split at the
spans' edges, each piece going to the kind of the innermost span open on the
host over it (``SPAN_KIND``; a ``q3.wait`` or a span not named there takes
its parent's kind; no span open: ``outside``, the benchmark's own loop), so
the five shares of a run sum to its ``device_idle_share``. The readers share
one analysis a run, and return None where the trace holds no device
operation or the window no program span (a program that records none).
Nothing here clears the program's record.
"""

from __future__ import annotations

import bisect

from . import program
from .stats import percentile

KINDS = ("prefill", "loop", "vocoder", "session", "outside")
SPAN_KIND = {"q3.open": "session", "q3.chunk": "session", "q3.audio": "session", "q3.grow": "session",
             "q3.prefill": "prefill", "q3.loop": "loop", "q3.vocoder": "vocoder"}


def recorded() -> list:
    """Every span the program recorded under the profiler; [] where it
    records none."""
    profiling = getattr(program.q, "profiling", None)
    read = getattr(profiling, "recorded_spans", None)
    return list(read()) if read is not None else []


def kind(span) -> str:
    """The kind a span's time goes to: its own, else its nearest ancestor's."""
    while span is not None:
        if span.name in SPAN_KIND:
            return SPAN_KIND[span.name]
        span = span.parent
    return "outside"


def _depth(span) -> int:
    d = 0
    while span.parent is not None:
        span, d = span.parent, d + 1
    return d


def host_segments(spans: list, lo: int, hi: int) -> list[tuple[int, int, str]]:
    """[lo, hi) cut at every span edge: (start, end, the kind of the
    innermost span open over it), neighbours of one kind merged."""
    spans = sorted((s for s in spans if s.end_ns > lo and s.start_ns < hi), key=lambda s: s.start_ns)
    depth = {id(s): _depth(s) for s in spans}
    points = sorted({lo, hi} | {min(max(t, lo), hi) for s in spans for t in (s.start_ns, s.end_ns)})
    out: list = []
    active: list = []
    i = 0
    for a, b in zip(points, points[1:]):
        while i < len(spans) and spans[i].start_ns <= a:
            active.append(spans[i])
            i += 1
        active = [s for s in active if s.end_ns > a]
        inner = max(active, key=lambda s: (depth[id(s)], s.start_ns)) if active else None
        k = kind(inner)
        if out and out[-1][2] == k and out[-1][1] == a:
            out[-1] = (out[-1][0], b, k)
        else:
            out.append((a, b, k))
    return out


def idle_intervals(trace) -> list[tuple[int, int]]:
    """The window less ``trace.busy_intervals()``."""
    lo, hi = trace.window_ns
    out, t = [], lo
    for s, e in trace.busy_intervals():
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def idle_by_kind(trace, spans: list) -> dict[str, int]:
    """The window's idle ns under each kind of span (every kind in ``KINDS``)."""
    lo, hi = trace.window_ns
    segs = host_segments(spans, lo, hi)
    out = dict.fromkeys(KINDS, 0)
    j = 0
    for a, b in idle_intervals(trace):
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            s, e, name = segs[k]
            out[name] += min(b, e) - max(a, s)
            k += 1
    return out


def loop_host_ms_per_frame(spans: list) -> float | None:
    """The frame loop's host self time a frame: the ``q3.loop`` spans less
    their ``q3.wait`` children, over the iterations they launched, in ms."""
    loops = [s for s in spans if s.name == "q3.loop"]
    frames = sum(s.counters.get("iterations", 0) for s in loops)
    if not frames:
        return None
    ids = {id(s) for s in loops}
    waits = sum(s.end_ns - s.start_ns for s in spans if s.name == "q3.wait" and id(s.parent) in ids)
    return (sum(s.end_ns - s.start_ns for s in loops) - waits) / frames / 1e6


def ttfa_prefill_ms(trace, spans: list) -> list[float]:
    """For each ``q3.open`` that starts in the window: from its start to the
    later of its ``q3.prefill``'s host end and the end of the last device
    operation launched inside that prefill, in ms."""
    lo, hi = trace.window_ns
    prefill = {id(s.parent): s for s in spans if s.name == "q3.prefill" and s.parent is not None}
    opens = [s for s in spans if s.name == "q3.open" and lo <= s.start_ns < hi and id(s) in prefill]
    if not opens:
        return []
    launched = sorted((trace.launches[op[4]], op[1] + op[2]) for op in trace.device_ops if op[4] in trace.launches)
    at = [t for t, _ in launched]
    out = []
    for o in opens:
        p = prefill[id(o)]
        ends = [e for _, e in launched[bisect.bisect_left(at, p.start_ns):bisect.bisect_right(at, p.end_ns)]]
        out.append((max([p.end_ns] + ends) - o.start_ns) / 1e6)
    return out


def _analysis(run) -> dict | None:
    """The run's spans and its idle split, computed once and kept on the run."""
    if run.trace is None or not run.trace.device_ops or run.trace.window_s <= 0:
        return None
    cached = run.__dict__.get("_program_spans")
    if cached is None:
        lo, hi = run.trace.window_ns
        spans = [s for s in recorded() if s.end_ns > lo and s.start_ns < hi]
        cached = {"spans": spans}
        if spans:
            idle = idle_by_kind(run.trace, spans)
            cached["idle_share"] = {k: 100.0 * ns / (hi - lo) for k, ns in idle.items()}
            cached["loop_host_ms_per_frame"] = loop_host_ms_per_frame(
                [s for s in spans if s.start_ns >= lo and s.end_ns <= hi])
        run._program_spans = cached
    return cached if cached["spans"] else None


def idle_share(run, which: str) -> float | None:
    """The share of the traced window in which the device idled while the
    host was in a span of kind ``which`` (``KINDS``), in %."""
    a = _analysis(run)
    return a["idle_share"][which] if a is not None else None


def loop_host(run) -> float | None:
    """``loop_host_ms_per_frame`` of the run's spans in the window."""
    a = _analysis(run)
    return a["loop_host_ms_per_frame"] if a is not None else None


def ttfa_prefill_ms_p50(run) -> float | None:
    a = _analysis(run)
    if a is None:
        return None
    if "ttfa_prefill_ms" not in a:
        a["ttfa_prefill_ms"] = ttfa_prefill_ms(run.trace, a["spans"])
    return percentile(a["ttfa_prefill_ms"], 50) if a["ttfa_prefill_ms"] else None

