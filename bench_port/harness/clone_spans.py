"""Readings of the spans an in-context clone adds: its prompt's two audio encoders and the vocoder's prefix feed.

The program records ``q3.clone_prompt`` around
``Qwen3TTS.create_voice_clone_prompt`` (counters ``samples`` and ``icl``;
children ``q3.speaker_encoder`` and ``q3.speech_encoder``, each reading its
result in a ``q3.wait``) and, in a stream, ``q3.prefix`` around
``StreamingSession._feed_prefix`` (counters ``pieces`` and ``frames``) over
one ``q3.piece`` a vocoder call on the reference codes (counter ``frames``).
None of these names is in ``spans.SPAN_KIND``, so the five-way idle split
reads as it did before they existed: a ``q3.clone_prompt``, opened outside
any session, counts as ``outside``; ``q3.prefix`` and ``q3.piece`` take the
kind of the chunk around them and their ``q3.vocoder`` calls stay
``vocoder``. Each reader returns None where the traced window holds no such
span (a program that records none).
"""

from __future__ import annotations

import bisect

from . import spans
from .roofline import residual_unit_chunk_bound_ms
from .stats import percentile


def named(run, name: str) -> list:
    """The run's spans called ``name`` that start inside the traced window."""
    a = spans._analysis(run)
    if a is None:
        return []
    lo, hi = run.trace.window_ns
    return [s for s in a["spans"] if s.name == name and lo <= s.start_ns < hi]


def through_device_ms(trace, regions: list) -> list[float]:
    """For each span: from its start to the later of its host end and the end
    of the last device operation launched inside it, in ms (as
    ``spans.ttfa_prefill_ms`` reads a prefill)."""
    launched = sorted((trace.launches[op[4]], op[1] + op[2]) for op in trace.device_ops if op[4] in trace.launches)
    at = [t for t, _ in launched]
    out = []
    for s in regions:
        ends = [e for _, e in launched[bisect.bisect_left(at, s.start_ns):bisect.bisect_right(at, s.end_ns)]]
        out.append((max([s.end_ns] + ends) - s.start_ns) / 1e6)
    return out


def through_device_ms_p50(run, name: str) -> float | None:
    """The median of ``through_device_ms`` over the window's ``name`` spans."""
    regions = named(run, name)
    return percentile(through_device_ms(run.trace, regions), 50) if regions else None


def idle_share_under(run, name: str) -> float | None:
    """The share of the traced window in which the device idled while a
    ``name`` span was open on the host, in %."""
    regions = named(run, name)
    if not regions:
        return None
    lo, hi = run.trace.window_ns
    idle = spans.idle_intervals(run.trace)
    starts = [a for a, _ in idle]
    total = 0
    for s in regions:
        a, b = max(s.start_ns, lo), min(s.end_ns, hi)
        for x, y in idle[max(bisect.bisect_right(starts, a) - 1, 0):]:
            if x >= b:
                break
            total += max(0, min(b, y) - max(a, x))
    return 100.0 * total / (hi - lo)


def counter_mean(run, name: str, counter: str) -> float | None:
    """The mean of ``counter`` over the window's ``name`` spans that carry it."""
    values = [s.counters[counter] for s in named(run, name) if counter in s.counters]
    return sum(values) / len(values) if values else None


def residual_unit_roofline_icl(run) -> float | None:
    """Kernel 2's stream entry over all the frames it decoded in the window:
    ``roofline.residual_unit_chunk_bound_ms`` summed over the chunks handed
    back and over every ``q3.piece`` of the reference prefix, over the summed
    device time of the kernel's launches, in %."""
    launches = run.trace.kernels("residual_unit") if run.trace else []
    pieces = [s.counters["frames"] for s in named(run, "q3.piece") if "frames" in s.counters]
    if not launches or not pieces:
        return None
    frames = [f for s in run.served for f in s.chunks if f] + [f for f in pieces if f]
    return 100.0 * sum(residual_unit_chunk_bound_ms(f) for f in frames) / (sum(op[2] for op in launches) / 1e6)
