"""The readers of the program's spans (``harness/spans.py``) on a synthetic trace and span list.

A window of 100 ns with the device busy over [10, 20) and [60, 70); on the
host a session opened over [5, 30) with its prefill over [8, 25), and a chunk
over [40, 90) whose loop [42, 80) waits over [50, 65). The idle time splits
at those edges: outside 25, session 20, prefill 7, loop 28 (its wait
included), vocoder 0, which sum to the 80 idle ns.
"""

from types import SimpleNamespace

import pytest

from bench_port.harness import cell, readings, spans
from bench_port.harness.trace import Trace

from conftest import ROOT


def span(name, start, end, parent=None, **counters):
    return SimpleNamespace(name=name, start_ns=start, end_ns=end, parent=parent, request=1, counters=counters)


def trace(busy=((10, 20), (60, 70)), window=(0, 100), launches=None):
    tr = Trace(window_ns=window)
    tr.device_ops = [(f"k{i}", s, e - s, "kernel", i + 1) for i, (s, e) in enumerate(busy)]
    tr.launches = launches if launches is not None else {i + 1: s - 1 for i, (s, _) in enumerate(busy)}
    return tr


def program_spans():
    open_ = span("q3.open", 5, 30)
    chunk = span("q3.chunk", 40, 90)
    loop = span("q3.loop", 42, 80, chunk, iterations=4)
    return [span("q3.prefill", 8, 25, open_), open_, span("q3.wait", 50, 65, loop), loop, chunk]


def run_of(tr, recorded, monkeypatch):
    monkeypatch.setattr(spans, "recorded", lambda: list(recorded))
    return SimpleNamespace(trace=tr, spec=SimpleNamespace(root=ROOT))


def test_idle_split_at_span_edges():
    got = spans.idle_by_kind(trace(), program_spans())
    assert got == {"prefill": 7, "loop": 28, "vocoder": 0, "session": 20, "outside": 25}
    assert sum(got.values()) == 80


def test_wait_takes_its_parents_kind():
    chunk = span("q3.chunk", 0, 100)
    voc = span("q3.vocoder", 10, 40, chunk)
    waits = [span("q3.wait", 20, 30, voc), span("q3.wait", 50, 60, chunk)]
    assert [spans.kind(w) for w in waits] == ["vocoder", "session"]
    got = spans.idle_by_kind(trace(busy=((0, 20), (60, 100))), [chunk, voc, *waits])
    assert got == {"prefill": 0, "loop": 0, "vocoder": 20, "session": 20, "outside": 0}
    assert spans.kind(span("q3.wait", 0, 1)) == "outside"


def test_shares_sum_to_device_idle_share(monkeypatch):
    run = run_of(trace(), program_spans(), monkeypatch)
    shares = {k: cell.read_metric(f"{k}_idle_share", run) for k in spans.KINDS}
    assert shares == {k: cell.read_metric(f"{k}_idle_share.stream", run) for k in spans.KINDS}
    assert shares == pytest.approx({"prefill": 7.0, "loop": 28.0, "vocoder": 0.0, "session": 20.0, "outside": 25.0})
    assert sum(shares.values()) == pytest.approx(readings.device_idle_share(run), abs=1e-9)


def test_loop_host_time_a_frame(monkeypatch):
    run = run_of(trace(), program_spans(), monkeypatch)
    # (38 ns of loop - 15 ns of its wait) / 4 frames, in ms.
    assert cell.read_metric("loop_host_ms_per_frame", run) == pytest.approx(23 / 4 / 1e6)
    assert cell.read_metric("loop_host_ms_per_frame.stream", run) == pytest.approx(23 / 4 / 1e6)


def test_ttfa_prefill_ends_with_the_device_work_it_launched(monkeypatch):
    # Kernel 1 launched at 9, inside the prefill, ends at 28 on the device;
    # kernel 2 launched at 59, after it, does not count.
    tr = trace(busy=((10, 28), (60, 70)), launches={1: 9, 2: 59})
    run = run_of(tr, program_spans(), monkeypatch)
    assert cell.read_metric("ttfa_prefill_ms_p50", run) == pytest.approx((28 - 5) / 1e6)
    # With no device work launched inside it, the prefill's host end.
    run = run_of(trace(launches={1: 3, 2: 59}), program_spans(), monkeypatch)
    assert cell.read_metric("ttfa_prefill_ms_p50", run) == pytest.approx((25 - 5) / 1e6)


NEW = [f"{k}_idle_share{s}" for s in ("", ".stream") for k in spans.KINDS] + [
    "loop_host_ms_per_frame", "loop_host_ms_per_frame.stream", "ttfa_prefill_ms_p50"]


@pytest.mark.parametrize("case", ["no device operation", "no trace", "no span in the window", "no program record"])
def test_readers_return_none(monkeypatch, case):
    tr, recorded = trace(), program_spans()
    if case == "no device operation":
        tr.device_ops = []
    elif case == "no trace":
        tr = None
    elif case == "no span in the window":
        tr.window_ns = (200, 300)
    run = run_of(tr, recorded, monkeypatch)
    if case == "no program record":  # a program without recorded_spans, as before spans existed
        monkeypatch.undo()
        monkeypatch.setattr(spans.program, "q", SimpleNamespace())
    assert [cell.read_metric(name, run) for name in NEW] == [None] * len(NEW)


def test_one_analysis_a_run_and_the_record_kept(monkeypatch):
    recorded = program_spans()
    calls = []
    monkeypatch.setattr(spans, "recorded", lambda: calls.append(1) or list(recorded))
    run = SimpleNamespace(trace=trace(), spec=SimpleNamespace(root=ROOT))
    values = [cell.read_metric(name, run) for name in NEW]
    assert len(calls) == 1 and None not in values and len(recorded) == 5
