"""The readers of an in-context clone's spans (``harness/clone_spans.py``) on a synthetic trace and span list.

A window of 200 ns with the device busy over [10, 20), [30, 45), [60, 70)
and [120, 150). On the host a clone prompt over [5, 40) (its two encoders
inside it), then a stream whose first chunk [50, 110) feeds the reference
codes under a prefix [52, 100) in three pieces of 4, 4 and 2 frames, and a
second clone prompt over [160, 190) with no device work. Kernel 1,
launched at 8 inside the first prompt, ends at 20; kernel 2, launched at 35
inside it too, ends at 45, after the prompt's host end; kernels 3 and 4
are kernel 2's ``residual_unit`` launches, 10 and 30 ns on the device.
"""

from types import SimpleNamespace

import pytest

from bench_port.harness import cell, roofline, spans

from conftest import ROOT
from test_bench_port_spans import span, trace

CELL_METRICS = ("clone_prompt_ms_p50", "clone_prompt_idle_share", "prefix_ms_p50", "prefix_pieces_per_stream",
                "k2_residual_unit_roofline.icl")


def clone_trace():
    tr = trace(busy=((10, 20), (30, 45), (60, 70), (120, 150)), window=(0, 200),
               launches={1: 8, 2: 35, 3: 55, 4: 110})
    tr.device_ops = [(name, s, e - s, "kernel", i + 1) for i, (name, s, e) in enumerate(
        (("ecapa", 10, 20), ("mimi", 30, 45), ("residual_unit_k", 60, 70), ("residual_unit_k", 120, 150)))]
    return tr


def clone_spans(pieces=(4, 4, 2), prefix_counters=True):
    prompt = span("q3.clone_prompt", 5, 40, samples=48000, icl=1)
    speaker = span("q3.speaker_encoder", 6, 22, prompt)
    speech = span("q3.speech_encoder", 25, 38, prompt, frames=10)
    chunk = span("q3.chunk", 50, 110)
    counters = {"pieces": len(pieces), "frames": sum(pieces)} if prefix_counters else {}
    prefix = span("q3.prefix", 52, 100, chunk, **counters)
    out = [span("q3.wait", 20, 22, speaker), speaker, span("q3.wait", 36, 38, speech), speech, prompt]
    at = 54
    for f in pieces:
        piece = span("q3.piece", at, at + 10, prefix, frames=f)
        out += [span("q3.vocoder", at + 1, at + 9, piece), piece]
        at += 12
    return out + [prefix, chunk, span("q3.clone_prompt", 160, 190, samples=24000, icl=1)]


def run_of(tr, recorded, monkeypatch, chunks=((4, 10),)):
    monkeypatch.setattr(spans, "recorded", lambda: list(recorded))
    served = [SimpleNamespace(chunks=list(c)) for c in chunks]
    return SimpleNamespace(trace=tr, served=served, spec=SimpleNamespace(root=ROOT))


read = cell.read_metric


def test_clone_prompt_ends_with_the_device_work_it_launched(monkeypatch):
    run = run_of(clone_trace(), clone_spans(), monkeypatch)
    # The first prompt: 5 to kernel 2's end at 45; the second: its host span, 30 ns.
    assert read("clone_prompt_ms_p50", run) == pytest.approx(((45 - 5) + 30) / 2 / 1e6)


def test_clone_prompt_idle_share(monkeypatch):
    run = run_of(clone_trace(), clone_spans(), monkeypatch)
    # Idle under [5, 40): [5, 10) and [20, 30), 15 ns; under [160, 190): all 30 ns. Over the window's 200 ns.
    assert read("clone_prompt_idle_share", run) == pytest.approx(100.0 * (15 + 30) / 200)


def test_prefix_time_and_pieces(monkeypatch):
    run = run_of(clone_trace(), clone_spans(), monkeypatch)
    # Kernel 3, launched at 55 inside the prefix, ends at 70 < its host end at 100.
    assert read("prefix_ms_p50", run) == pytest.approx((100 - 52) / 1e6)
    assert read("prefix_pieces_per_stream", run) == pytest.approx(3.0)


def test_prefix_pieces_are_a_mean_over_streams(monkeypatch):
    first, second = clone_spans((4, 4, 2)), clone_spans((4, 1))
    for s in second:
        s.start_ns, s.end_ns = s.start_ns + 1, s.end_ns + 1
    run = run_of(clone_trace(), first + second, monkeypatch)
    assert read("prefix_pieces_per_stream", run) == pytest.approx(2.5)


def test_kernel2_roofline_counts_the_prefix_pieces(monkeypatch):
    run = run_of(clone_trace(), clone_spans(), monkeypatch, chunks=((4, 10),))
    frames = [4, 10, 4, 4, 2]
    want = 100.0 * sum(roofline.residual_unit_chunk_bound_ms(f) for f in frames) / (40 / 1e6)
    assert read("k2_residual_unit_roofline.icl", run) == pytest.approx(want)
    # The existing reader counts the chunks alone.
    chunks_only = 100.0 * sum(roofline.residual_unit_chunk_bound_ms(f) for f in (4, 10)) / (40 / 1e6)
    assert read("k2_residual_unit_roofline", run) == pytest.approx(chunks_only) and want > chunks_only


@pytest.mark.parametrize("case", ["no clone spans", "no trace", "no device operation", "no program record",
                                  "spans outside the window"])
def test_readers_return_none(monkeypatch, case):
    tr, recorded = clone_trace(), clone_spans()
    if case == "no clone spans":  # a program before these spans: its stream's chunk alone
        recorded = [s for s in recorded if s.name in ("q3.chunk", "q3.vocoder")]
    elif case == "no trace":
        tr = None
    elif case == "no device operation":
        tr.device_ops = []
    elif case == "spans outside the window":
        tr.window_ns = (300, 400)
    run = run_of(tr, recorded, monkeypatch)
    if case == "no program record":
        monkeypatch.undo()
        monkeypatch.setattr(spans.program, "q", SimpleNamespace())
    assert [read(name, run) for name in CELL_METRICS] == [None] * len(CELL_METRICS)


def test_counters_absent_read_none(monkeypatch):
    run = run_of(clone_trace(), clone_spans(prefix_counters=False), monkeypatch)
    assert read("prefix_pieces_per_stream", run) is None
    assert read("prefix_ms_p50", run) is not None
