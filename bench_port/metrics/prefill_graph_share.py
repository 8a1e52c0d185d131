"""The share of the traced window's prefills (``q3.prefill`` spans) that replayed the talker's prefill as one CUDA graph
(the span's counter ``graph`` = 1), in %. Moves audio_s_per_s, in the utterance and long-form cells. None where no
span carries the counter."""

from bench_port.harness.spans import _analysis


def read(run):
    a = _analysis(run)
    marks = [s.counters["graph"] for s in a["spans"] if s.name == "q3.prefill" and "graph" in s.counters] if a else []
    return 100.0 * sum(marks) / len(marks) if marks else None
