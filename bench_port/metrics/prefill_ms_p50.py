"""The median of the talker's prefill (``models.talker.prefill``, wrapped by the benchmark with the host clock and
synchronised at its end) over every request of the traced window, in ms."""

from bench_port.harness.stats import percentile


def read(run):
    return percentile([s * 1e3 for s in run.prefill_s], 50) if run.prefill_s else None
