"""The 90th percentile over every request of the window of its wall time over its audio seconds (host clock)."""

from bench_port.harness.stats import percentile


def read(run):
    rtf = [s.wall_s / (s.samples / 24000) for s in run.served if s.samples]
    return percentile(rtf, 90) if rtf else None
