"""The 90th percentile over every stream of the window of the time from the call until the first chunk's samples
were on the host, in ms (host clock)."""

from bench_port.harness.stats import percentile


def read(run):
    first = [s.first_s * 1e3 for s in run.served if s.first_s is not None]
    return percentile(first, 90) if first else None
