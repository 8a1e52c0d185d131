"""The part of TTFA over once the prefill's work is done: for each stream opened in the traced window, from
``q3.open``'s start to the later of its ``q3.prefill``'s host end and the end of the last device operation launched
inside it; the median, in ms. Moves ttfa_p90_ms, in the stream cell."""

from bench_port.harness.spans import ttfa_prefill_ms_p50


def read(run):
    return ttfa_prefill_ms_p50(run)
