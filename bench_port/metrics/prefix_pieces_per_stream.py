"""The vocoder calls a stream makes on its reference codes before the first audio: the mean of the ``pieces`` counter
of the traced window's ``q3.prefix`` spans (``pipeline.prefix_piece_sizes``: the first chunk's frames at a time, then a
binary split of the rest). Moves ttfa_p90_ms, in the in-context clone stream cell. None where the program records no
such span."""

from bench_port.harness.clone_spans import counter_mean


def read(run):
    return counter_mean(run, "q3.prefix", "pieces")
