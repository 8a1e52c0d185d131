"""The frame loop's host self time a frame: the window's ``q3.loop`` spans less their ``q3.wait`` children, over
the iterations they launched, in ms. Moves ttfa_p90_ms, in the stream cell."""

from bench_port.harness.spans import loop_host


def read(run):
    return loop_host(run)
