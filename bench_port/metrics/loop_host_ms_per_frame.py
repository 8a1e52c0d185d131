"""The frame loop's host self time a frame: the window's ``q3.loop`` spans less their ``q3.wait`` children, over
the iterations they launched, in ms. Moves audio_s_per_s, in the utterance and long-form cells."""

from bench_port.harness.spans import loop_host


def read(run):
    return loop_host(run)
