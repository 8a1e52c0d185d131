"""The vocoder's feed of an in-context clone's reference codes before the first audio
(``StreamingSession._feed_prefix``): for each ``q3.prefix`` span that starts in the traced window, from its start to
the later of its host end and the end of the last device operation launched inside it; the median, in ms. Moves
ttfa_p90_ms, in the in-context clone stream cell. None where the program records no such span."""

from bench_port.harness.clone_spans import through_device_ms_p50


def read(run):
    return through_device_ms_p50(run, "q3.prefix")
