"""The share of the traced window in which the device idled while the host was in the vocoder (``q3.vocoder``), in %.
Moves ttfa_p90_ms, in the stream cell; the five idle shares sum to device_idle_share."""

from bench_port.harness.spans import idle_share


def read(run):
    return idle_share(run, "vocoder")
