"""The share of the traced window in which the device idled while the host was in the session and no inner span
(``q3.open``, ``q3.chunk``, ``q3.audio``, ``q3.grow`` and their ``q3.wait`` reads), in %. Moves audio_s_per_s, in the
utterance and long-form cells; the five idle shares sum to device_idle_share."""

from bench_port.harness.spans import idle_share


def read(run):
    return idle_share(run, "session")
