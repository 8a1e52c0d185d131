"""The share of the traced window in which the device idled while the host was in the frame loop (``q3.loop``, one
``generate_frames`` call, and its ``q3.wait`` looks at ``done``), in %. Moves audio_s_per_s, in the utterance and
long-form cells; the five idle shares sum to device_idle_share."""

from bench_port.harness.spans import idle_share


def read(run):
    return idle_share(run, "loop")
