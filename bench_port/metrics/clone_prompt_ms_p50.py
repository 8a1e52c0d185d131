"""The clone prompt's time (``Qwen3TTS.create_voice_clone_prompt``, made inside every request: the mel on the host, the
speaker and speech encoders on the card): for each ``q3.clone_prompt`` span that starts in the traced window, from its
start to the later of its host end and the end of the last device operation launched inside it; the median, in ms.
Moves ttfa_p90_ms, in the in-context clone stream cell. None where the program records no such span."""

from bench_port.harness.clone_spans import through_device_ms_p50


def read(run):
    return through_device_ms_p50(run, "q3.clone_prompt")
