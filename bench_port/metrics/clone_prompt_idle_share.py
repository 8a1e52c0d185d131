"""The share of the traced window in which the device idled while the host was inside a ``q3.clone_prompt`` span (the
mel on the host, the encoders' launches and their reads), in %. Moves ttfa_p90_ms, in the in-context clone stream cell.
The clone prompt is made before the session opens, so this idle time lies inside outside_idle_share.stream, of which
it is a part. None where the program records no such span."""

from bench_port.harness.clone_spans import idle_share_under


def read(run):
    return idle_share_under(run, "q3.clone_prompt")
