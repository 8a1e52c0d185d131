"""Seconds of audio handed back over the window's seconds: what a card-second buys.

Every request sent in the window counts whole, and the window lasts until the
last of them returned (host clock)."""

from bench_port.harness.stats import rate


def read(run):
    return rate(run.audio_s, run.window_s) if run.served else None
