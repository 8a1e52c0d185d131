"""The whole step's share of the card's peak: model FLOPs of the traced window's requests over its seconds times 989 TFLOP/s (bf16 dense; the f32 vocoder counted against the same peak), in %. Moves audio_s_per_s, in the utterance and long-form cells."""

from bench_port.harness.readings import mfu


def read(run):
    return mfu(run)
