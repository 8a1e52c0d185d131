"""The share of the traced window with no operation on the device (torch.profiler), in %. Moves audio_s_per_s, in the utterance and long-form cells."""

from bench_port.harness.readings import device_idle_share


def read(run):
    return device_idle_share(run)
