"""The share of the traced window with no operation on the device (torch.profiler), in %. Moves ttfa_p90_ms, in the stream cell."""

from bench_port.harness.readings import device_idle_share


def read(run):
    return device_idle_share(run)
