"""Device kernels in the traced window (torch.profiler) over the frames made in it. Moves audio_s_per_s, in the utterance and long-form cells."""

from bench_port.harness.readings import kernels_per_frame


def read(run):
    return kernels_per_frame(run)
