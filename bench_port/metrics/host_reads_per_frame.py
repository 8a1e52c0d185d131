"""Reads of a tensor's value by the host in the traced window (the benchmark's copy of TransferAudit) over the frames made in it. Moves audio_s_per_s, in the utterance and long-form cells."""

from bench_port.harness.readings import host_reads_per_frame


def read(run):
    return host_reads_per_frame(run)
