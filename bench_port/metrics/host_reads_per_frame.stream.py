"""Reads of a tensor's value by the host in the traced window (the benchmark's copy of TransferAudit) over the frames made in it. Moves ttfa_p90_ms, in the stream cell."""

from bench_port.harness.readings import host_reads_per_frame


def read(run):
    return host_reads_per_frame(run)
