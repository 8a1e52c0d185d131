"""Profiling: ``torch.profiler`` traces and named regions.

The port's counterpart of ``trace`` and ``annotate`` in
``qwen3_tts_tpu/profiling.py`` (the CLI's ``--profile``):

* ``trace(dir)`` records everything inside the context, the host's
  activity and, when a CUDA card is present, its kernels, and writes a
  Chrome trace to ``dir/trace.json`` (open it in ui.perfetto.dev or
  chrome://tracing);
* ``annotate(name)`` adds a named region visible in the trace;
* ``TransferAudit`` / ``count_host_transfers(fn)`` count the reads that
  bring a tensor's value to the host while they are active (the JAX
  package's host-transfer audit).
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """Record a ``torch.profiler`` trace into ``log_dir/trace.json``; yields
    the profiler."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


def annotate(name: str):
    """Named trace region: ``with annotate("prefill"): ...``."""
    return record_function(name)


# Tensor methods through which a value reaches the host. The value reads
# count on every tensor; the copies count when the tensor is not already
# on the CPU (a CPU tensor's ``.cpu()`` moves nothing).
_VALUE_READS = ("item", "tolist", "__bool__", "__int__", "__float__", "__index__", "__array__", "numpy")
_COPIES = ("cpu", "to")


def _to_cpu(args: tuple, kwargs: dict) -> bool:
    """Whether ``Tensor.to(*args, **kwargs)`` names the CPU as its device
    (a device or its name, or a tensor on the CPU)."""
    for a in (*args, kwargs.get("device"), kwargs.get("other")):
        if isinstance(a, torch.Tensor):
            return a.device.type == "cpu"
        if isinstance(a, (str, torch.device)):
            return torch.device(a).type == "cpu"
    return False


@dataclass
class TransferAudit:
    """Counts the reads of tensor values by the host while active: the
    value reads ``.item()``, ``.tolist()``, ``bool`` / ``int`` / ``float`` /
    ``__index__``, ``__array__`` and ``.numpy()``, on any device, and the
    copies ``.cpu()`` and ``.to`` onto the CPU of a tensor not on the CPU.

    It patches ``torch.Tensor`` on entry and restores it on exit; nothing is
    counted outside the context. A read made inside another counted read
    (``np.asarray(t)`` calls ``t.__array__``, which calls ``t.numpy()``)
    counts once. Blind spot: C code that reads a tensor's buffer without
    these methods (``torch.equal``, printing) is not seen.
    """

    transfers: int = 0
    _saved: dict = field(default_factory=dict, repr=False)
    _inside: threading.local = field(default_factory=threading.local, repr=False)

    def _hook(self, name: str, orig):
        def hook(t, *args, **kwargs):
            if getattr(self._inside, "depth", 0):
                return orig(t, *args, **kwargs)
            if name in _VALUE_READS or (t.device.type != "cpu" and (name == "cpu" or _to_cpu(args, kwargs))):
                self.transfers += 1
            self._inside.depth = 1
            try:
                return orig(t, *args, **kwargs)
            finally:
                self._inside.depth = 0

        return hook

    def __enter__(self) -> "TransferAudit":
        for name in _VALUE_READS + _COPIES:
            self._saved[name] = torch.Tensor.__dict__.get(name)
            setattr(torch.Tensor, name, self._hook(name, getattr(torch.Tensor, name)))
        return self

    def __exit__(self, *exc) -> bool:
        for name, orig in self._saved.items():
            if orig is None:
                delattr(torch.Tensor, name)  # it was inherited from the C base
            else:
                setattr(torch.Tensor, name, orig)
        self._saved = {}
        return False


def count_host_transfers(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` under a ``TransferAudit``; returns
    (result, the number of host reads it made)."""
    with TransferAudit() as audit:
        result = fn(*args, **kwargs)
    return result, audit.transfers
