"""Counts the reads that bring a tensor's value to the host.

A frozen copy of ``TransferAudit`` in ``qwen3_tts_tpu_torch/profiling.py``,
kept here so that a change to the program cannot change the counter.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

import torch

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
