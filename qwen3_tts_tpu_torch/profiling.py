"""Profiling: ``torch.profiler`` traces, the program's spans and host reads.

The port's counterpart of ``trace`` and ``annotate`` in
``qwen3_tts_tpu/profiling.py`` (the CLI's ``--profile``):

* ``trace(dir)`` records everything inside the context, the host's
  activity and, when a CUDA card is present, its kernels, and writes a
  Chrome trace to ``dir/trace.json`` (open it in ui.perfetto.dev or
  chrome://tracing);
* ``annotate(name, request)`` opens one span of the program: its name, the
  request it serves, the span around it on the same thread, its start and
  end on ``time.time_ns`` (the clock of ``torch.profiler``'s events) and
  the counters the code sets on it. A span records only inside
  ``spans()``, which yields the list it recorded, or while a
  ``torch.profiler`` records: then it also enters ``record_function(name)``,
  so it shows in the trace beside the kernels, and it joins the record
  ``recorded_spans()`` returns. Otherwise it costs one check of two flags;
* ``TransferAudit`` / ``count_host_transfers(fn)`` count the reads that
  bring a tensor's value to the host while they are active (the JAX
  package's host-transfer audit).

The spans of the batch-1 path (``README.md`` lists them): ``q3.open``
(a session's set-up, where its request id is drawn), ``q3.prefill``
(counter ``graph``: 1 where the talker's prefill replayed its CUDA graph),
``q3.loop`` (one ``generation.core.generate_frames`` call, counter
``iterations``), ``q3.vocoder``, ``q3.chunk``, ``q3.audio``, ``q3.grow`` and
``q3.wait``, around every place the host waits for the device or reads
from it; a clone's ``q3.clone_prompt`` (counters ``samples`` and ``icl``)
over ``q3.speaker_encoder`` and ``q3.speech_encoder`` (counter ``frames``),
and an in-context clone's ``q3.prefix`` (counters ``pieces`` and
``frames``) over one ``q3.piece`` (counter ``frames``) a vocoder call.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path

import torch
import torch.autograd.profiler as _autograd_profiler
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


# The spans closed while a torch.profiler recorded, the newest ``maxlen``.
_record: deque = deque(maxlen=1 << 18)
# The lists of the ``spans()`` contexts open now.
_collectors: list[list] = []
_local = threading.local()
_request_ids = itertools.count(1)


def _open_spans() -> list:
    """This thread's open spans, outermost first."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class Span:
    """One region of the program on the host's clock (``time.time_ns``, in
    ns). ``parent`` is the span open around it on the same thread; a span
    opened with no request takes its parent's. ``set(name, value)`` sets a
    counter before the span closes."""

    __slots__ = ("name", "request", "parent", "start_ns", "end_ns", "counters", "_region")

    def __init__(self, name: str, request: int | None):
        self.name, self.request, self.parent = name, request, None
        self.start_ns = self.end_ns = 0
        self.counters: dict = {}
        self._region = None

    def set(self, counter: str, value) -> None:
        self.counters[counter] = value

    def __enter__(self) -> "Span":
        stack = _open_spans()
        if stack:
            self.parent = stack[-1]
            if self.request is None:
                self.request = self.parent.request
        stack.append(self)
        if _autograd_profiler._is_profiler_enabled:
            self._region = record_function(self.name)
            self.start_ns = time.time_ns()
            self._region.__enter__()
        else:
            self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.time_ns()
        region, self._region = self._region, None
        if region is not None:
            region.__exit__(*exc)
            _record.append(self)
        for got in _collectors:
            got.append(self)
        stack = _open_spans()
        if stack and stack[-1] is self:
            stack.pop()
        return False


class _Off:
    """What ``annotate`` returns while nothing records: it does nothing."""

    __slots__ = ()
    request = None

    def set(self, counter: str, value) -> None:
        pass

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def annotate(name: str, request: int | None = None):
    """A span of the program: ``with annotate("q3.loop") as span: ...;
    span.set("iterations", n)``. It records inside ``spans()`` or while a
    ``torch.profiler`` records (as ``record_function(name)`` too); else it
    does nothing, at the cost of one check of two flags."""
    if _collectors or _autograd_profiler._is_profiler_enabled:
        return Span(name, request)
    return _OFF


def new_request() -> int:
    """A fresh request id (``q3.open`` draws one per session)."""
    return next(_request_ids)


@contextlib.contextmanager
def spans():
    """Record every span that closes inside the context, on any thread;
    yields the list they are appended to, in the order they close."""
    got: list = []
    _collectors.append(got)
    try:
        yield got
    finally:
        _collectors[:] = [c for c in _collectors if c is not got]


def recorded_spans() -> list:
    """The spans that closed while a ``torch.profiler`` recorded (the newest
    2**18), in the order they closed; nothing clears them."""
    return list(_record)


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
