"""One run of one cell: set-up, the measured window, the check, the result line.

``run`` builds the model from the seed (with a clone mix, its voices too,
and each voice's clone prompt made once), warms up the mix's sizes, then runs
the closed loop for ``seconds``: requests are sent one after another while
the window is open, and the window closes when the last of them has returned,
so every metric covers all the work and all the time of the window. With
``trace`` the window runs under ``torch.profiler`` and the benchmark's
counters, and the per-layer metrics are read; without, the end-to-end ones.
Then the program is freed, the check runs, and ``run`` returns the result
line and the lines that name each compared number beside its limit.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass, field

import torch

from . import check, program, traffic
from . import weights as bench_weights
from .audit import TransferAudit
from .spec import Spec
from .trace import WINDOW_SPAN, Trace

FORBIDDEN = ("jax", "jaxlib", "flax", "qwen3_tts_tpu")


@dataclass
class Record:
    """What the metric readers read (``bench_port/metrics/<name>.py``)."""

    spec: Spec
    dims: dict
    mix: dict
    done: list  # (traffic.Request, program.Served) of every request sent in the window
    window_s: float
    setup_s: float
    trace: Trace | None = None
    host_reads: int | None = None
    prefill_s: list = field(default_factory=list)

    @property
    def served(self) -> list:
        return [s for _, s in self.done if s.error is None]

    @property
    def frames(self) -> int:
        return sum(s.frames for s in self.served)

    @property
    def audio_s(self) -> float:
        return sum(s.samples for s in self.served) / program.SAMPLES_PER_FRAME / 12.5


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name for name in sys.modules if name.split(".")[0] in FORBIDDEN})


def read_metric(name: str, record: Record):
    """``bench_port/metrics/<name>.py``'s ``read(record)``: a number, or None
    where it found nothing to read."""
    path = record.spec.root / "bench_port" / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location("bench_port_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read(record)


def power_limit() -> str | None:
    """The card's power limit as nvidia-smi gives it."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0].strip() if out.returncode == 0 and out.stdout.strip() else None


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _serve(driver, req):
    try:
        with torch.profiler.record_function("bench.request"):
            return driver.run(req)
    except Exception:  # a failed request is counted, and the loop goes on
        served = program.Served(req.frames, error=traceback.format_exc())
        print(served.error, file=sys.stderr)
        return served


def window(driver, plan: traffic.Plan, seconds: float, device) -> tuple[list, float]:
    """The closed loop: (every (request, served) sent, the window's seconds)."""
    done = []
    _sync(device)
    with torch.profiler.record_function(WINDOW_SPAN):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            req = plan.next()
            done.append((req, _serve(driver, req)))
        _sync(device)
        elapsed = time.perf_counter() - t0
    return done, elapsed


def measure(spec: Spec, seed: int, seconds: float, trace: bool, device, t_start: float,
            quantize_int8: bool = False) -> tuple[Record, list, int]:
    """Set-up and the window: (the record, the check's cases, the device's
    peak of memory). The program is freed before it returns.
    ``quantize_int8`` runs the program's own int8 path, the check's control."""
    dims, mix = spec.dims, spec.traffic
    dev = torch.device(device)
    plan = traffic.Plan(mix, seed)  # refuses a mix the program cannot serve, before any set-up
    voices = traffic.voices(mix, seed)
    model = program.build(dims, bench_weights.draw(dims, seed, dev), traffic.WordTokenizer(), quantize_int8,
                          bench_weights.draw_encoders(dims, seed, dev))
    driver = program.Driver(model, mix, voices, dims)
    with torch.no_grad():
        driver.prepare()
        for req in traffic.warmup(mix, seed):
            served = driver.run(req)
            if served.samples != req.frames * program.SAMPLES_PER_FRAME:
                raise RuntimeError(f"warm-up request of {req.frames} frames gave {served.samples} samples")
        _sync(dev)
        setup_s = time.perf_counter() - t_start

        prof = audit = None
        prefill = program.PrefillClock()
        if trace:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if dev.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=activities)
            prof.start()
            audit = TransferAudit().__enter__()
            prefill.__enter__()
        try:
            done, window_s = window(driver, plan, seconds, dev)
        finally:
            if trace:
                prefill.__exit__(None, None, None)
                audit.__exit__(None, None, None)
                t0 = time.perf_counter()
                prof.stop()
                print(f"trace: the profiler stopped in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    record = Record(spec, dims, mix, done, window_s, setup_s)
    if trace:
        t0 = time.perf_counter()
        record.trace, record.host_reads, record.prefill_s = Trace.collect(prof), audit.transfers, prefill.seconds
        print(f"trace: {len(record.trace.device_ops)} device operations read in {time.perf_counter() - t0:.1f} s",
              file=sys.stderr)
        del prof
    # The check's inputs leave the program's memory; then the program goes.
    cases = check.take(check.sample(done, seed, mix["check_requests"]), voices, mix)
    for _, served in done:
        served.codes = served.audio = served.xvector = served.ref_codes = None
    del model, driver
    gc.collect()  # the driver's wrapper and the model refer to each other
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return record, cases, memory_peak


def run(spec: Spec, seed: int, seconds: float, trace: bool, device, t_start: float) -> tuple[dict, list[str]]:
    """One run: (the result line, the lines naming each compared number)."""
    dev = torch.device(device)
    record, cases, memory_peak = measure(spec, seed, seconds, trace, dev, t_start)
    readings = check.judge(record.dims, seed, dev, cases) if cases else {}
    ok, compared = check.verdict(readings, spec.limits)
    done = record.done
    failed = sum(s.error is not None or s.samples != s.frames * program.SAMPLES_PER_FRAME for _, s in done)

    metrics = {}
    for m in (spec.per_layer if trace else spec.end_to_end):
        value = read_metric(m["name"], record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": spec.cell["chips"], "memory_peak_bytes": memory_peak}
    if dev.type == "cuda":
        info["power_limit"] = power_limit()
    if trace:
        info["busy_s"], info["window_s"] = record.trace.busy_s(), record.trace.window_s
    line = {"correct": bool(ok and cases and failed == 0), "attempted": len(done), "failed": failed,
            "metrics": metrics, "device": info}
    if trace:
        line["breakdown"] = {"device_ops": record.trace.top_device_ops(), "idle_gaps": record.trace.top_idle_gaps()}
    line["compared"] = {k: [v["value"], v["limit"]] for k, v in compared.items()}
    notes = [f"checked {len(cases)} greedy requests of {len(done)} ({sum(len(c['codes']) for c in cases)} frames)",
             "readings " + json.dumps(readings)]
    notes += [f"{k} {v['value']} limit {v['limit']}" for k, v in compared.items()]
    return line, notes
