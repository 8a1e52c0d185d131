"""Aggregate per-kernel device time from a ``torch.profiler`` trace.

The counterpart of the JAX package's ``scripts/trace_report.py``, which
reads a ``jax.profiler`` xplane: this reads the Chrome trace that
``profiling.trace`` writes (the CLI's ``--profile DIR`` -> ``DIR/trace.json``),
takes the events of the selected categories (``--plane-filter``, default
``kernel``: the CUDA kernels) and sums their durations by name. Every frame
of the loop launches its kernels anew, so a kernel's steady cost a frame
is its total over the frames (``--frames N``).

    python -m qwen3_tts_tpu_torch.validation trace-report DIR [--top 40]
        [--frames N] [--line-filter "stream 7"] [--plane-filter kernel]

With --frames N, also prints ms per frame for each group. ``classify``
names the port's own kernels (``csrc/``) by their number.
"""

from __future__ import annotations

import argparse
import collections
import gzip
import json
from pathlib import Path


def load_traces(trace_dir: Path) -> list[tuple[Path, list]]:
    """(path, events) of every Chrome trace under ``trace_dir`` (or the file)."""
    paths = [trace_dir] if trace_dir.is_file() else sorted(
        [*trace_dir.glob("**/*.json"), *trace_dir.glob("**/*.json.gz")])
    if not paths:
        raise SystemExit(f"no trace .json under {trace_dir}")
    out = []
    for p in paths:
        raw = gzip.decompress(p.read_bytes()) if p.suffix == ".gz" else p.read_bytes()
        out.append((p, json.loads(raw).get("traceEvents", [])))
    return out


def aggregate(events: list, line_filter: str | None) -> dict:
    """{category: {(line, event name): [total µs, count]}} over the complete
    events; a line is the event's stream (its thread where it has none)."""
    out = collections.defaultdict(lambda: collections.defaultdict(lambda: [0.0, 0]))
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        args = ev.get("args") or {}
        line = f"stream {args['stream']}" if "stream" in args else f"thread {ev.get('tid')}"
        if line_filter and line_filter not in line:
            continue
        a = out[ev.get("cat", "")][(line, ev.get("name", ""))]
        a[0] += float(ev["dur"])
        a[1] += 1
    return out


# The port's kernels (csrc/), then the groups of library kernels.
GROUPS = (
    ("kernel 1: cp_frame", ("cp_frame_kernel",)),
    ("kernel 2: residual_unit", ("residual_unit_tc",)),
    ("kernel 4: int8_matmul", ("int8_mm_tc",)),
    ("kernel 5: attention_step", ("attention_step_kernel",)),
    ("kernel 6: mlp_step", ("mlp_step_kernel",)),
    ("gemm", ("gemm", "gemv", "cutlass", "xmma", "cublas")),
    ("convolution", ("conv", "cudnn")),
    ("reduce", ("reduce",)),
    ("copy/memcpy", ("memcpy", "memset", "copy")),
    ("elementwise", ("elementwise",)),
)


def classify(name: str) -> str:
    """The group of a kernel name. ``talker_step_kernel<T, W, kNorm>`` is
    kernel 3 (``kNorm`` false) or kernel 7 (its normalised form)."""
    low = name.lower()
    if "talker_step_kernel" in low:
        return "kernel 7: cp_step" if "true>" in low.replace(" ", "") else "kernel 3: talker_step"
    for label, keys in GROUPS:
        if any(k in low for k in keys):
            return label
    return "other"


def summarize(trace_dir: Path, plane_filter: str | None = "kernel", line_filter: str | None = None,
              top: int = 40) -> list[dict]:
    """Each selected category of each trace: its total ms, ms by group and
    its ``top`` events by time (name, group, ms, count)."""
    out = []
    for path, events in load_traces(Path(trace_dir)):
        for plane, agg in aggregate(events, line_filter).items():
            if plane_filter and plane_filter not in plane:
                continue
            rows = sorted(agg.items(), key=lambda kv: -kv[1][0])
            groups = collections.defaultdict(float)
            for (_, name), (us, _) in rows:
                groups[classify(name)] += us / 1e3
            out.append({
                "file": path.name, "plane": plane, "total_ms": sum(v[0] for v in agg.values()) / 1e3,
                "groups": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
                "top": [{"name": name, "group": classify(name), "ms": us / 1e3, "count": cnt}
                        for (_, name), (us, cnt) in rows[:top]],
            })
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="validation trace-report",
                                 description="Per-kernel device time from a torch.profiler trace")
    ap.add_argument("trace_dir", type=Path)
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--line-filter", default=None)
    ap.add_argument("--plane-filter", default="kernel")
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    planes = summarize(args.trace_dir, args.plane_filter, args.line_filter, args.top)
    if not planes:
        raise SystemExit(f"no '{args.plane_filter}' events in the traces under {args.trace_dir}")
    for s in planes:
        print(f"\n=== {s['plane']}  ({s['file']}) ===")
        print(f"{'total device time':<64} {s['total_ms']:10.3f} ms")
        for g, ms in s["groups"].items():
            extra = f"  ({ms / args.frames:.4f} ms/frame)" if args.frames else ""
            print(f"{'  [' + g + ']':<64} {ms:10.3f} ms{extra}")
        print(f"\ntop {args.top} ops:")
        for row in s["top"]:
            extra = f"  {row['ms'] / args.frames:8.4f} ms/frame" if args.frames else ""
            print(f"  {row['ms']:10.3f} ms  x{row['count']:<6} {row['name'][:90]}{extra}")
    return 0
