"""A kernel's timings on the card, for comparing two checkouts.

    python3 qwen3_tts_tpu_torch/kernel_timing.py --kernel int8_matmul|cp_frame [--root DIR] [--tag NAME]
        [--repeats R] [--sweep] [--sass] [--trace]

Times one kernel's wrapper of the checkout at ``--root`` (default: the one
that holds this file), ``--repeats`` times at each shape, in two ways: its
device span (calls captured in a CUDA graph and replayed: no host time
inside) and per call from Python as the path pays it (host included). Run
on two checkouts in one machine session (parent, change, change, parent),
it compares two versions of the kernel on one card; ``--root`` may name a
checkout whose kernel takes an older C interface, since only the wrapper is
called. The end-to-end cells come from each checkout's own
``chip_smoke.py``.

``--kernel int8_matmul`` (kernel 4, ``ops.quant.int8_matmul``): at
``SHAPES``, the shapes ``chip_smoke.py`` times it at (``time_shape``);
weight copies are cycled in the graph so that no call finds its weights in
L2, as on the path, where other weights pass between two calls. Beside
each, the library yardstick: one bf16 ``torch.matmul`` on the weight
dequantized ahead of time, timed both ways.

``--kernel cp_frame`` (kernel 1, ``ops.fused_layer.cp_frame``): one frame
of the 1.7B code predictor (random weights from seed 2, as ``chip_smoke.py``
builds them) in f32, bf16 and int8 (``time_frame``; the 157 MB of bf16
layers do not stay in the 50 MB L2 anyway). ``--trace`` adds, for each
form, where one frame's device time went by phase kind
(``fused_layer.cp_frame_trace_phases``: the work between barriers, its
staging and its GEMV, and the barriers).

``--sweep`` (int8_matmul) also times the kernel at every K split count its plan could
pick, at each m <= 16 shape, through the library's C entry directly (the
checkout's entry must take the plan: rows, K rows per chunk, splits).
``--sass`` (int8_matmul) first counts, in each instantiation of the kernel in the built
library's SASS (``cuobjdump -sass``), its tensor-core products (HMMA), its
asynchronous copies (LDGSTS), ldmatrix (LDSM) and any atomics (ATOM, ATOMS,
RED).

Prints one JSON object per shape or form on stdout. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import torch

# Weight bytes a timing cycles through: 2.4x an H100's 50 MB L2.
COLD_BYTES = 120e6
GRAPH_CALLS = 20
CP_FORMS = (("float32", torch.float32), ("bfloat16", torch.bfloat16), ("int8", torch.bfloat16))
# The code predictor's (K, N) on its per-step path (1.7B, intermediate 2816
# on that path and the stock 3072): qkv, o, gate|up, down, lm heads.
CP_KN = [(1024, 4096), (2048, 1024), (1024, 5632), (2816, 1024), (1024, 6144), (3072, 1024), (1024, 2048)]
# (m, K, N): the int8 talker prefill's projections (10 rows), the codec head
# (1 row, every frame), a longer prompt's prefill (32, 64 rows), the GEMM
# tier's top (1024), then the per-step code predictor's 2-row prefill and
# 1-row heads.
SHAPES = [(10, 2048, 4096), (10, 2048, 2048), (10, 2048, 12288), (10, 6144, 2048), (1, 2048, 3072),
          (32, 2048, 4096), (64, 2048, 4096), (1024, 2048, 4096)] + [(m, k, n) for k, n in CP_KN for m in (2, 1)]


def call_ms(fn, iters: int = GRAPH_CALLS) -> float:
    """Per call from Python: CUDA events around ``iters`` calls (after one
    warm-up call), host time included where it exceeds the device's."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


_CAPTURE_STREAMS: dict = {}


def capture_stream() -> torch.cuda.Stream:
    """The one side stream of the current device that every capture uses
    (each stream that runs a cuBLAS call keeps a workspace of its own for
    the life of the process)."""
    dev = torch.cuda.current_device()
    if dev not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[dev] = torch.cuda.Stream(dev)
    return _CAPTURE_STREAMS[dev]


def graph_ms(fns: list, iters: int) -> float:
    """Device span of one call: ``iters`` calls, cycling through ``fns``,
    captured in a CUDA graph and replayed between CUDA events (no host time
    inside), divided by ``iters``. Each fn runs once first, on the stream
    the capture then uses (``capture_stream``), so that state built on
    first use (the kernel library, cuBLAS handles, a frame pack's stream)
    stays outside the capture."""
    stream = capture_stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for fn in fns:
            fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for i in range(iters):
            fns[i % len(fns)]()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cold_copies(w: dict) -> list[dict]:
    """``w`` and enough copies of it to cycle through ``COLD_BYTES``."""
    copies = max(1, math.ceil(COLD_BYTES / w["q8"].numel()))
    return [w] + [{"q8": w["q8"].clone(), "scale": w["scale"].clone()} for _ in range(copies - 1)]


def time_shape(quant, x: torch.Tensor, w: dict) -> dict:
    """Kernel 4 (``quant.int8_matmul``) and the library yardstick on ``x``
    and the quantized weight ``w``: ``ms`` and ``library_ms`` per call from
    Python, ``device_ms`` and ``library_device_ms`` the device spans."""
    ws = cold_copies(w)
    deqs = [(c["q8"].float() * c["scale"]).to(torch.bfloat16) for c in ws]
    iters = max(GRAPH_CALLS, len(ws))
    return {
        "device_ms": graph_ms([lambda c=c: quant.int8_matmul(x, c["q8"], c["scale"]) for c in ws], iters),
        "library_device_ms": graph_ms([lambda d=d: torch.matmul(x, d) for d in deqs], iters),
        "ms": call_ms(lambda: quant.int8_matmul(x, w["q8"], w["scale"])),
        "library_ms": call_ms(lambda: torch.matmul(x, deqs[0])),
    }


def sweep_shape(quant, x: torch.Tensor, w: dict, repeats: int) -> dict:
    """Device span of the kernel at every split count 1..min(chunks, 16),
    its plan's rows and chunk rows kept, launched through the C entry."""
    dev = x.device
    plan = quant.int8_matmul_plan(x.shape[0], x.shape[1], w["q8"].shape[1],
                                  torch.cuda.get_device_properties(dev).multi_processor_count)
    lib = quant._kernel_lib()
    m, k = x.shape
    n = w["q8"].shape[1]
    ws = cold_copies(w)
    out = torch.empty((m, n), dtype=x.dtype, device=dev)
    iters = max(GRAPH_CALLS, len(ws))

    def launch(c, splits):
        err = lib.q3_int8_matmul(quant._DTYPES[x.dtype], x.data_ptr(), c["q8"].data_ptr(), c["scale"].data_ptr(),
                                 out.data_ptr(), m, k, n, plan.bm, plan.bk, splits,
                                 torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"int8_matmul kernel launch failed: CUDA error {err}")

    counts = range(1, min(k // plan.bk, 16) + 1)
    times = {s: [] for s in counts}
    for _ in range(repeats):
        for s in counts:
            times[s].append(graph_ms([lambda c=c, s=s: launch(c, s) for c in ws], iters))
    return {"plan_splits": plan.splits, "device_ms_by_splits": times}


def sass_counts() -> list[dict]:
    """Instruction counts of each ``int8_mm_tc`` instantiation in the SASS
    of the kernel library (built if needed)."""
    from qwen3_tts_tpu_torch import build

    tool = Path(build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(build.build())], capture_output=True, text=True,
                          check=True).stdout
    counts = []
    for part in text.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        if "int8_mm_tc" in name:
            ops = ("HMMA", "LDGSTS", "LDSM", "ATOM", "ATOMS", "RED")
            counts.append({"function": name, **{op: len(re.findall(rf"\b{op}\b", part)) for op in ops}})
    return counts


def frame_call(fused_layer, params: dict, cfg, h: torch.Tensor, s: torch.Tensor):
    """One ``cp_frame`` call as the checkout's main path makes it: with a
    pack of its own where the checkout has packs (built here, outside the
    call)."""
    if not hasattr(fused_layer, "CpFramePack"):
        return lambda: fused_layer.cp_frame(params, cfg, h, s)
    pack = fused_layer.CpFramePack(params, cfg, h.dtype, h.device)
    return lambda: fused_layer.cp_frame(params, cfg, h, s, pack)


def time_frame(fused_layer, params: dict, cfg, h: torch.Tensor, s: torch.Tensor) -> dict:
    """Kernel 1 on one frame: ``ms`` per call from Python and ``device_ms``
    the device span (each through its own pack: a graph keeps its frames'
    scratch)."""
    return {
        "ms": call_ms(frame_call(fused_layer, params, cfg, h, s)),
        "device_ms": graph_ms([frame_call(fused_layer, params, cfg, h, s)], GRAPH_CALLS),
    }


def cp_frame_lines(tag: str, repeats: int, trace: bool):
    """One JSON line per form of kernel 1 at 1.7B."""
    from qwen3_tts_tpu_torch import build
    from qwen3_tts_tpu_torch.models import weights as W
    from qwen3_tts_tpu_torch.models.config import config_for_variant
    from qwen3_tts_tpu_torch.ops import fused_layer, quant

    build.build()
    dev = torch.device("cuda", 0)
    cfg = config_for_variant("1.7B", "custom_voice").code_predictor
    gen = torch.Generator(device=dev).manual_seed(1)
    h = torch.randn((1, 1, cfg.embed_dim), generator=gen, device=dev)
    s = torch.randn((1, 1, cfg.embed_dim), generator=gen, device=dev) * 0.02
    for form, dtype in CP_FORMS:
        gen.manual_seed(2)
        params = W.fuse_model_params(W.init_code_predictor_params(gen, cfg, dtype))
        if form == "int8":
            params = quant.quantize_code_predictor_params(params)
        x, y = h.to(dtype), s.to(dtype)
        runs = [time_frame(fused_layer, params, cfg, x, y) for _ in range(repeats)]
        codes = fused_layer.cp_frame(params, cfg, x, y).tolist()
        line = {"tag": tag, "form": form, "codes": codes, **{key: [r[key] for r in runs] for key in runs[0]}}
        if trace:
            got, stamps = fused_layer.cp_frame(params, cfg, x, y, trace=True)
            torch.cuda.synchronize()
            line["traced_codes_equal"] = got.tolist() == codes
            line["phases_us"] = fused_layer.cp_frame_trace_phases(stamps, cfg)
        yield line
        del params
        torch.cuda.empty_cache()


def int8_matmul_lines(tag: str, repeats: int, sweep: bool):
    """One JSON line per shape of kernel 4."""
    from qwen3_tts_tpu_torch.ops import quant

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(6)
    for m, k, n in SHAPES:
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        w = quant.quantize_linear(torch.randn((k, n), generator=gen, device=dev) * 0.02)
        runs = [time_shape(quant, x, w) for _ in range(repeats)]
        line = {"tag": tag, "m": m, "k": k, "n": n, **{key: [r[key] for r in runs] for key in runs[0]}}
        if sweep and m <= 16:
            line.update(sweep_shape(quant, x, w, repeats))
        yield line


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", required=True, choices=("int8_matmul", "cp_frame"))
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parent.parent,
                    help="checkout whose qwen3_tts_tpu_torch is timed")
    ap.add_argument("--tag", default="", help="name printed on every line (default: --root)")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--sweep", action="store_true", help="int8_matmul: also time every K split count at m <= 16")
    ap.add_argument("--sass", action="store_true", help="int8_matmul: first count the kernel's SASS instructions")
    ap.add_argument("--trace", action="store_true", help="cp_frame: add each form's per-phase breakdown")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_timing: no CUDA device")
    sys.path[0] = str(args.root.resolve())  # in place of this file's directory

    tag = args.tag or str(args.root)
    if args.kernel == "cp_frame":
        for line in cp_frame_lines(tag, args.repeats, args.trace):
            print(json.dumps(line), flush=True)
        return
    if args.sass:
        for line in sass_counts():
            print(json.dumps({"tag": tag, **line}), flush=True)
    for line in int8_matmul_lines(tag, args.repeats, args.sweep):
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
