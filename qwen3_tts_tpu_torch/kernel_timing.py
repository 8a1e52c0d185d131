"""A kernel's timings on the card, for comparing two checkouts.

    python3 qwen3_tts_tpu_torch/kernel_timing.py
        --kernel int8_matmul|cp_frame|talker_step|cp_step|fused_step|residual_unit|prefill
        [--root DIR] [--tag NAME] [--repeats R] [--sweep] [--rows] [--sass] [--trace] [--forms F,...] [--kernels]
        [--sublayer attention|mlp]

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

``--kernel talker_step`` (kernel 3, ``ops.fused_layer.talker_step``): one
decode step of the 1.7B talker's 28 layers (random weights from seed 4) in
f32, bf16 and int8 (bf16 activations), with caches of 160 rows (the
125-frame main path's) and 2080 rows (the 2048-frame tier's), at the pos
``chip_smoke.py`` times it at (``time_step``; the 1.4-5.6 GB of weights do
not stay in L2). ``--trace`` adds each form's breakdown by phase kind
(``fused_layer.talker_step_trace_phases``), where the checkout has one;
``--kernels`` the device kernels one call launches (torch.profiler; one
``--forms`` a process, since a process's later profiler sessions may
record no device activity).

``--kernel cp_step`` (kernel 7, ``ops.fused_layer.streamed_decode_step``):
one decode step of the 1.7B code predictor's 5 int8 layers (random
weights from seed 2) with bf16 and f32 activations (``--forms``), a
17-row cache, at pos 2, 9 and 16 (``time_cp_step``; the 78.6 MB of
int8 weights a step do not fit the 50 MB L2), beside its plain version per
call (``chip_smoke.py`` gives its byte bound). A checkout without
``CpStepPack`` (the 51-operation chain before it) is timed through its
pack-free wrapper. ``--trace`` adds each form's
breakdown by phase kind (``fused_layer.talker_step_trace_phases``), where
the checkout has one; ``--kernels`` the device kernels one call launches
(torch.profiler; one ``--forms`` a process).

``--kernel fused_step`` (kernels 5 and 6, ``ops.fused_layer.
fused_attention_step`` and ``fused_mlp_step``): each sub-layer of 5 int8
layers (random weights from seed 5) at ``FUSED_STEP_CASES``, the 1.7B code
predictor's widths (intermediate 2816 and 3072, 17 cache rows, pos 2, 9
and 16, residual) in bf16 and f32 (``--forms``), and the 1.7B talker's
4-chip shard (4 / 2 heads, intermediate 1536, 2080 rows, pos 2079, no
residual) in bf16: the device span (20 calls in a CUDA graph, cycling
through the 5 layers as the route does, so that each call's weights
arrive cold: 5 layers hold 74.7 MB of int8 weights at intermediate 2816,
above the 50 MB L2), the time per call from Python (the same cycle) and
the plain version per call (``fused_step_times``). The calls are the
checkout's public wrappers, through a ``FusedStepPack`` (built outside
the call, one for the graph and one for the calls) where the checkout has
one, and pack-free where it has none. ``--trace`` adds each sub-layer's
phase stamps (``fused_layer.fused_step_trace_phases``) where the checkout
has them; ``--kernels`` the device kernels one call of ``--sublayer``
launches at the first case, and stops there (torch.profiler; one
sub-layer a process).

``--kernel residual_unit`` (kernel 2, ``models.codec.fused_blocks.
residual_unit``): the 9 units of a 128-frame decode bucket at their
main-path shapes (C = 384 / 192 / 96 over 20480 / 81920 / 245760 rows,
dilations 1, 3, 9; random unit weights from seed 3, as ``chip_smoke.py``
draws them), each unit's device span (calls in a CUDA graph) and time per
call from Python, then the device span of the 9 calls in one graph, the
plain version per call, and the library yardstick the port never calls:
``F.conv1d`` (cuDNN, TF32 off as the package sets it) for the dilated k7
conv plus one ``torch.matmul`` for the 1x1, without the snakes, on inputs
laid out channels-first (and left-padded) ahead of time; and the card's two
bounds for the 9 units' flops (f32 FMA at 67 TFLOP/s; 3xTF32, three TF32
products at 495 TFLOP/s). ``--sweep`` also times each unit at every chunk
width and window of taps that fits (``fused_blocks.residual_unit_ring``,
the deepest ring), through the kernel's C entry, where the checkout has
that plan.

``--kernel prefill`` (the talker's batch-1 prefill, ``models.talker.
prefill``, of a 10-row CustomVoice prompt at the 1.7B and 0.6B talkers'
widths, full depth, bf16 and int8): eager, and replayed as one CUDA graph
where the checkout has ``talker.PrefillGraph``. Per call from Python
(CUDA events around back-to-back calls), per call on the host's clock with
a synchronise after each (what the benchmark's ``prefill_ms_p50`` reads),
the replay's device span (CUDA events around the bare graph launch), and,
from one torch.profiler session over one call of each, the device kernels
each launched and their summed time on the device.

``--rows`` (int8_matmul) times ``ROW_SHAPES`` in place of ``SHAPES``: the
talker's projections at the rows of the batched and prompt prefills, the
code predictor's at the Jacobi stack's. ``--sweep`` (int8_matmul) also
times the kernel at every K segment count at each m <= 16 shape, and in
both cluster forms at the plan's segments above, through the library's C
entry directly (the checkout's entry must take the plan: rows, K rows per
chunk, segments, cluster).
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
import time
from pathlib import Path

import torch

# Weight bytes a timing cycles through: 2.4x an H100's 50 MB L2.
COLD_BYTES = 120e6
GRAPH_CALLS = 20
# Kernel 2's main-path shapes: (C, rows) of the residual units of a 128-frame
# bucket (x4 upsample, then the decoder blocks' rates 8, 5, 4 and 3), each at
# dilations 1, 3, 9.
RU_SHAPES = [(384, 128 * 4 * 8 * 5), (192, 128 * 4 * 8 * 5 * 4), (96, 128 * 4 * 8 * 5 * 4 * 3)]
RU_DILATIONS = (1, 3, 9)
# The card's published f32 FMA and TF32 tensor-core peaks (H100 SXM).
F32_FLOPS, TF32_FLOPS = 67e12, 495e12
# Kernel 3's cache sizes: the 125-frame main path's and the 2048-frame tier's.
TALKER_ROWS = (160, 2080)
# Kernel 7's activations (int8 weights) and positions: the first, a middle
# and the last decode step of the code predictor's 17-row cache.
CP_STEP_FORMS = (("bfloat16", torch.bfloat16), ("float32", torch.float32))
CP_STEP_POSITIONS = (2, 9, 16)
CP_STEP_ROWS = 17
CP_FORMS = (("float32", torch.float32), ("bfloat16", torch.bfloat16), ("int8", torch.bfloat16))
# The code predictor's (K, N) on its per-step path (1.7B, intermediate 2816
# on that path and the stock 3072): qkv, o, gate|up, down, lm heads.
# Kernels 5 and 6: (case, dims, positions, residual, forms) -- the 1.7B code
# predictor at the intermediate of the route's cell (2816) and the stock
# 3072, and the 1.7B talker's per-chip shard on 4 chips.
_CP_DIMS = dict(hidden=1024, heads=16, kv_heads=8, head_dim=128, rows=17)
FUSED_STEP_CASES = (
    ("cp-i2816", dict(_CP_DIMS, inter=2816), (2, 9, 16), True, ("bfloat16", "float32")),
    ("cp-i3072", dict(_CP_DIMS, inter=3072), (2, 9, 16), True, ("bfloat16", "float32")),
    ("tp4", dict(hidden=2048, heads=4, kv_heads=2, head_dim=128, inter=1536, rows=2080), (2079,), False,
     ("bfloat16",)),
)
FUSED_STEP_LAYERS = 5
CP_KN = [(1024, 4096), (2048, 1024), (1024, 5632), (2816, 1024), (1024, 6144), (3072, 1024), (1024, 2048)]
# (m, K, N): the int8 talker prefill's projections (10 rows), the codec head
# (1 row, every frame), a longer prompt's prefill (32, 64 rows), the GEMM
# tier's top (1024), then the per-step code predictor's 2-row prefill and
# 1-row heads.
SHAPES = [(10, 2048, 4096), (10, 2048, 2048), (10, 2048, 12288), (10, 6144, 2048), (1, 2048, 3072),
          (32, 2048, 4096), (64, 2048, 4096), (1024, 2048, 4096)] + [(m, k, n) for k, n in CP_KN for m in (2, 1)]
# ``--rows``: the talker's four projections (qkv, o, gate|up, down) at the
# rows of a B = 1 prefill (10), a dp = 2 replica's and the B = 8 batch's
# (40, 80), the ICL prompts' (105; 128 the tier's second row tile), a
# batch of long prompts (256, 512) and the largest call (1024), and the
# code predictor's four at the Jacobi stack's 16 and 128 rows.
TALKER_PROJ_KN = [(2048, 4096), (2048, 2048), (2048, 12288), (6144, 2048)]
CP_PROJ_KN = [(1024, 4096), (2048, 1024), (1024, 6144), (3072, 1024)]
ROW_SHAPES = [(m, k, n) for m in (10, 40, 80, 105, 128, 256, 512, 1024) for k, n in TALKER_PROJ_KN] + [
    (m, k, n) for m in (16, 128) for k, n in CP_PROJ_KN]


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
    """Device span of the kernel, its plan's rows and chunk rows kept,
    launched through the C entry: at m <= 16 at every segment count
    1..min(K / 64, 16) (a segment a block of the tile's cluster); above, at
    the plan's segments both ways, a segment a block of the cluster and one
    block walking them all (the same bits)."""
    dev = x.device
    plan = quant.int8_matmul_plan(x.shape[0], x.shape[1], w["q8"].shape[1],
                                  torch.cuda.get_device_properties(dev).multi_processor_count)
    lib = quant._kernel_lib()
    m, k = x.shape
    n = w["q8"].shape[1]
    ws = cold_copies(w)
    out = torch.empty((m, n), dtype=x.dtype, device=dev)
    iters = max(GRAPH_CALLS, len(ws))

    def launch(c, splits, cluster):
        err = lib.q3_int8_matmul(quant._DTYPES[x.dtype], x.data_ptr(), c["q8"].data_ptr(), c["scale"].data_ptr(),
                                 out.data_ptr(), m, k, n, plan.bm, plan.bk, splits, cluster,
                                 torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"int8_matmul kernel launch failed: CUDA error {err}")

    if plan.tier == 0:
        cases = {s: (s, s) for s in range(1, min(k // quant.INT8_MM_STEP, 16) + 1)}
    else:
        cases = {c: (plan.splits, c) for c in sorted({plan.splits, 1})}
    times = {key: [] for key in cases}
    for _ in range(repeats):
        for key, (splits, cluster) in cases.items():
            times[key].append(graph_ms([lambda c=c: launch(c, splits, cluster) for c in ws], iters))
    key = "device_ms_by_splits" if plan.tier == 0 else "device_ms_by_cluster"
    return {"plan_splits": plan.splits, "plan_cluster": plan.cluster, key: times}


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


def step_call(fused_layer, layers: dict, stack, x, ck, cv, pos: int):
    """One ``talker_step`` call as the checkout's main path makes it: through
    a pack of its own where the checkout has packs (built here, outside the
    call)."""
    if not hasattr(fused_layer, "TalkerStepPack"):
        return lambda: fused_layer.talker_step(layers, x, stack, ck, cv, pos)
    pack = fused_layer.TalkerStepPack(layers, stack, x.dtype, x.device)
    return lambda: fused_layer.talker_step(layers, x, stack, ck, cv, pos, pack)


def time_step(fused_layer, layers: dict, stack, x, ck, cv, pos: int) -> dict:
    """Kernel 3 on one step: ``ms`` per call from Python and ``device_ms``
    the device span (each through its own pack, where the checkout has
    packs: a graph keeps its steps' scratch)."""
    return {
        "ms": call_ms(step_call(fused_layer, layers, stack, x, ck, cv, pos)),
        "device_ms": graph_ms([step_call(fused_layer, layers, stack, x, ck, cv, pos)], GRAPH_CALLS),
    }


def device_kernels(fn) -> list | None:
    """The device kernels one warm call of ``fn`` launches, by name, as
    torch.profiler records them (None where it records no device activity:
    a process's later profiler sessions may record none, so run one form a
    process to count each)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return names or None


def talker_step_lines(tag: str, repeats: int, trace: bool, forms: tuple = (), kernels: bool = False):
    """One JSON line per form of kernel 3 at 1.7B (those in ``forms``, or
    all) and cache size; with ``kernels``, the first cache size's line also
    lists the device kernels one call launches."""
    from qwen3_tts_tpu_torch import build
    from qwen3_tts_tpu_torch.models import weights as W
    from qwen3_tts_tpu_torch.models.config import config_for_variant
    from qwen3_tts_tpu_torch.ops import fused_layer, quant

    build.build()
    dev = torch.device("cuda", 0)
    stack = config_for_variant("1.7B", "custom_voice").talker.layer_stack()
    kvd = stack.num_kv_heads * stack.head_dim
    for form, dtype in CP_FORMS:
        if forms and form not in forms:
            continue
        gen = torch.Generator(device=dev).manual_seed(4)
        layers = W.fuse_layer_params(W.init_layer_stack(
            gen, stack.num_layers, stack.hidden_size, stack.intermediate_size, stack.num_heads,
            stack.num_kv_heads, stack.head_dim, dtype))
        if form == "int8":
            layers = quant.quantize_layer_stack(layers)
        x = torch.randn((1, 1, stack.hidden_size), generator=gen, device=dev).to(dtype)
        for rows in TALKER_ROWS:
            ck = torch.randn((stack.num_layers, rows, kvd), generator=gen, device=dev).to(dtype)
            cv = torch.randn((stack.num_layers, rows, kvd), generator=gen, device=dev).to(dtype)
            pos = rows - 1 - 3 * 15  # chip_smoke.py's timed pos (its last trial)
            runs = [time_step(fused_layer, layers, stack, x, ck, cv, pos) for _ in range(repeats)]
            y = fused_layer.talker_step(layers, x, stack, ck, cv, pos)
            line = {"tag": tag, "form": form, "rows": rows, "pos": pos, "y_abs_sum": y.float().abs().sum().item(),
                    **{key: [r[key] for r in runs] for key in runs[0]}}
            if kernels and rows == TALKER_ROWS[0]:
                line["device_kernels"] = device_kernels(step_call(fused_layer, layers, stack, x, ck, cv, pos))
            if trace and hasattr(fused_layer, "talker_step_trace_phases"):
                got, stamps = fused_layer.talker_step(layers, x, stack, ck, cv, pos, trace=True)
                torch.cuda.synchronize()
                line["traced_equal"] = torch.equal(got, y)
                line["phases_us"] = fused_layer.talker_step_trace_phases(stamps, stack)
            yield line
            del ck, cv
        del layers
        torch.cuda.empty_cache()


def cp_step_call(fused_layer, layers: dict, stack, x, ck, cv, pos: int, cos_t, sin_t):
    """One ``streamed_decode_step`` call as the checkout's main path makes it:
    through a pack of its own where the checkout has packs (built here,
    outside the call)."""
    if not hasattr(fused_layer, "CpStepPack"):
        return lambda: fused_layer.streamed_decode_step(layers, x, stack, ck, cv, pos, cos_t, sin_t)
    pack = fused_layer.CpStepPack(layers, stack, x.dtype, x.device)
    return lambda: fused_layer.streamed_decode_step(layers, x, stack, ck, cv, pos, cos_t, sin_t, pack)


def time_cp_step(fused_layer, layers: dict, stack, x, ck, cv, pos: int, cos_t, sin_t) -> dict:
    """Kernel 7 on one step: ``ms`` per call from Python and ``device_ms``
    the device span (each through its own pack, where the checkout has
    packs: a graph keeps its steps' scratch)."""
    return {
        "ms": call_ms(cp_step_call(fused_layer, layers, stack, x, ck, cv, pos, cos_t, sin_t)),
        "device_ms": graph_ms([cp_step_call(fused_layer, layers, stack, x, ck, cv, pos, cos_t, sin_t)], GRAPH_CALLS),
    }


def cp_step_lines(tag: str, repeats: int, trace: bool, forms: tuple = (), kernels: bool = False):
    """One JSON line per form of kernel 7 at the 1.7B code predictor (those
    in ``forms``, or both) and pos; with ``kernels``, the first pos's line
    also lists the device kernels one call launches."""
    from qwen3_tts_tpu_torch import build
    from qwen3_tts_tpu_torch.models import weights as W
    from qwen3_tts_tpu_torch.models.config import config_for_variant
    from qwen3_tts_tpu_torch.ops import fused_layer, quant

    build.build()
    dev = torch.device("cuda", 0)
    stack = config_for_variant("1.7B", "custom_voice").code_predictor.layer_stack()
    kvd = stack.num_kv_heads * stack.head_dim
    cos_t, sin_t = fused_layer.rope_tables(stack.head_dim, stack.rope_theta, CP_STEP_ROWS, dev)
    for form, dtype in CP_STEP_FORMS:
        if forms and form not in forms:
            continue
        gen = torch.Generator(device=dev).manual_seed(2)
        layers = quant.quantize_layer_stack(W.fuse_layer_params(W.init_layer_stack(
            gen, stack.num_layers, stack.hidden_size, stack.intermediate_size, stack.num_heads,
            stack.num_kv_heads, stack.head_dim, dtype)))
        x = torch.randn((1, 1, stack.hidden_size), generator=gen, device=dev).to(dtype)
        ck = torch.randn((stack.num_layers, CP_STEP_ROWS, kvd), generator=gen, device=dev).to(dtype)
        cv = torch.randn((stack.num_layers, CP_STEP_ROWS, kvd), generator=gen, device=dev).to(dtype)
        for pos in CP_STEP_POSITIONS:
            runs = [time_cp_step(fused_layer, layers, stack, x, ck, cv, pos, cos_t, sin_t) for _ in range(repeats)]
            y = fused_layer.streamed_decode_step(layers, x, stack, ck, cv, pos, cos_t, sin_t)
            plain = lambda pos=pos: fused_layer.streamed_decode_step_plain(  # noqa: E731
                layers, x, stack, ck, cv, pos, cos_t, sin_t)
            line = {"tag": tag, "form": form, "pos": pos, "y_abs_sum": y.float().abs().sum().item(),
                    **{key: [r[key] for r in runs] for key in runs[0]}, "plain_ms": call_ms(plain, 3)}
            if kernels and pos == CP_STEP_POSITIONS[0]:
                line["device_kernels"] = device_kernels(
                    cp_step_call(fused_layer, layers, stack, x, ck, cv, pos, cos_t, sin_t))
            if trace and hasattr(fused_layer, "CpStepPack"):
                got, stamps = fused_layer.streamed_decode_step(layers, x, stack, ck, cv, pos, cos_t, sin_t,
                                                               trace=True)
                torch.cuda.synchronize()
                line["traced_equal"] = torch.equal(got, y)
                line["phases_us"] = fused_layer.talker_step_trace_phases(stamps, stack)
            yield line
        del layers, ck, cv
        torch.cuda.empty_cache()


def fused_step_fns(fused_layer, nn, layers: dict, stack, x, ck, cv, pos: int, cos_t, sin_t, residual: bool):
    """The checkout's kernel-5 and kernel-6 calls on each layer, as its
    route makes them: two lists of callables, layer by layer, through one
    ``FusedStepPack`` (built here, outside the calls) where the checkout
    has one, else pack-free."""
    views = [nn.layer_params_at(layers, l) for l in range(stack.num_layers)]
    args = (stack.num_heads, stack.num_kv_heads, stack.head_dim, stack.rms_norm_eps, residual)
    pack = None
    if hasattr(fused_layer, "FusedStepPack"):
        pack = fused_layer.FusedStepPack(layers, stack, x.dtype, x.device, max_seq=ck.shape[1])

    def kw(l):
        return {} if pack is None else {"pack": pack, "layer_index": l}

    attn = [lambda l=l: fused_layer.fused_attention_step(x, views[l], cos_t, sin_t, ck[l], cv[l], pos, *args, **kw(l))
            for l in range(stack.num_layers)]
    mlp = [lambda l=l: fused_layer.fused_mlp_step(x, views[l], stack.intermediate_size, stack.rms_norm_eps, residual,
                                                  **kw(l)) for l in range(stack.num_layers)]
    return attn, mlp


def cycled(fns: list):
    """One callable that calls ``fns`` in turn, one a call."""
    state = {"i": 0}

    def call():
        fn = fns[state["i"] % len(fns)]
        state["i"] += 1
        return fn()

    return call


def fused_step_times(fused_layer, nn, layers: dict, stack, x, ck, cv, pos: int, cos_t, sin_t,
                     residual: bool) -> dict:
    """Kernels 5 and 6, each cycling through the layers: ``device_ms`` the
    device span (GRAPH_CALLS calls in a CUDA graph) and ``ms`` per call from
    Python (each through a pack of its own, where the checkout has packs: a
    graph keeps its calls' scratch and stream)."""
    graph = fused_step_fns(fused_layer, nn, layers, stack, x, ck, cv, pos, cos_t, sin_t, residual)
    calls = fused_step_fns(fused_layer, nn, layers, stack, x, ck, cv, pos, cos_t, sin_t, residual)
    return {
        "attention_device_ms": graph_ms(graph[0], GRAPH_CALLS),
        "attention_ms": call_ms(cycled(calls[0])),
        "mlp_device_ms": graph_ms(graph[1], GRAPH_CALLS),
        "mlp_ms": call_ms(cycled(calls[1])),
    }


def fused_step_lines(tag: str, repeats: int, trace: bool, forms: tuple = (), kernels: bool = False,
                     sublayer: str = "attention"):
    """One JSON line per case of ``FUSED_STEP_CASES``, form (those in
    ``forms``, or all) and pos: kernels 5 and 6 by ``fused_step_times``
    (``repeats`` times), their plain versions per call, the outputs' sums;
    with ``kernels``, the first line also lists the device kernels one call
    of ``sublayer`` launches, and is the last."""
    from qwen3_tts_tpu_torch import build
    from qwen3_tts_tpu_torch.models import weights as W
    from qwen3_tts_tpu_torch.ops import fused_layer, nn, quant

    build.build()
    dev = torch.device("cuda", 0)
    first = True
    for case, dims, positions, residual, case_forms in FUSED_STEP_CASES:
        stack = nn.LayerStackConfig(
            hidden_size=dims["hidden"], intermediate_size=dims["inter"], num_layers=FUSED_STEP_LAYERS,
            num_heads=dims["heads"], num_kv_heads=dims["kv_heads"], head_dim=dims["head_dim"])
        rows, kvd = dims["rows"], dims["kv_heads"] * dims["head_dim"]
        cos_t, sin_t = fused_layer.rope_tables(stack.head_dim, stack.rope_theta, rows, dev)
        for form in case_forms:
            if forms and form not in forms:
                continue
            dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[form]
            gen = torch.Generator(device=dev).manual_seed(5)
            layers = quant.quantize_layer_stack(W.fuse_layer_params(W.init_layer_stack(
                gen, FUSED_STEP_LAYERS, stack.hidden_size, stack.intermediate_size, stack.num_heads,
                stack.num_kv_heads, stack.head_dim, dtype)))
            x = torch.randn((1, stack.hidden_size), generator=gen, device=dev).to(dtype)
            ck = torch.randn((FUSED_STEP_LAYERS, rows, kvd), generator=gen, device=dev).to(dtype)
            cv = torch.randn((FUSED_STEP_LAYERS, rows, kvd), generator=gen, device=dev).to(dtype)
            layer0 = nn.layer_params_at(layers, 0)
            for pos in positions:
                runs = [fused_step_times(fused_layer, nn, layers, stack, x, ck, cv, pos, cos_t, sin_t, residual)
                        for _ in range(repeats)]
                attn, mlp = fused_step_fns(fused_layer, nn, layers, stack, x, ck, cv, pos, cos_t, sin_t, residual)
                args = (pos, stack.num_heads, stack.num_kv_heads, stack.head_dim, stack.rms_norm_eps, residual)
                plain_ck, plain_cv = ck[0].clone(), cv[0].clone()
                line = {
                    "tag": tag, "case": case, "form": form, "pos": pos, "rows": rows, "residual": residual,
                    "attention_y_abs_sum": attn[0]().float().abs().sum().item(),
                    "mlp_y_abs_sum": mlp[0]().float().abs().sum().item(),
                    **{key: [r[key] for r in runs] for key in runs[0]},
                    "attention_plain_ms": call_ms(lambda: fused_layer.fused_attention_step_plain(
                        x, layer0, cos_t, sin_t, plain_ck, plain_cv, *args), 3),
                    "mlp_plain_ms": call_ms(lambda: fused_layer.fused_mlp_step_plain(
                        x, layer0, stack.intermediate_size, stack.rms_norm_eps, residual), 3),
                }
                if kernels and first:
                    fn = {"attention": attn, "mlp": mlp}[sublayer][0]
                    line["device_kernels_sublayer"] = sublayer
                    line["device_kernels"] = device_kernels(fn)
                if trace and hasattr(fused_layer, "fused_step_trace_phases"):
                    line["phases_us"] = fused_step_phases(fused_layer, nn, layers, stack, x, ck, cv, pos, cos_t,
                                                          sin_t, residual)
                first = False
                yield line
                if kernels:  # the profiled line only: the rest are timed by a run without --kernels
                    return
            del layers, ck, cv
            torch.cuda.empty_cache()


def fused_step_phases(fused_layer, nn, layers: dict, stack, x, ck, cv, pos: int, cos_t, sin_t,
                      residual: bool) -> dict:
    """Each sub-layer's phases on layer 0, from the kernels' own stamps
    (``fused_step_trace_phases``), and whether the traced call gave the
    untraced call's bits."""
    pack = fused_layer.FusedStepPack(layers, stack, x.dtype, x.device, max_seq=ck.shape[1])
    layer = nn.layer_params_at(layers, 0)
    args = (stack.num_heads, stack.num_kv_heads, stack.head_dim, stack.rms_norm_eps, residual)
    out = {}
    for name in ("attention", "mlp"):
        def call(trace, name=name):
            if name == "attention":
                return fused_layer.fused_attention_step(x, layer, cos_t, sin_t, ck[0], cv[0], pos, *args, pack=pack,
                                                        layer_index=0, trace=trace)
            return fused_layer.fused_mlp_step(x, layer, stack.intermediate_size, stack.rms_norm_eps, residual,
                                              pack=pack, layer_index=0, trace=trace)

        want = call(False)
        got, stamps = call(True)
        torch.cuda.synchronize()
        out[name] = {"traced_equal": torch.equal(got, want), **fused_layer.fused_step_trace_phases(stamps, name)}
    return out


def unit_params(gen: torch.Generator, c: int) -> dict:
    """A residual unit's random weights, as ``chip_smoke.py`` draws them."""
    dev = gen.device

    def rnd(shape, scale):
        return torch.randn(shape, generator=gen, device=dev) * scale

    return {
        "act1_alpha": rnd((c,), 0.1), "act1_beta": rnd((c,), 0.1),
        "conv1_w": rnd((7, c, c), 0.05), "conv1_b": rnd((c,), 0.1),
        "act2_alpha": rnd((c,), 0.1), "act2_beta": rnd((c,), 0.1),
        "conv2_w": rnd((1, c, c), 0.05), "conv2_b": rnd((c,), 0.1),
    }


def library_unit(x: torch.Tensor, p: dict, dilation: int):
    """The library yardstick for one unit: cuDNN's dilated k7 conv and one
    matmul for the 1x1 (no snakes, no residual), on x laid out channels-first
    and left-padded here, outside the call."""
    import torch.nn.functional as F

    xc = F.pad(x.transpose(1, 2), (6 * dilation, 0)).contiguous()  # [B, C, 6d + T]
    w1 = p["conv1_w"].permute(2, 1, 0).contiguous()  # [Cout, Cin, 7]
    w2 = p["conv2_w"][0].t().contiguous()  # [Cout, Cin]
    return lambda: torch.matmul(w2, F.conv1d(xc, w1, p["conv1_b"], dilation=dilation))


def ring_plans(fused_blocks, c: int, dilation: int) -> list:
    """Every (chunk width, taps a window) plan that fits, each with its
    deepest ring."""
    rings = (fused_blocks.residual_unit_ring(c, dilation, kc, taps)
             for kc in fused_blocks.RU_KC for taps in range(fused_blocks.RU_TAPS, 0, -1))
    return [plan for plan in rings if plan]


def residual_unit_lines(tag: str, repeats: int, sweep: bool):
    """One JSON line per unit of kernel 2 at its main-path shape, then one
    for the 9 together."""
    from qwen3_tts_tpu_torch import build
    from qwen3_tts_tpu_torch.models.codec import fused_blocks

    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    build.build()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(3)
    calls, totals, flops = [], {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}, 0
    for c, t in RU_SHAPES:
        for dil in RU_DILATIONS:
            p = unit_params(gen, c)
            x = torch.randn((1, t, c), generator=gen, device=dev)
            fn = lambda x=x, p=p, dil=dil: fused_blocks.residual_unit(x, p, dil)  # noqa: E731
            lib = library_unit(x, p, dil)
            runs = [{"device_ms": graph_ms([fn], 5), "ms": call_ms(fn, 5)} for _ in range(repeats)]
            line = {"tag": tag, "c": c, "t": t, "dilation": dil, **{key: [r[key] for r in runs] for key in runs[0]},
                    "plain_ms": call_ms(lambda: fused_blocks.residual_unit_plain(x, p, dil), 3),
                    "library_ms": call_ms(lib, 5), "library_device_ms": graph_ms([lib], 5)}
            if hasattr(fused_blocks, "residual_unit_ring"):
                line["plan"] = fused_blocks.residual_unit_plan(c, dil)._asdict()
                if sweep:
                    line["sweep"] = [
                        {**plan._asdict(), "device_ms": graph_ms(
                            [lambda plan=plan: fused_blocks._launch(x, p, dil, plan)], 5)}
                        for plan in ring_plans(fused_blocks, c, dil)]
            yield line
            calls.append(fn)
            for key in totals:
                totals[key] += min(line[key]) if isinstance(line[key], list) else line[key]
            flops += 2 * t * c * c * 8
    yield {"tag": tag, "units": len(calls), "device_ms_9": [graph_ms(calls, len(calls)) * len(calls)
                                                           for _ in range(repeats)],
           **{f"sum_{key}": v for key, v in totals.items()}, "gflop": flops / 1e9,
           "bound_f32_ms": flops / F32_FLOPS * 1e3, "bound_3xtf32_ms": 3 * flops / TF32_FLOPS * 1e3}


def wall_ms(fn, iters: int = GRAPH_CALLS) -> float:
    """Per call on the host's clock with a synchronise after each (after
    one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        total += time.perf_counter() - t0
    return total * 1e3 / iters


def profiled(fns: dict) -> dict:
    """One torch.profiler session over one warm call of each of ``fns`` in
    turn, a synchronise after each: for each key, the device kernels its
    call launched and their summed time on the device, in ms."""
    from torch.profiler import ProfilerActivity, profile

    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i, fn in enumerate(fns.values()):
            with torch.profiler.record_function(f"timing.{i}"):
                fn()
                torch.cuda.synchronize()
    events = prof.events()
    keys = {f"timing.{i}": key for i, key in enumerate(fns)}
    starts = sorted((e.time_range.start, keys[e.name]) for e in events if e.name in keys)
    out = {key: {"kernels": 0, "busy_ms": 0.0} for key in fns}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA or e.name in keys:
            continue
        owner = [key for start, key in starts if start <= e.time_range.start]
        if owner:
            out[owner[-1]]["kernels"] += 1
            out[owner[-1]]["busy_ms"] += e.time_range.elapsed_us() / 1e3
    return out


# The talker prefill's timed forms: the CustomVoice talkers, bf16 and int8 weights.
PREFILL_VARIANTS = ("1.7B", "0.6B")
PREFILL_FORMS = (("bfloat16", False), ("int8", True))


def prefill_lines(tag: str, repeats: int, forms: tuple = ()):
    """One JSON line per talker and form (those in ``forms``, or all) of the
    batch-1 prefill of a 10-row prompt: eager, and replayed where the
    checkout has ``talker.PrefillGraph``. The device kernels come from one
    profiler session over every line's calls (a process's later sessions
    may record nothing)."""
    from qwen3_tts_tpu_torch import build
    from qwen3_tts_tpu_torch.models import talker
    from qwen3_tts_tpu_torch.models import weights as W
    from qwen3_tts_tpu_torch.models.config import config_for_variant
    from qwen3_tts_tpu_torch.ops import nn, quant

    build.build()
    dev = torch.device("cuda", 0)
    lines, calls = [], {}
    for variant in PREFILL_VARIANTS:
        cfg = config_for_variant(variant, "custom_voice").talker
        gen = torch.Generator(device=dev).manual_seed(9)
        tree = W.fuse_model_params(W.init_talker_params(gen, cfg))
        prompt = (torch.randn((1, 10, cfg.hidden_size), generator=gen, device=dev) * 0.02).to(torch.bfloat16)
        for form, int8 in PREFILL_FORMS:
            if forms and form not in forms:
                continue
            params = quant.quantize_talker_params(tree) if int8 else tree
            cache = nn.init_kv_cache(cfg.layer_stack(), 1, 96, torch.bfloat16, dev)
            fns = {"eager": lambda p=params, c=cfg, x=prompt, kv=cache: talker.prefill(p, c, x, 10, kv)}
            graph = talker.PrefillGraph(params, cfg, 10) if hasattr(talker, "PrefillGraph") else None
            if graph is not None:
                fns["graph"] = lambda p=params, c=cfg, x=prompt, kv=cache, g=graph: talker.prefill(p, c, x, 10, kv, g)
            line = {"tag": tag, "variant": variant, "form": form}
            for name, fn in fns.items():
                line[f"{name}_ms"] = [call_ms(fn) for _ in range(repeats)]
                line[f"{name}_wall_ms"] = [wall_ms(fn) for _ in range(repeats)]
                calls[(len(lines), name)] = fn
            if graph is not None:
                line["replay_device_ms"] = [call_ms(graph.graph.replay) for _ in range(repeats)]
                eager, replayed = fns["eager"](), fns["graph"]()
                line["bit_equal"] = all(torch.equal(a, b) for a, b in zip(eager, replayed))
            lines.append(line)
    for (i, name), got in profiled(calls).items():
        lines[i][f"{name}_kernels"], lines[i][f"{name}_busy_ms"] = got["kernels"], got["busy_ms"]
    yield from lines


def int8_matmul_lines(tag: str, repeats: int, sweep: bool, shapes=SHAPES):
    """One JSON line per shape of kernel 4."""
    from qwen3_tts_tpu_torch.ops import quant

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(6)
    for m, k, n in shapes:
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        w = quant.quantize_linear(torch.randn((k, n), generator=gen, device=dev) * 0.02)
        runs = [time_shape(quant, x, w) for _ in range(repeats)]
        line = {"tag": tag, "m": m, "k": k, "n": n, **{key: [r[key] for r in runs] for key in runs[0]}}
        if sweep:
            line.update(sweep_shape(quant, x, w, repeats))
        yield line


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", required=True,
                    choices=("int8_matmul", "cp_frame", "talker_step", "cp_step", "fused_step", "residual_unit",
                             "prefill"))
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parent.parent,
                    help="checkout whose qwen3_tts_tpu_torch is timed")
    ap.add_argument("--tag", default="", help="name printed on every line (default: --root)")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--sweep", action="store_true",
                    help="int8_matmul: also time every K segment count at m <= 16 and both cluster forms above; "
                         "residual_unit: every chunk width and window of taps")
    ap.add_argument("--rows", action="store_true", help="int8_matmul: time ROW_SHAPES in place of SHAPES")
    ap.add_argument("--sass", action="store_true", help="int8_matmul: first count the kernel's SASS instructions")
    ap.add_argument("--trace", action="store_true",
                    help="cp_frame, talker_step, cp_step, fused_step: add each form's per-phase breakdown")
    ap.add_argument("--forms", default="",
                    help="talker_step, cp_step, fused_step, prefill: only these comma-separated forms "
                         "(float32, bfloat16, int8)")
    ap.add_argument("--kernels", action="store_true",
                    help="talker_step, cp_step, fused_step: add the device kernels one call launches (torch.profiler)")
    ap.add_argument("--sublayer", choices=("attention", "mlp"), default="attention",
                    help="fused_step --kernels: the sub-layer whose device kernels are counted")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_timing: no CUDA device")
    sys.path[0] = str(args.root.resolve())  # in place of this file's directory

    tag = args.tag or str(args.root)
    if args.kernel == "cp_frame":
        for line in cp_frame_lines(tag, args.repeats, args.trace):
            print(json.dumps(line), flush=True)
        return
    if args.kernel == "residual_unit":
        for line in residual_unit_lines(tag, args.repeats, args.sweep):
            print(json.dumps(line), flush=True)
        return
    forms = tuple(f for f in args.forms.split(",") if f)
    if args.kernel == "prefill":
        for line in prefill_lines(tag, args.repeats, forms):
            print(json.dumps(line), flush=True)
        return
    if args.kernel == "fused_step":
        for line in fused_step_lines(tag, args.repeats, args.trace, forms, args.kernels, args.sublayer):
            print(json.dumps(line), flush=True)
        return
    if args.kernel in ("talker_step", "cp_step"):
        lines = talker_step_lines if args.kernel == "talker_step" else cp_step_lines
        for line in lines(tag, args.repeats, args.trace, forms, args.kernels):
            print(json.dumps(line), flush=True)
        return
    if args.sass:
        for line in sass_counts():
            print(json.dumps({"tag": tag, **line}), flush=True)
    for line in int8_matmul_lines(tag, args.repeats, args.sweep, ROW_SHAPES if args.rows else SHAPES):
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
