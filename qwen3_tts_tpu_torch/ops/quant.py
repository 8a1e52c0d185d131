"""Weight-only int8: quantized linears and the W8A16 dequant matmul.

PyTorch port of ``qwen3_tts_tpu/ops/quant.py`` (weight-only mode). A
quantized linear is the dict ``{"q8": int8 [K, N], "scale": f32 [N]}``
(stacked layers: ``[L, K, N]`` and ``[L, N]``); ``mm(x, w)`` dispatches
between plain and quantized weights everywhere the model multiplies.

``int8_matmul`` computes ``x [.., K] @ dequant(q8 [K, N])``: x rounded to
bf16, the exact int8 -> bf16 weights, an f32 sum, times the per-column f32
scale, cast to x's dtype. On a CUDA tensor it launches the hand-written
W8A16 kernel (``csrc/int8_matmul.cu``, the port of ``_make_pallas_matmul``)
for the shapes the JAX package gives its Pallas kernel (m <= 1024 rows,
K and N multiples of 128), with the launch plan of ``int8_matmul_plan``;
other shapes take the plain form, as the JAX package takes XLA's
dequant-then-dot. On a CPU tensor it is always the plain form; any other
device raises.

Batched synthesis multiplies ``[B, m, K]`` activations: the leading dims
fold into B·m rows, so one launch reads the weight once for all streams
(the JAX package's batch rule ``_int8_mm_core_vmap``), and the gate above
sends B·m > 1024 to the plain form (``int8_matmul_route``). Per-example
weights (a batch axis on ``q8``) are not a shape the model makes, and
raise.

Inside ``w8a8_scope(True)`` (``Qwen3TTS(int8_activations=True)``: the
batched programs only, as in the JAX package) ``int8_matmul`` takes
``w8a8_matmul`` before kernel 4: the activations quantized per row and
an exact int8 x int8 -> int32 product (``torch._int_mm``, the counterpart
of the JAX package's XLA dot; not a Pallas kernel there), lossy by
design. On the card ``torch._int_mm`` wants more than 16 rows and K and N
multiples of 8: the rows, K and N are padded with zeros (``w8a8_padded``,
which also hands it the weight column-major), which leaves the int32
product exact, and cut back after it.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
from typing import NamedTuple

import torch

_LINEAR_KEYS = (
    "q_proj",
    "k_proj",
    "v_proj",
    "o_proj",
    "gate_proj",
    "up_proj",
    "down_proj",
    "qkv_proj",
    "gateup_proj",
)

# The JAX package's Pallas gate (quant.py: m <= 1024, K % 128, N % 128).
KERNEL_MAX_ROWS = 1024
KERNEL_ALIGN = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _absmax_scale(amax: torch.Tensor) -> torch.Tensor:
    """``max(amax, 1e-8) / 127`` as a true division on every device (on a
    CUDA tensor PyTorch divides by a Python scalar through its reciprocal,
    which can be one ulp off the JAX package's quotient)."""
    return torch.clamp(amax, min=1e-8) / amax.new_full((), 127.0)


def quantize_linear(w: torch.Tensor) -> dict:
    """[..., K, N] float weights -> {"q8": int8 [..., K, N], "scale": f32 [..., N]}.

    Per-output-channel symmetric absmax, bit for bit the JAX package's
    (f32 division, round half to even, clip to +-127).
    """
    wf = w.float()
    scale = _absmax_scale(wf.abs().amax(dim=-2))
    q8 = torch.clamp(torch.round(wf / scale.unsqueeze(-2)), -127, 127).to(torch.int8)
    return {"q8": q8, "scale": scale}


def is_quantized(w) -> bool:
    return isinstance(w, dict) and "q8" in w


def int8_matmul_plain(x2: torch.Tensor, q8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """[.., K] @ dequant([K, N]) -> [.., N] in plain PyTorch.

    The counterpart of ``_dequant_matmul_reference``: each product of a
    bf16 value and an int8 weight is exact in f32, so an f32 matmul of the
    bf16-rounded operands is that reference up to summation order.
    """
    acc = x2.to(torch.bfloat16).float() @ q8.float()
    return (acc * scale.float()).to(x2.dtype)


# csrc/int8_matmul.cu's two instantiations, (rows, K rows per chunk) of a
# block's tile: tier 0 for m <= 16, tier 1 above (the C entry refuses any
# other pair). Every tile is 128 columns.
INT8_MM_TIERS = ((16, 64), (64, 32))
INT8_MM_COLS = 128
# K is summed in segments of whole 64-row steps (a tier-0 chunk, two tier-1
# chunks), the same segments at every m.
INT8_MM_STEP = 64
# A tile's segments form one thread-block cluster. The kernel takes up to 16
# (an H100's largest cluster); the plan stops at 8, the portable cluster
# size: above it no GEMV shape of the 1.7B model ran more than 4% faster
# than at its best count of 8 or fewer on an H100, and most ran slower
# (PERF.md, PR 5).
INT8_MM_MAX_SPLITS = 8
INT8_MM_WAVE = 0.75  # the share of the SMs a split GEMV launch aims to fill


class Int8MatmulPlan(NamedTuple):
    tier: int  # 0: m <= 16 (weight-bound); 1: 16 < m <= 1024
    bm: int  # output rows per block
    bk: int  # K rows per chunk (one stage of the kernel's ring)
    splits: int  # K segments, whole 64-row steps spread evenly: S(K, N), the same at every m
    cluster: int  # blocks a tile: ``splits`` (a segment each, added in the cluster) or 1 (one walks them all)


def int8_matmul_splits(k: int, n: int, sms: int) -> int:
    """S(K, N): the K segments that every product of a (K, N) weight sums,
    whatever its rows. It is the count the GEMV tier's tiles (N / 128 of
    them at m <= 16) ask for: the blocks nearest to three quarters of the
    SMs, at most ``INT8_MM_MAX_SPLITS`` and one 64-row step a segment. On
    an H100 a sweep of every split count at the 1.7B model's GEMV shapes
    found this count the fastest, or within 3% of it, at all but one: at N
    12288 (96 tiles, 1 split) 2 splits ran 5-7% faster (PERF.md, PR 5)."""
    tiles = n // INT8_MM_COLS
    return max(1, min(round(sms * INT8_MM_WAVE / tiles), k // INT8_MM_STEP, INT8_MM_MAX_SPLITS))


@functools.lru_cache(maxsize=None)
def int8_matmul_plan(m: int, k: int, n: int, sms: int) -> Int8MatmulPlan:
    """The launch plan of the W8A16 kernel for ``[m, k] @ [k, n]`` on a card
    with ``sms`` SMs.

    The tier follows m; the K segments do not (``int8_matmul_splits``): a
    row's sum runs over the same segments in the same order at every m, so
    it has the same bits whatever rows share the launch. Segment z covers
    the 64-row steps ``[z * (K/64) // S, (z + 1) * (K/64) // S)``; they
    cover K exactly and none is empty. A tile's segments are the blocks of
    one cluster, which adds their partial sums in segment order in shared
    memory (``cluster`` = S), except in tier 1 where the tiles are half the
    SMs or more: there one block walks every segment and adds them in the
    same order (``cluster`` = 1), with no extra blocks. On an H100 that
    rule picked the faster form at every 1.7B projection timed both ways,
    m 40 to 1024 (PERF.md, PR 21).
    """
    if not (1 <= m <= KERNEL_MAX_ROWS and k > 0 and k % KERNEL_ALIGN == 0 and n > 0 and n % KERNEL_ALIGN == 0):
        raise ValueError(f"int8_matmul_plan: the kernel does not take m={m} K={k} N={n}")
    tier = 0 if m <= 16 else 1
    bm, bk = INT8_MM_TIERS[tier]
    splits = int8_matmul_splits(k, n, sms)
    tiles = (n // INT8_MM_COLS) * -(-m // bm)
    cluster = splits if tier == 0 or tiles < sms // 2 else 1
    return Int8MatmulPlan(tier, bm, bk, splits, cluster)


def _kernel_lib():
    from .. import build

    lib = build.load()
    if not getattr(lib, "_q3_int8_mm_bound", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.q3_int8_matmul.restype = i32
        lib.q3_int8_matmul.argtypes = [i32, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, ptr]
        lib._q3_int8_mm_bound = True
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _weight_dims(q8: torch.Tensor) -> tuple[int, int]:
    """(K, N) of a shared weight; per-example weights (a batch axis) raise."""
    if q8.ndim != 2:
        raise ValueError(f"int8_matmul: per-example weights are not supported; want q8 [K, N], got "
                         f"{tuple(q8.shape)}")
    return q8.shape


def int8_matmul_route(x: torch.Tensor, q8: torch.Tensor) -> str:
    """Where ``int8_matmul(x, q8, ...)`` goes on the card, from the shapes
    alone (meta tensors will do): "kernel" when the folded rows, K and N pass
    the JAX package's Pallas gate (m <= 1024, K and N multiples of 128), else
    "plain". A ``[B, m, K]`` batch is B·m rows."""
    k, n = _weight_dims(q8)
    m = x.numel() // max(x.shape[-1], 1)
    ok = 1 <= m <= KERNEL_MAX_ROWS and k % KERNEL_ALIGN == 0 and n % KERNEL_ALIGN == 0
    return "kernel" if ok else "plain"


_w8a8_state = threading.local()


@contextlib.contextmanager
def w8a8_scope(enabled: bool):
    """Dynamic activation quantization (w8a8) for the ``int8_matmul`` calls
    made inside the scope on this thread: activations quantized per row,
    an int8 x int8 -> int32 product, both scales applied to the output.
    Outputs are not bit-identical to the weight-only path. Off by default;
    the state is thread-local (a server's worker enters it inside the call
    it makes), and disable is sticky under nesting: an inner
    ``w8a8_scope(True)`` does not re-enable it inside an outer
    ``w8a8_scope(False)``."""
    prev = getattr(_w8a8_state, "enabled", None)
    _w8a8_state.enabled = (prev if prev is not None else True) and bool(enabled)
    try:
        yield
    finally:
        _w8a8_state.enabled = prev


def _w8a8_allowed() -> bool:
    return bool(getattr(_w8a8_state, "enabled", False))


# torch._int_mm on a CUDA tensor wants more than this many rows, and K and N
# multiples of W8A8_ALIGN.
W8A8_MIN_ROWS = 16
W8A8_ALIGN = 8


def w8a8_matmul(x2: torch.Tensor, q8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """[m, K] @ [K, N] with both operands int8, the JAX package's
    ``_w8a8_matmul`` step for step: x quantized per row (dynamic symmetric
    absmax: ``max(amax, 1e-8) / 127``, round half to even, clip to +-127),
    an exact int32 product, then ``acc.float() * x_scale * scale`` in that
    order, cast to x's dtype. On the card the rows, K and N are padded with
    zeros for ``torch._int_mm`` (``w8a8_padded``: zeros add nothing to an
    int32 sum) and the product cut again. Calls on the card count in
    ``w8a8_matmul.calls``."""
    xq, x_scale = w8a8_quantize(x2, w8a8_row_amax(x2))
    return (w8a8_int_mm(xq, q8).float() * x_scale * scale.float()).to(x2.dtype)


def w8a8_row_amax(x2: torch.Tensor) -> torch.Tensor:
    """max|x| of each row [m, 1] (f32): what w8a8 quantizes a row by. A
    row-parallel product under tensor parallelism takes the maximum of the
    ranks' (``ops/nn.run_layer_stack_tp``), as GSPMD all-reduces it."""
    return x2.float().abs().amax(dim=-1, keepdim=True)


def w8a8_quantize(x2: torch.Tensor, amax: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Rows of x quantized by their ``amax`` [m, 1]: (int8 x, f32 scale [m, 1])."""
    x_scale = _absmax_scale(amax)
    return torch.clamp(torch.round(x2.float() / x_scale), -127, 127).to(torch.int8), x_scale


def w8a8_padded(xq: torch.Tensor, q8: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The operands of ``w8a8_int_mm`` in the shapes and layout
    ``torch._int_mm`` takes on the card: x's rows zero-padded to the next
    multiple of ``W8A8_ALIGN`` above ``W8A8_MIN_ROWS``, K zero-padded in
    both operands and N in the weight's columns to multiples of
    ``W8A8_ALIGN``; the weight in column-major order, the layout of
    cuBLASLt's int8 products (a row-major weight it refuses at some shapes,
    e.g. 24 rows, K = 64, N = 256 on an H100). A zero adds nothing to an
    int32 sum, so the first [m, N] of the padded product is the product,
    bit for bit."""
    (m, k), n, a = xq.shape, q8.shape[1], W8A8_ALIGN
    rows, kp, np_ = max(-(-m // a) * a, W8A8_MIN_ROWS + a), -(-k // a) * a, -(-n // a) * a
    if (rows, kp) != (m, k):
        xq = torch.nn.functional.pad(xq, (0, kp - k, 0, rows - m))
    if (kp, np_) != (k, n):
        q8 = torch.nn.functional.pad(q8, (0, np_ - n, 0, kp - k))
    return xq, q8.t().contiguous().t()


def w8a8_int_mm(xq: torch.Tensor, q8: torch.Tensor) -> torch.Tensor:
    """The exact int8 x int8 -> int32 product [m, N] of ``w8a8_matmul``; on
    the card through ``torch._int_mm`` on the padded operands
    (``w8a8_padded``), cut back to [m, N]."""
    if xq.device.type != "cuda":
        return torch._int_mm(xq, q8)
    m, n = xq.shape[0], q8.shape[1]
    acc = torch._int_mm(*w8a8_padded(xq, q8))[:m, :n]
    w8a8_matmul.calls += 1
    return acc


w8a8_matmul.calls = 0  # calls on the card


def _int8_mm_core(x2: torch.Tensor, q8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    dev = x2.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"int8_matmul: no kernel for device {dev}")
    m, k = x2.shape
    n = q8.shape[1]
    if _w8a8_allowed():
        return w8a8_matmul(x2, q8, scale)
    if dev.type == "cpu":
        return int8_matmul_plain(x2, q8, scale)
    if int8_matmul_route(x2, q8) == "plain":
        int8_matmul.gated += 1
        return int8_matmul_plain(x2, q8, scale)
    if x2.dtype not in _DTYPES:
        raise ValueError(f"int8_matmul: unsupported activation dtype {x2.dtype}")
    if q8.dtype != torch.int8 or scale.dtype != torch.float32 or scale.shape != (n,):
        raise ValueError(
            f"int8_matmul: want int8 q8 [K, N] and f32 scale [N]; got {q8.dtype} {tuple(q8.shape)}, "
            f"{scale.dtype} {tuple(scale.shape)}"
        )
    for name, t in (("q8", q8), ("scale", scale)):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"int8_matmul: {name} must be contiguous on {dev}")
    x2 = x2.contiguous()
    for name, t in (("x", x2), ("q8", q8), ("scale", scale)):
        if t.data_ptr() % 16:
            raise ValueError(f"int8_matmul: {name} is not 16-byte aligned (a view at an odd offset)")
    plan = int8_matmul_plan(m, k, n, _sm_count(dev))
    out = torch.empty((m, n), dtype=x2.dtype, device=dev)
    err = _kernel_lib().q3_int8_matmul(
        _DTYPES[x2.dtype], x2.data_ptr(), q8.data_ptr(), scale.data_ptr(), out.data_ptr(), m, k, n,
        plan.bm, plan.bk, plan.splits, plan.cluster, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"int8_matmul kernel launch failed: CUDA error {err}")
    int8_matmul.launches += 1
    return out


def int8_matmul(x: torch.Tensor, q8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x [.., K] @ dequant(q8 [K, N]) -> [.., N]; leading dims fold into rows
    (a batch of streams is one launch). Per-example weights raise."""
    lead = x.shape[:-1]
    k, n = _weight_dims(q8)
    return _int8_mm_core(x.reshape(-1, k), q8, scale).reshape(*lead, n)


int8_matmul.launches = 0  # kernel launches (plain calls are not counted)
int8_matmul.gated = 0  # calls on the card that the gate sent to the plain form


def mm(x: torch.Tensor, w) -> torch.Tensor:
    """Matmul dispatch: plain tensor or quantized-linear dict."""
    if is_quantized(w):
        return int8_matmul(x, w["q8"], w["scale"])
    return x @ w


def mm_plain(x: torch.Tensor, w) -> torch.Tensor:
    """``mm`` in plain PyTorch on every device: what the plain versions of
    the fused kernels (``fused_layer.cp_frame_plain``) multiply with."""
    if is_quantized(w):
        return int8_matmul_plain(x, w["q8"], w["scale"])
    return x @ w


def quantize_layer_stack(stacked: dict) -> dict:
    """Quantize the stacked [L, K, N] linear weights of a layer stack."""
    out = dict(stacked)
    for key in _LINEAR_KEYS:
        if key in out:
            out[key] = quantize_linear(out[key])
    return out


def quantize_talker_params(params: dict) -> dict:
    out = dict(params)
    out["layers"] = quantize_layer_stack(params["layers"])
    out["codec_head"] = quantize_linear(params["codec_head"])
    return out


def quantize_code_predictor_params(params: dict) -> dict:
    out = dict(params)
    out["layers"] = quantize_layer_stack(params["layers"])
    out["lm_heads"] = quantize_linear(params["lm_heads"])  # [G, K, V] -> [G, V] scales
    return out
