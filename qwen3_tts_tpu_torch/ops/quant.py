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

The w8a8 scope (dynamic activation quantization) serves batched programs
only and comes with batching.
"""

from __future__ import annotations

import ctypes
import functools
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


def quantize_linear(w: torch.Tensor) -> dict:
    """[..., K, N] float weights -> {"q8": int8 [..., K, N], "scale": f32 [..., N]}.

    Per-output-channel symmetric absmax, bit for bit the JAX package's
    (f32 division, round half to even, clip to +-127).
    """
    wf = w.float()
    scale = torch.clamp(wf.abs().amax(dim=-2), min=1e-8) / 127.0
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
# A tile's K splits form one thread-block cluster. The kernel takes up to 16
# (an H100's largest cluster); the plan stops at 8, the portable cluster
# size: above it no GEMV shape of the 1.7B model ran more than 4% faster
# than at its best count of 8 or fewer on an H100, and most ran slower
# (PERF.md, PR 5).
INT8_MM_MAX_SPLITS = 8
INT8_MM_WAVE = 0.75  # the share of the SMs a split launch aims to fill


class Int8MatmulPlan(NamedTuple):
    tier: int  # 0: m <= 16 (weight-bound); 1: 16 < m <= 1024
    bm: int  # output rows per block
    bk: int  # K rows per chunk (one stage of the kernel's ring)
    splits: int  # K splits (grid.z), whole chunks spread evenly


@functools.lru_cache(maxsize=None)
def int8_matmul_plan(m: int, k: int, n: int, sms: int) -> Int8MatmulPlan:
    """The launch plan of the W8A16 kernel for ``[m, k] @ [k, n]`` on a card
    with ``sms`` SMs.

    The tier follows m. When the output tiles alone leave much of the
    card idle (the GEMV shapes), K is split into runs of whole chunks so
    that the blocks come nearest to three quarters of the SMs, at most
    ``INT8_MM_MAX_SPLITS`` (a tile's splits are one cluster, which adds
    their partial sums in shared memory: no scratch); the splits cover K
    exactly and none is empty. On an H100 a sweep of every split count at
    the 1.7B model's GEMV shapes found this count the fastest, or within 3%
    of it, at all but one: at N 12288 (96 tiles, 1 split) 2 splits ran 5-7%
    faster (PERF.md, PR 5).
    """
    if not (1 <= m <= KERNEL_MAX_ROWS and k > 0 and k % KERNEL_ALIGN == 0 and n > 0 and n % KERNEL_ALIGN == 0):
        raise ValueError(f"int8_matmul_plan: the kernel does not take m={m} K={k} N={n}")
    tier = 0 if m <= 16 else 1
    bm, bk = INT8_MM_TIERS[tier]
    tiles = (n // INT8_MM_COLS) * -(-m // bm)
    splits = max(1, min(round(sms * INT8_MM_WAVE / tiles), k // bk, INT8_MM_MAX_SPLITS))
    return Int8MatmulPlan(tier, bm, bk, splits)


def _kernel_lib():
    from .. import build

    lib = build.load()
    if not getattr(lib, "_q3_int8_mm_bound", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.q3_int8_matmul.restype = i32
        lib.q3_int8_matmul.argtypes = [i32, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, ptr]
        lib._q3_int8_mm_bound = True
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _int8_mm_core(x2: torch.Tensor, q8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    dev = x2.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"int8_matmul: no kernel for device {dev}")
    m, k = x2.shape
    n = q8.shape[1]
    if dev.type == "cpu" or not (1 <= m <= KERNEL_MAX_ROWS and k % KERNEL_ALIGN == 0 and n % KERNEL_ALIGN == 0):
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
        plan.bm, plan.bk, plan.splits, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"int8_matmul kernel launch failed: CUDA error {err}")
    int8_matmul.launches += 1
    return out


def int8_matmul(x: torch.Tensor, q8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x [.., K] @ dequant(q8 [K, N]) -> [.., N]; leading dims fold into rows."""
    lead = x.shape[:-1]
    k, n = q8.shape
    return _int8_mm_core(x.reshape(-1, k), q8, scale).reshape(*lead, n)


int8_matmul.launches = 0  # kernel launches (plain calls are not counted)


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
