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
K and N multiples of 128); other shapes take the plain form, as the JAX
package takes XLA's dequant-then-dot. On a CPU tensor it is always the
plain form; any other device raises.

The w8a8 scope (dynamic activation quantization) serves batched programs
only and comes with batching.
"""

from __future__ import annotations

import ctypes

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


def _kernel_lib():
    from .. import build

    lib = build.load()
    if not getattr(lib, "_q3_int8_mm_bound", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.q3_int8_matmul_scratch_floats.restype = ctypes.c_size_t
        lib.q3_int8_matmul_scratch_floats.argtypes = [i32, i32, i32]
        lib.q3_int8_matmul.restype = i32
        lib.q3_int8_matmul.argtypes = [i32, ptr, ptr, ptr, ptr, i32, i32, i32, ptr, ptr]
        lib._q3_int8_mm_bound = True
    return lib


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
    out = torch.empty((m, n), dtype=x2.dtype, device=dev)
    lib = _kernel_lib()
    n_scratch = lib.q3_int8_matmul_scratch_floats(m, k, n)
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=dev) if n_scratch else None
    err = lib.q3_int8_matmul(
        _DTYPES[x2.dtype], x2.data_ptr(), q8.data_ptr(), scale.data_ptr(), out.data_ptr(),
        m, k, n, None if scratch is None else scratch.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
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
