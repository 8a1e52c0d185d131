"""The fused vocoder residual unit: CUDA kernel wrapper, plain version, count.

``residual_unit`` computes SnakeBeta -> causal dilated conv k7 -> SnakeBeta
-> 1x1 conv -> residual on ``[B, T, C]`` f32. On a CUDA tensor it launches
the hand-written Hopper kernel (``csrc/residual_unit.cu``, the port of
``qwen3_tts_tpu/models/codec/fused_blocks.py:_residual_unit_kernel``); on a
CPU tensor it runs ``residual_unit_plain``, the taps form. Any other device
raises. Rows do not depend on where the kernel tiles time, so a prefix of
the input gives a bit-identical prefix of the output.
"""

from __future__ import annotations

import ctypes

import torch

from . import blocks

_PARAM_KEYS = ("act1_alpha", "act1_beta", "conv1_w", "conv1_b", "act2_alpha", "act2_beta", "conv2_w", "conv2_b")


def residual_unit_should_fuse(x: torch.Tensor) -> bool:
    """f32 units with at most 512 channels take the fused kernel's route."""
    return x.dtype == torch.float32 and x.shape[-1] <= 512


def residual_unit_plain(x: torch.Tensor, p: dict, dilation: int) -> torch.Tensor:
    """The taps form: 7 + 1 matmuls and the elementwise passes."""
    h = blocks.snake_beta(x, p["act1_alpha"], p["act1_beta"])
    h = blocks.causal_conv1d(h, p["conv1_w"], p["conv1_b"], dilation=dilation)
    h = blocks.snake_beta(h, p["act2_alpha"], p["act2_beta"])
    h = blocks.causal_conv1d(h, p["conv2_w"], p["conv2_b"])
    return x + h


def _kernel_lib():
    from ... import build

    lib = build.load()
    if not getattr(lib, "_q3_residual_unit_bound", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.q3_residual_unit_smem_bytes.restype = ctypes.c_size_t
        lib.q3_residual_unit_smem_bytes.argtypes = [i32, i32]
        lib.q3_residual_unit.restype = i32
        lib.q3_residual_unit.argtypes = [ptr, ptr] + [i32] * 4 + [ptr] * 9
        lib._q3_residual_unit_bound = True
    return lib


def residual_unit(x: torch.Tensor, p: dict, dilation: int) -> torch.Tensor:
    """The unit on x [B, T, C] f32: the CUDA kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return residual_unit_plain(x, p, dilation)
    if x.device.type != "cuda":
        raise ValueError(f"residual_unit: no kernel for device {x.device}")
    if x.dtype != torch.float32 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"residual_unit: x must be contiguous f32 [B, T, C]; got {x.dtype} {tuple(x.shape)}")
    b, t, c = x.shape
    shapes = {"conv1_w": (7, c, c), "conv2_w": (1, c, c)}
    for key in _PARAM_KEYS:
        w = p[key]
        want = shapes.get(key, (c,))
        if w.device != x.device or w.dtype != torch.float32 or tuple(w.shape) != want or not w.is_contiguous():
            raise ValueError(
                f"residual_unit: {key} must be contiguous f32 {want} on {x.device}; "
                f"got {w.dtype} {tuple(w.shape)} on {w.device}"
            )
    lib = _kernel_lib()
    if lib.q3_residual_unit_smem_bytes(c, dilation) == 0:
        raise ValueError(f"residual_unit: the kernel does not take C={c}, dilation={dilation}")
    y = torch.empty_like(x)
    err = lib.q3_residual_unit(
        x.data_ptr(), y.data_ptr(), b, t, c, dilation,
        *(p[key].data_ptr() for key in _PARAM_KEYS),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"residual_unit kernel launch failed: CUDA error {err}")
    residual_unit.launches += 1
    return y


residual_unit.launches = 0  # kernel launches (CPU-plain calls are not counted)
