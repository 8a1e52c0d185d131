"""The fused vocoder residual unit: CUDA kernel wrapper, plan, plain version, count.

``residual_unit`` computes SnakeBeta -> causal dilated conv k7 -> SnakeBeta
-> 1x1 conv -> residual on ``[B, T, C]`` f32. On a CUDA tensor it launches
the hand-written Hopper kernel (``csrc/residual_unit.cu``, the port of
``qwen3_tts_tpu/models/codec/fused_blocks.py:_residual_unit_kernel``: an
implicit GEMM on the tensor cores in 3xTF32) with the launch plan of
``residual_unit_plan``; on a CPU tensor it runs ``residual_unit_plain``, the
taps form. Any other device raises. Rows do not depend on where the kernel
tiles time, so a prefix of the input gives a bit-identical prefix of the
output.

``residual_unit_stream`` is the streaming entry (the port of the JAX
package's ``residual_unit_stream``): the same kernel on the carried raw
input rows in front of the chunk, the carried rows' outputs dropped; its
plain version is ``residual_unit_stream_plain``. Each entry counts its own
launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import blocks

_PARAM_KEYS = ("act1_alpha", "act1_beta", "conv1_w", "conv1_b", "act2_alpha", "act2_beta", "conv2_w", "conv2_b")

# The kernel's fixed shape (csrc/residual_unit.cu): 16 warps a block, each
# with 2 m16 x 6 n8 mma tiles (48 f32 accumulators a thread), so a block
# holds 32 * wm time rows and 768 / wm channels; chunks of 32, 16 or 8 K rows
# of weights; an H100 block's shared memory.
RU_WARPS = 16
RU_TAPS = 7
RU_WM = (8, 4, 2, 1)  # 256, 128, 64, 32 rows: more would waste a short decode's last tile
RU_KC = (32, 16, 8)  # on an H100, 32-row chunks ran 1.2-1.4x faster than 8-row ones
RU_MAX_STAGES = 6  # the kernel takes 8; deeper rings found no use
RU_MAX_SMEM = 232448


class ResidualUnitPlan(NamedTuple):
    wm: int  # warps along time (16 / wm along channels)
    kc: int  # K rows a chunk of the weight ring
    stages: int  # chunks in the ring
    taps: int  # taps whose rows the window holds at a time (7 but for wide C at large dilations)
    tm: int  # time rows a block: 32 * wm
    cp: int  # channels padded with zeros: 768 / wm >= C
    rows: int  # the window's rows: tm + (taps - 1) * min(dilation, tm)
    sa: int  # the window's row stride (floats), = 4 mod 32
    sb: int  # a ring chunk's row stride (floats), = 8 mod 32
    smem: int  # bytes of dynamic shared memory


def _pad32(n: int, residue: int) -> int:
    return n + (residue - n) % 32


def _layout(c: int, dilation: int, wm: int, kc: int, stages: int, taps: int) -> ResidualUnitPlan | None:
    """The plan for these choices, as ``ru_layout`` in the C source computes
    it, or None where the kernel does not take it."""
    if wm not in RU_WM or kc not in RU_KC:
        return None
    tm, cp = 32 * wm, 768 // wm
    if not (1 <= c <= 512 and dilation >= 1 and cp >= c and 1 <= taps <= RU_TAPS and 2 <= stages <= 8):
        return None
    rows = tm + (taps - 1) * min(dilation, tm)
    sa, sb = _pad32(cp, 4), _pad32(cp, 8)
    smem = 4 * (rows * sa + stages * kc * sb + 2 * cp)
    if smem > RU_MAX_SMEM:
        return None
    return ResidualUnitPlan(wm, kc, stages, taps, tm, cp, rows, sa, sb, smem)


def residual_unit_ring(c: int, dilation: int, kc: int, taps: int) -> ResidualUnitPlan | None:
    """The plan with chunks of kc K rows and windows of `taps` taps, its ring
    as deep as fits (up to ``RU_MAX_STAGES``), or None where no ring of 2
    fits beside the window."""
    wm = next((w for w in RU_WM if 768 // w >= c), RU_WM[-1])
    for stages in range(RU_MAX_STAGES, 1, -1):
        if plan := _layout(c, dilation, wm, kc, stages, taps):
            return plan
    return None


@functools.lru_cache(maxsize=None)
def residual_unit_plan(c: int, dilation: int) -> ResidualUnitPlan:
    """The kernel's launch plan for C channels and this dilation: the warp
    grid with the fewest padded channels, then the widest weight chunks (a
    chunk costs a block barrier), the most taps a window (a window of fewer
    taps is built again for the next ones) and the deepest ring that fit.
    None depends on T: tiles sit at fixed multiples of tm. Raises where the
    kernel takes none."""
    for kc in RU_KC:
        for taps in range(RU_TAPS, 0, -1):
            if plan := residual_unit_ring(c, dilation, kc, taps):
                return plan
    raise ValueError(f"residual_unit: the kernel does not take C={c}, dilation={dilation}")


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
        lib.q3_residual_unit_smem_bytes.argtypes = [i32] * 6
        lib.q3_residual_unit.restype = i32
        lib.q3_residual_unit.argtypes = [ptr, ptr] + [i32] * 8 + [ptr] * 9
        lib._q3_residual_unit_bound = True
    return lib


def _launch(x: torch.Tensor, p: dict, dilation: int, plan: ResidualUnitPlan) -> torch.Tensor:
    """The kernel on checked inputs with this plan (``residual_unit`` and
    the plan sweeps); uncounted."""
    b, t, c = x.shape
    y = torch.empty_like(x)
    err = _kernel_lib().q3_residual_unit(
        x.data_ptr(), y.data_ptr(), b, t, c, dilation, plan.wm, plan.kc, plan.stages, plan.taps,
        *(p[key].data_ptr() for key in _PARAM_KEYS),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"residual_unit kernel launch failed: CUDA error {err}")
    return y


def _check(x: torch.Tensor, p: dict, op: str) -> None:
    """Raises unless x and the unit's weights are what the kernel takes."""
    if x.device.type != "cuda":
        raise ValueError(f"{op}: no kernel for device {x.device}")
    if x.dtype != torch.float32 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"{op}: x must be contiguous f32 [B, T, C]; got {x.dtype} {tuple(x.shape)}")
    c = x.shape[-1]
    shapes = {"conv1_w": (7, c, c), "conv2_w": (1, c, c)}
    for key in _PARAM_KEYS:
        w = p[key]
        want = shapes.get(key, (c,))
        if w.device != x.device or w.dtype != torch.float32 or tuple(w.shape) != want or not w.is_contiguous():
            raise ValueError(
                f"{op}: {key} must be contiguous f32 {want} on {x.device}; "
                f"got {w.dtype} {tuple(w.shape)} on {w.device}"
            )


def residual_unit(x: torch.Tensor, p: dict, dilation: int) -> torch.Tensor:
    """The unit on x [B, T, C] f32: the CUDA kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return residual_unit_plain(x, p, dilation)
    _check(x, p, "residual_unit")
    y = _launch(x, p, dilation, residual_unit_plan(x.shape[-1], dilation))
    residual_unit.launches += 1
    return y


residual_unit.launches = 0  # kernel launches (CPU-plain calls are not counted)


def residual_unit_stream_plain(
    x: torch.Tensor, ctx_rows: torch.Tensor, p: dict, dilation: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """``residual_unit_stream``'s plain version: ``residual_unit_plain`` on
    [carry | chunk], the carry's output rows dropped."""
    ctx = ctx_rows.shape[1]
    x_ext = torch.cat([ctx_rows, x], dim=1)
    return residual_unit_plain(x_ext, p, dilation)[:, ctx:], x_ext[:, -ctx:]


def residual_unit_stream(
    x: torch.Tensor, ctx_rows: torch.Tensor, p: dict, dilation: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The streaming unit on a chunk x [B, T, C] f32 with ``ctx_rows`` [B,
    6*dilation, C], the raw input rows of the chunks before it (zeros at
    the start, as the batch unit's left padding): the kernel on [carry |
    chunk] (its last tile cut short and masked), the first 6*dilation
    output rows dropped. Returns (the chunk's output [B, T, C], the new
    carry: the last 6*dilation rows of [carry | chunk]). The plain version
    on a CPU tensor; a launch failure raises."""
    if x.device.type == "cpu":
        return residual_unit_stream_plain(x, ctx_rows, p, dilation)
    _check(x, p, "residual_unit_stream")
    x_ext = torch.cat([ctx_rows, x], dim=1)
    ctx = ctx_rows.shape[1]
    y = _launch(x_ext, p, dilation, residual_unit_plan(x.shape[-1], dilation))
    residual_unit_stream.launches += 1
    return y[:, ctx:], x_ext[:, -ctx:]


residual_unit_stream.launches = 0  # kernel launches (CPU-plain calls are not counted)
