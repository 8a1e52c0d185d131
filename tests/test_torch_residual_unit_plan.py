"""Kernel 2's launch plan (``fused_blocks.residual_unit_plan``), on the CPU.

The CUDA kernel (``csrc/residual_unit.cu``) takes its tile, padding, weight
ring and window from this plan and only checks it (``ru_layout``, the same
formulas); ``tests/test_torch_kernels.py`` holds the C side's shared-memory
bytes to the plan's on the card. Here: every plan fits an H100 block's
shared memory, pads C to the fewest zero channels of the kernel's warp grids,
keeps both row strides off shared-memory bank conflicts, and covers every T
with tiles at fixed multiples of its rows (so that a row's sums do not
depend on T); the window's row map gives every tap the rows it reads; and
nothing the routing gate sends (f32, C <= 512) is refused, at any dilation
the earlier kernel took and beyond.
"""

import inspect

import pytest

from qwen3_tts_tpu_torch.models.codec import fused_blocks as fb
from qwen3_tts_tpu_torch.models.codec.vocoder import VocoderConfig

CHANNELS = (1, 7, 48, 96, 192, 384, 500, 512)
DILATIONS = (1, 3, 9)
SMEM = 232448  # an H100 block's dynamic shared memory


def old_kernel_took(c: int, dilation: int) -> bool:
    """The FFMA kernel this one replaced: 32-row tiles plus the context, all
    C columns, and four per-channel factors in shared memory."""
    return c <= 512 and ((32 + 6 * dilation) * c + 4 * c) * 4 <= SMEM


def window_time(plan, dilation: int, i0: int, r: int) -> int:
    """Time (less the tile's first row) of window row r when the window
    holds taps i0 .. i0 + taps - 1: the kernel's ``build_window`` map."""
    seg = dilation > plan.tm
    return (i0 - 6) * dilation + ((r // plan.tm) * dilation + r % plan.tm if seg else r)


@pytest.mark.parametrize("dilation", DILATIONS)
@pytest.mark.parametrize("c", CHANNELS)
def test_plan_fits_and_pads(c, dilation):
    plan = fb.residual_unit_plan(c, dilation)
    assert plan.smem == 4 * (plan.rows * plan.sa + plan.stages * plan.kc * plan.sb + 2 * plan.cp) <= SMEM
    # 16 warps of 2 x 6 mma tiles: 32 * wm rows by 768 / wm channels.
    assert plan.wm in fb.RU_WM and plan.tm == 32 * plan.wm <= 256
    # Padding: C up to the narrowest grid that holds it (96 channels at
    # least: a grid of 48 would take 512-row tiles).
    assert plan.cp == 768 // plan.wm >= c
    assert plan.cp == 96 or plan.cp // 2 < c
    # Row strides: ldmatrix's 8 rows of 16 bytes and the B fragments' 4 rows
    # x 8 columns each fall on distinct banks.
    assert plan.sa >= plan.cp and plan.sa % 32 == 4 and plan.sa % 4 == 0
    assert plan.sb >= plan.cp and plan.sb % 32 == 8
    assert {(r * plan.sa) % 32 // 4 for r in range(8)} == set(range(8))
    assert {(t * plan.sb + g) % 32 for t in range(4) for g in range(8)} == set(range(32))
    # The weight stream: whole chunks that never span two taps.
    assert plan.kc in fb.RU_KC and plan.cp % plan.kc == 0 and 2 <= plan.stages <= fb.RU_MAX_STAGES
    assert 1 <= plan.taps <= 7 and plan.rows == plan.tm + (plan.taps - 1) * min(dilation, plan.tm)


@pytest.mark.parametrize("c", CHANNELS)
def test_tiles_cover_every_t_at_fixed_rows(c):
    """The plan sees C and the dilation only; the grid is ceil(T / tm) tiles
    starting at multiples of tm, so every row lies in exactly one tile, at an
    offset that does not depend on T (the vocoder's bucket invariance)."""
    assert list(inspect.signature(fb.residual_unit_plan).parameters) == ["c", "dilation"]
    for dilation in DILATIONS:
        tm = fb.residual_unit_plan(c, dilation).tm
        for t in (1, 5, tm - 1, tm, tm + 1, 1000, 20480, 81920, 245760):
            blocks = -(-t // tm)
            rows = [row for b in range(blocks) for row in range(b * tm, min((b + 1) * tm, t))]
            assert rows == list(range(t))


@pytest.mark.parametrize(
    "c, dilation", [(384, 9), (96, 1), (48, 3), (7, 9), (1, 300), (384, 20), (500, 13), (512, 20), (512, 2000)]
)
def test_window_gives_each_tap_its_rows(c, dilation):
    """Output row q of a tile reads, for tap i, the time q - (6 - i) *
    dilation; the kernel reads it at window row (i % taps) * de + q of the
    window built for the taps from i - i % taps on. Wide C at large
    dilations holds fewer than 7 taps at a time."""
    plan = fb.residual_unit_plan(c, dilation)
    de = min(dilation, plan.tm)
    for i in range(7):
        for q in (0, 1, plan.tm // 2, plan.tm - 1):
            r = (i % plan.taps) * de + q
            assert 0 <= r < plan.rows
            assert window_time(plan, dilation, i - i % plan.taps, r) == q - (6 - i) * dilation
    if (c, dilation) in ((512, 20), (512, 2000)):  # no 7-tap window fits
        assert all(fb.residual_unit_ring(c, dilation, kc, 7) is None for kc in fb.RU_KC)


def test_every_dilation_the_earlier_kernel_took():
    """No (C, dilation) that the FFMA kernel took is refused now; past it,
    the window holds fewer taps at a time."""
    for c in (1, 7, 48, 96, 192, 200, 383, 384, 385, 449, 500, 512):
        dilation, taken = 1, []
        while old_kernel_took(c, dilation):
            taken.append(dilation)
            dilation += 1
        for d in [d for d in taken if d <= 64] + taken[-1:] + [taken[-1] + 1, 4096]:
            assert fb.residual_unit_plan(c, d).smem <= SMEM, (c, d)


def test_nothing_the_gate_sends_is_refused():
    """Every C the gate sends (f32, C <= 512) at the vocoder's dilations has a
    plan that fits; the default vocoder's units take a plan with no
    padding."""
    for c in range(1, 513):
        for d in DILATIONS:
            assert fb.residual_unit_plan(c, d).smem <= SMEM, (c, d)
    cfg = VocoderConfig()
    ch = cfg.decoder_dim
    for _ in cfg.upsample_rates:
        ch //= 2
        for d in DILATIONS:
            if ch <= 512:
                assert fb.residual_unit_plan(ch, d).cp == ch


def test_plan_choices():
    """The plan takes the widest chunks, then the most taps a window, then
    the deepest ring that fit. At C = 384 and dilation 9 a 7-tap window
    leaves room for 8-row chunks only; the plan takes 32-row chunks and a
    window of 3 taps."""
    for c, d in ((384, 1), (192, 9), (96, 3), (384, 9)):
        plan = fb.residual_unit_plan(c, d)
        assert plan.cp == c and plan == fb.residual_unit_ring(c, d, plan.kc, plan.taps)
        assert all(fb.residual_unit_ring(c, d, plan.kc, taps) is None for taps in range(plan.taps + 1, 8))
        assert all(fb.residual_unit_ring(c, d, kc, 1) is None for kc in fb.RU_KC if kc > plan.kc)
    best = fb.residual_unit_plan(384, 9)
    assert (best.tm, best.kc, best.taps) == (64, 32, 3)
    assert fb.residual_unit_ring(384, 9, 8, 7).kc == 8 and fb.residual_unit_ring(384, 9, 16, 7) is None
    with pytest.raises(ValueError, match="does not take"):
        fb.residual_unit_plan(513, 1)
