"""The port's weight-only int8 (``ops/quant.py``) against the JAX package's.

Quantized trees must equal the JAX package's bit for bit (both round half
to even). ``int8_matmul_plain`` -- what ``int8_matmul`` runs on a CPU tensor
and, on the card, for shapes the kernel does not take -- must agree with
``quant._dequant_matmul_reference``, the computation of the Pallas kernel
and what the JAX package runs off the TPU: the same exact products summed
in another order, so within 1e-5. The CUDA kernel itself is held against
the plain version on the card (``tests/test_torch_kernels.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu.models import weights as JW
from qwen3_tts_tpu.ops import quant as jq
from qwen3_tts_tpu_torch import kernel_timing as kt
from qwen3_tts_tpu_torch.models import weights as TW
from qwen3_tts_tpu_torch.ops import nn as tnn
from qwen3_tts_tpu_torch.ops import quant as tq
from test_fused_layer import STREAM_CFG
from test_pipeline import TINY_TALKER

torch.set_num_threads(1)


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_trees_equal(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_trees_equal(got[k], want[k])
    elif want is None:
        assert got is None
    else:
        g = got.float().numpy() if got.dtype == torch.bfloat16 else got.numpy()
        w = np.asarray(want, np.float32) if want.dtype.name == "bfloat16" else np.asarray(want)
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_quantize_linear_matches_jax_bit_for_bit(dtype):
    rs = np.random.RandomState(0)
    w = rs.randn(96, 160).astype(np.float32) * 0.05
    # A column with absmax 127 has scale 1.0, so x.5 values test round half
    # to even (2.5 -> 2, -3.5 -> -4) in both frameworks.
    w[:6, 0] = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5]
    jw = jnp.asarray(w).astype(jnp.bfloat16) if dtype == "bfloat16" else jnp.asarray(w)
    tw = torch.from_numpy(w).to(torch.bfloat16) if dtype == "bfloat16" else torch.from_numpy(w)
    want = _numpy(jq.quantize_linear(jw))
    got = tq.quantize_linear(tw)
    assert got["q8"].dtype == torch.int8 and got["scale"].dtype == torch.float32
    np.testing.assert_array_equal(got["q8"].numpy(), want["q8"])
    np.testing.assert_array_equal(got["scale"].numpy(), want["scale"])
    np.testing.assert_array_equal(got["q8"][:6, 0].numpy(), [127, 2, -4, 0, 0, 2])


def test_quantize_trees_match_jax_bit_for_bit():
    """quantize_layer_stack / quantize_talker_params /
    quantize_code_predictor_params on the fused trees: identical leaves."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(21))
    jt = JW.fuse_model_params(JW.init_talker_params(k1, TINY_TALKER, jnp.float32))
    jc = JW.fuse_model_params(JW.init_code_predictor_params(k2, STREAM_CFG, jnp.float32))
    tt = TW.from_numpy_tree(_numpy(jt), "cpu")
    tc = TW.from_numpy_tree(_numpy(jc), "cpu")
    _assert_trees_equal(tq.quantize_layer_stack(tt["layers"]), _numpy(jq.quantize_layer_stack(jt["layers"])))
    _assert_trees_equal(tq.quantize_talker_params(tt), _numpy(jq.quantize_talker_params(jt)))
    _assert_trees_equal(tq.quantize_code_predictor_params(tc), _numpy(jq.quantize_code_predictor_params(jc)))


def test_from_numpy_tree_keeps_int8_and_f32_scales():
    """A JAX-quantized tree carried across with dtype=bf16: float leaves
    become bf16, but a quantized linear keeps int8 weights and f32 scales
    equal to the JAX package's (a bf16 scale would change every product)."""
    jc = jq.quantize_code_predictor_params(
        JW.fuse_model_params(JW.init_code_predictor_params(jax.random.PRNGKey(22), STREAM_CFG, jnp.float32))
    )
    want = _numpy(jc)
    got = TW.from_numpy_tree(want, "cpu", dtype=torch.bfloat16)
    assert got["norm"].dtype == torch.bfloat16
    for w, ref in ((got["layers"]["qkv_proj"], want["layers"]["qkv_proj"]), (got["lm_heads"], want["lm_heads"])):
        assert w["q8"].dtype == torch.int8 and w["scale"].dtype == torch.float32
        np.testing.assert_array_equal(w["q8"].numpy(), ref["q8"])
        np.testing.assert_array_equal(w["scale"].numpy(), ref["scale"])


@pytest.mark.parametrize("m", [1, 10, 40])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_int8_matmul_plain_matches_jax_reference(m, dtype):
    """Against _dequant_matmul_reference, tolerance 1e-5 (relative and
    absolute): the same exact products, summed in another order."""
    rs = np.random.RandomState(m)
    x = rs.randn(m, 256).astype(np.float32)
    w = rs.randn(256, 512).astype(np.float32) * 0.05
    q = jq.quantize_linear(jnp.asarray(w))
    jx = jnp.asarray(x).astype(jnp.bfloat16) if dtype == "bfloat16" else jnp.asarray(x)
    want = np.asarray(jq._dequant_matmul_reference(jx, q["q8"], q["scale"]).astype(jnp.float32))
    tx = torch.from_numpy(x).to(torch.bfloat16) if dtype == "bfloat16" else torch.from_numpy(x)
    tqw = {k: torch.from_numpy(np.array(v)) for k, v in q.items()}
    got = tq.int8_matmul_plain(tx, tqw["q8"], tqw["scale"])
    assert got.dtype == tx.dtype and got.shape == (m, 512)
    if dtype == "bfloat16":
        # Sums that differ in the last f32 bit may round to neighbouring bf16
        # values: within one bf16 ulp of the output's scale.
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=np.abs(want).max() * 2.0**-7)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # The wrapper on a CPU tensor is the plain form, leading dims folded.
    before = tq.int8_matmul.launches
    folded = tq.mm(tx.reshape(1, m, 256), tqw)
    assert tq.int8_matmul.launches == before
    assert torch.equal(folded.reshape(m, 512), got)


def test_int8_matmul_plain_matches_pallas_kernel_interpret():
    """Against the Pallas kernel itself, run in interpret mode as
    tests/test_quant.py runs it, with that test's tolerance (rtol 2e-2,
    atol 1e-3 on bf16 outputs). Skips where interpret mode is unavailable."""
    from jax.experimental.pallas import tpu as pltpu

    rs = np.random.RandomState(2)
    x = rs.randn(1, 256).astype(np.float32)
    w = jnp.asarray(rs.randn(256, 512).astype(np.float32) * 0.05)
    q = jq.quantize_linear(w)
    fn = jq._make_pallas_matmul(1, 256, 512, jnp.bfloat16)
    assert fn is not None
    try:
        with pltpu.force_tpu_interpret_mode():
            want = fn(jnp.asarray(x).astype(jnp.bfloat16), q["q8"], q["scale"].astype(jnp.float32)[None, :])
    except Exception as e:  # noqa: BLE001 -- interpret support varies by version
        pytest.skip(f"pallas interpret mode unavailable on CPU: {e}")
    got = tq.int8_matmul_plain(
        torch.from_numpy(x).to(torch.bfloat16),
        torch.from_numpy(np.array(q["q8"])),
        torch.from_numpy(np.array(q["scale"])),
    )
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=2e-2, atol=1e-3)


# Every (K, N) that kernel 4 takes at the 1.7B widths: the talker's qkv, o,
# gate|up and down projections and codec head; the code predictor's qkv, o,
# gate|up and down (intermediate 3072, and 2816 on its per-step path) and
# lm heads.
WIDTHS_1P7B = [
    (2048, 4096), (2048, 2048), (2048, 12288), (6144, 2048), (2048, 3072),
    (1024, 4096), (2048, 1024), (1024, 6144), (3072, 1024), (1024, 5632), (2816, 1024), (1024, 2048),
]
H100_SMS = 132


def _segments(p, k):
    """The K rows [start, end) of plan ``p``'s segments as its tier's kernel
    walks them: segment z is the 64-row steps [z * (K/64) // S, (z + 1) *
    (K/64) // S), in ``p.bk``-row chunks."""
    steps, per = k // tq.INT8_MM_STEP, tq.INT8_MM_STEP // p.bk
    chunks = [(per * (z * steps // p.splits), per * ((z + 1) * steps // p.splits)) for z in range(p.splits)]
    return [(a * p.bk, b * p.bk) for a, b in chunks]


def _check_plan(m, k, n):
    """The rules of a kernel-4 launch plan on an H100: the tier follows m;
    the K segments do not: S is S(K, N) at every m, so a row's f32 sum runs
    over the same K rows in the same order whatever rows share its launch,
    and the segments are the same K rows in both tiers (whole 64-row steps,
    two tier-1 chunks each); they cover K exactly, none is empty; at most 8
    (a tile's cluster). A tile's blocks are its segments (tier 0, and tier 1
    where the tiles leave the card idle) or one block that walks them all
    (tier 1 only). Returns the blocks."""
    p = tq.int8_matmul_plan(m, k, n, H100_SMS)
    assert p.tier == (0 if m <= 16 else 1)
    assert (p.bm, p.bk) == tq.INT8_MM_TIERS[p.tier]
    assert p.splits == tq.int8_matmul_splits(k, n, H100_SMS)
    other = tq.int8_matmul_plan(1 if p.tier else tq.KERNEL_MAX_ROWS, k, n, H100_SMS)
    assert other.tier != p.tier and other.splits == p.splits
    spans = _segments(p, k)
    assert spans == _segments(other, k)
    assert spans[0][0] == 0 and spans[-1][1] == k
    assert all(end > start and start % tq.INT8_MM_STEP == 0 for start, end in spans)
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert 1 <= p.splits <= min(k // tq.INT8_MM_STEP, tq.INT8_MM_MAX_SPLITS)
    assert p.cluster == p.splits or (p.tier == 1 and p.cluster == 1)
    tiles = (n // tq.INT8_MM_COLS) * -(-m // p.bm)
    return tiles * p.cluster


@pytest.mark.parametrize("k,n", WIDTHS_1P7B)
def test_int8_matmul_plan_every_m_at_1p7b_widths(k, n):
    splits = {tq.int8_matmul_plan(m, k, n, H100_SMS).splits for m in range(1, tq.KERNEL_MAX_ROWS + 1)}
    assert len(splits) == 1
    for m in range(1, tq.KERNEL_MAX_ROWS + 1):
        _check_plan(m, k, n)


# The K splits of the plan at the GEMV (m <= 16) shapes chip_smoke.py
# times, by (K, N): the counts chosen against a sweep of every count on an
# H100 (PERF.md, PR 5). At least 64 blocks (8 tiles x 8) stream weights.
GEMV_SPLITS = {
    (2048, 4096): 3, (2048, 2048): 6, (2048, 12288): 1, (6144, 2048): 6, (2048, 3072): 4,
    (1024, 4096): 3, (2048, 1024): 8, (1024, 5632): 2, (2816, 1024): 8, (1024, 6144): 2, (3072, 1024): 8,
    (1024, 2048): 6,
}


@pytest.mark.parametrize("m,k,n", kt.SHAPES)
def test_int8_matmul_plan_at_timed_shapes(m, k, n):
    blocks = _check_plan(m, k, n)
    if m <= 16:
        assert tq.int8_matmul_plan(m, k, n, H100_SMS).splits == GEMV_SPLITS[(k, n)]
        assert blocks >= 64


def test_int8_matmul_plan_refuses_shapes_outside_the_gate():
    for m, k, n in ((0, 128, 128), (1025, 128, 128), (1, 64, 128), (1, 128, 100)):
        with pytest.raises(ValueError, match="does not take"):
            tq.int8_matmul_plan(m, k, n, H100_SMS)
    # The smallest K: two 64-row segments at every m, as two 64-row chunks
    # (tier 0) or two pairs of 32-row ones (tier 1); its 16 tiles at m 1024
    # leave the card idle, so each segment is a block of the tile's cluster.
    assert tq.int8_matmul_plan(1, 128, 128, H100_SMS) == (0, 16, 64, 2, 2)
    assert tq.int8_matmul_plan(1024, 128, 128, H100_SMS) == (1, 64, 32, 2, 2)


def test_int8_layer_stack_matches_jax():
    """The layer path on an int8 tree (every projection through quant.mm):
    a 3-row prefill into a fresh cache, f32, within 1e-5 of the JAX
    package's run_layer_stack (the same rounding points; f32 sums in
    another order)."""
    from qwen3_tts_tpu.ops import nn as jnn

    stack = TINY_TALKER.layer_stack()
    jt = jq.quantize_talker_params(
        JW.fuse_model_params(JW.init_talker_params(jax.random.PRNGKey(23), TINY_TALKER, jnp.float32))
    )
    x = np.random.RandomState(3).randn(1, 3, stack.hidden_size).astype(np.float32)
    jcache = jnn.init_kv_cache(stack, 1, 8, jnp.float32)
    want, _ = jnn.run_layer_stack(
        jt["layers"], jnp.asarray(x), stack, jcache, jnp.arange(3, dtype=jnp.int32), jnp.int32(0),
        self_attn_prefill=True,
    )
    tstack = tnn.LayerStackConfig(**{f: getattr(stack, f) for f in tnn.LayerStackConfig.__dataclass_fields__})
    tcache = tnn.init_kv_cache(tstack, 1, 8, torch.float32)
    tlayers = TW.from_numpy_tree(_numpy(jt), "cpu")["layers"]
    got = tnn.run_layer_stack(tlayers, torch.from_numpy(x), tstack, tcache, torch.arange(3), 0, self_attn_prefill=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
