"""The port's CUDA kernels against their plain PyTorch versions.

This file imports torch and the port only (no JAX), so it also runs on a
machine with a card and no JAX: ``python -m pytest --noconftest -m gpu
tests/test_torch_kernels.py``. Tests marked ``gpu`` skip without a CUDA
device; the others check the wrappers' routing on any machine.
"""

from dataclasses import replace

import pytest
import torch

from qwen3_tts_tpu_torch import build
from qwen3_tts_tpu_torch.models import weights as W
from qwen3_tts_tpu_torch.models.codec import fused_blocks
from qwen3_tts_tpu_torch.models.config import CodePredictorConfig, TalkerConfig, config_for_variant
from qwen3_tts_tpu_torch.ops import fused_layer, nn, quant

torch.set_num_threads(1)

# Small shapes the frame kernel takes (K multiples of 64, N of 256 columns).
CP_CFG = CodePredictorConfig(
    hidden_size=256, intermediate_size=512, num_hidden_layers=2, num_attention_heads=4,
    num_key_value_heads=2, head_dim=64, vocab_size=512, codec_embed_dim=512,
)
# The widest vocab the frame kernel takes (2^16), over 3 acoustic groups: a
# block's head slice is wider than one TMA box row (256 columns).
CP_WIDE_VOCAB = replace(CP_CFG, vocab_size=65536, num_code_groups=4)
# Small shapes the talker step kernel takes (int8 and bf16 GEMVs: N multiples
# of 256).
TALKER_CFG = TalkerConfig(
    text_embed_dim=128, hidden_size=256, text_proj_intermediate=128, intermediate_size=512,
    num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2, head_dim=64,
    text_vocab_size=1024, codec_vocab_size=512,
)
TALKER_STACK = TALKER_CFG.layer_stack()


# The 1.7B code predictor's widths (H 1024, 16 / 8 heads of 128, I 3072):
# the shapes of kernels 5, 6 and 7 on the per-step path.
CP_STACK = config_for_variant("1.7B", "custom_voice").code_predictor.layer_stack()


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and the CUDA toolkit")
    return torch.device("cuda", 0)


def _cp_inputs(device, dtype, seed=0, cfg=CP_CFG):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = W.fuse_model_params(W.init_code_predictor_params(gen, cfg, dtype))
    hidden = torch.randn((1, 1, 512), generator=gen, device=device).to(dtype)
    semantic = (torch.randn((1, 1, 512), generator=gen, device=device) * 0.02).to(dtype)
    return params, hidden, semantic


def _talker_inputs(device, dtype, rows, seed=0, quantized=True):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    st = TALKER_STACK
    stacked = W.init_layer_stack(
        gen, st.num_layers, st.hidden_size, st.intermediate_size, st.num_heads, st.num_kv_heads, st.head_dim, dtype
    )
    layers = W.fuse_layer_params(stacked)
    if quantized:
        layers = quant.quantize_layer_stack(layers)
    kvd = st.num_kv_heads * st.head_dim
    ck = torch.randn((st.num_layers, rows, kvd), generator=gen, device=device).to(dtype)
    cv = torch.randn((st.num_layers, rows, kvd), generator=gen, device=device).to(dtype)
    x = torch.randn((1, 1, st.hidden_size), generator=gen, device=device).to(dtype)
    return layers, x, ck, cv


def _unit_params(device, c, seed=0):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def rnd(shape, scale):
        return torch.randn(shape, generator=gen, device=device) * scale

    return {
        "act1_alpha": rnd((c,), 0.1), "act1_beta": rnd((c,), 0.1),
        "conv1_w": rnd((7, c, c), 0.05), "conv1_b": rnd((c,), 0.1),
        "act2_alpha": rnd((c,), 0.1), "act2_beta": rnd((c,), 0.1),
        "conv2_w": rnd((1, c, c), 0.05), "conv2_b": rnd((c,), 0.1),
    }


def test_wrappers_raise_on_devices_without_a_kernel():
    """Only CPU tensors take the plain version; any other device without a
    kernel raises instead of falling back."""
    params, hidden, semantic = _cp_inputs("cpu", torch.float32)
    with pytest.raises(ValueError, match="no kernel"):
        fused_layer.cp_frame(params, CP_CFG, hidden.to("meta"), semantic.to("meta"))
    x = torch.zeros((1, 40, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fused_blocks.residual_unit(x, _unit_params("cpu", 16), 1)
    params8 = quant.quantize_code_predictor_params(params)
    with pytest.raises(ValueError, match="no kernel"):
        fused_layer.cp_frame(params8, CP_CFG, hidden.to("meta"), semantic.to("meta"))
    layers, xt, ck, cv = _talker_inputs("cpu", torch.float32, 8)
    with pytest.raises(ValueError, match="no kernel"):
        fused_layer.talker_step(layers, xt.to("meta"), TALKER_STACK, ck.to("meta"), cv.to("meta"), 3)
    plain = _talker_inputs("cpu", torch.float32, 8, quantized=False)[0]
    with pytest.raises(ValueError, match="no kernel"):
        fused_layer.talker_step(plain, xt.to("meta"), TALKER_STACK, ck.to("meta"), cv.to("meta"), 3)
    w = quant.quantize_linear(torch.randn(128, 256))
    with pytest.raises(ValueError, match="no kernel"):
        quant.int8_matmul(torch.zeros((2, 128), device="meta"), w["q8"], w["scale"])
    layer = nn.layer_params_at(layers, 0)
    cos_t, sin_t = fused_layer.rope_tables(64, 1e6, 8, torch.device("cpu"))
    xm = xt.reshape(1, -1).to("meta")
    with pytest.raises(ValueError, match="no kernel"):
        fused_layer.fused_attention_step(xm, layer, cos_t, sin_t, ck[0].to("meta"), cv[0].to("meta"), 3, 4, 2, 64, 1e-6)
    with pytest.raises(ValueError, match="no kernel"):
        fused_layer.fused_mlp_step(xm, layer, TALKER_STACK.intermediate_size, 1e-6)
    with pytest.raises(ValueError, match="no kernel"):
        fused_layer.streamed_decode_step(layers, xt.to("meta"), TALKER_STACK, ck.to("meta"), cv.to("meta"), 3, cos_t, sin_t)


def test_kernel_library_name_tracks_the_sources():
    path = build.library_path()
    assert path == build.library_path()
    assert path.parent == build.BUILD_DIR and path.suffix == ".so"
    assert {p.name for p in build.CSRC.glob("*.cu")} == {
        "cp_frame.cu", "cp_step.cu", "fused_step.cu", "int8_matmul.cu", "residual_unit.cu", "talker_step.cu",
    }


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_cp_frame_matches_plain(dtype):
    """f32: codes identical to the plain version. bf16: the first code agrees
    (later codes may follow a near-tied logit that rounds the other way).
    One launch a frame, and the same bits twice."""
    dev = _cuda()
    params, hidden, semantic = _cp_inputs(dev, dtype)
    before = fused_layer.cp_frame.launches
    got = fused_layer.cp_frame(params, CP_CFG, hidden, semantic)
    assert fused_layer.cp_frame.launches == before + 1
    again = fused_layer.cp_frame(params, CP_CFG, hidden, semantic)
    assert fused_layer.cp_frame.launches == before + 2
    assert torch.equal(got, again) and got.data_ptr() != again.data_ptr()
    want = fused_layer.cp_frame_plain(params, CP_CFG, hidden, semantic)
    assert got.dtype == want.dtype == torch.int32 and got.shape == (CP_CFG.num_acoustic,)
    if dtype == torch.float32:
        assert torch.equal(got, want)
    else:
        assert got[0] == want[0]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_cp_frame_int8_matches_plain(dtype):
    """Weight-only int8 tree: the first code agrees with the plain version
    (sums in another order can flip a later near-tied logit), and most
    codes do."""
    dev = _cuda()
    params, hidden, semantic = _cp_inputs(dev, dtype, seed=3)
    params = quant.quantize_code_predictor_params(params)
    before = fused_layer.cp_frame.launches
    got = fused_layer.cp_frame(params, CP_CFG, hidden, semantic)
    assert fused_layer.cp_frame.launches == before + 1
    again = fused_layer.cp_frame(params, CP_CFG, hidden, semantic)
    assert fused_layer.cp_frame.launches == before + 2 and torch.equal(got, again)
    want = fused_layer.cp_frame_plain(params, CP_CFG, hidden, semantic)
    assert got.dtype == torch.int32 and got.shape == (CP_CFG.num_acoustic,)
    assert got[0] == want[0]
    assert (got == want).float().mean().item() >= 0.5


@pytest.mark.gpu
def test_cuda_cp_frame_trace():
    """A traced frame gives the same codes in one launch, and every block's
    stamps of a phase run in order (GEMV start <= end <= barrier arrival <=
    leave, the GEMV stamps 0 where the block owns no columns)."""
    dev = _cuda()
    params, hidden, semantic = _cp_inputs(dev, torch.bfloat16)
    want = fused_layer.cp_frame(params, CP_CFG, hidden, semantic)
    before = fused_layer.cp_frame.launches
    got, stamps = fused_layer.cp_frame(params, CP_CFG, hidden, semantic, trace=True)
    assert fused_layer.cp_frame.launches == before + 1 and torch.equal(got, want)
    st = stamps.cpu().reshape(stamps.shape[0], -1, 4)
    start, end, arrive, leave = st.unbind(-1)
    assert (arrive > 0).all() and (arrive <= leave).all()
    owns = start > 0
    assert ((start <= end) & (end <= arrive))[owns].all() and (end[~owns] == 0).all()
    assert fused_layer.cp_frame_trace_phases(stamps, CP_CFG)["span"] > 0


@pytest.mark.gpu
def test_cuda_cp_frame_checks_a_tree_once():
    """A pack checks and packs its tree once and serves every frame of it
    with one scratch (the same codes as a call that packs for itself); it
    refuses a tree holding other tensors, and a tree the kernel does not
    take raises before any launch."""
    dev = _cuda()
    params, hidden, semantic = _cp_inputs(dev, torch.bfloat16)
    pack = fused_layer.CpFramePack(params, CP_CFG, torch.bfloat16, dev)
    first = fused_layer.cp_frame(params, CP_CFG, hidden, semantic, pack)
    scratch = pack.scratch.data_ptr()
    assert torch.equal(fused_layer.cp_frame(params, CP_CFG, hidden, semantic, pack), first)
    assert pack.scratch.data_ptr() == scratch
    assert torch.equal(fused_layer.cp_frame(params, CP_CFG, hidden, semantic), first)
    heads = params["lm_heads"]
    params["lm_heads"] = heads.clone()
    before = fused_layer.cp_frame.launches
    with pytest.raises(ValueError, match="another tree"):
        fused_layer.cp_frame(params, CP_CFG, hidden, semantic, pack)
    params["lm_heads"] = heads.float()
    with pytest.raises(ValueError, match="lm_heads"):
        fused_layer.cp_frame(params, CP_CFG, hidden, semantic)
    with pytest.raises(ValueError, match="talker_hidden"):
        fused_layer.cp_frame(dict(params, lm_heads=heads), CP_CFG, hidden.expand(1, 2, -1), semantic, pack)
    assert fused_layer.cp_frame.launches == before


@pytest.mark.gpu
def test_cuda_cp_frame_pack_keeps_to_one_stream():
    """A pack's scratch serves one frame at a time: its frames run on the
    stream of its first, a frame on another stream raises before any
    launch, and a pack of that stream's own gives the same codes."""
    dev = _cuda()
    params, hidden, semantic = _cp_inputs(dev, torch.float32)
    pack = fused_layer.CpFramePack(params, CP_CFG, torch.float32, dev)
    want = fused_layer.cp_frame(params, CP_CFG, hidden, semantic, pack)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    before = fused_layer.cp_frame.launches
    with torch.cuda.stream(side):
        with pytest.raises(RuntimeError, match="stream"):
            fused_layer.cp_frame(params, CP_CFG, hidden, semantic, pack)
        assert fused_layer.cp_frame.launches == before
        own = fused_layer.CpFramePack(params, CP_CFG, torch.float32, dev)
        got = fused_layer.cp_frame(params, CP_CFG, hidden, semantic, own)
    torch.cuda.synchronize(dev)
    assert fused_layer.cp_frame.launches == before + 1 and torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("weights", ["float32", "bfloat16", "int8"])
def test_cuda_cp_frame_takes_a_wide_vocab(weights):
    """Vocab 65,536: each block's head slice is wider than a TMA box row,
    so it streams in 256-column segments. f32: codes identical to the plain
    version; bf16 and int8: the first code agrees."""
    dev = _cuda()
    dtype = torch.float32 if weights == "float32" else torch.bfloat16
    params, hidden, semantic = _cp_inputs(dev, dtype, cfg=CP_WIDE_VOCAB)
    if weights == "int8":
        params = quant.quantize_code_predictor_params(params)
    pack = fused_layer.CpFramePack(params, CP_WIDE_VOCAB, dtype, dev)
    head = pack.plan.projs["head"]
    assert head.box_vecs < head.nv
    got = fused_layer.cp_frame(params, CP_WIDE_VOCAB, hidden, semantic, pack)
    want = fused_layer.cp_frame_plain(params, CP_WIDE_VOCAB, hidden, semantic)
    assert got.shape == (CP_WIDE_VOCAB.num_acoustic,)
    if weights == "float32":
        assert torch.equal(got, want)
    else:
        assert got[0] == want[0]


@pytest.mark.gpu
@pytest.mark.parametrize("weights", ["int8", "plain"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,pos", [(32, 29), (288, 270)])
def test_cuda_talker_step_matches_plain(rows, pos, dtype, weights):
    """Int8 or plain (x's dtype) fused weights: hidden within 1e-4 (f32) /
    3e-2 (bf16) of max|plain| (sums in another order; bf16 roundings move by
    an ulp here and there), the written row likewise, every other cache row
    bit-unchanged."""
    dev = _cuda()
    layers, x, ck0, cv0 = _talker_inputs(dev, dtype, rows, quantized=weights == "int8")
    ck, cv, ckp, cvp = ck0.clone(), cv0.clone(), ck0.clone(), cv0.clone()
    before = fused_layer.talker_step.launches
    got = fused_layer.talker_step(layers, x, TALKER_STACK, ck, cv, pos)
    assert fused_layer.talker_step.launches == before + 1
    want = fused_layer.talker_step_plain(layers, x, TALKER_STACK, ckp, cvp, pos)
    assert got.dtype == dtype and got.shape == (1, 1, TALKER_STACK.hidden_size)
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol * want.float().abs().max().item())
    for c, cp_ in ((ck, ckp), (cv, cvp)):
        torch.testing.assert_close(c[:, pos].float(), cp_[:, pos].float(), rtol=0,
                                   atol=tol * cp_[:, pos].float().abs().max().item())
    others = torch.ones(rows, dtype=torch.bool, device=dev)
    others[pos] = False
    assert torch.equal(ck[:, others], ck0[:, others]) and torch.equal(cv[:, others], cv0[:, others])


@pytest.mark.gpu
def test_cuda_talker_step_refuses_mixed_trees():
    """A tree with int8 and plain projections, or plain weights in another
    dtype than x, raises on the card instead of running anything."""
    dev = _cuda()
    layers, x, ck, cv = _talker_inputs(dev, torch.bfloat16, 32)
    plain = _talker_inputs(dev, torch.bfloat16, 32, quantized=False)[0]
    before = fused_layer.talker_step.launches
    with pytest.raises(ValueError, match="all int8 or all plain"):
        fused_layer.talker_step(dict(plain, o_proj=layers["o_proj"]), x, TALKER_STACK, ck, cv, 5)
    with pytest.raises(ValueError, match="qkv_proj must be"):
        fused_layer.talker_step(dict(plain, qkv_proj=plain["qkv_proj"].float()), x, TALKER_STACK, ck, cv, 5)
    assert fused_layer.talker_step.launches == before


@pytest.mark.gpu
def test_cuda_model_fuses_its_plain_talker():
    """``Qwen3TTS.from_random`` on the card holds a fused bf16 talker (no
    separate projections), and its decode steps take kernel 3."""
    from qwen3_tts_tpu_torch.models import talker
    from qwen3_tts_tpu_torch.models.config import ModelConfig, ModelType
    from qwen3_tts_tpu_torch.pipeline import Qwen3TTS

    dev = _cuda()
    cfg = ModelConfig(model_type=ModelType.CUSTOM_VOICE, model_size="small", talker=TALKER_CFG, code_predictor=CP_CFG)
    model = Qwen3TTS.from_random(cfg, seed=0, device=dev)
    layers = model.talker_params["layers"]
    assert layers["qkv_proj"].dtype == torch.bfloat16 and layers["qkv_proj"].device.type == "cuda"
    assert not {"q_proj", "k_proj", "v_proj", "gate_proj", "up_proj"} & set(layers)
    cache = nn.init_kv_cache(TALKER_STACK, 1, 64, torch.bfloat16, dev)
    assert talker.stream_plane_mode(model.talker_params, TALKER_CFG, cache)
    before = fused_layer.talker_step.launches
    x = torch.zeros((1, 1, TALKER_CFG.hidden_size), dtype=torch.bfloat16, device=dev)
    talker.decode_step(model.talker_params, TALKER_CFG, x, 3, cache)
    assert fused_layer.talker_step.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n", [(128, 128), (256, 384), (2048, 3072), (6144, 2048), (4096, 256)])
@pytest.mark.parametrize("m", [1, 2, 10, 16, 17, 64, 65, 1000, 1024])
def test_cuda_int8_matmul_matches_plain(m, k, n, dtype):
    """f32 out: within 1e-5 of max|plain| (the same exact products, summed
    by the tensor cores and the K splits in another order); bf16 out: within
    one bf16 ulp of the output's scale. Both tiers (m <= 16, m > 16), K with
    fewer chunks than the ring has stages (128), split K and not (m >= 1000
    at N >= 2048 fills the card without), and the plan's largest clusters
    (K 4096, N 256: 2 tiles, 8 splits). One launch per call, and the same bits
    twice (the splits are added in a fixed order)."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(m * 7 + k)
    x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
    w = quant.quantize_linear(torch.randn((k, n), generator=gen, device=dev) * 0.05)
    before = quant.int8_matmul.launches
    got = quant.int8_matmul(x, w["q8"], w["scale"])
    assert quant.int8_matmul.launches == before + 1
    again = quant.int8_matmul(x, w["q8"], w["scale"])
    want = quant.int8_matmul_plain(x, w["q8"], w["scale"])
    assert got.dtype == dtype and got.shape == (m, n)
    assert torch.equal(got, again)
    tol = 1e-5 if dtype == torch.float32 else 2.0**-7
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol * want.float().abs().max().item())
    # A shape outside the kernel's gate takes the plain form, as the JAX
    # package takes XLA's dequant-then-dot.
    w_odd = quant.quantize_linear(torch.randn((k, 100), generator=gen, device=dev))
    out = quant.int8_matmul(x, w_odd["q8"], w_odd["scale"])
    assert quant.int8_matmul.launches == before + 2
    assert torch.equal(out, quant.int8_matmul_plain(x, w_odd["q8"], w_odd["scale"]))


@pytest.mark.gpu
@pytest.mark.parametrize("dilation", [1, 3, 9])
@pytest.mark.parametrize("c", [96, 200])
def test_cuda_residual_unit_matches_plain(c, dilation):
    """Within 1e-5 * max|x| of the plain version (sums in another order),
    and a prefix run bit-identical to the long run."""
    dev = _cuda()
    p = _unit_params(dev, c, seed=dilation)
    x = torch.randn((2, 1000, c), generator=torch.Generator(device=dev).manual_seed(c), device=dev)
    before = fused_blocks.residual_unit.launches
    got = fused_blocks.residual_unit(x, p, dilation)
    assert fused_blocks.residual_unit.launches == before + 1
    want = fused_blocks.residual_unit_plain(x, p, dilation)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * x.abs().max().item())
    short = fused_blocks.residual_unit(x[:, :613].contiguous(), p, dilation)
    assert torch.equal(short, got[:, :613])


@pytest.mark.gpu
def test_cuda_wrappers_check_their_inputs():
    dev = _cuda()
    params, hidden, semantic = _cp_inputs(dev, torch.float32)
    with pytest.raises(ValueError):
        fused_layer.cp_frame(params, CP_CFG, hidden.to(torch.bfloat16), semantic.to(torch.bfloat16))
    unfused = W.init_code_predictor_params(torch.Generator(device=dev), CP_CFG, torch.float32)
    with pytest.raises(ValueError, match="fused"):
        fused_layer.cp_frame(unfused, CP_CFG, hidden, semantic)
    p = _unit_params(dev, 64)
    x = torch.randn((1, 50, 64), device=dev)
    with pytest.raises(ValueError):
        fused_blocks.residual_unit(x.transpose(1, 2).contiguous().transpose(1, 2), p, 3)
    with pytest.raises(ValueError):
        fused_blocks.residual_unit(x.double(), p, 3)
    # Kernel 4 copies x, q8 and scale with 16-byte cp.async: a contiguous view
    # at an odd offset raises (no fallback), the aligned one launches.
    w = quant.quantize_linear(torch.randn((256, 384), device=dev))
    flat = torch.randn(2 * 256 + 8, device=dev).to(torch.bfloat16)
    before = quant.int8_matmul.launches
    with pytest.raises(ValueError, match="aligned"):
        quant.int8_matmul(flat[1 : 1 + 2 * 256].view(2, 256), w["q8"], w["scale"])
    scale_view = torch.cat([w["scale"][:1], w["scale"]])[1:]  # contiguous, 4 bytes in
    with pytest.raises(ValueError, match="aligned"):
        quant.int8_matmul(flat[:512].view(2, 256), w["q8"], scale_view)
    assert quant.int8_matmul.launches == before
    quant.int8_matmul(flat[8 : 8 + 2 * 256].view(2, 256), w["q8"], w["scale"])
    assert quant.int8_matmul.launches == before + 1
    # The plan's tile sizes are the kernel's own: its C entry takes both of
    # the plan's tiers and refuses any other (rows, chunk rows) pair.
    x = flat[:512].view(2, 256)
    out = torch.empty((2, 384), dtype=x.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def entry(bm, bk):
        return quant._kernel_lib().q3_int8_matmul(1, x.data_ptr(), w["q8"].data_ptr(), w["scale"].data_ptr(),
                                                  out.data_ptr(), 2, 256, 384, bm, bk, 1, stream)

    assert [entry(bm, bk) for bm, bk in quant.INT8_MM_TIERS] == [0, 0]
    assert entry(16, 32) != 0 and entry(64, 64) != 0


def _cp_step_inputs(device, dtype, layers, seed=0):
    """Int8 layers at the 1.7B code predictor's widths, random caches of
    CP_MAX_SEQ rows, an input row, and the RoPE tables."""
    st = CP_STACK
    gen = torch.Generator(device=device).manual_seed(seed)
    stacked = W.init_layer_stack(
        gen, layers, st.hidden_size, st.intermediate_size, st.num_heads, st.num_kv_heads, st.head_dim, dtype
    )
    stacked = quant.quantize_layer_stack(W.fuse_layer_params(stacked))
    kvd = st.num_kv_heads * st.head_dim
    ck = torch.randn((layers, fused_layer.CP_MAX_SEQ, kvd), generator=gen, device=device).to(dtype)
    cv = torch.randn((layers, fused_layer.CP_MAX_SEQ, kvd), generator=gen, device=device).to(dtype)
    x = torch.randn((1, st.hidden_size), generator=gen, device=device).to(dtype)
    cos_t, sin_t = fused_layer.rope_tables(st.head_dim, st.rope_theta, fused_layer.CP_MAX_SEQ, torch.device(device))
    return stacked, x, ck, cv, cos_t, sin_t


def _step_tol(dtype, layers=1):
    # Relative to max|plain|. The int8 matmuls round their inputs to bf16 in
    # f32 programs too, so a sum in another order can flip an input's
    # rounding by a bf16 ulp (2^-8) wherever a value sits near a rounding
    # boundary; through 5 layers and 17 live cache rows that moves an f32 step
    # by up to ~4e-4 of its scale even for a 2^-22 change of every scale
    # (plain version on the CPU); over chip_smoke.py's 16 random steps the
    # kernel lies up to 3.0e-3 away, a step whose residual stream is rounded
    # to bf16 (``_bf16_residual_step``) at least 5.6e-3, so the 5-layer f32
    # bar sits between. In bf16 every element may round one ulp the other
    # way, and that moves the rest of the step by a few ulps.
    if dtype == torch.float32:
        return 1e-3 if layers == 1 else 4e-3
    return 3e-2


def _bf16_residual_step(layers, x, ck, cv, pos, cos_t, sin_t):
    """Kernel 7's plain step with its residual stream rounded to bf16 after
    every sub-layer: a faulty f32 step that the f32 bar must reject."""
    st, bf16 = CP_STACK, torch.bfloat16
    cos_row, sin_row = cos_t[pos : pos + 1].to(bf16), sin_t[pos : pos + 1].to(bf16)
    h = x.reshape(1, st.hidden_size)
    for l in range(ck.shape[0]):
        layer = nn.layer_params_at(layers, l)
        h = fused_layer._attention_plain(
            h, layer, cos_row, sin_row, ck[l], cv[l], pos, st.num_heads, st.num_kv_heads, st.head_dim,
            st.rms_norm_eps, True, st.hidden_size,
        ).to(bf16).float()
        h = fused_layer._mlp_plain(h, layer, st.intermediate_size, st.rms_norm_eps, True, st.hidden_size)
        h = h.to(bf16).float()
    return h.reshape(1, 1, st.hidden_size)


def _assert_rows(ck, ck0, ckp, pos, tol):
    torch.testing.assert_close(ck[..., pos, :].float(), ckp[..., pos, :].float(), rtol=0,
                               atol=tol * ckp[..., pos, :].float().abs().max().item())
    others = torch.ones(ck.shape[-2], dtype=torch.bool, device=ck.device)
    others[pos] = False
    bits = torch.int32 if ck.dtype == torch.float32 else torch.int16  # NaN rows compare by their bits
    assert torch.equal(ck[..., others, :].view(bits), ck0[..., others, :].view(bits))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("pos", [2, 16])
def test_cuda_attention_step_matches_plain(pos, residual, dtype):
    """Kernel 5 at the 1.7B code predictor's widths, S = 17; rows above pos
    hold NaN, which the kernel must not read."""
    dev = _cuda()
    layers, x, ck0, cv0, cos_t, sin_t = _cp_step_inputs(dev, dtype, 1)
    layer = nn.layer_params_at(layers, 0)
    ck0[0, pos + 1 :], cv0[0, pos + 1 :] = float("nan"), float("nan")
    ck, cv, ckp, cvp = ck0[0].clone(), cv0[0].clone(), ck0[0].clone(), cv0[0].clone()
    st = CP_STACK
    args = (pos, st.num_heads, st.num_kv_heads, st.head_dim, st.rms_norm_eps, residual)
    before = fused_layer.fused_attention_step.launches
    got = fused_layer.fused_attention_step(x, layer, cos_t, sin_t, ck, cv, *args)
    assert fused_layer.fused_attention_step.launches == before + 1
    want = fused_layer.fused_attention_step_plain(x, layer, cos_t, sin_t, ckp, cvp, *args)
    assert got.dtype == dtype and got.shape == x.shape and bool(torch.isfinite(got).all())
    tol = _step_tol(dtype)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol * want.float().abs().max().item())
    _assert_rows(ck, ck0[0], ckp, pos, tol)
    _assert_rows(cv, cv0[0], cvp, pos, tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual", [True, False])
def test_cuda_mlp_step_matches_plain(residual, dtype):
    """Kernel 6 at the 1.7B code predictor's widths."""
    dev = _cuda()
    layers, x, *_ = _cp_step_inputs(dev, dtype, 1, seed=1)
    layer = nn.layer_params_at(layers, 0)
    before = fused_layer.fused_mlp_step.launches
    got = fused_layer.fused_mlp_step(x, layer, CP_STACK.intermediate_size, CP_STACK.rms_norm_eps, residual)
    assert fused_layer.fused_mlp_step.launches == before + 1
    want = fused_layer.fused_mlp_step_plain(x, layer, CP_STACK.intermediate_size, CP_STACK.rms_norm_eps, residual)
    assert got.dtype == dtype and got.shape == x.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=_step_tol(dtype) * want.float().abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pos", [2, 16])
def test_cuda_streamed_step_matches_plain(pos, dtype):
    """Kernel 7 through the 1.7B code predictor's 5 layers, S = 17. In f32
    the bar must also reject a step whose residual stream is bf16."""
    dev = _cuda()
    layers, x, ck0, cv0, cos_t, sin_t = _cp_step_inputs(dev, dtype, CP_STACK.num_layers, seed=2)
    ck0[:, pos + 1 :], cv0[:, pos + 1 :] = float("nan"), float("nan")
    ck, cv, ckp, cvp = ck0.clone(), cv0.clone(), ck0.clone(), cv0.clone()
    x = x.reshape(1, 1, -1)
    before = fused_layer.streamed_decode_step.launches
    got = fused_layer.streamed_decode_step(layers, x, CP_STACK, ck, cv, pos, cos_t, sin_t)
    assert fused_layer.streamed_decode_step.launches == before + 1
    want = fused_layer.streamed_decode_step_plain(layers, x, CP_STACK, ckp, cvp, pos, cos_t, sin_t)
    assert got.dtype == dtype and got.shape == x.shape and bool(torch.isfinite(got).all())
    tol = _step_tol(dtype, CP_STACK.num_layers)
    scale = want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol * scale)
    _assert_rows(ck, ck0, ckp, pos, tol)
    _assert_rows(cv, cv0, cvp, pos, tol)
    if dtype == torch.float32:
        faulty = _bf16_residual_step(layers, x, ck0.clone(), cv0.clone(), pos, cos_t, sin_t)
        assert (faulty - want).abs().max().item() > tol * scale
