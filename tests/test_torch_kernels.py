"""The port's CUDA kernels against their plain PyTorch versions.

This file imports torch and the port only (no JAX), so it also runs on a
machine with a card and no JAX: ``python -m pytest --noconftest -m gpu
tests/test_torch_kernels.py``. Tests marked ``gpu`` skip without a CUDA
device; the others check the wrappers' routing on any machine.
"""

import pytest
import torch

from qwen3_tts_tpu_torch import build
from qwen3_tts_tpu_torch.models import weights as W
from qwen3_tts_tpu_torch.models.codec import fused_blocks
from qwen3_tts_tpu_torch.models.config import CodePredictorConfig
from qwen3_tts_tpu_torch.ops import fused_layer

torch.set_num_threads(1)

# Small shapes the frame kernel takes (K multiples of 64, N of 256 columns).
CP_CFG = CodePredictorConfig(
    hidden_size=256, intermediate_size=512, num_hidden_layers=2, num_attention_heads=4,
    num_key_value_heads=2, head_dim=64, vocab_size=512, codec_embed_dim=512,
)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and the CUDA toolkit")
    return torch.device("cuda", 0)


def _cp_inputs(device, dtype, seed=0):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = W.fuse_model_params(W.init_code_predictor_params(gen, CP_CFG, dtype))
    hidden = torch.randn((1, 1, 512), generator=gen, device=device).to(dtype)
    semantic = (torch.randn((1, 1, 512), generator=gen, device=device) * 0.02).to(dtype)
    return params, hidden, semantic


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


def test_kernel_library_name_tracks_the_sources():
    path = build.library_path()
    assert path == build.library_path()
    assert path.parent == build.BUILD_DIR and path.suffix == ".so"
    assert {p.name for p in build.CSRC.glob("*.cu")} == {"cp_frame.cu", "residual_unit.cu"}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_cp_frame_matches_plain(dtype):
    """f32: codes identical to the plain version. bf16: the first code agrees
    (later codes may follow a near-tied logit that rounds the other way)."""
    dev = _cuda()
    params, hidden, semantic = _cp_inputs(dev, dtype)
    before = fused_layer.cp_frame.launches
    got = fused_layer.cp_frame(params, CP_CFG, hidden, semantic)
    assert fused_layer.cp_frame.launches == before + 1
    want = fused_layer.cp_frame_plain(params, CP_CFG, hidden, semantic)
    assert got.dtype == want.dtype == torch.int32 and got.shape == (CP_CFG.num_acoustic,)
    if dtype == torch.float32:
        assert torch.equal(got, want)
    else:
        assert got[0] == want[0]


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
