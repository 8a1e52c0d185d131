"""Kernel 2's path at full width: the default vocoder (decoder_dim 1536,
rates 8/5/4/3), the JAX package and the port, on the CPU in f32.

Seeded numpy weights at the widths every published variant uses
(``qwen3_tts_tpu_torch.vocoder_fixture``) and 8 seeded codec frames go to
both packages. The JAX package's ``vocoder.decode_jit`` (XLA on the CPU:
its residual units take no Pallas kernel there) must give the committed
fixture's audio, and the port's ``decode`` (its residual units with C <=
512 routed to ``fused_blocks.residual_unit``, which runs the plain version
on a CPU tensor) the same, within atol 1e-5 and within 1e-4 of max|audio|
(f32 sums in another order through the whole stack), as
``test_torch_vocoder.py::test_decode_matches_jax`` holds the tiny vocoder.
``chip_smoke.py`` holds the card's ``decode_bucketed`` (kernel 2 at C =
384, 192 and 96) to the same fixture. ~20 s of CPU.

    JAX_PLATFORMS=cpu python tests/test_torch_vocoder_full.py   # rewrites the fixture
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from qwen3_tts_tpu.models.codec import vocoder as jvoc  # noqa: E402
from qwen3_tts_tpu_torch import vocoder_fixture  # noqa: E402
from qwen3_tts_tpu_torch.models import weights as TW  # noqa: E402
from qwen3_tts_tpu_torch.models.codec import fused_blocks as tfb  # noqa: E402
from qwen3_tts_tpu_torch.models.codec import vocoder as tvoc  # noqa: E402

torch.set_num_threads(1)

ATOL = 1e-5
REL = 1e-4  # of max|audio|


def jax_audio(params: dict, codes: np.ndarray) -> np.ndarray:
    """The JAX package's f32 decode of ``codes`` at its default config."""
    return np.asarray(jvoc.decode_jit(jax.tree.map(jnp.asarray, params), jvoc.VocoderConfig(), jnp.asarray(codes)))


def assert_audio_close(got: np.ndarray, want: np.ndarray) -> None:
    assert got.shape == want.shape == (1, vocoder_fixture.FRAMES * vocoder_fixture.config().total_upsample)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert np.abs(got - want).max() <= REL * np.abs(want).max()


@pytest.fixture(scope="module")
def case():
    cfg = vocoder_fixture.config()
    return cfg, vocoder_fixture.numpy_params(cfg), vocoder_fixture.numpy_codes(cfg)


def test_configs_agree():
    """The port's default vocoder config is the JAX package's, field for field."""
    cfg, jcfg = vocoder_fixture.config(), jvoc.VocoderConfig()
    assert {f: getattr(cfg, f) for f in type(cfg).__dataclass_fields__} == {
        f: getattr(jcfg, f) for f in type(jcfg).__dataclass_fields__
    }


def test_fixture_is_unclipped_audio():
    """The fixture exercises the whole stack: audio of a real scale, nowhere
    clipped (the decode clamps to [-1, 1], which would hide a difference)."""
    audio = vocoder_fixture.load()
    assert audio.dtype == np.float32 and np.isfinite(audio).all()
    assert 0.1 < np.abs(audio).max() < 0.9 and audio.std() > 0.01


def test_jax_package_gives_the_fixture(case):
    _, params, codes = case
    assert_audio_close(jax_audio(params, codes), vocoder_fixture.load())


def test_port_plain_decode_gives_the_fixture(case):
    cfg, params, codes = case
    tparams = TW.from_numpy_tree(params, "cpu")
    before = tfb.residual_unit.launches
    with torch.no_grad():
        got = tvoc.decode(tparams, cfg, torch.from_numpy(codes)).numpy()
    assert tfb.residual_unit.launches == before  # CPU tensors take the plain version
    assert_audio_close(got, vocoder_fixture.load())


if __name__ == "__main__":
    cfg = vocoder_fixture.config()
    audio = jax_audio(vocoder_fixture.numpy_params(cfg), vocoder_fixture.numpy_codes(cfg))
    np.save(vocoder_fixture.FIXTURE, audio.astype(np.float32))
    print(f"wrote {vocoder_fixture.FIXTURE}: {audio.shape}, max|audio| {np.abs(audio).max():.4f}, "
          f"std {audio.std():.4f}")
