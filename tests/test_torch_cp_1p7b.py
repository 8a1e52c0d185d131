"""Kernel 1's reference at full width: the 1.7B code predictor, the JAX
package and the port, on the CPU in f32.

Seeded numpy weights at the 1.7B code-predictor widths, with the mtp
projection (``qwen3_tts_tpu_torch.cp_fixture``), go to both packages. The
JAX package's ``predict_acoustic_codes`` (its XLA path: the unfused tree
takes no Pallas kernel) gives 4 frames of 15 codes, which must equal the
committed fixture; the port's plain frame (what ``cp_frame`` runs on a CPU
tensor, on the fused tree the card's kernel takes) must give the same 60
codes. The fixture also holds each code's top-2 logit gap, so that a
near-tie flip can be told from a fault; ``chip_smoke.py`` holds kernel 1 to
the same codes on the card.

    JAX_PLATFORMS=cpu python tests/test_torch_cp_1p7b.py   # rewrites the fixture
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from qwen3_tts_tpu.models import code_predictor as jcp  # noqa: E402
from qwen3_tts_tpu.models.config import config_for_variant as jconfig  # noqa: E402
from qwen3_tts_tpu.ops import nn as jnn  # noqa: E402
from qwen3_tts_tpu_torch import cp_fixture  # noqa: E402
from qwen3_tts_tpu_torch.models import weights as TW  # noqa: E402
from qwen3_tts_tpu_torch.ops import fused_layer as tfl  # noqa: E402

# Gaps below this (f32 logits of scale ~0.6) could flip under another
# summation order; the fixture's seed has none.
MIN_GAP = 1e-3


def jax_frames(params: dict, cfg, inputs: list, with_gaps: bool = False) -> tuple[np.ndarray, np.ndarray | None]:
    """The JAX package's codes for each frame and, ``with_gaps``, each
    code's top-2 logit gap from one causal pass over the frame's 16
    positions with the codes fed back (the same logits as the 15 cached
    steps, up to f32 sums)."""
    jp = jax.tree.map(jnp.asarray, params)
    codes, gaps = [], []
    for hidden, semantic in inputs:
        c = np.asarray(jcp.predict_acoustic_codes(jp, cfg, jnp.asarray(hidden), jnp.asarray(semantic)))
        codes.append(c.tolist())
        if not with_gaps:
            continue
        emb = jp["codec_embeddings"][jnp.arange(cfg.num_acoustic - 1), c[:-1]][None]
        x = jnp.concatenate([jnp.asarray(hidden), jnp.asarray(semantic), emb], axis=1)
        x = x @ jp["mtp_proj"]["w"] + jp["mtp_proj"]["b"]
        h = jnn.rms_norm(jnn.run_layer_stack_nocache(jp["layers"], x, cfg.layer_stack()), jp["norm"], cfg.rms_norm_eps)
        logits = np.asarray(jnp.einsum("gh,ghv->gv", h[0, 1:], jp["lm_heads"]))
        top2 = np.sort(logits, axis=-1)[:, -2:]
        assert np.array_equal(np.argmax(logits, axis=-1), c)
        gaps.append((top2[:, 1] - top2[:, 0]).tolist())
    return np.array(codes), np.array(gaps) if with_gaps else None


@pytest.fixture(scope="module")
def frames():
    cfg = cp_fixture.config()
    return cfg, cp_fixture.numpy_params(cfg), cp_fixture.numpy_inputs(cfg)


def test_jax_package_gives_the_fixture(frames):
    cfg, params, inputs = frames
    jcfg = jconfig("1.7B", "custom_voice").code_predictor
    assert jcfg == type(jcfg)(**{f: getattr(cfg, f) for f in type(jcfg).__dataclass_fields__})
    codes, _ = jax_frames(params, jcfg, inputs)
    fixture = cp_fixture.load()
    assert codes.tolist() == fixture["codes"]
    assert np.array(fixture["top2_gap"]).shape == codes.shape and min(map(min, fixture["top2_gap"])) >= MIN_GAP


def test_port_plain_frame_gives_the_fixture(frames):
    cfg, params, inputs = frames
    tparams = TW.fuse_model_params(TW.from_numpy_tree(params, "cpu"))
    before = tfl.cp_frame.launches
    got = [tfl.cp_frame(tparams, cfg, torch.from_numpy(h), torch.from_numpy(s)).tolist() for h, s in inputs]
    assert tfl.cp_frame.launches == before  # CPU tensors take the plain version
    assert got == cp_fixture.load()["codes"]


if __name__ == "__main__":
    cfg = cp_fixture.config()
    codes, gaps = jax_frames(cp_fixture.numpy_params(cfg), jconfig("1.7B", "custom_voice").code_predictor,
                             cp_fixture.numpy_inputs(cfg), with_gaps=True)
    assert gaps.min() >= MIN_GAP, f"a near-tied code (top-2 gap {gaps.min():.3e}): pick another seed"
    cp_fixture.FIXTURE.write_text(json.dumps({
        "source": "qwen3_tts_tpu.models.code_predictor.predict_acoustic_codes, f32, XLA on the CPU",
        "seed": cp_fixture.SEED, "frames": cp_fixture.FRAMES,
        "codes": codes.tolist(), "top2_gap": [[round(g, 6) for g in row] for row in gaps.tolist()],
    }, indent=1) + "\n")
    print(f"wrote {cp_fixture.FIXTURE}: min top-2 gap {gaps.min():.3e}")
