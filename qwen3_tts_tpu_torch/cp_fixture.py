"""Seeded weights and inputs at the 1.7B code predictor's widths, and the
codes the JAX package gives them (a committed fixture).

``tests/test_torch_cp_1p7b.py`` holds the JAX package's
``predict_acoustic_codes`` (its XLA path, f32, on the CPU) and the port's
plain frame to the fixture; ``chip_smoke.py`` holds kernel 1 to it on the
card, in f32. Both build the same weights here, from one seed, with numpy's
legacy ``RandomState`` (whose stream does not change between numpy
versions): uniform weights of standard deviation 0.02 (the scale of the
packages' random init), norms of ones, a zero mtp bias. The tree has the JAX
package's layout (unfused, with the mtp projection), which
``models.weights.from_numpy_tree`` takes.

    JAX_PLATFORMS=cpu python tests/test_torch_cp_1p7b.py   # rewrites the fixture
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from .models.config import CodePredictorConfig, config_for_variant

SEED = 1717
FRAMES = 4
FIXTURE = Path(__file__).resolve().parent / "testdata" / "cp_1p7b_codes.json"


def config() -> CodePredictorConfig:
    return config_for_variant("1.7B", "custom_voice").code_predictor


def _uniform(rs: np.random.RandomState, shape: tuple, std: float = 0.02) -> np.ndarray:
    """Uniform f32 values of standard deviation ``std`` from 16 random bits each."""
    n = int(np.prod(shape))
    bits = np.frombuffer(rs.bytes(2 * n), dtype="<i2").reshape(shape)
    return bits.astype(np.float32) * np.float32(std * 3**0.5 / 32768)


def numpy_params(cfg: CodePredictorConfig, seed: int = SEED) -> dict:
    """The code predictor's f32 tree (the JAX package's layout)."""
    rs = np.random.RandomState(seed)
    sc = cfg.layer_stack()
    L, H, I, D = sc.num_layers, sc.hidden_size, sc.intermediate_size, sc.head_dim
    qd, kvd, G = sc.num_heads * D, sc.num_kv_heads * D, cfg.num_acoustic
    ones = lambda *shape: np.ones(shape, np.float32)  # noqa: E731
    params = {
        "codec_embeddings": _uniform(rs, (G, cfg.vocab_size, cfg.embed_dim)),
        "layers": {
            "q_proj": _uniform(rs, (L, H, qd)), "k_proj": _uniform(rs, (L, H, kvd)),
            "v_proj": _uniform(rs, (L, H, kvd)), "o_proj": _uniform(rs, (L, qd, H)),
            "q_norm": ones(L, D), "k_norm": ones(L, D), "input_ln": ones(L, H), "post_ln": ones(L, H),
            "gate_proj": _uniform(rs, (L, H, I)), "up_proj": _uniform(rs, (L, H, I)),
            "down_proj": _uniform(rs, (L, I, H)),
        },
        "norm": ones(H),
        "lm_heads": _uniform(rs, (G, H, cfg.vocab_size)),
        "mtp_proj": None,
    }
    if cfg.needs_projection:
        params["mtp_proj"] = {"w": _uniform(rs, (cfg.embed_dim, H)), "b": np.zeros(H, np.float32)}
    return params


def numpy_inputs(cfg: CodePredictorConfig, seed: int = SEED, frames: int = FRAMES) -> list:
    """``frames`` (talker hidden, semantic embedding) pairs, f32 [1, 1, E]."""
    rs = np.random.RandomState(seed + 1)
    e = cfg.embed_dim
    return [(rs.standard_normal((1, 1, e)).astype(np.float32),
             (0.02 * rs.standard_normal((1, 1, e))).astype(np.float32)) for _ in range(frames)]


def load() -> dict:
    """The fixture: ``codes`` [FRAMES][15] and each code's ``top2_gap`` (its
    logit minus the runner-up's, by the JAX package's layer stack)."""
    return json.loads(FIXTURE.read_text())
