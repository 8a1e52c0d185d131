"""Seeded weights and inputs at the 1.7B code predictor's widths, and what
the JAX package gives them (committed fixtures).

``tests/test_torch_cp_1p7b.py`` holds the JAX package's
``predict_acoustic_codes`` (its XLA path, f32, on the CPU) and the port's
plain frame to the codes fixture; ``chip_smoke.py`` holds kernel 1 to it on
the card, in f32. Both build the same weights here, from one seed, with
numpy's legacy ``RandomState`` (whose stream does not change between numpy
versions): uniform weights of standard deviation 0.02 (the scale of the
packages' random init), norms of ones, a zero mtp bias. The tree has the JAX
package's layout (unfused, with the mtp projection), which
``models.weights.from_numpy_tree`` takes.

The same layers, fused and quantized to int8 (``step_layers``), are kernel
7's fixture: one decode step at each of ``STEP_POSITIONS`` from seeded
inputs (``step_inputs``), whose f32 outputs by the JAX package's
``streamed_decode_step`` (interpret mode, with its stream pack) are
committed (``STEP_FIXTURE``). ``tests/test_torch_cp_step_1p7b.py`` holds
the JAX package and the port's plain step to them on the CPU;
``chip_smoke.py`` holds kernel 7 in f32 to them on the card.

The same draw at intermediate 2816 (``fused_step_config``: not a multiple of
the hidden 1024, so the JAX gates send the code predictor to kernels 5 + 6
per layer), fused and quantized, stepped from the same inputs by the JAX
package's ``run_fused_decode_step`` without a stream pack (its
``fused_attention_step`` and ``fused_mlp_step`` per layer, interpret mode,
f32), is kernels 5 and 6's fixture (``FUSED_STEP_FIXTURE``):
``tests/test_torch_fused_step_1p7b.py`` holds the JAX package and the
port's plain step to it on the CPU, ``chip_smoke.py`` the f32 kernels
through a ``FusedStepPack`` on the card.

    JAX_PLATFORMS=cpu python tests/test_torch_cp_1p7b.py          # rewrites the codes fixture
    JAX_PLATFORMS=cpu python tests/test_torch_cp_step_1p7b.py     # rewrites the step fixture
    JAX_PLATFORMS=cpu python tests/test_torch_fused_step_1p7b.py  # rewrites kernels 5 and 6's fixture
"""

from __future__ import annotations

import json
from dataclasses import replace
from pathlib import Path

import numpy as np

from .models.config import CodePredictorConfig, config_for_variant

SEED = 1717
FRAMES = 4
FIXTURE = Path(__file__).resolve().parent / "testdata" / "cp_1p7b_codes.json"
# Kernel 7's fixture: the positions stepped (the first and the last decode
# step of a 17-row cache) and their outputs [len(STEP_POSITIONS), H].
STEP_POSITIONS = (2, 16)
STEP_ROWS = 17
STEP_FIXTURE = Path(__file__).resolve().parent / "testdata" / "cp_step_1p7b.npy"
# Kernels 5 and 6's fixture: the same positions' outputs through the
# per-layer route at intermediate 2816.
FUSED_STEP_INTERMEDIATE = 2816
FUSED_STEP_FIXTURE = Path(__file__).resolve().parent / "testdata" / "fused_step_1p7b.npy"


def config() -> CodePredictorConfig:
    return config_for_variant("1.7B", "custom_voice").code_predictor


def fused_step_config() -> CodePredictorConfig:
    """``config()`` at intermediate ``FUSED_STEP_INTERMEDIATE``."""
    return replace(config(), intermediate_size=FUSED_STEP_INTERMEDIATE)


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


def step_layers(cfg: CodePredictorConfig, seed: int = SEED) -> dict:
    """``numpy_params``' layer stack fused and quantized to int8 by the port
    (bit for bit the JAX package's quantizer), f32 norms: a tree of CPU
    tensors."""
    import torch

    from .models import weights as W
    from .ops import quant

    layers = numpy_params(cfg, seed)["layers"]
    return quant.quantize_layer_stack(W.fuse_layer_params({k: torch.from_numpy(v) for k, v in layers.items()}))


def step_inputs(cfg: CodePredictorConfig, seed: int = SEED) -> list:
    """For each of ``STEP_POSITIONS``: (pos, x f32 [1, 1, H], the caches k
    and v f32 [L, STEP_ROWS, KV*D] with the rows below pos seeded and the
    rest zero)."""
    rs = np.random.RandomState(seed + 2)
    sc = cfg.layer_stack()
    shape = (sc.num_layers, STEP_ROWS, sc.num_kv_heads * sc.head_dim)
    out = []
    for pos in STEP_POSITIONS:
        k, v = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
        k[:, :pos] = rs.standard_normal(k[:, :pos].shape)
        v[:, :pos] = rs.standard_normal(v[:, :pos].shape)
        out.append((pos, rs.standard_normal((1, 1, sc.hidden_size)).astype(np.float32), k, v))
    return out


def load_step() -> np.ndarray:
    """Kernel 7's fixture: the JAX package's f32 step outputs
    [len(STEP_POSITIONS), H]."""
    return np.load(STEP_FIXTURE)


def load_fused_step() -> np.ndarray:
    """Kernels 5 and 6's fixture: the JAX package's f32 outputs of the
    per-layer route [len(STEP_POSITIONS), H]."""
    return np.load(FUSED_STEP_FIXTURE)
