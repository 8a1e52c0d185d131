"""Seeded weights and inputs at the 1.7B talker's widths, and the codec-head
argmaxes the JAX package gives them (a committed fixture).

``tests/test_torch_talker_1p7b.py`` holds the JAX package's f32 decode step
(its XLA layer path: the unfused tree takes no Pallas kernel, on the CPU)
and the port's plain step (``fused_layer.talker_step_plain`` on the fused
tree: what ``talker_step`` runs on a CPU tensor) to the fixture;
``chip_smoke.py`` holds kernel 3 to it on the card, in f32. Both build the
same weights here, from one seed, with numpy's legacy ``RandomState``
(whose stream does not change between numpy versions): the 1.7B talker's
widths (hidden 2048, intermediate 6144, 16 q / 8 kv heads of 128, a 3072-
token codec head) with the depth cut from 28 layers to ``LAYERS`` (2), so
that the CPU test stays small (~200 MB of f32 weights a package); uniform
weights of standard deviation 0.02 (the scale of the packages' random
init), norms of 1 +- 0.1. The inputs are a seeded ``START``-row cache
prefix and ``STEPS`` step embeddings, decoded at positions START,
START + 1, ... of a ``ROWS``-row cache; the fixture holds each step's
codec-head argmax and its top-2 logit gap. The tree has the JAX package's
layout (unfused), which ``models.weights.from_numpy_tree`` takes.

    JAX_PLATFORMS=cpu python tests/test_torch_talker_1p7b.py   # rewrites the fixture
"""

from __future__ import annotations

import json
from dataclasses import replace
from pathlib import Path

import numpy as np

from .cp_fixture import _uniform
from .models.config import TalkerConfig, config_for_variant

SEED = 2090
LAYERS = 2
ROWS = 24
START = 16
STEPS = 4
FIXTURE = Path(__file__).resolve().parent / "testdata" / "talker_1p7b_codes.json"


def config() -> TalkerConfig:
    """The 1.7B talker, cut to ``LAYERS`` layers."""
    return replace(config_for_variant("1.7B", "custom_voice").talker, num_hidden_layers=LAYERS)


def numpy_params(cfg: TalkerConfig, seed: int = SEED) -> dict:
    """The talker's decode-step f32 tree (the JAX package's layout): the
    layer stack, the final norm and the codec head."""
    rs = np.random.RandomState(seed)
    L, H, I, D = cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    qd, kvd = cfg.num_attention_heads * D, cfg.num_key_value_heads * D

    def norm(*shape):
        return 1 + _uniform(rs, shape, 0.1)

    return {
        "layers": {
            "q_proj": _uniform(rs, (L, H, qd)), "k_proj": _uniform(rs, (L, H, kvd)),
            "v_proj": _uniform(rs, (L, H, kvd)), "o_proj": _uniform(rs, (L, qd, H)),
            "q_norm": norm(L, D), "k_norm": norm(L, D), "input_ln": norm(L, H), "post_ln": norm(L, H),
            "gate_proj": _uniform(rs, (L, H, I)), "up_proj": _uniform(rs, (L, H, I)),
            "down_proj": _uniform(rs, (L, I, H)),
        },
        "norm": norm(H),
        "codec_head": _uniform(rs, (H, cfg.codec_vocab_size)),
    }


def numpy_inputs(cfg: TalkerConfig, seed: int = SEED) -> tuple[np.ndarray, np.ndarray, list]:
    """The cache (k, v: f32 [L, 1, ROWS, KV, D], rows < START seeded, the
    rest zero) and ``STEPS`` step embeddings (f32 [1, 1, H])."""
    rs = np.random.RandomState(seed + 1)
    shape = (cfg.num_hidden_layers, 1, ROWS, cfg.num_key_value_heads, cfg.head_dim)
    k, v = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    k[:, :, :START] = rs.standard_normal(k[:, :, :START].shape)
    v[:, :, :START] = rs.standard_normal(v[:, :, :START].shape)
    xs = [rs.standard_normal((1, 1, cfg.hidden_size)).astype(np.float32) for _ in range(STEPS)]
    return k, v, xs


def load() -> dict:
    """The fixture: ``codes`` [STEPS] (the codec-head argmax of each step)
    and each step's ``top2_gap`` (its logit minus the runner-up's, by the
    JAX package's decode step)."""
    return json.loads(FIXTURE.read_text())
