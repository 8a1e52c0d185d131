"""Seeded weights and codes for the full-width vocoder, and the audio the JAX
package decodes from them (a committed fixture).

``tests/test_torch_vocoder_full.py`` holds the JAX package's f32
``vocoder.decode_jit`` (its XLA path on the CPU: the residual units take no
Pallas kernel there) and the port's plain ``decode`` to the fixture;
``chip_smoke.py`` holds the card's ``decode_bucketed`` (its f32 residual
units with C <= 512 on kernel 2) to it. Both build the same weights here,
from one seed, with numpy's legacy ``RandomState`` (whose stream does not
change between numpy versions), at the default ``VocoderConfig``, the one
every published variant uses (decoder_dim 1536, rates 8/5/4/3: kernel 2 at
C = 384, 192 and 96): uniform values of standard deviation 1 / sqrt(fan-in)
for the projections and convolutions (so that the activations keep their
scale through the stack and the audio is not clipped), snake alphas and
betas, norms, layer scales and biases drawn nonzero around their init. The
tree has the JAX package's layout, which ``models.weights.from_numpy_tree``
takes.

    JAX_PLATFORMS=cpu python tests/test_torch_vocoder_full.py   # rewrites the fixture
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .cp_fixture import _uniform
from .models.codec.vocoder import VocoderConfig

SEED = 1920
FRAMES = 8
FIXTURE = Path(__file__).resolve().parent / "testdata" / "vocoder_audio.npy"


def config() -> VocoderConfig:
    return VocoderConfig()


def numpy_params(cfg: VocoderConfig, seed: int = SEED) -> dict:
    """The vocoder's f32 tree (the JAX package's layout)."""
    rs = np.random.RandomState(seed)

    def w(shape, fan_in, gain=1.0):
        return _uniform(rs, shape, gain / fan_in**0.5)

    def near(n, v, spread):
        return np.float32(v) + _uniform(rs, (n,), spread)

    def conv(cin, cout, k, gain=1.0):
        return w((k, cin, cout), k * cin, gain), near(cout, 0.0, 0.02)

    def tconv(cin, cout, k, stride):
        return w((k, cout, cin), cin * k // stride), near(cout, 0.0, 0.02)

    def convnext(dim):
        return {
            "dwconv_w": w((7, 1, dim), 7), "dwconv_b": near(dim, 0.0, 0.02),
            "norm_w": near(dim, 1.0, 0.1), "norm_b": near(dim, 0.0, 0.02),
            "pwconv1_w": w((dim, 4 * dim), dim), "pwconv1_b": near(4 * dim, 0.0, 0.02),
            "pwconv2_w": w((4 * dim, dim), 4 * dim), "pwconv2_b": near(dim, 0.0, 0.02),
            "gamma": near(dim, 0.1, 0.02),
        }

    def res_unit(dim):
        c1w, c1b = conv(dim, dim, 7, 0.5)
        c2w, c2b = conv(dim, dim, 1, 0.5)
        return {
            "act1_alpha": near(dim, 0.0, 0.1), "act1_beta": near(dim, 0.0, 0.1), "conv1_w": c1w, "conv1_b": c1b,
            "act2_alpha": near(dim, 0.0, 0.1), "act2_beta": near(dim, 0.0, 0.1), "conv2_w": c2w, "conv2_b": c2b,
        }

    hs, hd, inter, nl = cfg.hidden_size, cfg.num_heads * cfg.head_dim, cfg.intermediate_size, cfg.num_layers
    layers = {
        "input_ln": 1 + _uniform(rs, (nl, hs), 0.1),
        "q_proj": w((nl, hs, hd), hs), "k_proj": w((nl, hs, hd), hs), "v_proj": w((nl, hs, hd), hs),
        "o_proj": w((nl, hd, hs), hd),
        "attn_scale": 0.1 + _uniform(rs, (nl, hs), 0.02),
        "post_ln": 1 + _uniform(rs, (nl, hs), 0.1),
        "gate_proj": w((nl, hs, inter), hs), "up_proj": w((nl, hs, inter), hs),
        "down_proj": w((nl, inter, hs), inter),
        "mlp_scale": 0.1 + _uniform(rs, (nl, hs), 0.02),
    }
    ed, nq = cfg.codebook_embed_dim, cfg.num_quantizers
    params = {
        "first_codebook": _uniform(rs, (cfg.codebook_size, ed), 1.0),
        "rest_codebooks": _uniform(rs, (nq - 1, cfg.codebook_size, ed), 1.0),
        "first_output_proj": w((ed, cfg.codebook_dim), ed),
        "rest_output_proj": w((ed, cfg.codebook_dim), ed * (nq - 1)),
    }
    params["pre_conv_w"], params["pre_conv_b"] = conv(cfg.codebook_dim, cfg.latent_dim, 3)
    params["input_proj_w"], params["input_proj_b"] = w((cfg.latent_dim, hs), cfg.latent_dim), near(hs, 0.0, 0.02)
    params["layers"] = layers
    params["final_norm"] = near(hs, 1.0, 0.1)
    params["output_proj_w"] = w((hs, cfg.latent_dim), hs)
    params["output_proj_b"] = near(cfg.latent_dim, 0.0, 0.02)
    params["upsample"] = []
    for r in cfg.upsampling_ratios:
        uw, ub = tconv(cfg.latent_dim, cfg.latent_dim, 2 * r, r)
        params["upsample"].append({"up_w": uw, "up_b": ub, "convnext": convnext(cfg.latent_dim)})
    params["init_conv_w"], params["init_conv_b"] = conv(cfg.latent_dim, cfg.decoder_dim, 7)
    params["decoder_blocks"] = []
    ch = cfg.decoder_dim
    for r in cfg.upsample_rates:
        out = ch // 2
        uw, ub = tconv(ch, out, 2 * r, r)
        params["decoder_blocks"].append({
            "snake_alpha": near(ch, 0.0, 0.1), "snake_beta": near(ch, 0.0, 0.1), "up_w": uw, "up_b": ub,
            "res1": res_unit(out), "res2": res_unit(out), "res3": res_unit(out),
        })
        ch = out
    params["final_snake_alpha"] = near(ch, 0.0, 0.1)
    params["final_snake_beta"] = near(ch, 0.0, 0.1)
    params["final_conv_w"], params["final_conv_b"] = conv(ch, 1, cfg.final_kernel, 0.05)
    return params


def numpy_codes(cfg: VocoderConfig, seed: int = SEED, frames: int = FRAMES) -> np.ndarray:
    """Codec frames [1, num_quantizers, frames] int32."""
    rs = np.random.RandomState(seed + 1)
    return rs.randint(0, cfg.codebook_size, size=(1, cfg.num_quantizers, frames)).astype(np.int32)


def load() -> np.ndarray:
    """The fixture: the JAX package's audio [1, FRAMES * 1920] f32."""
    return np.load(FIXTURE)
