"""The checkpoint-landing validation chain of the PyTorch/CUDA port.

The counterpart of the JAX package's validation scripts (``scripts/``,
driven by ``make parity``, ``parity-matrix``, ``parity-drill`` and
``audit``), on the port and on the card:

* ``quality``: the audio quality gate of a WAV (``check_wav``);
* ``trace_report``: per-kernel device time from a ``--profile`` trace;
* ``audit``: the frame loops' host reads, listed in the source and counted
  in a run (``loop_read_bound``: the loop contract's most reads a call);
* ``quant_report``: int8 and w8a8 weight SNR, logit drift and the promote
  decision;
* ``parity_matrix``: {solo, mesh} x {bf16, int8, w8a8} through
  ``from_pretrained``;
* ``variants``: the variant x seed synthesis matrix with an HTML report.

``python -m qwen3_tts_tpu_torch.validation <command>`` runs one of them, or
the chains ``parity`` and ``drill``; every command runs on the CUDA card
unless given ``--device cpu``. Nothing here imports JAX.
"""

from __future__ import annotations

import subprocess

import torch


def card_name(device: torch.device) -> str:
    """The device's name and power limit as ``nvidia-smi`` gives them (``NVIDIA
    H100 80GB HBM3, 700.00 W``), or ``cpu``."""
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else torch.cuda.current_device()
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", str(index)],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0].strip()


def tiny_config():
    """The CI-sized CustomVoice config of the JAX side's scripts (talker and
    code predictor at hidden 64, 2 layers, 4 / 2 heads): the quant report's
    ``--variant tiny``, the audit's model and the drill's checkpoint."""
    from dataclasses import replace

    from ..models.config import CodePredictorConfig, TalkerConfig, config_for_variant

    return replace(
        config_for_variant("0.6B", "custom_voice"),
        talker=TalkerConfig(text_embed_dim=32, hidden_size=64, text_proj_intermediate=32, intermediate_size=128,
                            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2, head_dim=16),
        code_predictor=CodePredictorConfig(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                                           num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                                           vocab_size=128),
    )


def tiny_vocoder():
    """The tests' tiny vocoder config (the default one's structure at width 16-32)."""
    from ..models.codec.vocoder import VocoderConfig

    return VocoderConfig(codebook_dim=16, latent_dim=24, hidden_size=16, num_layers=2, num_heads=2, head_dim=8,
                         intermediate_size=32, codebook_size=2048, codebook_embed_dim=8, decoder_dim=32)


def launch_counts() -> dict:
    """Every kernel wrapper's launch count, by the wrapper's name (calls on
    the CPU, which run the plain versions, are not counted)."""
    from ..models.codec import fused_blocks
    from ..ops import fused_layer, quant

    wrappers = (fused_layer.cp_frame, fused_layer.talker_step, quant.int8_matmul, fused_blocks.residual_unit,
                fused_blocks.residual_unit_stream, fused_layer.fused_attention_step, fused_layer.fused_mlp_step,
                fused_layer.streamed_decode_step)
    return {w.__name__: w.launches for w in wrappers} | {"w8a8_matmul": quant.w8a8_matmul.calls}


def launches_since(before: dict) -> dict:
    """The kernels launched since ``before`` (``launch_counts()``): each one's
    count, those launched only."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return {k: n - before[k] for k, n in launch_counts().items() if n != before[k]}
