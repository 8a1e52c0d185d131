"""Fixtures of the benchmark's tests: a checkout with a tiny cell of its own.

``tiny_checkout`` copies ``BENCHMARK.json`` and ``bench_port/`` into a
temporary directory and adds a cell the way a later change would: new files
(configurations, traffic mixes, a metric, the cells' limits) and new entries
in ``BENCHMARK.json``, no existing file edited: a tiny CustomVoice model under
a preset-speaker utterance and stream mix, and a tiny Base model (with its
speaker and speech encoders) under an in-context clone stream, a sequential
in-context clone's utterances, x-vector clone utterances and a voice
description stream. The tiny models run on the CPU through the program's
plain paths in float32, where the reference agrees with them to rounding.
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

TINY_CONFIG = {
    "name": "tiny", "dtype": "float32", "tts_model_size": "tiny",
    "talker_config": {
        "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2, "num_attention_heads": 4,
        "num_key_value_heads": 2, "head_dim": 16, "rms_norm_eps": 1e-6, "rope_theta": 1000000,
        "rope_scaling": {"mrope_section": [4, 2, 2]}, "max_position_embeddings": 32768, "vocab_size": 3072,
        "text_vocab_size": 151936, "text_hidden_size": 32,
        "code_predictor_config": {
            "hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
            "num_key_value_heads": 2, "head_dim": 8, "rms_norm_eps": 1e-6, "rope_theta": 1000000,
            "vocab_size": 2048, "num_code_groups": 16}},
    "vocoder": {
        "codebook_dim": 16, "latent_dim": 32, "hidden_size": 16, "num_layers": 1, "num_heads": 2, "head_dim": 8,
        "intermediate_size": 32, "num_quantizers": 16, "codebook_size": 2048, "codebook_embed_dim": 8,
        "upsampling_ratios": [2, 2], "decoder_dim": 48, "upsample_rates": [8, 5, 4, 3], "rms_norm_eps": 1e-5,
        "rope_theta": 10000.0, "final_kernel": 7},
}
TINY_MIXES = {
    "tiny-utterances": {"entry": "utterance", "frames": [6, 14], "text_tokens": [3, 8], "strata": 4,
                        "greedy_every": 2, "warmup": [[6, 3]], "check_requests": 2, "temperature": 0.9},
    "tiny-stream": {"entry": "stream", "frames": [6, 14], "text_tokens": [3, 8], "strata": 4, "greedy_every": 2,
                    "streaming_lookahead": 1, "chunk_frames": 10, "first_chunk_frames": 4, "warmup": [[14, 8]],
                    "check_requests": 2, "temperature": 0.9},
}
# A tiny Base model: the same talker, code predictor and vocoder, and the two
# audio encoders at tiny widths.
TINY_BASE_CONFIG = dict(
    TINY_CONFIG, name="tiny-base", tts_model_type="base",
    speaker_encoder_config={
        "mel_dim": 32, "enc_dim": 64, "enc_channels": [32, 32, 32, 32, 96], "enc_kernel_sizes": [5, 3, 3, 3, 1],
        "enc_dilations": [1, 2, 3, 4, 1], "enc_attention_channels": 16, "enc_res2net_scale": 4,
        "enc_se_channels": 8, "sample_rate": 24000},
    encoder_config={
        "sampling_rate": 24000, "frame_rate": 12.5, "num_filters": 8, "upsampling_ratios": [8, 6, 5, 4],
        "kernel_size": 7, "last_kernel_size": 3, "residual_kernel_size": 3, "compress": 2, "hidden_size": 32,
        "num_hidden_layers": 2, "num_attention_heads": 2, "head_dim": 16, "intermediate_size": 64, "norm_eps": 1e-5,
        "rope_theta": 10000.0, "sliding_window": 250, "layer_scale_initial_scale": 0.01, "codebook_size": 64,
        "codebook_dim": 16, "num_quantizers": 16, "num_semantic_quantizers": 1})
CLONE = {"voices": 2, "ref_seconds": [0.5, 1.0], "ref_text_tokens": [2, 5]}
STREAM = {"streaming_lookahead": 1, "chunk_frames": 10, "first_chunk_frames": 4}
TINY_BASE_MIXES = {
    "tiny-icl-stream": {"entry": "stream", "prompt": "icl", "clone_prompt": "per_request", **CLONE, **STREAM,
                        "frames": [6, 14], "text_tokens": [3, 8], "strata": 4, "greedy_every": 2,
                        "warmup": [[14, 8]], "check_requests": 2, "temperature": 0.9},
    "tiny-icl-seq-utterances": {"entry": "utterance", "prompt": "icl", "clone_prompt": "per_voice",
                                "icl_sequential": True, **CLONE, "frames": [6, 14], "text_tokens": [3, 8],
                                "strata": 4, "greedy_every": 2, "warmup": [[6, 3]], "check_requests": 2,
                                "temperature": 0.9},
    "tiny-xvector-utterances": {"entry": "utterance", "prompt": "xvector", "clone_prompt": "per_voice", **CLONE,
                                "frames": [6, 14], "text_tokens": [3, 8], "strata": 4, "greedy_every": 2,
                                "warmup": [[6, 3]], "check_requests": 2, "temperature": 0.9},
    "tiny-design-stream": {"entry": "stream", "prompt": "design", "instruct_tokens": [4, 12], **STREAM,
                           "frames": [6, 14], "text_tokens": [3, 8], "strata": 4, "greedy_every": 2,
                           "warmup": [[14, 8]], "check_requests": 2, "temperature": 0.9},
}
# The float32 program agrees with the float32 reference to rounding.
TINY_LIMITS = {"talker_gap_mean": {"limit": 1e-3}, "cp_gap_mean": {"limit": 1e-3}, "audio_err": {"limit": 1e-4}}
# A clone's prompt too: the x-vector to rounding; in context, the speech codes the nearest.
TINY_XVECTOR_LIMITS = dict(TINY_LIMITS, xvector_err={"limit": 1e-4})
TINY_ICL_LIMITS = dict(TINY_XVECTOR_LIMITS, speech_code_gap_mean={"limit": 1e-3})
LIMITS = {"preset": TINY_LIMITS, "design": TINY_LIMITS, "xvector": TINY_XVECTOR_LIMITS, "icl": TINY_ICL_LIMITS}
DUMMY_METRIC = '''"""Frames made in the window, a second (a metric a later change adds as one new file)."""


def read(run):
    return run.frames / run.window_s
'''


@pytest.fixture
def tiny_checkout(tmp_path):
    """(the checkout, {its copied file: the original's bytes})."""
    shutil.copytree(ROOT / "bench_port", tmp_path / "bench_port", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    originals = {p: p.read_bytes() for p in tmp_path.rglob("*") if p.is_file() and p.name != "BENCHMARK.json"}
    bp = tmp_path / "bench_port"
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    cells = []
    for config, mixes in ((TINY_CONFIG, TINY_MIXES), (TINY_BASE_CONFIG, TINY_BASE_MIXES)):
        (bp / "configs" / f"{config['name']}.json").write_text(json.dumps(config))
        bench["configs"].append({"name": config["name"], "source": "a test's own",
                                 "file": f"bench_port/configs/{config['name']}.json", "reduced": [],
                                 "why": "a test's tiny model"})
        for name, mix in mixes.items():
            (bp / "traffic" / f"{name}.json").write_text(json.dumps(mix))
            (bp / "limits" / f"{name}-cell.json").write_text(json.dumps(LIMITS[mix.get("prompt", "preset")]))
            bench["workloads"].append({"name": f"{name}-cell", "config": config["name"], "traffic": name, "chips": 1,
                                       "why": "a test's tiny cell"})
            cells.append(f"{name}-cell")
    (bp / "metrics" / "frames_per_s.py").write_text(DUMMY_METRIC)
    bench["per_layer"].append({"name": "frames_per_s", "unit": "frames/s", "better": "higher",
                               "source": "host_clock", "layer": "frame loop", "moves": "audio_s_per_s"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += cells
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path, originals
