"""Fixtures of the benchmark's tests: a checkout with a tiny cell of its own.

``tiny_checkout`` copies ``BENCHMARK.json`` and ``bench_port/`` into a
temporary directory and adds a cell the way a later change would: new files
(a configuration, a traffic mix, a metric, the cell's limits) and new entries
in ``BENCHMARK.json``, no existing file edited. The tiny model runs on the
CPU through the program's plain paths in float32, where the reference agrees
with it to rounding.
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
# The float32 program agrees with the float32 reference to rounding.
TINY_LIMITS = {"talker_gap_mean": {"limit": 1e-3}, "cp_gap_mean": {"limit": 1e-3}, "audio_err": {"limit": 1e-4}}
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
    (bp / "configs" / "tiny.json").write_text(json.dumps(TINY_CONFIG))
    for name, mix in TINY_MIXES.items():
        (bp / "traffic" / f"{name}.json").write_text(json.dumps(mix))
        (bp / "limits" / f"{name}-cell.json").write_text(json.dumps(TINY_LIMITS))
    (bp / "metrics" / "frames_per_s.py").write_text(DUMMY_METRIC)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "a test's own", "file": "bench_port/configs/tiny.json",
                             "reduced": [], "why": "a test's tiny model"})
    for name in TINY_MIXES:
        bench["workloads"].append({"name": f"{name}-cell", "config": "tiny", "traffic": name, "chips": 1,
                                   "why": "a test's tiny cell"})
    bench["per_layer"].append({"name": "frames_per_s", "unit": "frames/s", "better": "higher",
                               "source": "host_clock", "layer": "frame loop", "moves": "audio_s_per_s"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [f"{name}-cell" for name in TINY_MIXES]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path, originals
