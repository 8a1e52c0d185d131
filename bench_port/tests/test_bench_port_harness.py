"""The harness end to end on the CPU at a tiny size, through the program's plain paths, in each prompt layout."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from bench_port.harness import cell, spec

from conftest import ROOT

LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run_tiny(root, name: str, trace: bool, seconds: float = 2.0, seed: int = 2**31 + 7):
    torch.set_num_threads(2)
    return cell.run(spec.load(name, root), seed, seconds, trace, "cpu", time.perf_counter())


CELLS = ["tiny-utterances-cell", "tiny-stream-cell", "tiny-icl-stream-cell", "tiny-icl-seq-utterances-cell",
         "tiny-xvector-utterances-cell", "tiny-design-stream-cell"]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_end_to_end(tiny_checkout, name, trace):
    root, originals = tiny_checkout
    line, notes = run_tiny(root, name, trace)
    assert list(line)[:5] == LINE_KEYS and list(line)[-1] == "compared"
    json.dumps(line)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 2
    s = spec.load(name, root)
    wanted = s.per_layer if trace else s.end_to_end
    assert set(line["metrics"]) <= {m["name"] for m in wanted}
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    if trace:
        # The metric the fixture added as a new file is read, and the
        # traced keys are there (the CPU's device record is empty).
        assert line["metrics"]["frames_per_s"]["value"] > 0
        assert {"busy_s", "window_s"} <= set(line["device"]) and "breakdown" in line
    else:
        assert {"audio_s_per_s", "setup_s"} <= set(line["metrics"])
        tail = "ttfa_p90_ms" if "stream" in name else "rtf_p90"
        assert tail in line["metrics"]
    # The float32 program and the float32 reference agree to rounding.
    for key, (value, limit) in line["compared"].items():
        assert value is not None and value <= limit, key
    compared = line["compared"]
    assert notes[-len(compared):] == [f"{k} {v} limit {lim}" for k, (v, lim) in compared.items()]
    # Adding the cell edited no file that was there.
    for path, data in originals.items():
        assert path.read_bytes() == data, path


def test_run_refuses_without_a_card():
    assert not torch.cuda.is_available()
    out = subprocess.run([sys.executable, "bench_port/run.py", "--workload", "cv1p7b-bf16-utterances", "--seed",
                          str(2**31 + 3), "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_run_refuses_in_a_bare_checkout(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files holds
    no program: no result, and another exit code than 0."""
    shutil.copytree(ROOT / "bench_port", tmp_path / "bench_port", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "bench_port/run.py", "--workload", "cv1p7b-bf16-utterances", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "qwen3_tts_tpu_torch_like", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert cell.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "qwen3_tts_tpu.models", object())
    monkeypatch.setitem(sys.modules, "jax", object())
    assert cell.forbidden_modules() == ["jax", "qwen3_tts_tpu.models"]


def test_encoder_control_reads_a_clone_cell(tiny_checkout):
    """``control.tf32_encoder_readings`` reads a clone cell's cases; on the
    CPU, which has no TF32, the control is the float32 reference itself."""
    from bench_port import control

    root, _ = tiny_checkout
    torch.set_num_threads(2)
    s = spec.load("tiny-icl-stream-cell", root)
    _, cases, _ = cell.measure(s, 2**31 + 17, 1.0, False, "cpu", time.perf_counter())
    got = control.tf32_encoder_readings(s.dims, 2**31 + 17, torch.device("cpu"), cases)
    assert set(got) == {"xvector_err", "speech_code_gap_mean", "speech_code_gap_max", "speech_code_gap_miss"}
    assert got["xvector_err"] < 1e-5 and got["speech_code_gap_max"] == 0.0
    assert control.tf32_encoder_readings(s.dims, 2**31 + 17, torch.device("cpu"), []) == {}
