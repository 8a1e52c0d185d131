"""The port's audit, trace report, variant matrix and drill (CPU).

* audit (``validation/audit.py``): the static audit lists exactly the read
  sites the loop contract allows (``audit.ALLOWED``, one entry each) and
  flags a read planted outside it; the dynamic audit's reads of a tiny
  model's loop call, in f32 and int8, stay within ``loop_read_bound``, and
  a read planted in every frame breaks it; ``main`` exits 0;
* trace report (``validation/trace_report.py``): a CPU ``--profile`` run of
  the CLI aggregates by op; a Chrome trace of CUDA kernel events groups the
  port's kernels 1-7 by their ``csrc/`` names, sums by stream and gives ms
  a frame;
* variants (``validation/variants.py``): writes its WAVs and its HTML, and
  the frames of custom_voice at seed 42 equal the JAX side's
  ``scripts/test_variants.py`` on the same tiny model (both scripts' model
  builders pointed at ``tests/test_pipeline.tiny_model()``'s trees);
* no module of ``validation/`` imports ``jax``, ``qwen3_tts_tpu`` or
  ``scripts`` (a fresh interpreter with the three blocked).
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import qwen3_tts_tpu.models.config as jconfig
from qwen3_tts_tpu.pipeline import Qwen3TTS as JQwen3TTS
from qwen3_tts_tpu_torch import cli
from qwen3_tts_tpu_torch.ops import sampling
from qwen3_tts_tpu_torch.pipeline import Qwen3TTS
from qwen3_tts_tpu_torch.validation import __main__ as chain
from qwen3_tts_tpu_torch.validation import audit, trace_report, variants
from scripts import test_variants as jvariants
from test_torch_pipeline import models  # noqa: F401  (the JAX tiny model and the port's, f32)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


def test_static_audit_lists_the_contracts_read_sites(capsys):
    sites = audit.read_sites()
    assert {(s["module"], s["function"]) for s in sites} == set(audit.ALLOWED)
    assert audit.static_audit() == []
    assert "0 outside the contract" in capsys.readouterr().out


def test_static_audit_flags_a_read_outside_the_contract(tmp_path, monkeypatch):
    (tmp_path / "ops").mkdir()
    (tmp_path / "ops" / "loop.py").write_text("def step(x):\n    return int(x.sum()) + x.item()  # both\n")
    monkeypatch.setattr(audit, "PACKAGE", tmp_path)
    sites = audit.read_sites(["ops/loop.py"])
    assert [(s["line"], s["function"], s["label"]) for s in sites] == [
        (2, "step", "value read .item()"), (2, "step", "scalar read of a reduction")]


def test_dynamic_audit_within_the_bound():
    reads = audit.dynamic_audit(CPU, frames=8)
    assert set(reads) == {"f32", "int8"}
    assert all(0 < n <= audit.loop_read_bound(8) for n in reads.values())


def test_dynamic_audit_catches_a_read_a_frame(monkeypatch):
    sample = sampling.sample

    def reading(logits, cfg, uniform):
        token = sample(logits, cfg, uniform)
        token.sum().item()
        return token

    monkeypatch.setattr(sampling, "sample", reading)
    with pytest.raises(AssertionError, match="host reads"):
        audit.dynamic_audit(CPU, frames=8)


def test_audit_main():
    assert audit.main(["--device", "cpu"]) == 0


@pytest.fixture(scope="module")
def drill_ckpt(tmp_path_factory):
    return chain.drill_checkpoint(tmp_path_factory.mktemp("drill") / "ckpt")


def test_trace_report_of_a_cpu_profile(drill_ckpt, tmp_path, capsys):
    trace = tmp_path / "trace"
    assert cli.main(["-m", str(drill_ckpt), "-t", "trace me", "-f", "4", "--min-new-tokens", "4", "--device", "cpu",
                     "--output", str(tmp_path / "a.wav"), "--profile", str(trace)]) == 0
    planes = trace_report.summarize(trace, "cpu_op", top=10)
    assert len(planes) == 1 and planes[0]["total_ms"] > 0
    assert any(row["name"] == "aten::mm" for row in planes[0]["top"])
    capsys.readouterr()
    assert trace_report.main([str(trace), "--plane-filter", "cpu_op", "--frames", "4", "--top", "5"]) == 0
    out = capsys.readouterr().out
    assert "=== cpu_op  (trace.json) ===" in out and "ms/frame" in out and "top 5 ops:" in out


KERNELS = {
    "void q3::cp_frame_kernel<__nv_bfloat16, __nv_bfloat16>(FrameArgs, FrameMaps, ...)": "kernel 1: cp_frame",
    "q3::residual_unit_tc(q3::RuArgs)": "kernel 2: residual_unit",
    "void q3::talker_step_kernel<__nv_bfloat16, signed char, false>(q3::StepArgs, q3::StepMaps)":
        "kernel 3: talker_step",
    "void q3::int8_mm_tc<float, 1, 1, 64, 4, false>(float const*, ...)": "kernel 4: int8_matmul",
    "q3::attention_step_kernel(q3::FsArgs, q3::FsMaps)": "kernel 5: attention_step",
    "q3::mlp_step_kernel(q3::FsArgs, q3::FsMaps)": "kernel 6: mlp_step",
    "void q3::talker_step_kernel<float, signed char, true>(q3::StepArgs, q3::StepMaps)": "kernel 7: cp_step",
    "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize64x64x64": "gemm",
    "void at::native::vectorized_elementwise_kernel<4, ...>": "elementwise",
}


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_classify_names_the_ports_kernels(name):
    assert trace_report.classify(name) == KERNELS[name]


def test_trace_report_of_kernel_events(tmp_path, capsys):
    events = [{"ph": "X", "cat": "kernel", "name": name, "dur": 1000.0 * (i + 1), "ts": i, "tid": 7,
               "args": {"stream": 7 if i % 2 else 13}} for i, name in enumerate(sorted(KERNELS))]
    events += [{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 5.0, "tid": 1, "args": {}},
               {"ph": "i", "cat": "kernel", "name": "marker"}]
    (tmp_path / "trace.json").write_text(json.dumps({"traceEvents": events * 2}))
    (plane,) = trace_report.summarize(tmp_path)
    assert plane["plane"] == "kernel" and plane["total_ms"] == 2 * sum(range(1, len(KERNELS) + 1))
    assert plane["groups"] == {KERNELS[name]: 2.0 * (i + 1) for i, name in enumerate(sorted(KERNELS))}
    assert [row["count"] for row in plane["top"]] == [2] * len(KERNELS)
    (streamed,) = trace_report.summarize(tmp_path, line_filter="stream 13")
    assert len(streamed["top"]) == (len(KERNELS) + 1) // 2
    assert trace_report.main([str(tmp_path), "--frames", "2"]) == 0
    out = capsys.readouterr().out
    assert "[kernel 1: cp_frame]" in out and "ms/frame" in out and "x2" in out


def test_variants_match_jax(models, tmp_path, monkeypatch, capsys):  # noqa: F811
    jm, tm = models
    monkeypatch.setattr(variants, "VARIANTS", [("0.6B", "custom_voice")])
    monkeypatch.setattr(jvariants, "VARIANTS", [("0.6B", "custom_voice")])
    monkeypatch.setattr(jconfig, "config_for_variant", lambda size, variant: jm.config)
    monkeypatch.setattr(JQwen3TTS, "from_random", classmethod(lambda cls, cfg: jm))
    monkeypatch.setattr(Qwen3TTS, "from_random", classmethod(lambda cls, cfg, device: tm))
    monkeypatch.syspath_prepend(str(REPO / "scripts"))  # the script imports quality_check by name
    sessions = {}

    def keeping(cls, key):
        make = cls._custom_voice_session

        def session(self, *a, **k):
            sessions[key] = make(self, *a, **k)
            return sessions[key]

        monkeypatch.setattr(cls, "_custom_voice_session", session)

    keeping(JQwen3TTS, "jax")
    keeping(Qwen3TTS, "port")
    monkeypatch.setattr(sys, "argv", ["test_variants.py", "--out-dir", str(tmp_path / "jax"), "--seeds", "42",
                                      "--frames", "6"])
    jvariants.main()
    assert variants.main(["--out-dir", str(tmp_path / "port"), "--seeds", "42", "--frames", "6",
                          "--device", "cpu"]) == 0
    j, t = sessions["jax"], sessions["port"]
    want = np.asarray(j.state.frames)[: j.frames_generated]
    got = t.state.frames[: t.frames_generated].numpy()
    assert got.shape == want.shape == (6, 16)
    np.testing.assert_array_equal(got, want)
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == ["0.6B_CustomVoice_seed42.wav", "report.html"]
    html = (tmp_path / "port" / "report.html").read_text()
    assert "0.6B CustomVoice" in html and "n/a (synthetic)" in html and "device: cpu" in html
    assert "RTF" in capsys.readouterr().out


def test_validation_imports_no_jax():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'qwen3_tts_tpu', 'scripts'):\n"
        "    sys.modules[name] = None\n"
        "import importlib, pkgutil\n"
        "import qwen3_tts_tpu_torch.validation as v\n"
        "names = [m.name for m in pkgutil.iter_modules(v.__path__)]\n"
        "for name in names:\n"
        "    importlib.import_module(f'{v.__name__}.{name}')\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'qwen3_tts_tpu', 'scripts')\n"
        "            and sys.modules[m] is not None]\n"
        "print(sorted(names))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == str(["__main__", "audit", "parity_matrix", "quality", "quant_report", "trace_report",
                                    "variants"])
