"""BENCHMARK.json keeps to the form the benchmark's driver reads, and every name it uses has its files."""

import json
import re

from bench_port.harness.spec import BENCH_DIR

from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"]
    assert BENCH["paths"] == ["bench_port"] and BENCH["command"] == ["python3", "bench_port/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_configs_and_cells():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and line(c["why"])
        assert NAME.match(c["name"]) and line(c["source"]) and (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"] == []
    names = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and line(w["why"])
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in configs
        assert w["chips"] == 1 and w["name"] not in names
        names.add(w["name"])
        assert (BENCH_DIR / "traffic" / f"{w['traffic']}.json").is_file()
        limits = json.loads((BENCH_DIR / "limits" / f"{w['name']}.json").read_text())
        assert "audio_err" in limits and {"talker_gap_mean", "code_gap_mean"} & set(limits)
        assert all(v["lower"] < v["limit"] < v["upper"] and v["upper"] >= 3 * v["lower"] for v in limits.values())
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(BENCH["workloads"])
    assert {w["config"] for w in BENCH["workloads"]} == set(configs)


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and line(m["layer"])
        for cell in m.get("workloads", cells):
            assert cell in e2e[m["moves"]].get("workloads", cells)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", cells)) <= set(cells)
    for cell in cells:
        mine = [m["name"] for m in BENCH["end_to_end"] if cell in m.get("workloads", cells)]
        assert "setup_s" in mine and len(mine) >= 2
        assert any(cell in m.get("workloads", cells) for m in BENCH["per_layer"])
