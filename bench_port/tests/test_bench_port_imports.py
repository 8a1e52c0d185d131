"""Nothing the benchmark runs imports JAX or the JAX package, and the reference imports nothing of the program.

Module names are compared by their whole top-level name: ``qwen3_tts_tpu_torch``
is the program, ``qwen3_tts_tpu`` the JAX package."""

import ast

import pytest

from bench_port.harness.spec import BENCH_DIR

FORBIDDEN = {"jax", "jaxlib", "flax", "qwen3_tts_tpu"}


def top_level_imports(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in BENCH_DIR.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not top_level_imports(path) & (FORBIDDEN | {"qwen3_tts_tpu_torch", "bench_port"})
    assert "qwen3_tts_tpu" not in path.read_text().replace("qwen3_tts_tpu_torch", "")


def test_only_program_module_imports_the_program():
    users = {p.relative_to(BENCH_DIR).as_posix() for p in SOURCES if "qwen3_tts_tpu_torch" in top_level_imports(p)}
    assert users <= {"harness/program.py", "tests/test_bench_port_faults.py", "tests/test_bench_port_prompts.py"}
