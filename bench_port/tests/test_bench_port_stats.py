"""The arithmetic of the end-to-end metrics on hand-made samples."""

import importlib.util
from types import SimpleNamespace

import pytest

from bench_port.harness import stats
from bench_port.harness.spec import BENCH_DIR


def reader(name):
    mod_spec = importlib.util.spec_from_file_location(name, BENCH_DIR / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read


@pytest.mark.parametrize("values, q, want", [
    ([5.0], 90, 5.0),
    (list(range(1, 11)), 90, 9.1),  # rank 8.1 between 9 and 10
    (list(range(1, 11)), 50, 5.5),
    ([3.0, 1.0, 2.0], 100, 3.0),
    ([3.0, 1.0, 2.0], 0, 1.0),
    ([10.0, 20.0], 90, 19.0),
])
def test_percentile(values, q, want):
    assert stats.percentile(values, q) == pytest.approx(want)


def test_percentile_and_rate_refuse_nothing():
    with pytest.raises(ValueError):
        stats.percentile([], 90)
    with pytest.raises(ValueError):
        stats.rate(1.0, 0.0)


def served(frames, wall_s, first_s=None):
    return SimpleNamespace(frames=frames, samples=frames * 1920, wall_s=wall_s, first_s=first_s, error=None)


def test_end_to_end_readers():
    # Ten requests of 25 frames (2 s of audio) at 0.1 .. 1.0 s of wall; the
    # window lasts their sum.
    reqs = [served(25, 0.1 * (i + 1), first_s=0.01 * (i + 1)) for i in range(10)]
    run = SimpleNamespace(served=reqs, audio_s=20.0, window_s=5.5, setup_s=12.5)
    assert reader("audio_s_per_s")(run) == pytest.approx(20.0 / 5.5)
    assert reader("rtf_p90")(run) == pytest.approx(0.91 / 2.0)  # p90 of wall / 2 s
    assert reader("ttfa_p90_ms")(run) == pytest.approx(91.0)
    assert reader("setup_s")(run) == 12.5
    none = SimpleNamespace(served=[], audio_s=0.0, window_s=1.0)
    assert reader("audio_s_per_s")(none) is None and reader("rtf_p90")(none) is None
