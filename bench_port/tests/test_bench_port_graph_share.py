"""``prefill_graph_share`` and ``.stream``: the share of the window's ``q3.prefill`` spans whose counter ``graph`` is 1,
on synthetic spans (``test_bench_port_spans.py``'s trace); None where no prefill carries the counter, as a program
without the prefill graph records them."""

import pytest

from bench_port.harness import cell

from test_bench_port_spans import run_of, span, trace

NAMES = ("prefill_graph_share", "prefill_graph_share.stream")


def prefills(*graphs):
    """One session a prefill in a 100 ns window, the prefill's ``graph`` as given (None: no counter)."""
    out = []
    for i, g in enumerate(graphs):
        open_ = span("q3.open", 10 * i, 10 * i + 9)
        counters = {} if g is None else {"graph": g}
        out += [span("q3.prefill", 10 * i + 1, 10 * i + 8, open_, **counters), open_]
    return out


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("graphs,share", [((1, 1, 1), 100.0), ((1, 0, 1, 0), 50.0), ((0, 0), 0.0)])
def test_share_of_replayed_prefills(name, graphs, share, monkeypatch):
    assert cell.read_metric(name, run_of(trace(), prefills(*graphs), monkeypatch)) == pytest.approx(share)


@pytest.mark.parametrize("name", NAMES)
def test_none_without_the_counter(name, monkeypatch):
    assert cell.read_metric(name, run_of(trace(), prefills(None, None), monkeypatch)) is None
    assert cell.read_metric(name, run_of(trace(), [span("q3.loop", 2, 8)], monkeypatch)) is None
    assert cell.read_metric(name, run_of(trace(), [], monkeypatch)) is None
    assert cell.read_metric(name, run_of(None, prefills(1), monkeypatch)) is None
