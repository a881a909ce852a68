"""The per-layer ``decode_graph_share``: replayed decode steps over all
decode steps of every batch of the window, on batches as the harness records
them (its keys beside ``Engine.last_stats``)."""
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]


def _run(batches, device="cuda"):
    return SimpleNamespace(batches=batches, device=device)


def _batch(out, graph_steps=None, in_span=False):
    b = {"n": 4, "out": out, "in_span": in_span, "decode_ms_per_step": 1.0}
    if graph_steps is not None:
        b["graph_steps"] = graph_steps
    return b


@pytest.mark.parametrize("batches,want", [
    ([_batch(8, 8), _batch(24, 24, in_span=True), _batch(1, 1)], 100.0),
    ([_batch(8, 0), _batch(24, 0)], 0.0),
    ([_batch(10, 10), _batch(30, 0, in_span=True)], 25.0),
])
def test_share_of_replayed_steps_over_every_batch(batches, want):
    read = harness.reader(ROOT, "metrics", "decode_graph_share")
    assert read(_run(batches)) == pytest.approx(want, rel=1e-12)


def test_nothing_on_a_cpu_rehearsal_or_without_the_counter():
    read = harness.reader(ROOT, "metrics", "decode_graph_share")
    assert read(_run([_batch(8, 8)], device="cpu")) is None
    assert read(_run([_batch(8, 8), _batch(8)])) is None       # a program without graphs
    assert read(_run([])) is None
    assert read(_run([_batch(0, 0)])) is None


def test_declared_for_the_three_cells():
    cell = harness.load_cell(ROOT, "phi4-mini.gen")
    (m,) = [m for m in cell.per_layer if m["name"] == "decode_graph_share"]
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"]) == (
        "%", "higher", "program_counter", "engine", "items_per_s")
    assert m["workloads"] == ["phi4-mini.gen", "phi4-mini.score", "mixtral-8x7b-4l.gen"]
