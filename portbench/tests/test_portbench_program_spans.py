"""The per-layer metrics that read the program's own stats
(``decode_step_p95_ms``, ``decode_host_ms_per_step``,
``prefill_host_ms_per_batch``, ``host_syncs_per_batch``) over a traced run of
the harness on the CPU at smoke size. A CPU rehearsal's line leaves them out:
their times would be the CPU's. So each test also reads them from the run's
own batches as the card's line would, and the sync count against the count
worked out from the deck."""
from types import SimpleNamespace

import pytest

from portbench import harness, traffic
from portbench.reference import ladder
from portbench.tests import smoke

SEED = 2**31 + 29
NEW = {"decode_step_p95_ms", "decode_host_ms_per_step", "prefill_host_ms_per_batch",
       "host_syncs_per_batch"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return smoke.make_root(tmp_path_factory.mktemp("bench"))


def _traced(root, cell, monkeypatch):
    """A traced CPU run's line and the run the readers were handed."""
    seen = []
    real = harness.reader

    def spy(root_, kind, name):
        read = real(root_, kind, name)
        return lambda run: (seen.append(run), read(run))[1]

    monkeypatch.setattr(harness, "reader", spy)
    # seconds=0: the window is one pass over the deck
    line = harness.run(root, cell, SEED, 0, True, device="cpu")
    return line, seen[-1]


def _moe_layers(sizes: dict) -> int:
    moe = sizes.get("moe")
    if not moe:
        return 0
    return len(range(moe["first_moe_layer"], sizes["num_layers"], moe["moe_every"]))


def _deck_syncs(cell) -> float:
    """Host syncs a batch over one pass of the deck, from the gateway's plan:
    the upload, the tokens' copy back and the finite flag, and one dispatch at
    each MoE layer of the prefill and of each decode step."""
    from repro_torch.core.resource_manager import Event
    from repro_torch.launch.serve import build_gateway
    sizes = harness.model_sizes(cell.config)
    gn = build_gateway(harness.port_config(cell.config), policy=cell.mix["policy"])
    deck = traffic.deck(cell.mix, gn.table.perf[0].sum(), gn.table.perf[-1].sum())
    per_batch = []
    for rid, r in enumerate(deck):
        gn.handle(Event(kind="workload", request=harness._request(rid, r)))
        for a in gn.dispatches[-1].assignments:
            moe = _moe_layers(ladder.level_sizes(sizes, a.apx_level))
            per_batch += [3 + moe * (1 + r.out_len)
                          for _ in traffic.batches(a.items, cell.mix["max_batch"])]
    return sum(per_batch) / len(per_batch)


@pytest.mark.parametrize("cell", ["smoke-phi4.tiny", "smoke-mixtral.tiny"])
def test_program_metrics_read_the_engines_stats(root, cell, monkeypatch):
    line, run = _traced(root, cell, monkeypatch)
    assert line["correct"] is True
    assert not NEW & set(line["metrics"])
    on_card = SimpleNamespace(**dict(vars(run), device="cuda"))
    got = {m: harness.reader(root, "metrics", m)(on_card) for m in sorted(NEW)}
    assert all(isinstance(v, float) and v >= 0 for v in got.values()), got
    want = _deck_syncs(harness.load_cell(root, cell))
    assert got["host_syncs_per_batch"] == pytest.approx(want, rel=1e-12)
    if cell == "smoke-phi4.tiny":
        assert want == 3.0
    else:
        assert want > 3.0
    steps = [ms for b in run.batches for ms in b["step_ms"]]
    assert len(steps) == sum(b["out"] for b in run.batches)
    assert min(steps) <= got["decode_step_p95_ms"] <= max(steps)


def test_a_program_without_the_stats_reports_nothing(root, monkeypatch):
    """A program older than these stats keeps no per-step intervals, host
    times or sync counts: each reader returns nothing and raises nothing."""
    _, run = _traced(root, "smoke-phi4.tiny", monkeypatch)
    keys = ("step_ms", "prefill_host_ms", "decode_host_ms", "syncs")
    old = [{k: v for k, v in b.items() if k not in keys} for b in run.batches]
    before = SimpleNamespace(**dict(vars(run), batches=old, device="cuda"))
    assert {m: harness.reader(root, "metrics", m)(before) for m in NEW} == dict.fromkeys(NEW)
