"""The traffic generator: a deck fixed by the mix file, orders by the seed."""
import json
from pathlib import Path

import numpy as np

from portbench import seeds, traffic

MIXES = Path(__file__).resolve().parents[1] / "traffic"


def _deck(name):
    return traffic.deck(traffic.load(MIXES / f"{name}.json"), 1000.0, 3000.0)


def test_deck_is_the_same_for_every_call():
    assert _deck("gen") == _deck("gen")
    assert _deck("score") == _deck("score")


def test_deck_holds_the_mix_in_proportion():
    mix = json.loads((MIXES / "gen.json").read_text())
    d = _deck("gen")
    assert len(d) == mix["requests_per_pass"] == 10
    lens = sorted(r.prompt_len for r in d)
    assert lens == [256] * 5 + [512] * 3 + [1024] * 2
    assert sorted(r.items for r in d) == [11, 16, 22, 28, 33, 39, 44, 50, 56, 61]
    assert all(8 <= r.out_len <= 24 for r in d)
    assert all(86.0 <= r.acc_req <= 90.5 for r in d)
    assert all(900.0 <= r.perf_req <= 2850.0 for r in d)
    assert {r.out_len for r in _deck("score")} == {1}


def test_weighted_choice_takes_largest_remainders():
    got = traffic._weighted({"values": [1, 2, 3], "weights": [0.5, 0.3, 0.2]}, 7)
    assert sorted(got.tolist()) == [1, 1, 1, 1, 2, 2, 3]


def test_seed_streams_are_deterministic_and_distinct():
    a = seeds.rng(2**31 + 7, "order").permutation(10)
    b = seeds.rng(2**31 + 7, "order").permutation(10)
    c = seeds.rng(2**31 + 8, "order").permutation(10)
    assert (a == b).all() and not (a == c).all()
    p = seeds.rng(5, "prompts").integers(1, 100, size=20)
    assert not (p == seeds.rng(5, "order").integers(1, 100, size=20)).all()
    assert seeds.derive(2**40 + 3, "weights", 2) == seeds.derive(2**40 + 3, "weights", 2)
    assert seeds.derive(-5, "weights", 0) != seeds.derive(5, "weights", 0)
    assert 0 <= seeds.derive(2**64 - 1, "sample") < 2**63


def test_batches_and_longest():
    assert traffic.batches(19, 8) == [8, 8, 3]
    assert traffic.batches(0, 8) == []
    assert traffic.longest(traffic.load(MIXES / "gen.json")) == 1024 + 24
    assert traffic.longest(traffic.load(MIXES / "score.json")) == 4096 + 1
    assert np.isclose(sum(r.items for r in _deck("gen")), 360)
