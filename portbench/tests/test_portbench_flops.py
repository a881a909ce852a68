"""The benchmark's FLOP and byte arithmetic against numbers worked by hand."""
import json
from pathlib import Path

import pytest

from portbench import flops

ROOT = Path(__file__).resolve().parents[2]
PHI4 = json.loads((ROOT / "portbench" / "configs" / "phi4-mini-3.8b.json").read_text())
PEAK = {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12}


def test_causal_pairs():
    assert flops.causal_pairs(8) == 36
    assert flops.causal_pairs(8, 3) == 6 + 5 * 3       # the first 3 rows, then 3 each
    assert flops.causal_pairs(8, 8) == 36


def test_k1_call_by_hand():
    # q (2, 4, 8, 16), k/v (2, 2, 8, 16) bf16, causal: 36 pairs a head;
    # q.k and p.v 2 x 2 x 16 FLOPs a pair: 4 x 2 x 4 x 16 x 36 = 18432
    f, b = flops.k1_call(2, 4, 2, 8, 16)
    assert f == 18432
    # q and out 2 x (2*4*8*16) = 2048 elements, k and v 2 x (2*2*8*16) = 1024,
    # 2 bytes each, plus the fp32 lse 2*4*8 x 4 bytes
    assert b == 2 * (2048 + 1024) + 256 == 6400
    assert flops.k1_call(2, 4, 2, 8, 16, window=3)[0] == 4 * 2 * 4 * 16 * 21


def test_k2_call_by_hand():
    # 2 rows, 4 heads over 2 kv heads of 16, 5 valid slots of 8
    f, b = flops.k2_call(2, 4, 2, 16, valid=5, slots=8)
    assert f == 4 * 2 * 4 * 16 * 5 == 2560
    # q and out 2 x 2*4*16 = 256 elements, valid K and V 2 x 2*2*5*16 = 640,
    # 2 bytes each, and the bool mask 2 x 8 bytes
    assert b == 2 * (256 + 640) + 16 == 1808


def test_one_phi4_token_by_hand():
    # a layer: q and o 3072 x 3072 each, k and v 3072 x 1024 each, the MLP
    # 3 x 3072 x 8192: 100663296 weights, 2 FLOPs each, 32 layers
    assert flops.linear_flops_per_token(PHI4) == 2 * 100663296 * 32 == 6442450944
    assert flops.head_flops(PHI4) == 2 * 3072 * 200064 == 1229193216
    # one prompt token: the layers, the head, and one (query, key) pair of
    # 4 x 24 heads x 128 FLOPs in each of 32 layers
    assert flops.batch_flops(PHI4, 1, 1, 1) == 6442450944 + 1229193216 + 393216
    # a second served token is one decode step over 2 positions
    assert (flops.batch_flops(PHI4, 1, 1, 2) - flops.batch_flops(PHI4, 1, 1, 1)
            == 6442450944 + 1229193216 + 2 * 393216)


def test_moe_token_counts_active_experts():
    mix = json.loads((ROOT / "portbench" / "configs" / "mixtral-8x7b-4l.json").read_text())
    attn = 2 * 4096 * (4096 + 2 * 1024) + 2 * 4096 * 4096
    mlp = 2 * 4096 * 8 + 2 * 3 * 2 * 4096 * 14336
    assert flops.linear_flops_per_token(mix) == 4 * (attn + mlp)


def test_bound_takes_the_larger_term():
    assert flops.bound_s(989e12, 0, PEAK) == pytest.approx(1.0)
    assert flops.bound_s(0, 3.35e12, PEAK) == pytest.approx(1.0)
    assert flops.bound_s(989e9, 3.35e12, PEAK) == pytest.approx(1.0)


def test_peaks_table_names_the_card():
    assert flops.peaks(ROOT, "NVIDIA H100 80GB HBM3") == PEAK
    with pytest.raises(KeyError):
        flops.peaks(ROOT, "cpu")
