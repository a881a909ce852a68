"""The profiled span's reduction, on a hand-made trace."""
import pytest

from portbench import calls, trace
from portbench.reference import ladder


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


EVENTS = [
    _ev("user_annotation", "portbench.generate", 0, 100),
    _ev("cpu_op", "aten::argmax", 40, 20),
    _ev("kernel", "void flash_fwd_sm90_kernel<128>(...)", 0, 10),
    _ev("kernel", "gemm", 5, 20),                       # overlaps the first
    _ev("kernel", "void decode_mma_kernel<128, 3>(...)", 45, 5),
    _ev("gpu_memcpy", "Memcpy DtoH", 90, 4),
    _ev("kernel", "void decode_mma_kernel<128, 3>(...)", 60, 5),
]


def test_summary_of_a_trace():
    s = trace.summarise(EVENTS, window_s=100e-6)
    assert s["busy_s"] == pytest.approx((25 + 5 + 5 + 4) * 1e-6)
    # gaps: 65-90, 25-45, 50-60 (the host in argmax at its start)
    assert [g for _, g in s["idle_gaps"]] == pytest.approx([25e-6, 20e-6, 10e-6])
    assert s["idle_gaps"][2][0] == "portbench.generate > aten::argmax"
    assert s["idle_gaps"][0][0] == "portbench.generate > python"
    assert s["device_ops"][0] == ["gemm", pytest.approx(20e-6)]
    assert len(s["kernels"]) == 4


def test_rooflines_from_a_span():
    sizes = {"num_heads": 4, "num_kv_heads": 2, "head_dim": 16, "num_layers": 1,
             "attention_kind": "full", "sliding_window": 0}
    run = type("Run", (), {})()
    run.levels = [sizes] * len(ladder.ALPHAS)
    run.max_len = 8
    run.peak = {"bf16_flops": 1e12, "hbm_bytes_per_s": 1e9}
    run.batches = [{"in_span": True, "level": 0, "n": 2, "plen": 6, "out": 2},
                   {"in_span": False, "level": 0, "n": 2, "plen": 6, "out": 9}]
    run.span = trace.summarise(EVENTS, 100e-6)
    k1 = calls.k1(run)
    assert len(k1) == 1
    k2 = calls.k2(run)
    assert [c[1] for c in k2] == [2 * (2 * 2 * 4 * 16 + 2 * 2 * 2 * v * 16) + 2 * 8
                                  for v in (7, 8)]
    # bytes bound the calls here: 1 GB/s
    want = 100 * sum(b for _, b in k2) * 1e-9 / 10e-6
    assert calls.roofline(run, k2, calls.K2_NAMES) == pytest.approx(want)
    run.span = None
    assert calls.roofline(run, k2, calls.K2_NAMES) is None
