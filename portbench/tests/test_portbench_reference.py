"""The plain reference against the port's CPU path at smoke size: in float32
the port's prefill and every decode step through the cache give the
reference's logits, at accuracy levels 0 and 5, dense and with experts."""
import numpy as np
import pytest
import torch

from portbench import harness, weights
from portbench.reference import gqa_transformer as ref
from portbench.reference import ladder
from portbench.tests import smoke


def _engine_logits(cfg_file, level, prompts, steps):
    from repro_torch.core.variants import VariantPool
    from repro_torch.serving.engine import Engine, EngineConfig
    sizes = harness.model_sizes(cfg_file)
    lay = ref.layout(ladder.level_sizes(sizes, level))
    params = weights.make(lay, 99, level, "cpu", dtype=torch.float32)
    vcfg = VariantPool(harness.port_config(cfg_file))[level].config.scaled(dtype="float32")
    eng = Engine(vcfg, params, EngineConfig(max_len=prompts.shape[1] + steps), device="cpu")
    logits, caches, lengths = eng.prefill(prompts)
    out, toks = [logits], []
    for _ in range(steps - 1):
        tok = logits.argmax(-1)
        toks.append(tok)
        logits, caches, lengths = eng.decode(caches, lengths, tok)
        out.append(logits)
    return params, torch.stack(out, 1), torch.stack(toks, 1) if toks else None


@pytest.mark.parametrize("name", ["smoke-phi4", "smoke-mixtral"])
@pytest.mark.parametrize("level", [0, 5])
def test_reference_matches_port_in_fp32(name, level):
    cfg_file = smoke.smoke_config(name)
    sizes = ladder.level_sizes(harness.model_sizes(cfg_file), level)
    # 14 prompt tokens and 6 steps: past mixtral's smoke window of 16
    prompts = torch.as_tensor(np.random.default_rng(level).integers(1, 256, size=(3, 14)))
    params, got, toks = _engine_logits(cfg_file, level, prompts, 6)
    seq = torch.cat([prompts, toks], 1)
    want, _ = ref.logits_at(sizes, params, seq, 14, range(13, 19))
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_capacity_drops_tokens_as_the_program_does():
    # a router that sends every token to experts 0 and 1: each keeps the
    # first ``capacity`` tokens of a call
    moe_sizes = {"num_experts": 4, "top_k": 2, "d_ff_expert": 8}
    d = 4
    w = {"w_router": torch.zeros(d, 4), "we_gate": torch.randn(4, d, 8),
         "we_up": torch.randn(4, d, 8), "we_down": torch.randn(4, 8, d)}
    w["w_router"][0, :2] = torch.tensor([10.0, 5.0])
    h = torch.ones(2, 20, d)
    _, dropped, margin, unsure = ref.moe(h, w, moe_sizes, [slice(0, 20)], ref._Mat(None))
    assert torch.allclose(margin, torch.full((2, 20), 5.0))
    c = ref.capacity(40, 4, 2)
    assert c == 32
    assert dropped == 2 * (40 - 32)
    assert not unsure.any()
    _, dropped, _, _ = ref.moe(h, w, moe_sizes, [slice(i, i + 1) for i in range(20)],
                            ref._Mat(None))
    assert dropped == 0


def test_a_near_tie_makes_the_capacity_boundary_unsure():
    # every token takes experts 0 and 1 (capacity 32 of 40 in one call);
    # token 0 nearly takes expert 2 instead: a flip of it moves every later
    # token's place in expert 1's queue by one, so the tokens at places 31
    # and 32 may be kept on one side and dropped on the other
    moe_sizes = {"num_experts": 4, "top_k": 2, "d_ff_expert": 8}
    d = 4
    w = {"w_router": torch.zeros(d, 4), "we_gate": torch.randn(4, d, 8),
         "we_up": torch.randn(4, d, 8), "we_down": torch.randn(4, 8, d)}
    w["w_router"][0, :2] = torch.tensor([10.0, 5.0])
    w["w_router"][1, 2] = 4.99
    h = torch.zeros(1, 40, d)
    h[..., 0] = 1.0
    h[0, 0, 1] = 1.0
    _, _, margin, unsure = ref.moe(h, w, moe_sizes, [slice(0, 40)], ref._Mat(None), near=0.05)
    assert margin[0, 0] < 0.05 and (margin[0, 1:] == 5.0).all()
    assert unsure[0].nonzero()[:, 0].tolist() == [0, 31, 32]
    _, _, _, unsure = ref.moe(h, w, moe_sizes, [slice(0, 40)], ref._Mat(None))
    assert not unsure.any()


def test_control_rounds_to_fp8():
    x = torch.tensor([[1.0, 1.03, 0.5, -448.0]])
    q = ref._fp8(x, -1)
    assert q[0, 3] == -448.0 and q[0, 2] == 0.5
    assert q[0, 1] != x[0, 1]                  # 3 mantissa bits cannot hold 1.03


def test_ladder_matches_the_port():
    from repro_torch.core.variants import VariantPool
    for name in ("smoke-phi4", "smoke-mixtral"):
        cfg_file = smoke.smoke_config(name)
        pool = VariantPool(harness.port_config(cfg_file))
        for level in range(6):
            s = ladder.level_sizes(harness.model_sizes(cfg_file), level)
            v = pool[level].config
            assert (s["num_layers"], s["d_ff"]) == (v.num_layers, v.d_ff)
            if v.moe:
                assert (s["moe"]["top_k"], s["moe"]["d_ff_expert"]) == (
                    v.moe.top_k, v.moe.d_ff_expert)


def test_reference_refuses_what_it_does_not_compute():
    sizes = harness.model_sizes(smoke.smoke_config("smoke-phi4"))
    ref.check_supported(sizes)
    with pytest.raises(ValueError):
        ref.check_supported({**sizes, "attn_logit_softcap": 50.0})
