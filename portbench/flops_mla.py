"""Model FLOPs of a served batch of a configuration with multi-head latent
attention and a mixture of experts of which the chip holds a share
(deepseek-v3-4l), from shapes alone. A product of an (m, k) by a (k, n)
matrix is 2 m k n FLOPs.

Each term is counted in the form the program runs it:

- prefill, per token: the query's down and up projections (``w_dq``,
  ``w_uq``), the latent's (``w_dkv``), the decompressed keys and values
  (``w_uk``, ``w_uv``) and the output (``wo``); per causal (query, key)
  pair, the scores over the nope and rope dims and the values;
- decode, per token: ``w_dq``, ``w_uq``, ``w_dkv``, the query absorbed into
  the latent space (``w_uk``), the attended latent decompressed (``w_uv``)
  and ``wo``; per cached slot (the prompt and the steps before, and the new
  token), the scores against the latent and the rope key and the values in
  the latent space;
- the MoE, per token in both: the router at its full width, the shared
  expert, and the routed experts at the share of a token's k pairs that
  lands on the experts held, ``k * held / width`` (as if the router spread
  them evenly);
- the head at the prompt's last position and at each step.

The prefill's score products run in float32 in the program; they are
counted like the rest, against the bf16 peak.
"""
from __future__ import annotations

from portbench.flops import causal_pairs


def _dims(sizes: dict):
    m = sizes["mla"]
    return (sizes["d_model"], sizes["num_heads"], m["q_lora_rank"], m["kv_lora_rank"],
            m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"])


def moe_flops_per_token(sizes: dict) -> float:
    """The router, the shared expert and the expected routed share, one layer."""
    moe, d = sizes["moe"], sizes["d_model"]
    width = moe.get("num_routed") or moe["num_experts"]
    f = moe["d_ff_expert"]
    expert = 3 * 2 * d * f
    return (2 * d * width + moe["num_shared_experts"] * expert
            + moe["top_k"] * moe["num_experts"] / width * expert)


def attn_prefill_per_token(sizes: dict) -> int:
    d, h, ql, kl, nope, rope, vd = _dims(sizes)
    return 2 * (d * ql + ql * h * (nope + rope) + d * (kl + rope)
                + kl * h * nope + kl * h * vd + h * vd * d)


def attn_prefill_per_pair(sizes: dict) -> int:
    _, h, _, _, nope, rope, vd = _dims(sizes)
    return 2 * h * (nope + rope) + 2 * h * vd


def attn_decode_per_token(sizes: dict) -> int:
    d, h, ql, kl, nope, rope, vd = _dims(sizes)
    return 2 * (d * ql + ql * h * (nope + rope) + d * (kl + rope)
                + h * nope * kl + h * kl * vd + h * vd * d)


def attn_decode_per_slot(sizes: dict) -> int:
    _, h, _, kl, _, rope, _ = _dims(sizes)
    return 2 * h * (kl + rope) + 2 * h * kl


def head_flops(sizes: dict) -> int:
    return 2 * sizes["d_model"] * sizes["vocab_size"]


def batch_flops(sizes: dict, n: int, prompt_len: int, out_len: int) -> float:
    """Model FLOPs to serve ``n`` sequences: the prompt's prefill with the
    head at its last position, then ``out_len - 1`` decode steps, step i
    attending to ``prompt_len + i + 1`` cached slots (the last served token
    comes from the step before, so no step past it counts)."""
    layers, moe, head = sizes["num_layers"], moe_flops_per_token(sizes), head_flops(sizes)
    total = n * (layers * (prompt_len * (attn_prefill_per_token(sizes) + moe)
                           + causal_pairs(prompt_len) * attn_prefill_per_pair(sizes)) + head)
    for i in range(out_len - 1):
        slots = prompt_len + i + 1
        total += n * (layers * (attn_decode_per_token(sizes) + moe
                                + slots * attn_decode_per_slot(sizes)) + head)
    return total
