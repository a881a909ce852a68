"""Three-term roofline of one step, with the H100's peaks.

  compute term    = FLOPs / peak_FLOP/s
  memory term     = HBM bytes / HBM_bw
  collective term = collective wire bytes / link_bw

The JAX package reads the first two from an XLA artifact
(``compiled.cost_analysis()``) and parses the third from its HLO text.
PyTorch has neither: :func:`analyze_counts` takes the counts directly
(``launch.dryrun`` counts FLOPs with ``torch.utils.flop_counter`` and
reckons the bytes). One card has no collective, so its term is 0 there, and
the HLO parser has no counterpart until there is a multi-card path.

Peaks per card: ``core.profiling.H100_SXM`` (NVIDIA H100 SXM data sheet,
dense bf16 989 TFLOP/s, 3.35 TB/s HBM3); NVLink 4 moves 450 GB/s each way.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.core.profiling import H100_SXM

PEAK_FLOPS = H100_SXM.peak_flops      # bf16 / card
HBM_BW = H100_SXM.hbm_bw              # bytes/s / card
LINK_BW = 450e9                       # bytes/s / card, NVLink 4, one direction


@dataclasses.dataclass
class Roofline:
    flops: float                  # per device
    hbm_bytes: float              # per device
    collective_bytes: float       # per device (wire)
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float = 0.0      # 6*N*D useful flops, per device
    peak_mem_bytes: float = 0.0

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """useful-compute time / bound time — the score we hillclimb."""
        if self.bound_s <= 0:
            return 0.0
        return (self.model_flops / PEAK_FLOPS) / self.bound_s


def analyze_counts(flops: float, hbm_bytes: float, collective_bytes: float = 0.0,
                   *, model_flops_per_device: float = 0.0,
                   peak_mem_bytes: float = 0.0) -> Roofline:
    """The roofline of one device's step from its counts."""
    return Roofline(
        flops=flops, hbm_bytes=hbm_bytes, collective_bytes=collective_bytes,
        compute_s=flops / PEAK_FLOPS, memory_s=hbm_bytes / HBM_BW,
        collective_s=collective_bytes / LINK_BW,
        model_flops=model_flops_per_device, peak_mem_bytes=peak_mem_bytes)


def ssm_scan_correction(cfg, seq_len: int, global_batch: int,
                        n_devices: int, kind: str, *, data_axis: int = 16,
                        model_axis: int = 16) -> Dict[str, float]:
    """Analytic per-device (flops, bytes) for the SSM/RWKV time recurrences,
    which a FLOP count cannot see inside the K3 and K4 kernels. Sharding:
    batch over the ``data_axis``, channels over the ``model_axis`` (the
    reference's 16x16 mesh by default; one card passes 1 and 1). Train
    multiplies by 4 (fwd + remat recompute + ~2x bwd). Decode needs no
    correction."""
    if cfg.ssm is None or kind == "decode":
        return {"flops": 0.0, "bytes": 0.0}
    b_dev = max(global_batch // data_axis, 1)
    s = seq_len
    n_ssm_layers = sum(1 for i in range(cfg.num_layers)
                       if not cfg.layer_is_attn(i))
    if n_ssm_layers == 0:
        return {"flops": 0.0, "bytes": 0.0}
    if cfg.ssm.kind == "mamba":
        d_in = cfg.ssm.expand * cfg.d_model // model_axis
        n = cfg.ssm.d_state
        flops_l = s * b_dev * d_in * n * 8.0
        bytes_l = s * b_dev * (16.0 * d_in + 8.0 * n)
    else:  # rwkv6
        hd = cfg.ssm.wkv_head_dim
        nh = max(cfg.d_model // hd // model_axis, 1)
        flops_l = s * b_dev * nh * hd * hd * 5.0
        bytes_l = s * b_dev * 4.0 * (cfg.d_model // model_axis) * 4.0
    mult = 4.0 if kind == "train" else 1.0
    return {"flops": flops_l * n_ssm_layers * mult,
            "bytes": bytes_l * n_ssm_layers * mult}


def flash_attention_correction(cfg, seq_len: int, global_batch: int,
                               n_devices: int, kind: str, *, data_axis: int = 16,
                               model_axis: int = 16) -> Dict[str, float]:
    """Analytic per-device (flops, bytes) for the flash-attention kernels
    (K1, and K5 in training), which a FLOP count cannot see inside: FLOPs
    4*B*S*S_eff*H*D per layer (x0.5 causal, x~3.5 for train
    fwd+recompute+bwd) and HBM bytes at the flash ideal (linear q/k/v/out
    streams only, never S^2 score materialisation; bwd re-streams ~2.5x), 4
    bytes an element as in the reference (fp32-equivalent).

    Sharding as the reference deploys it: batch over the ``data_axis``; the
    query sequence over the ``model_axis`` (K/V whole per shard); heads
    unsharded. One card passes 1 and 1."""
    if kind == "decode" or cfg.attention_kind in ("none", "mla"):
        return {"flops": 0.0, "bytes": 0.0}
    b_dev = max(global_batch // data_axis, 1)
    h_shard = cfg.num_heads
    seq_div = model_axis if seq_len % model_axis == 0 else 1
    s_q = seq_len / seq_div
    d = cfg.head_dim
    flops = 0.0
    bytes_ = 0.0
    for i in range(cfg.num_layers):
        if not cfg.layer_is_attn(i):
            continue
        eff = seq_len
        if cfg.attention_kind == "sliding" or (
                cfg.attention_kind == "local_global"
                and not cfg.layer_is_global_attn(i)):
            eff = min(seq_len, cfg.sliding_window)
        causal = 0.5 if eff == seq_len else 1.0
        flops += 4.0 * b_dev * h_shard * s_q * eff * d * causal
        bytes_ += 4.0 * b_dev * (2 * h_shard * s_q
                                 + 2 * cfg.num_kv_heads * seq_len) * d
    mult_f = 3.5 if kind == "train" else 1.0
    mult_b = 2.5 if kind == "train" else 1.0
    return {"flops": flops * mult_f, "bytes": bytes_ * mult_b}


def model_flops(cfg, shape, n_devices: int) -> float:
    """MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE), per device.

    D = tokens processed by the step: B*S for train/prefill, B for decode.
    Train includes the backward pass (the 6x already covers fwd+bwd;
    prefill/decode use 2*N*D)."""
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        d = shape.global_batch * shape.seq_len
        mult = 6.0
    elif shape.kind == "prefill":
        d = shape.global_batch * shape.seq_len
        mult = 2.0
    else:
        d = shape.global_batch
        mult = 2.0
    return mult * n_active * d / n_devices
