"""Closed-loop gateway control: admission control + autoscaling.

Public surface:
  * admission   — TokenBucket, AdmissionController, AdmissionDecision
  * autoscaler  — Autoscaler, ScalingAction
  * fairshare   — FairShareScheduler, weighted_max_min

The simulator (`repro_torch.sim.simulator.OnlineSimulator`) consumes both: the
AdmissionController gates every arrival (reject / degrade / admit) against
the token bucket and an SLO-feasibility estimate from live queue depths;
the Autoscaler spawns/retires standby worker groups from queue-depth and
deadline-violation signals with cooldown + warm-up dynamics.
"""
from repro_torch.control.admission import (AdmissionController, AdmissionDecision,
                                     TokenBucket)
from repro_torch.control.autoscaler import Autoscaler, ScalingAction
from repro_torch.control.fairshare import FairShareScheduler, weighted_max_min

__all__ = [
    "AdmissionController", "AdmissionDecision", "TokenBucket",
    "Autoscaler", "ScalingAction",
    "FairShareScheduler", "weighted_max_min",
]
