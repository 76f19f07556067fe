"""Online cascade learning (Algorithm 1), ported to PyTorch.

Public surface: the sequential ``OnlineCascade``, the serving-scale
``BatchedCascadeEngine`` (base form), the kernel-ladder configuration,
the deferral-gate math and the simulated expert.
"""
from repro_torch.core.batched import BatchedCascadeEngine
from repro_torch.core.cascade import (
    STATE_ATTRS, CascadeConfig, LevelSpec, OnlineCascade,
    kernel_cascade_config)
from repro_torch.core.deferral import (
    DeferralSpec, deferral_init, deferral_prob, reexploration_floor)
from repro_torch.core.experts import ExpertTicket, SimulatedExpert

__all__ = ["BatchedCascadeEngine", "CascadeConfig", "DeferralSpec",
           "ExpertTicket", "LevelSpec", "OnlineCascade", "STATE_ATTRS",
           "SimulatedExpert", "deferral_init", "deferral_prob",
           "kernel_cascade_config", "reexploration_floor"]
