"""Online cascade learning (Algorithm 1), ported to PyTorch.

Public surface: the sequential ``OnlineCascade``, the serving-scale
``BatchedCascadeEngine`` (with its async expert queue, per-lane commits,
fault requeues, autoscaling, pipelined route passes, occupancy ticks and
live-state checkpoints), the continuous-batching front-end
``CascadeFrontEnd`` with its ``StreamRecord`` and ``serve_requests``,
the paper's default and the kernel ladder's configurations, the
deferral-gate math, the simulated and the model expert (and the
fault-injecting ``FlakyExpert``), the MDP's cost terms, the
online-ensemble baseline and the offline distillation baseline
``distill_students``.
"""
from repro_torch.core.admission import (CascadeFrontEnd, StreamRecord,
                                        serve_requests)
from repro_torch.core.batched import BatchedCascadeEngine
from repro_torch.core.cascade import (
    LEVEL_KINDS, STATE_ATTRS, CascadeConfig, LevelSpec, OnlineCascade,
    default_cascade_config, kernel_cascade_config)
from repro_torch.core.deferral import (
    DeferralSpec, deferral_init, deferral_prob, reexploration_floor)
from repro_torch.core.distill import distill_students
from repro_torch.core.ensemble import OnlineEnsemble
from repro_torch.core.experts import (
    ExpertShardError, ExpertShardTimeout, ExpertTicket, ExpertWorkerDied,
    FlakyExpert, ModelExpert, SimulatedExpert, train_model_expert)
from repro_torch.core.mdp import episode_cost, policy_value

__all__ = ["BatchedCascadeEngine", "CascadeConfig", "CascadeFrontEnd",
           "DeferralSpec",
           "ExpertShardError", "ExpertShardTimeout", "ExpertTicket",
           "ExpertWorkerDied", "FlakyExpert", "LEVEL_KINDS", "LevelSpec",
           "ModelExpert", "OnlineCascade", "OnlineEnsemble", "STATE_ATTRS",
           "SimulatedExpert", "StreamRecord", "default_cascade_config",
           "deferral_init", "deferral_prob", "distill_students",
           "episode_cost",
           "kernel_cascade_config", "policy_value", "reexploration_floor",
           "serve_requests", "train_model_expert"]
