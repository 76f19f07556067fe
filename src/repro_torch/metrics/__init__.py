"""Analytic cost model (port of ``repro.metrics``): the students' and
the expert's costs and the deferral penalties (``costs``), the roofline
and the kernels' cost formulas (``roofline``) and the step counter
(``cost``).

The reference's exports, and the port's other student costs, are loaded
on first use: ``costs`` imports the models, whose kernel ops import
``roofline`` and ``cost`` from this package.  ``parse_collective_bytes``
reads XLA's HLO text, which the port never produces: ``cost.
CostCounter`` counts the collectives themselves."""

_COSTS = ("lr_flops", "tinytf_flops", "expert_prefill_flops",
          "expert_decode_flops", "relative_costs", "CostModel", "mlp_flops",
          "tinytf_flash_flops", "ssm_student_flops")
_ROOFLINE = ("HW", "H100", "roofline_terms", "model_flops_6nd")
__all__ = list(_COSTS + _ROOFLINE)


def __getattr__(name):
    if name in _COSTS:
        from repro_torch.metrics import costs
        return getattr(costs, name)
    if name in _ROOFLINE:
        from repro_torch.metrics import roofline
        return getattr(roofline, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
