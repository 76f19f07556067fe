"""Analytic cost model (port of ``repro.metrics``): the students' costs
(``costs``), the roofline and the kernels' cost formulas (``roofline``)
and the step counter (``cost``).

The students' cost functions are loaded on first use: ``costs`` imports
the models, whose kernel ops import ``roofline`` and ``cost`` from this
package."""

__all__ = ["lr_flops", "ssm_student_flops", "tinytf_flash_flops"]


def __getattr__(name):
    if name in __all__:
        from repro_torch.metrics import costs
        return getattr(costs, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
