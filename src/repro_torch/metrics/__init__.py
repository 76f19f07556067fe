"""Analytic cost model (port of ``repro.metrics``)."""
from repro_torch.metrics.costs import (
    lr_flops, ssm_student_flops, tinytf_flash_flops)

__all__ = ["lr_flops", "ssm_student_flops", "tinytf_flash_flops"]
