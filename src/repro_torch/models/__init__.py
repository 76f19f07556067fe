"""Cascade students (port of ``repro.models``: the LR student and the
kernel-path ``tinytf_flash`` / ``ssm`` levels)."""
