"""Models (port of ``repro.models``): the cascade students (the LR
student and the kernel-path ``tinytf_flash`` / ``ssm`` levels) and the
zoo's serving path (``transformer``, ``attention``, ``moe``, ``layers``)."""
