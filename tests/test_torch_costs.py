"""The expert half of ``metrics/costs.py`` against the JAX package's: the
expert LLM's prefill and decode FLOPs for every architecture (published
and smoke configs) at several lengths, the deferral-penalty table
``relative_costs`` with every optional spec, and the package's exports.
Tolerance: equal (the same float arithmetic on the same numbers)."""
import dataclasses
import itertools

import pytest

pytest.importorskip("torch")

from repro import metrics as j_metrics  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_smoke_config as j_get_smoke  # noqa: E402
from repro.metrics import costs as JC  # noqa: E402
from repro.models import kernel_students as JK  # noqa: E402
from repro.models import students as JS  # noqa: E402
from repro_torch import metrics as t_metrics  # noqa: E402
from repro_torch.configs import (get_config, get_smoke_config,  # noqa: E402
                                 list_architectures)
from repro_torch.metrics import costs as PC  # noqa: E402
from repro_torch.models import kernel_students as PK  # noqa: E402
from repro_torch.models import students as PS  # noqa: E402

LENGTHS = (1, 7, 256, 4096, 32768, 524288)


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", list_architectures())
def test_expert_flops_match_the_reference(arch, smoke):
    jcfg = (j_get_smoke if smoke else j_get_config)(arch)
    cfg = (get_smoke_config if smoke else get_config)(arch)
    for n in LENGTHS:
        assert PC.expert_prefill_flops(cfg, n) == \
            JC.expert_prefill_flops(jcfg, n), n
        assert PC.expert_decode_flops(cfg, n) == \
            JC.expert_decode_flops(jcfg, n), n
        assert PC._attn_flops(cfg, n, n / 3) == JC._attn_flops(jcfg, n,
                                                               n / 3), n
    windowed = cfg.with_window(64) if cfg.attn is not None else cfg
    jwindowed = jcfg.with_window(64) if jcfg.attn is not None else jcfg
    assert PC.expert_prefill_flops(windowed, 4096) == \
        JC.expert_prefill_flops(jwindowed, 4096)


def _specs(mod_s, mod_k, scale):
    """Each student spec of one package, defaults or widened."""
    def make(cls):
        if scale == 1:
            return cls()
        kw = {f.name: f.default * scale for f in dataclasses.fields(cls)
              if f.name in ("d_model", "hidden", "n_features", "max_len")}
        return cls(**kw)
    return {"lr_spec": make(mod_s.LRSpec), "tf_spec": make(mod_s.TinyTFSpec),
            "mlp_spec": make(mod_s.MLPSpec),
            "tf_flash_spec": make(mod_k.TinyTFFlashSpec),
            "ssm_spec": make(mod_k.SSMStudentSpec)}


OPTIONAL = ("expert_cfg", "mlp_spec", "tf_flash_spec", "ssm_spec", "extra")


@pytest.mark.parametrize("scale", [1, 2])
def test_relative_costs_match_the_reference_with_every_spec(scale):
    """Every subset of the optional entries, the expert at two
    architectures and document lengths: the same table, and
    ``CostModel.cost`` reads it."""
    j, p = _specs(JS, JK, scale), _specs(PS, PK, scale)
    for n in range(len(OPTIONAL) + 1):
        for chosen in itertools.combinations(OPTIONAL, n):
            for arch, doc_len in (("mixtral-8x22b", 256),
                                  ("mamba2-370m", 1024)):
                jkw = {"lr_spec": j["lr_spec"], "tf_spec": j["tf_spec"]}
                pkw = {"lr_spec": p["lr_spec"], "tf_spec": p["tf_spec"]}
                for k in chosen:
                    if k == "expert_cfg":
                        jkw[k], pkw[k] = j_get_config(arch), get_config(arch)
                        jkw["doc_len"] = pkw["doc_len"] = doc_len
                    elif k == "extra":
                        jkw[k] = {"expert": 7.5e5, "other": 3.0}
                        pkw[k] = dict(jkw[k])
                    else:
                        jkw[k], pkw[k] = j[k], p[k]
                want = JC.relative_costs(**jkw)
                got = PC.relative_costs(**pkw)
                assert got.units == want.units, chosen
                for level in want.units:
                    assert got.cost(level) == want.cost(level)


def test_metrics_exports_the_references_names():
    """Every name the reference's ``repro.metrics`` exports, but its TPU
    envelope ``V5E`` (the port's is ``H100``) and ``parse_collective_
    bytes`` (HLO text, which the port never produces), is the port's
    ``repro_torch.metrics``'."""
    names = set(j_metrics.__all__) - {"V5E", "parse_collective_bytes"}
    assert names <= set(t_metrics.__all__)
    for name in names:
        assert getattr(t_metrics, name) is not None, name
    assert t_metrics.CostModel is PC.CostModel
    assert t_metrics.H100.name == "h100-sxm"
