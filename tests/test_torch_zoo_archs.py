"""The zoo's decoder-only architectures in the port vs the JAX package
on the CPU: jamba-1.5-large-398b, mamba2-370m, internlm2-1.8b, qwen3-8b,
h2o-danube-3-4b, llama3-405b and dbrx-132b (Mixtral-8x22B has its own
file, ``tests/test_torch_zoo.py``).

The whole-model runs start from the reference's own
``init_params(PRNGKey(0))`` at the smoke config through
``bridge.load_zoo_params``; prompts come from ``lm_batches`` (numpy,
seeded).  S = 40 is one chunk of 32 plus a ragged tail of 8 for the
MAMBA blocks, and the 4 decode steps wrap the 40-slot ring.  MoE
models serve at the configured capacity (tokens may drop, in both
packages alike).  Tolerances, each with its reason:

* configs: equal, field for field (``source`` included); the meta tree:
  the reference's paths, shapes and dtypes at full width;
* fp32: 1e-4 on forward and prefill logits, every cache leaf (``k``,
  ``v``, ``pos``, ``conv``, ``ssm``) and 4 decode steps' logits, with
  identical greedy tokens (two layers of fp32 products over d_model
  128-256, attention and the SSD scan in another schedule);
* bf16: 6e-2, the tolerance ``tests/test_archs_smoke.py`` gives the
  reference's own prefill/decode paths against each other;
* the bridge: bit-exact, bf16 and fp32 leaves alike.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_smoke_config as j_get_smoke  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.data import lm_batches  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ARCHS = ("jamba-1.5-large-398b", "mamba2-370m", "internlm2-1.8b",
         "qwen3-8b", "h2o-danube-3-4b", "llama3-405b", "dbrx-132b")
MODEL_TOL = 1e-4
BF16_TOL = 6e-2
S, N_DECODE = 40, 4


def _fp32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_the_reference(arch, smoke):
    mine = (get_smoke_config if smoke else get_config)(arch)
    ref = (j_get_smoke if smoke else j_get_config)(arch)
    for f in dataclasses.fields(mine):
        a, b = getattr(mine, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(a):
            # the port's sub-configs hold the fields it reads; the rest of
            # the reference's stay at their defaults in this config
            rf = dataclasses.asdict(b)
            assert dataclasses.asdict(a) == {
                k: rf[k] for k in dataclasses.asdict(a)}, f.name
            for g in dataclasses.fields(b):
                if not hasattr(a, g.name):
                    assert getattr(b, g.name) == g.default, (f.name, g.name)
        else:
            assert a == b, f.name
    # the reference fields the port leaves out are at their defaults
    for g in dataclasses.fields(ref):
        if not hasattr(mine, g.name):
            assert getattr(ref, g.name) == g.default, g.name
    assert mine.n_periods == ref.n_periods
    assert mine.source == ref.source


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_tree_is_the_reference(arch):
    """``init_params(None, cfg)`` at full width: the reference tree's
    paths, shapes and dtypes (no storage)."""
    cfg = get_config(arch)
    ref = jax.eval_shape(lambda: j_tf.init_params(jax.random.PRNGKey(0),
                                                  j_get_config(arch)))
    mine = _paths(t_tf.init_params(None, cfg))
    ref = _paths(ref)
    assert set(mine) == set(ref)
    for k, v in mine.items():
        assert v.device.type == "meta", k
        assert tuple(v.shape) == tuple(ref[k].shape), k
        assert str(v.dtype).split(".")[-1] == str(ref[k].dtype), k


def _reference_model(jcfg):
    params = j_tf.init_params(jax.random.PRNGKey(0), jcfg)
    return params, jax.tree.map(np.asarray, params)


_J_FORWARD = jax.jit(j_tf.forward, static_argnames=("cfg",))
_J_PREFILL = jax.jit(j_tf.prefill, static_argnames=("cfg",))
_J_DECODE = jax.jit(j_tf.decode_step, static_argnames=("cfg",))


def _close_cache(cache, jcache, tol):
    assert set(cache) == set(jcache)
    for b in cache:
        assert set(cache[b]) == set(jcache[b]), b
        for name, leaf in cache[b].items():
            assert tuple(leaf.shape) == tuple(jcache[b][name].shape)
            if name == "pos":
                assert leaf.dtype == torch.int32
                assert np.array_equal(leaf.numpy(),
                                      np.asarray(jcache[b][name]))
            else:
                _close(leaf, jcache[b][name], tol)


def _serve_both(arch, fp32, seed, tol, greedy_equal, n_decode):
    cfg, jcfg = get_smoke_config(arch), j_get_smoke(arch)
    if fp32:
        cfg, jcfg = _fp32(cfg), _fp32(jcfg)
    jparams, tree = _reference_model(jcfg)
    params = bridge.load_zoo_params(tree, cfg, "cpu")
    tokens = next(lm_batches(cfg.vocab, 2, S, 1, seed=seed))["tokens"]
    with torch.no_grad():
        if fp32:
            logits, _ = t_tf.forward(params, {"tokens": _t(tokens)}, cfg)
            jlogits, _ = _J_FORWARD(jparams, {"tokens": jnp.asarray(tokens)},
                                    cfg=jcfg)
            _close(logits, jlogits, tol)
        last, cache = t_tf.prefill(params, {"tokens": _t(tokens)}, cfg)
    jlast, jcache = _J_PREFILL(jparams, {"tokens": jnp.asarray(tokens)},
                               cfg=jcfg)
    _close(last, jlast, tol)
    _close_cache(cache, jcache, tol)
    tok, jtok = last.argmax(-1), np.asarray(jnp.argmax(jlast, -1))
    for step in range(n_decode):
        if greedy_equal:
            assert np.array_equal(tok.numpy(), jtok), step
        with torch.no_grad():
            logits, cache = t_tf.decode_step(params, cache, _t(jtok)[:, None],
                                             S + step, cfg)
        jlogits, jcache = _J_DECODE(jparams, jcache,
                                    jnp.asarray(jtok)[:, None],
                                    jnp.int32(S + step), cfg=jcfg)
        _close(logits, jlogits, tol)
        _close_cache(cache, jcache, tol)
        tok, jtok = logits.argmax(-1), np.asarray(jnp.argmax(jlogits, -1))
    if greedy_equal:
        assert np.array_equal(tok.numpy(), jtok)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_fp32_matches_reference(arch):
    """Forward and prefill logits, every cache leaf and 4 greedy decode
    steps in fp32, tokens identical."""
    _serve_both(arch, True, 0, MODEL_TOL, True, N_DECODE)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_bf16_matches_reference(arch):
    """The default dtype at the loose tolerance the reference gives its
    own paths; tokens are the reference's greedy ones."""
    _serve_both(arch, False, 1, BF16_TOL, False, 2)


@pytest.mark.parametrize("arch", ARCHS)
def test_load_zoo_params_round_trip_is_bit_exact(arch):
    """Every leaf of the reference's smoke tree, the MAMBA ones (A_log,
    dt_bias, D, gate_norm, conv_b in fp32) included, arrives with the
    same bits."""
    cfg = get_smoke_config(arch)
    jparams, tree = _reference_model(j_get_smoke(arch))
    params = bridge.load_zoo_params(tree, cfg, "cpu")
    mine, ref = _paths(params), _paths(jparams)
    assert set(mine) == set(ref)
    for k, a in mine.items():
        b = np.asarray(ref[k])
        if a.dtype == torch.bfloat16:
            assert np.array_equal(a.view(torch.int16).numpy(),
                                  b.view(np.int16)), k
        else:
            assert np.array_equal(a.numpy(), b), k
    if cfg.ssm is not None:
        blk = next(v for v in params["blocks"].values() if "mamba" in v)
        for name in ("A_log", "dt_bias", "D", "gate_norm", "conv_b"):
            assert blk["mamba"][name].dtype == torch.float32, name
    assert all(t.device.type == "cpu" for t in tree_leaves(params))
