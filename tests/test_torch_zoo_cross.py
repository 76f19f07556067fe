"""The zoo's CROSS architectures in the port vs the JAX package on the
CPU: seamless-m4t-medium (an encoder and CROSS decoder layers over its
frames) and llama-3.2-vision-11b (CROSS layers over image embeddings).

The whole-model runs start from the reference's own
``init_params(PRNGKey(0))`` at the smoke config through
``bridge.load_zoo_params``; prompts come from ``lm_batches`` (numpy,
seeded) and the memory the modality stub would hand over (seamless'
frame embeddings, 48 frames against 40 decoder tokens; the vision
model's 16 image embeddings) from a seeded numpy generator.  The 4
decode steps wrap the 40-slot ring and read the cached ``xk`` /
``xv``.  Tolerances, each with its reason:

* configs: equal, field for field (``source`` included); the meta tree
  and ``cache_struct``: the reference's paths, shapes and dtypes at full
  width;
* fp32: 1e-4 on forward and prefill logits, every cache leaf (``k``,
  ``v``, ``pos``, ``xk``, ``xv``) and 4 decode steps' logits, with
  identical greedy tokens (two layers of fp32 products over d_model
  128-256 and attention in another schedule); ``encode`` alone within
  the same 1e-4;
* ``cross_attention`` alone: 1e-5 (the same fp32 arithmetic in another
  summation order);
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
from repro.configs import list_architectures as j_archs  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.data import lm_batches  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402

ARCHS = ("seamless-m4t-medium", "llama-3.2-vision-11b")
FP32_TOL = 1e-5
MODEL_TOL = 1e-4
BF16_TOL = 6e-2
S, S_ENC, N_DECODE = 40, 48, 4


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


def _same_struct(mine, ref):
    """Paths, shapes and dtypes equal; the port's leaves on ``meta``."""
    mine, ref = _paths(mine), _paths(ref)
    assert set(mine) == set(ref)
    for k, v in mine.items():
        assert v.device.type == "meta", k
        assert tuple(v.shape) == tuple(ref[k].shape), k
        assert str(v.dtype).split(".")[-1] == str(ref[k].dtype), k


def _memory_len(cfg):
    return cfg.n_image_tokens if cfg.vision_stub else S_ENC


def _batch(cfg, seed):
    """Tokens from ``lm_batches`` and the stub's memory in fp32 (each
    model casts it to its dtype)."""
    batch = {"tokens": next(lm_batches(cfg.vocab, 2, S, 1,
                                       seed=seed))["tokens"]}
    mem = np.random.default_rng(seed + 100).standard_normal(
        (2, _memory_len(cfg), cfg.d_model)).astype(np.float32)
    batch["frames" if cfg.encoder is not None else "image_embeds"] = mem
    return batch


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
    for g in dataclasses.fields(ref):
        if not hasattr(mine, g.name):
            assert getattr(ref, g.name) == g.default, g.name
    assert mine.n_periods == ref.n_periods
    assert mine.source == ref.source


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_tree_is_the_reference(arch):
    """``init_params(None, cfg)`` at full width, the encoder and the
    ``cross_attn`` / ``norm_x`` leaves included: the reference tree's
    paths, shapes and dtypes (no storage)."""
    ref = jax.eval_shape(lambda: j_tf.init_params(jax.random.PRNGKey(0),
                                                  j_get_config(arch)))
    _same_struct(t_tf.init_params(None, get_config(arch)), ref)


@pytest.mark.parametrize("arch", j_archs())
def test_cache_struct_is_the_reference(arch):
    """``cache_struct`` at full width for every architecture: the
    reference's tree of ``ShapeDtypeStruct``s (a window caps the ring,
    a CROSS block adds the memory's ``xk`` / ``xv``)."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    mem = (jcfg.n_image_tokens if jcfg.vision_stub
           else 4096 if jcfg.encoder is not None else 0)
    _same_struct(t_tf.cache_struct(cfg, 2, 8192, memory_len=mem),
                 j_tf.cache_struct(jcfg, 2, 8192, memory_len=mem))


_MODELS = {}


def _reference_model(jcfg):
    """The reference's smoke parameters, made once per config."""
    if jcfg not in _MODELS:
        params = j_tf.init_params(jax.random.PRNGKey(0), jcfg)
        _MODELS[jcfg] = (params, jax.tree.map(np.asarray, params))
    return _MODELS[jcfg]


_J_FORWARD = jax.jit(j_tf.forward, static_argnames=("cfg",))
_J_PREFILL = jax.jit(j_tf.prefill, static_argnames=("cfg",))
_J_DECODE = jax.jit(j_tf.decode_step, static_argnames=("cfg",))
_J_ENCODE = jax.jit(j_tf.encode, static_argnames=("cfg",))


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
    batch = _batch(cfg, seed)
    tb = {k: _t(v) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with torch.no_grad():
        if fp32:
            logits, _ = t_tf.forward(params, tb, cfg)
            jlogits, _ = _J_FORWARD(jparams, jb, cfg=jcfg)
            _close(logits, jlogits, tol)
        last, cache = t_tf.prefill(params, tb, cfg)
    jlast, jcache = _J_PREFILL(jparams, jb, cfg=jcfg)
    _close(last, jlast, tol)
    _close_cache(cache, jcache, tol)
    struct = t_tf.cache_struct(cfg, 2, S, memory_len=_memory_len(cfg))
    assert {k: (tuple(v.shape), v.dtype) for k, v in _paths(cache).items()} \
        == {k: (tuple(v.shape), v.dtype) for k, v in _paths(struct).items()}
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
    """Forward and prefill logits, every cache leaf (the memory's ``xk``
    / ``xv`` included) and 4 greedy decode steps in fp32, tokens
    identical; the cache's tree is ``cache_struct``'s."""
    _serve_both(arch, True, 0, MODEL_TOL, True, N_DECODE)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_bf16_matches_reference(arch):
    """The default dtype at the loose tolerance the reference gives its
    own paths; tokens are the reference's greedy ones."""
    _serve_both(arch, False, 1, BF16_TOL, False, 2)


@pytest.mark.parametrize("arch", ARCHS)
def test_load_zoo_params_round_trip_is_bit_exact(arch):
    """Every leaf of the reference's smoke tree, the encoder's and the
    cross-attention's included, arrives with the same bits."""
    cfg = get_smoke_config(arch)
    jparams, tree = _reference_model(j_get_smoke(arch))
    params = bridge.load_zoo_params(tree, cfg, "cpu")
    mine, ref = _paths(params), _paths(jparams)
    assert set(mine) == set(ref)
    assert any("/cross_attn/" in k for k in mine)
    for k, a in mine.items():
        b = np.asarray(ref[k])
        assert a.device.type == "cpu", k
        if a.dtype == torch.bfloat16:
            assert np.array_equal(a.view(torch.int16).numpy(),
                                  b.view(np.int16)), k
        else:
            assert np.array_equal(a.numpy(), b), k


def test_encode_matches_reference():
    """seamless' encoder stack alone (non-causal self-attention, RoPE,
    layernorm, gelu, the final norm) in fp32."""
    arch = "seamless-m4t-medium"
    cfg, jcfg = _fp32(get_smoke_config(arch)), _fp32(j_get_smoke(arch))
    jparams, tree = _reference_model(jcfg)
    params = bridge.load_zoo_params(tree, cfg, "cpu")
    frames = _batch(cfg, 2)["frames"]
    with torch.no_grad():
        mem = t_tf.encode(params, _t(frames), cfg)
    assert tuple(mem.shape) == (2, S_ENC, cfg.d_model)
    assert mem.dtype == torch.float32
    _close(mem, _J_ENCODE(jparams, jnp.asarray(frames), cfg=jcfg), MODEL_TOL)


@pytest.mark.parametrize("case", ["prefill", "decode", "kv_valid_len"])
def test_cross_attention_matches_reference(case):
    """``cross_attention`` at Sq > 1 (one non-causal flash call), Sq = 1
    (one decode-attention call over every memory slot) and with a
    ``kv_valid_len`` at both, against the reference's, GQA 2, fp32."""
    rng = np.random.default_rng(7)
    B, Skv, H, K, hd = 2, 50, 4, 2, 32
    k = rng.standard_normal((B, Skv, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, Skv, K, hd)).astype(np.float32)
    sqs = {"prefill": (24,), "decode": (1,), "kv_valid_len": (24, 1)}[case]
    kw = {"kv_valid_len": 19} if case == "kv_valid_len" else {}
    for sq in sqs:
        q = rng.standard_normal((B, sq, H, hd)).astype(np.float32)
        got = t_attn.cross_attention(_t(q), _t(k), _t(v), **kw)
        want = j_attn.cross_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), **kw)
        assert tuple(got.shape) == (B, sq, H, hd)
        _close(got, want, FP32_TOL)
