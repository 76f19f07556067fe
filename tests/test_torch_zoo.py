"""The port's zoo serving path vs the JAX package's on the CPU.

This file holds Mixtral-8x22B's path (the other decoder-only
architectures: ``tests/test_torch_zoo_archs.py``).  Inputs are made
with numpy from a seed and handed to both packages; the whole-model runs
start from the reference's own ``init_params(PRNGKey(0))`` through
``bridge.load_zoo_params``.  Tolerances, each with its reason:

* routing (``top_idx``), the dispatch one-hot and greedy tokens: equal;
* fp32 layers and MoE: 1e-5 (the same fp32 arithmetic in another
  summation order);
* the fp32 whole model: 1e-4 on logits and caches (two layers of
  products over d_model 128 and d_ff 256, and attention in another
  schedule: the reference's chunked/banded jnp scan, here one masked
  softmax);
* the bf16 whole model: 6e-2, the tolerance ``tests/test_archs_smoke.py``
  gives the reference's own prefill/decode paths against each other.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as j_base  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_smoke_config as j_get_smoke  # noqa: E402
from repro.data.streams import lm_batches as j_lm_batches  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import base as t_base  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.configs import list_architectures  # noqa: E402
from repro_torch.data import lm_batches  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ARCH = "mixtral-8x22b"
FP32_TOL = 1e-5
MODEL_TOL = 1e-4
BF16_TOL = 6e-2


def _np(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _fp32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# configs and data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["ModelConfig", "AttnConfig", "MoEConfig",
                                  "SSMConfig", "EncoderConfig"])
def test_config_field_defaults_match_reference(name):
    """Every field the port has is the reference's, with its default (the
    port's ModelConfig.dtype once defaulted to float32)."""
    mine = {f.name: f for f in dataclasses.fields(getattr(t_base, name))}
    ref = {f.name: f for f in dataclasses.fields(getattr(j_base, name))}
    assert set(mine) <= set(ref), set(mine) - set(ref)
    for n, f in mine.items():
        assert f.default == ref[n].default, n
        assert f.default_factory == ref[n].default_factory, n
    # the order of the required (positional) fields is the reference's
    assert [n for n in ref if n in mine] == list(mine)
    assert t_base.ModelConfig.__dataclass_fields__["dtype"].default \
        == "bfloat16"


@pytest.mark.parametrize("smoke", [False, True])
def test_mixtral_config_is_the_reference(smoke):
    get_t = get_smoke_config if smoke else get_config
    get_j = j_get_smoke if smoke else j_get_config
    mine, ref = get_t(ARCH), get_j(ARCH)
    for f in dataclasses.fields(mine):
        a, b = getattr(mine, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(a):
            # the port's sub-configs hold the fields it reads; the rest
            # of the reference's stay at their defaults in this config
            ref_fields = dataclasses.asdict(b)
            assert dataclasses.asdict(a) == {
                k: ref_fields[k] for k in dataclasses.asdict(a)}, f.name
            for g in dataclasses.fields(b):
                if g.name not in ref_fields or hasattr(a, g.name):
                    continue
                assert getattr(b, g.name) == g.default, (f.name, g.name)
        else:
            assert a == b, f.name
    assert mine.n_periods == ref.n_periods
    assert mine.torch_dtype == torch.bfloat16
    # all ten of the zoo's architectures, the CROSS ones included
    assert list_architectures() == sorted([
        ARCH, "jamba-1.5-large-398b", "mamba2-370m", "internlm2-1.8b",
        "qwen3-8b", "h2o-danube-3-4b", "llama3-405b", "dbrx-132b",
        "seamless-m4t-medium", "llama-3.2-vision-11b"])


@pytest.mark.parametrize("seed", [0, 3])
def test_lm_batches_bit_exact(seed):
    mine = list(lm_batches(512, 2, 48, 2, seed=seed))
    ref = list(j_lm_batches(512, 2, 48, 2, seed=seed))
    assert len(mine) == len(ref) == 2
    for a, b in zip(mine, ref):
        for k in ("tokens", "targets"):
            assert a[k].dtype == b[k].dtype
            assert np.array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# layers and attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bf16", [False, True])
def test_rope_matches(bf16):
    rng = np.random.default_rng(11)
    x = _np(rng, 2, 24, 4, 32)
    pos = np.arange(100, 124, dtype=np.int32)
    tdt = torch.bfloat16 if bf16 else torch.float32
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    got = t_attn.rope(_t(x, tdt), _t(pos), 1_000_000.0)
    want = j_attn.rope(jnp.asarray(x, jdt), jnp.asarray(pos), 1_000_000.0)
    assert got.dtype == tdt
    _close(got, want, 2 ** -7 if bf16 else FP32_TOL)


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norms_match(norm):
    cfg = dataclasses.replace(get_smoke_config(ARCH), norm=norm)
    jcfg = dataclasses.replace(j_get_smoke(ARCH), norm=norm)
    rng = np.random.default_rng(12)
    x = _np(rng, 2, 8, cfg.d_model, scale=3.0)
    p = {"scale": _np(rng, cfg.d_model)}
    if norm == "layernorm":
        p["bias"] = _np(rng, cfg.d_model)
    got = t_layers.apply_norm({k: _t(v) for k, v in p.items()}, _t(x), cfg)
    want = j_layers.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                               jnp.asarray(x), jcfg)
    _close(got, want, FP32_TOL)
    got = t_layers.rms_norm_headwise(_t(x), _t(p["scale"]))
    want = j_layers.rms_norm_headwise(jnp.asarray(x), jnp.asarray(p["scale"]))
    _close(got, want, FP32_TOL)


@pytest.mark.parametrize("S,window", [(32, None), (32, 64), (64, 16),
                                      (48, 7)])
def test_prefill_attention_matches(S, window):
    """Full causal, a window longer than S, and windows below S/2, where
    the reference takes its banded ``swa_prefill_attention`` path."""
    rng = np.random.default_rng(13 + S)
    q, k, v = _np(rng, 2, S, 4, 32), _np(rng, 2, S, 2, 32), \
        _np(rng, 2, S, 2, 32)
    chunk = 16
    got = t_attn.prefill_attention(_t(q), _t(k), _t(v), window=window,
                                   chunk=chunk)
    want = j_attn.prefill_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), window=window,
                                    chunk=chunk)
    _close(got, want, FP32_TOL)


@pytest.mark.parametrize("W,window,pos", [(16, 64, 9), (16, 16, 40),
                                          (32, None, 31)])
def test_ring_decode_attention_matches(W, window, pos):
    """One token over a ring cache, partly empty or wrapped."""
    rng = np.random.default_rng(14 + W + pos)
    q = _np(rng, 2, 1, 4, 32)
    k, v = _np(rng, 2, W, 2, 32), _np(rng, 2, W, 2, 32)
    # ring slots: positions max(0, pos-W+1)..pos at slot p % W, -1 elsewhere
    cpos = np.full((W,), -1, np.int32)
    for p in range(max(0, pos - W + 1), pos + 1):
        cpos[p % W] = p
    got = t_attn.ring_decode_attention(_t(q), _t(k), _t(v),
                                       kv_positions=_t(cpos), q_position=pos,
                                       window=window)
    want = j_attn.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_positions=jnp.asarray([pos], jnp.int32),
        kv_positions=jnp.asarray(cpos), causal=True, window=window)
    _close(got, want, FP32_TOL)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 5),
                                           (False, None), (False, 3)])
def test_mask_matches(causal, window):
    q_pos = np.arange(4, 12, dtype=np.int32)
    kv_pos = np.array([-1, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, -1],
                      np.int32)
    got = t_attn._mask(_t(q_pos), _t(kv_pos), causal, window)
    want = j_attn._mask(jnp.asarray(q_pos), jnp.asarray(kv_pos), causal,
                        window)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_ring_longer_than_window_attends_to_the_window():
    """A ring of 16 slots under a window of 8: the slots at or before
    q_pos - 8 are masked, as the reference's window mask does (and a slot
    after the query position, as its causal mask does)."""
    rng = np.random.default_rng(21)
    q = _np(rng, 2, 1, 4, 32)
    k, v = _np(rng, 2, 16, 2, 32), _np(rng, 2, 16, 2, 32)
    pos = 29
    cpos = np.full((16,), -1, np.int32)
    for p in range(pos - 15, pos + 1):
        cpos[p % 16] = p
    cpos[3] = pos + 2                 # a slot the causal mask drops
    got = t_attn.ring_decode_attention(_t(q), _t(k), _t(v),
                                       kv_positions=_t(cpos), q_position=pos,
                                       window=8)
    want = j_attn.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_positions=jnp.asarray([pos], jnp.int32),
        kv_positions=jnp.asarray(cpos), causal=True, window=8)
    _close(got, want, 1e-5)
    # the window is what changed the answer: the whole ring differs
    whole = t_attn.ring_decode_attention(_t(q), _t(k), _t(v),
                                         kv_positions=_t(cpos),
                                         q_position=pos, window=None)
    assert not torch.allclose(got, whole, atol=1e-3)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------
def _moe_inputs(cfg, T, seed, skew=3.0):
    rng = np.random.default_rng(seed)
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.num_experts
    x = _np(rng, T, d)
    p = {"router": _np(rng, d, e, scale=skew * d ** -0.5),
         "w_in": _np(rng, e, d, f, scale=d ** -0.5),
         "w_gate": _np(rng, e, d, f, scale=d ** -0.5),
         "w_out": _np(rng, e, f, d, scale=f ** -0.5)}
    return x, p


@pytest.mark.parametrize("T", [64, 4096])
def test_route_and_dispatch_equal(T):
    """Top-k indices and the dispatch one-hot are equal, with tokens
    dropped at capacity_factor 1.25; T = 4096 is two MOE_GROUPs."""
    cfg, jcfg = _fp32(get_smoke_config(ARCH)), _fp32(j_get_smoke(ARCH))
    x, p = _moe_inputs(cfg, T, 15)
    G = min(T, t_moe.MOE_GROUP)
    cap = t_moe.capacity_for(G, cfg)
    assert cap == j_moe.capacity_for(G, jcfg)
    dropped = 0
    for g0 in range(0, T, G):
        xg = x[g0:g0 + G]
        idx, w, aux = t_moe.route(_t(xg), _t(p["router"]), cfg)
        jidx, jw, jaux = j_moe.route(jnp.asarray(xg),
                                     jnp.asarray(p["router"]), jcfg)
        assert np.array_equal(idx.numpy(), np.asarray(jidx))
        _close(w, jw, FP32_TOL)
        _close(aux, jaux, FP32_TOL)
        disp, comb = t_moe._dispatch_combine(idx, w, G, cap, cfg)
        jdisp, jcomb = j_moe._dispatch_combine(jidx, jw, G, cap, jcfg)
        assert np.array_equal(disp.numpy(), np.asarray(jdisp))
        _close(comb, jcomb, FP32_TOL)
        dropped += G * cfg.moe.top_k - int(disp.sum())
    if T == 64:
        assert dropped > 0      # the capacity really drops tokens here


@pytest.mark.parametrize("T", [64, 4096])
def test_moe_ffn_local_matches(T):
    cfg, jcfg = _fp32(get_smoke_config(ARCH)), _fp32(j_get_smoke(ARCH))
    x, p = _moe_inputs(cfg, T, 16)
    y, aux = t_moe.moe_ffn_local(_t(x), {k: _t(v) for k, v in p.items()},
                                 cfg)
    jy, jaux = j_moe.moe_ffn_local(jnp.asarray(x),
                                   {k: jnp.asarray(v) for k, v in p.items()},
                                   jcfg)
    _close(y, jy, FP32_TOL)
    _close(aux, jaux, FP32_TOL)
    y3, aux3 = t_moe.moe_ffn(_t(x).reshape(2, T // 2, -1),
                             {k: _t(v) for k, v in p.items()}, cfg)
    assert torch.equal(y3.reshape(T, -1), y) and torch.equal(aux3, aux)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------
def _reference_model(jcfg):
    params = j_tf.init_params(jax.random.PRNGKey(0), jcfg)
    return params, jax.tree.map(np.asarray, params)


_J_PREFILL = jax.jit(j_tf.prefill, static_argnames=("cfg",))
_J_DECODE = jax.jit(j_tf.decode_step, static_argnames=("cfg",))


def _serve_both(cfg, jcfg, tokens, n_decode, tol, greedy_equal):
    jparams, tree = _reference_model(jcfg)
    params = bridge.load_zoo_params(tree, cfg, "cpu")
    S = tokens.shape[1]
    last, cache = t_tf.prefill(params, {"tokens": _t(tokens)}, cfg)
    jlast, jcache = _J_PREFILL(jparams, {"tokens": jnp.asarray(tokens)},
                               cfg=jcfg)
    _close(last, jlast, tol)
    for name in ("k", "v", "pos"):
        _close(cache["b0"][name], jcache["b0"][name], tol)
    assert cache["b0"]["pos"].dtype == torch.int32
    tok, jtok = last.argmax(-1), np.asarray(jnp.argmax(jlast, -1))
    for step in range(n_decode):
        if greedy_equal:
            assert np.array_equal(tok.numpy(), jtok), step
        pos = S + step
        logits, cache = t_tf.decode_step(params, cache, _t(jtok)[:, None],
                                         pos, cfg)
        jlogits, jcache = _J_DECODE(
            jparams, jcache, jnp.asarray(jtok)[:, None], jnp.int32(pos),
            cfg=jcfg)
        _close(logits, jlogits, tol)
        for name in ("k", "v", "pos"):
            _close(cache["b0"][name], jcache["b0"][name], tol)
        tok, jtok = logits.argmax(-1), np.asarray(jnp.argmax(jlogits, -1))
    if greedy_equal:
        assert np.array_equal(tok.numpy(), jtok)


def test_model_fp32_matches_reference():
    """Prefill logits and caches and 4 greedy decode steps (the ring of
    32 slots wraps) at mixtral-8x22b-smoke in fp32."""
    cfg, jcfg = _fp32(get_smoke_config(ARCH)), _fp32(j_get_smoke(ARCH))
    tokens = next(lm_batches(cfg.vocab, 2, 32, 1, seed=0))["tokens"]
    _serve_both(cfg, jcfg, tokens, 4, MODEL_TOL, greedy_equal=True)


def test_model_bf16_matches_reference():
    """The default dtype, at the loose tolerance the reference gives its
    own paths; tokens are the reference's greedy ones."""
    cfg, jcfg = get_smoke_config(ARCH), j_get_smoke(ARCH)
    tokens = next(lm_batches(cfg.vocab, 2, 32, 1, seed=1))["tokens"]
    _serve_both(cfg, jcfg, tokens, 2, BF16_TOL, greedy_equal=False)


def test_forward_matches_reference():
    cfg, jcfg = _fp32(get_smoke_config(ARCH)), _fp32(j_get_smoke(ARCH))
    jparams, tree = _reference_model(jcfg)
    params = bridge.load_zoo_params(tree, cfg, "cpu")
    tokens = next(lm_batches(cfg.vocab, 2, 16, 1, seed=2))["tokens"]
    logits, aux = t_tf.forward(params, {"tokens": _t(tokens)}, cfg)
    jlogits, jaux = j_tf.forward(jparams, {"tokens": jnp.asarray(tokens)},
                                 jcfg)
    _close(logits, jlogits, MODEL_TOL)
    _close(aux, jaux, MODEL_TOL)


def test_init_params_shapes_dtypes_and_stds():
    """The port's own init draws the reference's tree: same paths, shapes
    and dtypes, std within 10% of the reference's for the big leaves."""
    cfg = get_smoke_config(ARCH)
    mine = t_tf.init_params(torch.Generator().manual_seed(0), cfg)
    _, ref = _reference_model(j_get_smoke(ARCH))
    bridge._check_like(bridge.to_torch(ref, "cpu"), mine, "params")
    ref_t = bridge.to_torch(ref, "cpu")
    for a, b in zip(tree_leaves(mine), tree_leaves(ref_t)):
        if a.numel() >= 4096:
            sa, sb = float(a.float().std()), float(b.float().std())
            assert abs(sa - sb) <= 0.1 * sb
    # the full width on the meta device: the reference's parameter count
    # (which leaves out the final norm; 32768 needs no vocab padding)
    full = get_config(ARCH)
    meta = t_tf.init_params(None, full)
    n = sum(t.numel() for t in tree_leaves(meta))
    assert n == j_get_config(ARCH).param_count() + full.d_model
    assert {t.device.type for t in tree_leaves(meta)} == {"meta"}


def test_train_loss_and_remat_run_on_the_smoke_config():
    """``train_loss`` (remat on, its default) gives a finite loss whose
    gradient reaches every leaf, and ``forward(remat=True)`` is bitwise
    ``forward(remat=False)`` (the parity with the reference's loss and
    gradients: ``tests/test_torch_train.py``)."""
    cfg = _fp32(get_smoke_config(ARCH))
    params = t_tf.init_params(torch.Generator().manual_seed(0), cfg)
    batch = next(lm_batches(cfg.vocab, 2, 16, 1, seed=1))
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    loss, metrics = t_tf.train_loss(params, batch, cfg)
    assert bool(torch.isfinite(loss)) and float(metrics["aux"].detach()) > 0
    loss.backward()
    assert all(t.grad is not None and bool(torch.isfinite(t.grad).all())
               for t in leaves)
    with torch.no_grad():
        plain, aux = t_tf.forward(params, batch, cfg)
        remat, raux = t_tf.forward(params, batch, cfg, remat=True)
    assert torch.equal(plain, remat) and torch.equal(aux, raux)


def test_cross_smoke_model_initialises_and_encodes():
    """A CROSS model (seamless' smoke config) draws its tree from the
    port's own generator, encoder included, and ``encode`` returns the
    memory (B, S, d_model) in the model dtype."""
    cfg = get_smoke_config("seamless-m4t-medium")
    params = t_tf.init_params(torch.Generator().manual_seed(0), cfg)
    assert set(params["blocks"]["b0"]) >= {"attn", "norm_x", "cross_attn"}
    assert set(params["encoder"]) == {"blocks", "final_norm"}
    frames = torch.randn((2, 24, cfg.d_model),
                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        mem = t_tf.encode(params, frames, cfg)
    assert tuple(mem.shape) == (2, 24, cfg.d_model)
    assert mem.dtype == cfg.torch_dtype
    assert bool(torch.isfinite(mem.float()).all())


# ---------------------------------------------------------------------------
# bridge
# ---------------------------------------------------------------------------
def test_load_zoo_params_round_trip_is_bit_exact():
    """bf16 leaves (numpy dtype ml_dtypes.bfloat16) and fp32 leaves arrive
    with the same bits."""
    cfg = get_smoke_config(ARCH)
    jparams, tree = _reference_model(j_get_smoke(ARCH))
    params = bridge.load_zoo_params(tree, cfg, "cpu")
    pairs = list(zip(tree_leaves(params), jax.tree.leaves(jparams)))
    assert {a.dtype for a, _ in pairs} == {torch.bfloat16, torch.float32}
    for a, b in pairs:
        b = np.asarray(b)
        if a.dtype == torch.bfloat16:
            assert np.array_equal(a.view(torch.int16).numpy(),
                                  b.view(np.int16))
        else:
            assert np.array_equal(a.numpy(), b)


def test_load_zoo_params_rejects_wrong_trees():
    cfg = get_smoke_config(ARCH)
    _, tree = _reference_model(j_get_smoke(ARCH))

    def edited(fn):
        t = jax.tree.map(lambda a: a, tree)
        fn(t)
        return t

    bad_path = edited(lambda t: t["blocks"]["b0"]["moe"].pop("w_gate"))
    with pytest.raises(ValueError, match=r"params\.blocks\.b0\.moe"):
        bridge.load_zoo_params(bad_path, cfg, "cpu")
    bad_shape = edited(lambda t: t["embed"].update(
        table=t["embed"]["table"][:-1]))
    with pytest.raises(ValueError, match=r"params\.embed\.table"):
        bridge.load_zoo_params(bad_shape, cfg, "cpu")
    bad_dtype = edited(lambda t: t["final_norm"].update(
        scale=t["final_norm"]["scale"].astype(np.float64)))
    with pytest.raises(ValueError, match=r"params\.final_norm\.scale"):
        bridge.load_zoo_params(bad_dtype, cfg, "cpu")
