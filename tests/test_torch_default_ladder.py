"""The paper's default ladder on the port against the JAX package, on the
CPU, at CI widths (vocab 256, max_len 32, d_model 32, 2 heads, 1 layer,
d_ff 64; 512 hashed features; 48 items).

* Students: ``tinytf`` / ``mlp`` logits on the reference's own params
  (bridged) to rtol 1e-5 / atol 1e-6; gradients of the weighted losses to
  rtol 1e-4 / atol 1e-6; ``tinytf_large``'s widths and an all-pad row;
  the FLOP model exactly.
* ``OnlineCascade`` and ``BatchedCascadeEngine`` (S = 8, both update
  modes) on ``lr -> tinytf``, from the reference engine's state: routing
  identical on every item and lane, learned state to rtol 1e-4 / atol
  1e-5 — plain, under ``sample_actions`` and under a ``hard_budget`` that
  runs out mid-stream.  S = 1 is bitwise the port's ``OnlineCascade``
  with the budget and sampled actions on.
* ``ModelExpert``: labels equal to the reference expert's on its own
  trained params; the training loop from the reference's initial params
  within rtol 1e-4 / atol 1e-5 of the reference's loop.
* ``episode_cost`` / ``policy_value`` to 1e-6; ``OnlineEnsemble``:
  identical predictions and expert calls, ``theta`` within 1e-5.
* The serve CLI on ``--device cpu`` with ``--ladder default``.
"""
import io
from contextlib import redirect_stdout
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
from repro.core import mdp as JM  # noqa: E402
from repro.core.experts import train_model_expert as j_train_model_expert  # noqa: E402
from repro.data import features as JF  # noqa: E402
from repro.data import make_stream as j_make_stream  # noqa: E402
from repro.metrics import costs as JC  # noqa: E402
from repro.models import students as JS  # noqa: E402
from repro.optim import adam as j_adam  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro_torch.bridge import load_level_state, to_numpy, to_torch  # noqa: E402
from repro_torch.core import mdp as PM  # noqa: E402
from repro_torch.core.cascade import _grads  # noqa: E402
from repro_torch.core.experts import train_tinytf  # noqa: E402
from repro_torch.data import make_stream  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.metrics import costs as PC  # noqa: E402
from repro_torch.models import students as PS  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from test_torch_engine import (_assert_same_routing, _assert_state_close,  # noqa: E402
                               _bridge)

N_ITEMS = 48
CPU = torch.device("cpu")
LOGIT_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
TF_KW = dict(vocab=256, max_len=32, d_model=32, n_heads=2, n_layers=1,
             d_ff=64)
MLP_KW = dict(n_features=512, hidden=64, n_layers=2)
# the hard budget of the budget variants: it runs out within the first
# third of the 48-item stream, inside a tick at S = 8 in both update
# modes (which then call the expert 8 + 8 and 8 + 3 times in ticks 1-2)
BUDGET = 10
VARIANTS = {"plain": {}, "sampled": {"sample_actions": True},
            "budget": {"hard_budget": BUDGET}}


def _jit(fn, *static):
    """The reference function jitted (op-by-op JAX is ~10x slower here)."""
    return jax.jit(fn, static_argnums=static)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, **tol):
    for a, b in zip(tree_leaves(to_numpy(got)),
                    jax.tree_util.tree_leaves(_np_tree(want))):
        np.testing.assert_allclose(a, b, **tol)


def _tokens(rng, B, L, vocab):
    """Hashed ids with pads at the end of each row, and one all-pad row."""
    tok = rng.integers(1, vocab, (B, L)).astype(np.int32)
    for b, n in enumerate(rng.integers(0, L + 1, B)):
        tok[b, n:] = 0
    tok[-1] = 0
    return tok


def _with_head(params, rng, d, C):
    """The reference's params with a random classifier head in place of
    its zero init (whose body gradients are exactly zero), at about the
    size the head reaches in serving: ~15 adam steps of lr 1e-3, each
    weight ~0.015, i.e. 0.1x the fan-in std of the other dense weights."""
    p = dict(_np_tree(params))
    p["cls_w"] = (rng.standard_normal((d, C)) * 0.1 * d ** -0.5
                  ).astype(np.float32)
    p["cls_b"] = (rng.standard_normal((C,)) * 0.01).astype(np.float32)
    return p


# ---------------------------------------------------------------------------
# students
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("large", [False, True])
def test_tinytf_logits_and_grads_match(large):
    spec_kw = dict(TF_KW, n_classes=3)
    if large:       # tinytf_large: d_model x 2, n_layers + 2, d_ff x 2
        spec_kw.update(d_model=64, n_layers=3, d_ff=128)
    jspec, pspec = JS.TinyTFSpec(**spec_kw), PS.TinyTFSpec(**spec_kw)
    rng = np.random.default_rng(1 + large)
    p_np = _with_head(_jit(JS.tinytf_init, 1)(jax.random.PRNGKey(3), jspec),
                      rng, jspec.d_model, 3)
    params = to_torch(p_np, CPU)
    # the port's own init has the reference's layout, shapes and dtypes
    own = PS.tinytf_init(torch.Generator().manual_seed(0), pspec, CPU)
    assert [(t.shape, t.dtype) for t in tree_leaves(own)] == \
        [(t.shape, t.dtype) for t in tree_leaves(params)]
    tok = _tokens(rng, 6, 32, 256)
    got = PS.tinytf_logits(params, torch.from_numpy(tok), pspec)
    want = _jit(JS.tinytf_logits, 2)(p_np, jnp.asarray(tok), jspec)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    # the all-pad row pools nothing: its logits are the head's bias
    np.testing.assert_allclose(got[-1].numpy(), p_np["cls_b"], **LOGIT_TOL)
    y = rng.integers(0, 3, 6).astype(np.int32)
    w = np.array([1, 1, 1, 0, 1, 1], np.float32)   # a padded lane: w 0
    g = _grads(lambda p, *a: PS.tinytf_loss_weighted(p, *a, pspec), params,
               torch.from_numpy(tok), torch.from_numpy(y),
               torch.from_numpy(w))
    gj = _jit(jax.grad(JS.tinytf_loss_weighted), 4)(
        p_np, jnp.asarray(tok), jnp.asarray(y), jnp.asarray(w), jspec)
    _close(g, gj, **GRAD_TOL)
    np.testing.assert_allclose(
        float(PS.tinytf_loss(params, torch.from_numpy(tok),
                             torch.from_numpy(y), pspec)),
        float(_jit(JS.tinytf_loss, 3)(p_np, jnp.asarray(tok),
                                      jnp.asarray(y), jspec)), **LOGIT_TOL)


def test_mlp_and_lr_match():
    jspec, pspec = JS.MLPSpec(**MLP_KW), PS.MLPSpec(**MLP_KW)
    rng = np.random.default_rng(5)
    p_np = _np_tree(_jit(JS.mlp_init, 1)(jax.random.PRNGKey(1), jspec))
    p_np["cls_w"] = rng.standard_normal((64, 2)).astype(np.float32)
    params = to_torch(p_np, CPU)
    own = PS.mlp_init(torch.Generator().manual_seed(0), pspec, CPU)
    assert [(t.shape, t.dtype) for t in tree_leaves(own)] == \
        [(t.shape, t.dtype) for t in tree_leaves(params)]
    x = np.stack([JF.hash_bow(rng.integers(0, 9999, 40), 512)
                  for _ in range(5)]).astype(np.float32)
    y = rng.integers(0, 2, 5).astype(np.int32)
    w = rng.uniform(0.0, 2.0, 5).astype(np.float32)
    xt, yt, wt = (torch.from_numpy(a) for a in (x, y, w))
    np.testing.assert_allclose(
        PS.mlp_logits(params, xt).numpy(),
        np.asarray(_jit(JS.mlp_logits)(p_np, jnp.asarray(x))), **LOGIT_TOL)
    _close(_grads(PS.mlp_loss_weighted, params, xt, yt, wt),
           _jit(jax.grad(JS.mlp_loss_weighted))(
               p_np, jnp.asarray(x), jnp.asarray(y), jnp.asarray(w)),
           **GRAD_TOL)
    lr_np = {"w": rng.standard_normal((512, 2)).astype(np.float32),
             "b": rng.standard_normal((2,)).astype(np.float32)}
    np.testing.assert_allclose(
        float(PS.lr_loss(to_torch(lr_np, CPU), xt, yt)),
        float(JS.lr_loss(lr_np, jnp.asarray(x), jnp.asarray(y))),
        **LOGIT_TOL)


def test_flop_model_and_default_config_equal():
    for kw in (TF_KW, {}, dict(d_model=256, n_layers=4, d_ff=1024)):
        for train in (False, True):
            assert PC.tinytf_flops(PS.TinyTFSpec(**kw), train) == \
                JC.tinytf_flops(JS.TinyTFSpec(**kw), train)
    for kw in (MLP_KW, {}):
        assert PC.mlp_flops(PS.MLPSpec(**kw)) == \
            JC.mlp_flops(JS.MLPSpec(**kw))
    for large in (False, True):
        a = P.default_cascade_config(3, mu=2e-7, large=large, seed=4)
        b = J.default_cascade_config(3, mu=2e-7, large=large, seed=4)
        assert [vars(x) for x in a.levels] == [vars(x) for x in b.levels]
        assert vars(a.tf_spec) == vars(b.tf_spec)
        assert (a.mu, a.expert_cost, a.seed, a.n_classes) == \
            (b.mu, b.expert_cost, b.seed, b.n_classes)
    # tinytf_large's level builds at the reference's widths
    cfg = replace(P.default_cascade_config(2, large=True),
                  tf_spec=PS.TinyTFSpec(**TF_KW), n_features=512)
    eng = P.OnlineCascade(cfg, None, device="cpu")
    big = eng.levels[2].sspec
    assert (big.d_model, big.n_layers, big.d_ff) == (64, 3, 128)


# ---------------------------------------------------------------------------
# the engines on lr -> tinytf
# ---------------------------------------------------------------------------
def _levels(mod):
    """The default ladder with a DAgger schedule that decays within the
    stream, so the students answer and every gate moves."""
    return (
        mod.LevelSpec(kind="lr", cost=1.0, cache_size=8, batch_size=8,
                      student_lr=0.5, beta_decay=0.9,
                      calibration_factor=0.4),
        mod.LevelSpec(kind="tinytf", cost=550.0, cache_size=8,
                      batch_size=4, student_lr=1e-3, beta_decay=0.9,
                      calibration_factor=0.3))


def _cfgs(**kw):
    common = dict(n_classes=2, expert_cost=1e6, mu=3e-6, n_features=512,
                  seed=0, **kw)
    return (J.CascadeConfig(levels=_levels(J),
                            tf_spec=JS.TinyTFSpec(**TF_KW), **common),
            P.CascadeConfig(levels=_levels(P),
                            tf_spec=PS.TinyTFSpec(**TF_KW), **common))


def _streams(n=N_ITEMS):
    return (j_make_stream("hatespeech", seed=0, n_samples=n),
            make_stream("hatespeech", seed=0, n_samples=n))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_online_cascade_matches_jax(variant):
    jcfg, pcfg = _cfgs(**VARIANTS[variant])
    js, ps = _streams()
    je = J.OnlineCascade(jcfg, J.SimulatedExpert(js))
    pe = P.OnlineCascade(pcfg, P.SimulatedExpert(ps), device="cpu")
    _bridge(je, pe)
    jm, pm = je.run(js), pe.run(ps)
    _assert_same_routing(je.history, pe.history)
    assert jm["expert_calls"] == pm["expert_calls"]
    assert jm["level_fractions"] == pm["level_fractions"]
    assert 0 < pm["expert_calls"] < N_ITEMS
    levels = np.asarray(pe.history["level"])
    assert (levels == 0).any()
    if variant == "sampled":
        # the transformer's gate starts open (dprob ~0.88): only sampled
        # actions let it answer within the stream
        assert (levels == 1).any()
    if variant == "budget":
        # spent mid-stream; from then on the last student answers what
        # it would have deferred
        called = np.flatnonzero(pe.history["expert_called"])
        assert pm["expert_calls"] == BUDGET and called[-1] < N_ITEMS - 8
    for jl, pl in zip(je.levels, pe.levels):
        assert (jl.cache_n, jl.cache_ptr) == (pl.cache_n, pl.cache_ptr)
        assert np.array_equal(jl.cache_x, pl.cache_x)
        assert jl.beta == pl.beta
    np.testing.assert_allclose(pe.total_cost, je.total_cost, rtol=1e-12)
    _assert_state_close(je, pe)


@pytest.mark.parametrize("updates", ["single", "scaled"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_batched_s8_matches_jax(variant, updates):
    jcfg, pcfg = _cfgs(**VARIANTS[variant])
    js, ps = _streams()
    je = J.BatchedCascadeEngine(jcfg, J.SimulatedExpert(js), n_streams=8,
                                updates_per_tick=updates)
    pe = P.BatchedCascadeEngine(pcfg, P.SimulatedExpert(ps), n_streams=8,
                                updates_per_tick=updates, device="cpu")
    _bridge(je, pe)
    jm, pm = je.run(js), pe.run(ps)
    _assert_same_routing(je.history, pe.history)
    assert np.array_equal(jm["predictions"], pm["predictions"])
    assert jm["expert_calls"] == pm["expert_calls"]
    np.testing.assert_allclose(pe.total_cost, je.total_cost, rtol=1e-12)
    levels = np.concatenate([np.asarray(x) for x in pe.history["level"]])
    assert (levels < len(pe.levels)).any()      # students answer too
    fallbacks = pe.levels[-1].forwards_by_batch.get(1, 0)
    if variant == "budget":
        # the budget ran out inside a tick: at least one deferred lane
        # overflowed to the last student's single-item fallback forward
        assert pm["expert_calls"] == BUDGET and fallbacks >= 1
    else:
        assert fallbacks == 0
    assert pe._cache_n == je._cache_n and pe._cache_ptr == je._cache_ptr
    _assert_state_close(je, pe)


def test_batched_s1_is_bitwise_online_cascade_under_budget_and_sampling():
    _, pcfg = _cfgs(sample_actions=True, hard_budget=BUDGET)
    _, ps = _streams()
    seq = P.OnlineCascade(pcfg, P.SimulatedExpert(ps), device="cpu")
    bat = P.BatchedCascadeEngine(pcfg, P.SimulatedExpert(ps), n_streams=1,
                                 device="cpu")
    ms, mb = seq.run(ps), bat.run(ps)
    assert np.array_equal(ms["predictions"], mb["predictions"])
    assert ms["expert_calls"] == mb["expert_calls"] == BUDGET
    assert ms["total_cost_units"] == mb["total_cost_units"]
    _assert_same_routing(seq.history, bat.history)
    for a, b in zip(seq.levels, bat.levels):
        assert a.forwards == b.forwards
        for attr in P.STATE_ATTRS:
            for x, y in zip(tree_leaves(getattr(a, attr)),
                            tree_leaves(getattr(b, attr))):
                assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the model expert
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def expert_setup():
    js, ps = _streams(64)
    jx = j_train_model_expert(js, 2, d_model=32, n_layers=1, epochs=8,
                              batch=16, seed=3)
    pspec = PS.TinyTFSpec(d_model=32, n_layers=1, d_ff=128, n_classes=2)
    return js, ps, jx, pspec


def test_model_expert_labels_match(expert_setup):
    js, ps, jx, pspec = expert_setup
    px = P.ModelExpert(params=to_torch(_np_tree(jx.params), CPU),
                       spec=pspec, workers=2, device="cpu")
    try:
        idxs = list(range(len(ps)))
        want = np.asarray(jx.label_batch(idxs, js.docs))
        assert len(set(want.tolist())) == 2      # not a constant labeller
        assert np.array_equal(px.label_batch(idxs, ps.docs), want)
        ticket = px.submit_many(idxs, ps.docs)
        assert np.array_equal(px.poll(ticket), want)
        assert np.array_equal(px.poll(px.submit(idxs[:5], ps.docs[:5])),
                              want[:5])
        assert all(px.label(i, ps.docs[i]) == want[i] for i in (0, 7, 33))
    finally:
        px.close()
    # the process backend's spawned children label as the thread pool does
    pp = P.ModelExpert(params=px.params, spec=pspec, workers=2,
                       backend="process", device="cpu")
    try:
        assert np.array_equal(pp.poll(pp.submit_many(idxs[:12],
                                                     ps.docs[:12])),
                              want[:12])
    finally:
        pp.close()
    # workers="auto" hands the width to the engine: a fleet of 1 to start
    pa = P.ModelExpert(params=px.params, spec=pspec, workers="auto",
                       device="cpu")
    assert pa.auto_workers and pa.workers == 1


def test_expert_training_loop_matches_reference(expert_setup):
    js, _, _, pspec = expert_setup
    jspec = JS.TinyTFSpec(d_model=32, n_layers=1, d_ff=128, n_classes=2)
    init = _jit(JS.tinytf_init, 1)(jax.random.PRNGKey(3), jspec)
    ids = np.stack([JF.hash_ids(d, 4096, 128) for d in js.docs[:48]])
    labels = js.labels[:48]
    # the reference's own loop (core/experts.py train_model_expert)
    opt = j_adam(1e-3)

    @jax.jit
    def step(params, state, xb, yb):
        grads = jax.grad(lambda p: JS.tinytf_loss(p, xb, yb, jspec))(params)
        return opt.step(params, grads, state)

    params, state = init, opt.init(init)
    rng = np.random.default_rng(3)
    order = rng.permutation(48)
    for s in range(0, 48 - 16 + 1, 16):
        sel = order[s:s + 16]
        params, state = step(params, state, jnp.asarray(ids[sel]),
                             jnp.asarray(labels[sel]))
    got = train_tinytf(to_torch(_np_tree(init), CPU), pspec, ids, labels,
                       epochs=1, batch=16, lr=1e-3, seed=3)
    _close(got, params, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# MDP terms and the ensemble baseline
# ---------------------------------------------------------------------------
def test_episode_cost_and_policy_value_match():
    rng = np.random.default_rng(9)
    f = rng.uniform(0, 1, (5, 3)).astype(np.float32)
    f[:, -1] = 0.0
    losses = rng.uniform(0, 3, (5, 3)).astype(np.float32)
    c = np.array([550.0, 1e6, 0.0], np.float32)
    cost, reach = PM.episode_cost(torch.from_numpy(f[0]),
                                  torch.from_numpy(losses[0]),
                                  torch.from_numpy(c), 2e-6)
    jcost, jreach = JM.episode_cost(jnp.asarray(f[0]),
                                    jnp.asarray(losses[0]),
                                    jnp.asarray(c), 2e-6)
    np.testing.assert_allclose(float(cost), float(jcost), rtol=1e-6)
    np.testing.assert_allclose(reach.numpy(), np.asarray(jreach), rtol=1e-6)
    np.testing.assert_allclose(
        float(PM.policy_value(torch.from_numpy(f), torch.from_numpy(losses),
                              torch.from_numpy(c), 2e-6)),
        float(JM.policy_value(jnp.asarray(f), jnp.asarray(losses),
                              jnp.asarray(c), 2e-6)), rtol=1e-6)


@pytest.mark.parametrize("hard_budget", [None, 6])
def test_online_ensemble_matches_jax(hard_budget):
    jcfg, pcfg = _cfgs()
    js, ps = _streams()
    je = J.OnlineEnsemble(jcfg, J.SimulatedExpert(js),
                          expert_prob_decay=0.9)
    pe = P.OnlineEnsemble(pcfg, P.SimulatedExpert(ps),
                          expert_prob_decay=0.9, device="cpu")
    for jl, pl in zip(je.levels, pe.levels):
        load_level_state(pl, _np_tree(jl.state_tree()))
    for i in range(N_ITEMS):
        a = je.process(i, js.docs[i], hard_budget)
        b = pe.process(i, ps.docs[i], hard_budget)
        assert (a["prediction"], a["expert_called"]) == \
            (b["prediction"], b["expert_called"]), f"item {i}"
        np.testing.assert_allclose(pe.theta, je.theta, atol=1e-5,
                                   err_msg=f"item {i}")
    assert 0 < pe.expert_calls < N_ITEMS
    if hard_budget is not None:
        assert pe.expert_calls == hard_budget


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def _cli(argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        serve.main(argv)
    return buf.getvalue()


@pytest.mark.parametrize("argv", [
    ["--expert", "simulated", "--samples", "48", "--batch", "16"],
    ["--expert", "simulated", "--samples", "48", "--engine", "sequential"],
    ["--expert", "model", "--samples", "32", "--batch", "8"],
], ids=["batched", "sequential", "model-expert"])
def test_serve_cli_default_ladder(argv):
    out = _cli(["--device", "cpu", "--ladder", "default", "--dataset",
                "imdb", "--log-every", "0"] + argv)
    n = argv[argv.index("--samples") + 1]
    assert f"served {n} queries" in out and "ladder=default" in out, out
    assert "accuracy=" in out and "level fractions:" in out, out
    if "sequential" in argv:
        assert "probe mispredicts (single-call fallbacks)=0" in out, out
    if "model" in argv:
        assert "expert trained in" in out, out
