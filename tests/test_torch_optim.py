"""The port's optimizers vs the JAX package's on the CPU.

Every optimizer the reference has (``sgd``, ``momentum``, ``adam``,
``adamw``, ``ogd_sqrt_t``, with and without ``clip=``, the Adams also
with bfloat16 moments) takes three ``step``s and one ``step_k`` (k =
2.5) on the same tree in both packages: fp32 and bf16 leaves, nested
dicts, gradients from a seeded numpy generator.  Tolerances: fp32
parameters and state 1e-6 absolute and relative (the same fp32
operations in the same order; measured equal); bf16 leaves one bf16 ulp
(2^-8 relative: a 1-ulp fp32 difference may round the other way).  The
cascade's ``adam`` and ``ogd_sqrt_t`` must be bitwise what they were
before ``clip=`` / ``state_dtype=`` / ``adamw`` came (a frozen copy of
that code is below), and an Adam leaf updated in slices must be bitwise
the leaf updated whole.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import optimizers as J  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.optim import optimizers as T  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

FP32_TOL = 1e-6
BF16_RTOL = 2.0 ** -8

CASES = {
    "sgd": lambda m: m.sgd(0.1),
    "sgd clip": lambda m: m.sgd(0.1, clip=1.0),
    "momentum": lambda m: m.momentum(0.05, beta=0.8),
    "momentum clip": lambda m: m.momentum(0.05, clip=1.0),
    "adam": lambda m: m.adam(1e-2),
    "adam clip bf16 state": lambda m: m.adam(1e-2, clip=0.5,
                                             state_dtype="bfloat16"),
    "adamw": lambda m: m.adamw(1e-2),
    "adamw bf16 state": lambda m: m.adamw(1e-2, state_dtype="bfloat16"),
    "ogd": lambda m: m.ogd_sqrt_t(0.3),
    "ogd clip": lambda m: m.ogd_sqrt_t(0.3, clip=1.0),
}


def _tree(rng, scale=1.0):
    """fp32 leaves (numpy) and a (3, 4) leaf the tests cast to bf16."""
    def a(*shape):
        return (scale * rng.standard_normal(shape)).astype(np.float32)
    return {"enc": {"w": a(5, 7), "b": a(7)}, "head": a(3, 4)}


def _to_jax(tree):
    return {"enc": {k: jnp.asarray(v) for k, v in tree["enc"].items()},
            "head": jnp.asarray(tree["head"]).astype(jnp.bfloat16)}


def _to_torch(jtree):
    return bridge.to_torch(jax.tree.map(np.asarray, jtree), "cpu")


def _close(got, want):
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        w = np.asarray(w.astype(jnp.float32) if w.dtype == jnp.bfloat16
                       else w)
        g_np = g.float().numpy()
        if g.dtype == torch.bfloat16:
            np.testing.assert_allclose(g_np, w, rtol=BF16_RTOL, atol=0)
        else:
            np.testing.assert_allclose(g_np, w, rtol=FP32_TOL,
                                       atol=FP32_TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_steps_match_the_reference(case):
    rng = np.random.default_rng(0)
    jparams = _to_jax(_tree(rng))
    params = _to_torch(jparams)
    jopt, opt = CASES[case](J), CASES[case](T)
    jstate, state = jopt.init(jparams), opt.init(params)
    assert opt.name == jopt.name
    _close(state, jstate)
    # scale 3 puts the global norm (~15) above every clip
    for _ in range(3):
        jg = _to_jax(_tree(rng, scale=3.0))
        jparams, jstate = jopt.step(jparams, jg, jstate)
        params, state = opt.step(params, _to_torch(jg), state)
        _close(params, jparams)
        _close(state, jstate)
    jg = _to_jax(_tree(rng, scale=3.0))
    jparams, jstate = jopt.step_k(jparams, jg, jstate, jnp.float32(2.5))
    params, state = opt.step_k(params, _to_torch(jg), state,
                               torch.tensor(2.5))
    _close(params, jparams)
    _close(state, jstate)
    assert state["count"].dtype == torch.int32 and int(state["count"]) == 5
    for p, q in zip(tree_leaves(params), tree_leaves(_to_torch(jparams))):
        assert p.dtype == q.dtype


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_the_reference(max_norm):
    """Above and below the norm; bf16 leaves cast back to bf16."""
    jg = _to_jax(_tree(np.random.default_rng(1), scale=3.0))
    jclipped, jnorm = J.clip_by_global_norm(jg, max_norm)
    clipped, norm = T.clip_by_global_norm(_to_torch(jg), max_norm)
    assert norm.dtype == torch.float32
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=FP32_TOL)
    _close(clipped, jclipped)
    assert clipped["head"].dtype == torch.bfloat16
    if max_norm > float(norm):
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(clipped), tree_leaves(_to_torch(jg))))


# ---------------------------------------------------------------------------
# the cascade's optimizers, as they were before this module grew
# ---------------------------------------------------------------------------
def _frozen_adam(lr, b1=0.9, b2=0.999, eps=1e-8):
    def init(params):
        def z(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"count": T._count0(params),
                "m": tree_map(z, params), "v": tree_map(z, params)}

    def _update(params, m, v, t, scale):
        tf = t.float()
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32), tf)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32), tf)

        def upd(p, m_, v_):
            mh, vh = m_ / bc1, v_ / bc2
            if scale is None:
                return -lr * mh / (torch.sqrt(vh) + eps)
            return -lr * scale * mh / (torch.sqrt(vh) + eps)

        return T._apply(params, tree_map(upd, params, m, v))

    def step(params, grads, state):
        t = state["count"] + 1
        m = tree_map(lambda m0, g: b1 * m0 + (1 - b1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda v0, g: b2 * v0 + (1 - b2)
                     * torch.square(g.float()), state["v"], grads)
        return _update(params, m, v, t, None), {"count": t, "m": m, "v": v}

    def step_k(params, grads, state, k):
        t = state["count"] + k.to(torch.int32)
        b1k = torch.pow(torch.tensor(b1, dtype=torch.float32), k)
        b2k = torch.pow(torch.tensor(b2, dtype=torch.float32), k)
        m = tree_map(lambda m0, g: b1k * m0 + (1 - b1k) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda v0, g: b2k * v0 + (1 - b2k)
                     * torch.square(g.float()), state["v"], grads)
        return _update(params, m, v, t, k), {"count": t, "m": m, "v": v}

    return T.Optimizer(init, step, "adam", step_k)


def _frozen_ogd(eta0):
    def init(params):
        return {"count": T._count0(params)}

    def step(params, grads, state):
        t = state["count"] + 1
        eta = eta0 * torch.rsqrt(t.float())
        return (T._apply(params, tree_map(lambda g: -eta * g.float(), grads)),
                {"count": t})

    def step_k(params, grads, state, k):
        t0 = state["count"].float()
        eta = eta0 * 2.0 * (torch.sqrt(t0 + k + 0.5) - torch.sqrt(t0 + 0.5))
        return (T._apply(params, tree_map(lambda g: -eta * g.float(), grads)),
                {"count": state["count"] + k.to(torch.int32)})

    return T.Optimizer(init, step, "ogd", step_k)


@pytest.mark.parametrize("name", ["adam", "ogd"])
def test_cascade_optimizers_are_bitwise_unchanged(name):
    rng = np.random.default_rng(2)
    params = _to_torch(_to_jax(_tree(rng)))
    new, old = ((T.adam(3e-3), _frozen_adam(3e-3)) if name == "adam"
                else (T.ogd_sqrt_t(0.2), _frozen_ogd(0.2)))
    ps, s = params, new.init(params)
    po, so = params, old.init(params)
    for i in range(4):
        g = _to_torch(_to_jax(_tree(rng)))
        if i == 3:
            k = torch.tensor(3.0)
            ps, s = new.step_k(ps, g, s, k)
            po, so = old.step_k(po, g, so, k)
        else:
            ps, s = new.step(ps, g, s)
            po, so = old.step(po, g, so)
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves((ps, s)), tree_leaves((po, so))))


def test_adam_leaf_updated_in_slices_is_bitwise_the_whole(monkeypatch):
    rng = np.random.default_rng(3)
    params = _to_torch(_to_jax(_tree(rng)))
    grads = _to_torch(_to_jax(_tree(rng, scale=3.0)))
    opt = T.adamw(1e-2, state_dtype="bfloat16")
    whole = opt.step(params, grads, opt.init(params))
    monkeypatch.setattr(T, "_SLICE", 8)     # 35- and 12-element leaves
    sliced = opt.step(params, grads, opt.init(params))
    assert all(torch.equal(a, b) and a.shape == b.shape for a, b in zip(
        tree_leaves(whole), tree_leaves(sliced)))
