"""Port building blocks vs the JAX package on the CPU: the numpy copies
(streams, featurizers, tick RNG), the deferral gate, the optimizers, the
initializers, and the kernel-ladder students' logits on both paths.

Inputs are made with numpy from a seed; student parameters come from the
JAX package's own init, installed into the port (``repro_torch.bridge``),
so both sides compute on the same numbers.  Tolerances: deferral and
optimizers 1e-6; ``tinytf_flash`` logits 1e-5 and ``ssm`` logits 2e-3,
the tolerances the JAX package pins between its own two paths.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import deferral as JD  # noqa: E402
from repro.core import rng as JR  # noqa: E402
from repro.core.cascade import kernel_cascade_config as j_kernel_cfg  # noqa: E402
from repro.data import features as JF  # noqa: E402
from repro.data import streams as JS  # noqa: E402
from repro.models import kernel_students as JK  # noqa: E402
from repro.optim import adam as j_adam  # noqa: E402
from repro.optim import ogd_sqrt_t as j_ogd  # noqa: E402
from repro_torch.bridge import to_numpy, to_torch  # noqa: E402
from repro_torch.core import deferral as PD  # noqa: E402
from repro_torch.core import rng as PR  # noqa: E402
from repro_torch.core.cascade import kernel_cascade_config  # noqa: E402
from repro_torch.data import features as PF  # noqa: E402
from repro_torch.data import streams as PS  # noqa: E402
from repro_torch.models import kernel_students as PK  # noqa: E402
from repro_torch.models.layers import dense_init, trunc_normal  # noqa: E402
from repro_torch.optim import adam, ogd_sqrt_t  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

CPU = torch.device("cpu")


def _leaves_close(a, b, atol, rtol=0.0):
    la = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, a))
    lb = tree_leaves(to_numpy(b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.shape == y.shape and x.dtype == y.dtype
        np.testing.assert_allclose(y, x, atol=atol, rtol=rtol)


# ---------------------------------------------------------------------------
# numpy copies: bit-for-bit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["imdb", "hatespeech", "isear"])
def test_make_stream_identical(name):
    a = JS.make_stream(name, seed=3, n_samples=40)
    b = PS.make_stream(name, seed=3, n_samples=40)
    assert len(a) == len(b)
    for x, y in zip(a.docs, b.docs):
        assert np.array_equal(x, y) and x.dtype == y.dtype
    for attr in ("labels", "categories", "lengths"):
        assert np.array_equal(getattr(a, attr), getattr(b, attr))
    assert np.array_equal(a.expert_labels("gpt-3.5-turbo"),
                          b.expert_labels("gpt-3.5-turbo"))
    ra, rb = a.reorder("length"), b.reorder("length")
    assert np.array_equal(ra.expert_labels("gpt-3.5-turbo"),
                          rb.expert_labels("gpt-3.5-turbo"))


def test_featurizers_identical():
    rng = np.random.default_rng(0)
    for n in (0, 5, 131, 400):
        toks = rng.integers(0, 30_000, n).astype(np.int32)
        assert np.array_equal(JF.hash_bow(toks, 512), PF.hash_bow(toks, 512))
        for vocab, max_len in ((256, 32), (4096, 128)):
            assert np.array_equal(JF.hash_ids(toks, vocab, max_len),
                                  PF.hash_ids(toks, vocab, max_len))


def test_tick_rngs_and_cache_sampling_identical():
    for seed, sid, t in ((0, 0, 1), (7, 3, 19), (2 ** 40 + 5, 63, 1000)):
        a, b = JR.tick_rngs(seed, sid, t, 3), PR.tick_rngs(seed, sid, t, 3)
        assert np.array_equal(a.jump.random(3), b.jump.random(3))
        assert np.array_equal(a.action.random(3), b.action.random(3))
        for ca, cb in zip(a.cache, b.cache):
            for n, bs in ((3, 8), (8, 8), (32, 16)):
                assert np.array_equal(JR.sample_cache_indices(ca, n, bs),
                                      PR.sample_cache_indices(cb, n, bs))


def test_kernel_cascade_costs_identical():
    def rows(cfg):
        return [(s.kind, s.cost, s.cache_size, s.batch_size, s.student_lr,
                 s.beta_decay, s.calibration_factor) for s in cfg.levels]

    assert rows(j_kernel_cfg(7, mu=3e-7)) == \
        rows(kernel_cascade_config(7, mu=3e-7))
    assert rows(j_kernel_cfg(2, tf_flash_spec=JK.TINY_TF_CI,
                             ssm_spec=JK.TINY_SSM_CI)) == \
        rows(kernel_cascade_config(2, tf_flash_spec=PK.TINY_TF_CI,
                                   ssm_spec=PK.TINY_SSM_CI))


# ---------------------------------------------------------------------------
# deferral gate
# ---------------------------------------------------------------------------
def _gate_inputs(C, B=6, seed=0):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, C)) * 2
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    probs[0] = 1.0 / C                     # ties: argmax must agree
    probs = probs.astype(np.float32)
    y = rng.integers(0, C, B).astype(np.int32)
    reach = rng.random(B).astype(np.float32)
    w = (rng.random(B) < 0.7).astype(np.float32)
    params = JD.deferral_init(jax.random.PRNGKey(seed), JD.DeferralSpec(C))
    return probs, y, reach, w, params


@pytest.mark.parametrize("C", [2, 7])
def test_deferral_matches_jax(C):
    probs, y, reach, w, jparams = _gate_inputs(C, seed=C)
    pparams = to_torch(jax.tree_util.tree_map(np.asarray, jparams), CPU)
    tp = torch.from_numpy(probs)
    np.testing.assert_allclose(PD._features(tp).numpy(),
                               np.asarray(JD._features(jnp.asarray(probs))),
                               atol=1e-6)
    np.testing.assert_allclose(
        PD.deferral_prob(pparams, tp).numpy(),
        np.asarray(JD.deferral_prob(jparams, jnp.asarray(probs))), atol=1e-6)
    z_j, mcl_j = JD.deferral_update_terms(jnp.asarray(probs), jnp.asarray(y),
                                          3.0)
    z_p, mcl_p = PD.deferral_update_terms(tp, torch.from_numpy(y), 3.0)
    assert np.array_equal(z_p.numpy(), np.asarray(z_j))
    np.testing.assert_allclose(mcl_p.numpy(), np.asarray(mcl_j), atol=1e-5)
    args_j = (jnp.asarray(probs), z_j, jnp.asarray(reach), mcl_j,
              jnp.asarray(w), 0.3)
    args_p = (tp, z_p, torch.from_numpy(reach), mcl_p, torch.from_numpy(w),
              0.3)
    np.testing.assert_allclose(
        float(PD.deferral_loss_weighted(pparams, *args_p)),
        float(JD.deferral_loss_weighted(jparams, *args_j)), rtol=1e-5)
    _leaves_close(JD.deferral_grads_weighted(jparams, *args_j),
                  PD.deferral_grads_weighted(pparams, *args_p), atol=1e-6,
                  rtol=1e-5)


def test_reexploration_floor_matches_jax():
    for floor in (0.0, 0.05, 0.3):
        for t in (0, 1, 2, 17, 10_000):
            assert PD.reexploration_floor(floor, t) == \
                JD.reexploration_floor(floor, t)


# ---------------------------------------------------------------------------
# optimizers: step and step_k from identical state
# ---------------------------------------------------------------------------
def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((5, 3)).astype(np.float32),
            "layers": [{"b": rng.standard_normal((3,)).astype(np.float32)}]}


@pytest.mark.parametrize("which", ["adam", "ogd"])
def test_optimizer_steps_match_jax(which):
    jopt, popt = ((j_adam(1e-3), adam(1e-3)) if which == "adam"
                  else (j_ogd(0.5), ogd_sqrt_t(0.5)))
    params = _tree(0)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    pp = to_torch(params, CPU)
    js, ps = jopt.init(jp), popt.init(pp)
    _leaves_close(js, ps, atol=0)
    for it in range(4):
        g = _tree(10 + it)
        jg, pg = jax.tree_util.tree_map(jnp.asarray, g), to_torch(g, CPU)
        if it % 2:
            k = 3.0
            jp, js = jopt.step_k(jp, jg, js, jnp.asarray(k, jnp.float32))
            pp, ps = popt.step_k(pp, pg, ps,
                                 torch.tensor(k, dtype=torch.float32))
        else:
            jp, js = jopt.step(jp, jg, js)
            pp, ps = popt.step(pp, pg, ps)
        _leaves_close(jp, pp, atol=1e-6, rtol=1e-6)
        _leaves_close(js, ps, atol=1e-6, rtol=1e-6)
    assert ps["count"].dtype == torch.int32 and int(ps["count"]) == 8


# ---------------------------------------------------------------------------
# initializers: the reference's distributions from a torch.Generator
# ---------------------------------------------------------------------------
def test_trunc_normal_distribution():
    gen = torch.Generator().manual_seed(0)
    x = trunc_normal(gen, (200, 200), 0.5)
    assert x.dtype == torch.float32
    assert float(x.abs().max()) <= 1.0
    # std of a +-2 sigma truncated unit normal is 0.8796
    assert abs(float(x.std()) - 0.5 * 0.8796) < 0.01
    w = dense_init(torch.Generator().manual_seed(0), 64, 8)
    assert w.shape == (64, 8)
    assert abs(float(w.std()) - 64 ** -0.5 * 0.8796) < 0.02
    again = dense_init(torch.Generator().manual_seed(0), 64, 8)
    assert torch.equal(w, again)


# ---------------------------------------------------------------------------
# kernel-ladder students: both paths against JAX
# ---------------------------------------------------------------------------
def _tokens(lengths, max_len, vocab, seed=0):
    toks = np.zeros((len(lengths), max_len), np.int32)
    rng = np.random.default_rng(seed)
    for i, n in enumerate(lengths):
        toks[i, :n] = rng.integers(1, vocab, n)
    return toks


def _jax_params(init, spec, seed):
    key = jax.random.PRNGKey(seed)
    params = dict(init(key, spec))
    # zero-initialized heads make logits trivially equal: randomize
    params["cls_w"] = jax.random.normal(jax.random.fold_in(key, 1),
                                        (spec.d_model, spec.n_classes)) * 0.1
    return params


STUDENTS = {
    "tinytf_flash": (JK.tinytf_flash_init, JK.tinytf_flash_logits,
                     PK.tinytf_flash_logits, JK.TINY_TF_CI, PK.TINY_TF_CI,
                     1e-5, [32, 17, 7, 1]),
    "ssm": (JK.ssm_student_init, JK.ssm_student_logits,
            PK.ssm_student_logits, JK.TINY_SSM_CI, PK.TINY_SSM_CI, 2e-3,
            [32, 19, 5, 1]),
}


@pytest.mark.parametrize("kind", sorted(STUDENTS))
def test_student_logits_match_jax(kind):
    """Odd-length masked tails, both paths, against the JAX package's
    kernel path (Pallas interpret) and plain path."""
    j_init, j_logits, p_logits, jspec, pspec, tol, lens = STUDENTS[kind]
    jparams = _jax_params(j_init, jspec, seed=len(kind))
    pparams = to_torch(jax.tree_util.tree_map(np.asarray, jparams), CPU)
    toks = _tokens(lens, jspec.max_len, jspec.vocab)
    j_fn = jax.jit(j_logits, static_argnums=(2, 3))
    j_ref = np.asarray(j_fn(jparams, jnp.asarray(toks), jspec, False))
    j_ker = np.asarray(j_fn(jparams, jnp.asarray(toks), jspec, True))
    with torch.no_grad():
        p_ker = p_logits(pparams, torch.from_numpy(toks), pspec,
                         use_kernels=True).numpy()
        p_ref = p_logits(pparams, torch.from_numpy(toks), pspec,
                         use_kernels=False).numpy()
    assert p_ker.shape == (len(lens), pspec.n_classes)
    for got in (p_ker, p_ref):
        for want in (j_ref, j_ker):
            np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    np.testing.assert_allclose(p_ker, p_ref, atol=tol, rtol=tol)


@pytest.mark.parametrize("kind", sorted(STUDENTS))
def test_student_pad_independence(kind):
    """An item's logits do not depend on the other rows of its batch nor
    on how much pad tail follows it."""
    j_init, _, p_logits, jspec, pspec, tol, _ = STUDENTS[kind]
    pparams = to_torch(jax.tree_util.tree_map(
        np.asarray, _jax_params(j_init, jspec, seed=11)), CPU)
    one = _tokens([11], pspec.max_len, pspec.vocab, seed=7)
    two = np.concatenate([one, _tokens([29], pspec.max_len, pspec.vocab,
                                       seed=8)])
    with torch.no_grad():
        a = p_logits(pparams, torch.from_numpy(one), pspec)[0]
        b = p_logits(pparams, torch.from_numpy(two), pspec)[0]
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kind", sorted(STUDENTS))
def test_student_loss_gradients_match_jax(kind):
    """The imitation loss (plain path) and its gradient, as the engines
    take them."""
    from repro_torch.core.cascade import _grads
    j_init, _, _, jspec, pspec, _, lens = STUDENTS[kind]
    jparams = _jax_params(j_init, jspec, seed=3)
    pparams = to_torch(jax.tree_util.tree_map(np.asarray, jparams), CPU)
    toks = _tokens(lens, jspec.max_len, jspec.vocab, seed=5)
    y = np.array([0, 1, 1, 0], np.int32)
    w = np.array([1, 1, 0, 1], np.float32)
    j_loss = (JK.tinytf_flash_loss_weighted if kind == "tinytf_flash"
              else JK.ssm_student_loss_weighted)
    p_loss = (PK.tinytf_flash_loss_weighted if kind == "tinytf_flash"
              else PK.ssm_student_loss_weighted)
    jg = jax.jit(jax.grad(j_loss), static_argnums=4)(
        jparams, jnp.asarray(toks), jnp.asarray(y), jnp.asarray(w), jspec)
    pg = _grads(lambda p, *a: p_loss(p, *a, pspec), pparams,
                torch.from_numpy(toks), torch.from_numpy(y),
                torch.from_numpy(w))
    _leaves_close(jg, pg, atol=2e-5, rtol=1e-3)
    assert math.isfinite(float(p_loss(pparams, torch.from_numpy(toks),
                                      torch.from_numpy(y),
                                      torch.from_numpy(w), pspec)))
