"""The port's engines against the JAX package's on the CPU.

* ``OnlineCascade`` (port) vs ``OnlineCascade`` (JAX) on the CI-sized
  kernel ladder, both starting from the JAX engine's initial state
  (installed with ``repro_torch.bridge.load_level_state``): routing —
  chosen level, expert called, prediction — identical on every item of
  the stream (the horizon is the whole 64-item stream), learned state
  allclose at rtol 1e-4 / atol 1e-5.
* ``BatchedCascadeEngine`` (port) at S=1 vs the port's ``OnlineCascade``:
  bitwise, since the same torch ops run in the same order.
* ``BatchedCascadeEngine`` (port) vs (JAX) at S=8, both update modes:
  identical routing on every tick and lane of the stream, state allclose.
* The ``repro_torch.launch.serve`` CLI on ``--device cpu``, and the
  device rule: without CUDA, nothing runs unless the CPU is asked for.

Where routing parts, the failure names the first divergent tick and lane
(``repro.analysis.sanitize.diff_traces`` over state-free records).
"""
import io
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

import repro.core as J  # noqa: E402
from repro.analysis.sanitize import diff_traces  # noqa: E402
from repro.data import make_stream as j_make_stream  # noqa: E402
from repro.models import kernel_students as JK  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro_torch.bridge import load_level_state, to_numpy  # noqa: E402
from repro_torch.data import make_stream  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import kernel_students as PK  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

N_ITEMS = 64
RTOL, ATOL = 1e-4, 1e-5


def _levels(mod):
    """A CI ladder whose DAgger schedule decays within the stream, so the
    students (not only the expert) answer and every level's gate moves."""
    return (
        mod.LevelSpec(kind="lr", cost=1.0, cache_size=8, batch_size=8,
                      student_lr=0.5, beta_decay=0.9,
                      calibration_factor=0.4),
        mod.LevelSpec(kind="tinytf_flash", cost=50.0, cache_size=8,
                      batch_size=4, student_lr=1e-3, beta_decay=0.9,
                      calibration_factor=0.3),
        mod.LevelSpec(kind="ssm", cost=200.0, cache_size=8, batch_size=4,
                      student_lr=7e-4, beta_decay=0.9,
                      calibration_factor=0.4))


def _cfgs():
    jcfg = J.CascadeConfig(
        levels=_levels(J), n_classes=2, expert_cost=1e6, mu=3e-6,
        n_features=512, tf_flash_spec=JK.TINY_TF_CI,
        ssm_spec=JK.TINY_SSM_CI, seed=0)
    pcfg = P.CascadeConfig(
        levels=_levels(P), n_classes=2, expert_cost=1e6, mu=3e-6,
        n_features=512, tf_flash_spec=PK.TINY_TF_CI,
        ssm_spec=PK.TINY_SSM_CI, seed=0)
    return jcfg, pcfg


def _streams():
    return (j_make_stream("hatespeech", seed=0, n_samples=N_ITEMS),
            make_stream("hatespeech", seed=0, n_samples=N_ITEMS))


def _bridge(j_engine, p_engine):
    for jl, pl in zip(j_engine.levels, p_engine.levels):
        load_level_state(pl, jax.tree_util.tree_map(np.asarray,
                                                    jl.state_tree()))


def _records(history):
    """State-free per-tick trace records from an engine's history (a
    sequential engine's item is a 1-lane tick)."""
    out = []
    for t, (lv, called, pred) in enumerate(zip(
            history["level"], history["expert_called"], history["pred"])):
        out.append({"t": t + 1,
                    "level": np.atleast_1d(lv).astype(int).tolist(),
                    "called": np.atleast_1d(called).astype(int).tolist(),
                    "pred": np.atleast_1d(pred).astype(int).tolist()})
    return out


def _assert_same_routing(a_hist, b_hist):
    div = diff_traces(_records(a_hist), _records(b_hist))
    assert div is None, div.describe()


def _assert_state_close(j_engine, p_engine):
    for i, (jl, pl) in enumerate(zip(j_engine.levels, p_engine.levels)):
        for attr in P.STATE_ATTRS:
            la = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
                np.asarray, getattr(jl, attr)))
            lb = tree_leaves(to_numpy(getattr(pl, attr)))
            assert len(la) == len(lb), (i, attr)
            for x, y in zip(la, lb):
                np.testing.assert_allclose(
                    y, x, rtol=RTOL, atol=ATOL,
                    err_msg=f"level {i} ({pl.spec.kind}) {attr}")


@pytest.fixture(scope="module")
def sequential_pair():
    jcfg, pcfg = _cfgs()
    js, ps = _streams()
    je = J.OnlineCascade(jcfg, J.SimulatedExpert(js))
    pe = P.OnlineCascade(pcfg, P.SimulatedExpert(ps), device="cpu")
    _bridge(je, pe)
    return je, pe, je.run(js), pe.run(ps)


def test_online_cascade_matches_jax(sequential_pair):
    je, pe, jm, pm = sequential_pair
    _assert_same_routing(je.history, pe.history)
    assert jm["expert_calls"] == pm["expert_calls"]
    assert jm["accuracy"] == pm["accuracy"]
    assert jm["level_fractions"] == pm["level_fractions"]
    # the students answer part of the stream: the routing pin is not
    # vacuous (the expert alone would make it trivially identical)
    assert 0 < pm["expert_calls"] < N_ITEMS
    np.testing.assert_allclose(pe.J_cum, je.J_cum, rtol=1e-12)
    for jl, pl in zip(je.levels, pe.levels):
        assert (jl.cache_n, jl.cache_ptr) == (pl.cache_n, pl.cache_ptr)
        assert np.array_equal(jl.cache_x, pl.cache_x)
        assert np.array_equal(jl.cache_y, pl.cache_y)
        assert jl.beta == pl.beta
    _assert_state_close(je, pe)


def test_batched_s1_is_bitwise_online_cascade():
    _, pcfg = _cfgs()
    _, ps = _streams()
    seq = P.OnlineCascade(pcfg, P.SimulatedExpert(ps), device="cpu")
    bat = P.BatchedCascadeEngine(pcfg, P.SimulatedExpert(ps), n_streams=1,
                                 device="cpu")
    ms, mb = seq.run(ps), bat.run(ps)
    assert np.array_equal(ms["predictions"], mb["predictions"])
    assert ms["expert_calls"] == mb["expert_calls"]
    _assert_same_routing(seq.history, bat.history)
    for i, (a, b) in enumerate(zip(seq.levels, bat.levels)):
        assert a.forwards == b.forwards
        for attr in P.STATE_ATTRS:
            for x, y in zip(tree_leaves(getattr(a, attr)),
                            tree_leaves(getattr(b, attr))):
                assert torch.equal(x, y), (i, attr)
        assert np.array_equal(a.cache_x, bat._cache_x[i].numpy())
        assert np.array_equal(a.cache_y, bat._cache_y[i].numpy())
        assert (a.cache_n, a.cache_ptr) == (bat._cache_n[i],
                                            bat._cache_ptr[i])


@pytest.mark.parametrize("updates", ["single", "scaled"])
def test_batched_s8_matches_jax(updates):
    jcfg, pcfg = _cfgs()
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
    levels = np.concatenate([np.asarray(x) for x in pe.history["level"]])
    assert (levels < len(pe.levels)).any()      # students answer too
    assert pe._cache_n == je._cache_n and pe._cache_ptr == je._cache_ptr
    for i in range(len(pe.levels)):
        assert np.array_equal(np.asarray(je._cache_x[i]),
                              pe._cache_x[i].numpy())
        assert np.array_equal(np.asarray(je._cache_y[i]),
                              pe._cache_y[i].numpy())
    _assert_state_close(je, pe)


def test_serve_cli_on_cpu():
    for argv in (["--device", "cpu", "--ladder", "kernel-ci", "--samples",
                  "48", "--batch", "16", "--dataset", "fever",
                  "--log-every", "0", "--expert", "simulated"],
                 ["--device", "cpu", "--ladder", "kernel-ci", "--samples",
                  "24", "--engine", "sequential", "--log-every", "0",
                  "--expert", "simulated"]):
        buf = io.StringIO()
        with redirect_stdout(buf):
            serve.main(argv)
        out = buf.getvalue()
        n = argv[argv.index("--samples") + 1]
        assert f"served {n} queries" in out, out
        assert "accuracy=" in out and "level fractions:" in out, out


def test_cli_engine_matches_engine_run():
    buf = io.StringIO()
    with redirect_stdout(buf):
        m = serve.serve_stream_batched("imdb", 32, 3e-7, batch=8,
                                       expert_kind="simulated",
                                       log_every=0, ladder="kernel-ci",
                                       device="cpu")
    eng = m["engine"]
    assert eng.device == torch.device("cpu")
    assert sum(m["per_stream"]["items_seen"]) == 32
    assert all(lvl.forwards > 0 for lvl in eng.levels)


@pytest.mark.parametrize("batch,buckets", [(1, {1}), (16, {8, 16})])
def test_forwards_by_batch_splits_forwards_by_bucket(batch, buckets):
    """Each level's forwards, split by the padded batch its route passes
    ran at: the engine's buckets (powers of two from 8, capped at the
    lane count), summing to ``forwards``."""
    m = serve.serve_stream_batched("imdb", 32, 3e-7, batch=batch,
                                   expert_kind="simulated",
                                   log_every=0, ladder="kernel-ci",
                                   device="cpu")
    for lvl in m["engine"].levels:
        assert sum(lvl.forwards_by_batch.values()) == lvl.forwards > 0
        assert set(lvl.forwards_by_batch) <= buckets
        lvl.reset()
        assert lvl.forwards_by_batch == {} and lvl.forwards == 0


def test_default_device_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is honoured")
    _, pcfg = _cfgs()
    _, ps = _streams()
    ex = P.SimulatedExpert(ps)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.BatchedCascadeEngine(pcfg, ex, n_streams=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.OnlineCascade(pcfg, ex, device=None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--ladder", "kernel-ci", "--samples", "8",
                    "--expert", "simulated"])
    # the model expert is trained only after the device check passed
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--ladder", "default", "--samples", "8"])


def test_unported_level_kind_raises():
    """Every level kind of the reference is ported: a kind no engine
    knows raises, naming the known ones."""
    _, pcfg = _cfgs()
    from dataclasses import replace
    assert set(P.LEVEL_KINDS) == {"lr", "mlp", "tinytf", "tinytf_large",
                                  "tinytf_flash", "ssm"}
    cfg = replace(pcfg, levels=(P.LevelSpec(kind="bert", cost=1.0),))
    with pytest.raises(ValueError, match="known kinds are lr, mlp, tinytf"):
        P.OnlineCascade(cfg, None, device="cpu")


def test_bridge_rejects_mismatched_state():
    _, pcfg = _cfgs()
    eng = P.OnlineCascade(pcfg, None, device="cpu")
    tree = to_numpy(eng.levels[1].state_tree())
    tree["params"]["cls_w"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="cls_w"):
        load_level_state(eng.levels[1], tree)
