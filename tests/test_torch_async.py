"""The port's async expert queue (``BatchedCascadeEngine(max_delay=...)``)
against the JAX engine's, on the CPU.

Setup (shared by the engine-matrix files ``test_torch_async.py``,
``test_torch_pool.py``, ``test_torch_pipelined.py`` and
``test_torch_faults.py``): the CI-sized kernel ladder of
``tests/test_torch_engine.py`` (``TINY_TF_CI`` / ``TINY_SSM_CI``), S = 8
lanes, ``hatespeech``, 64-256 items.  One reference engine per test module
is reset and reconfigured for each run (its compiled steps survive
``reset``, so each module compiles once), and every port engine starts
from its initial state (``bridge.load_level_state``).

Contract, every run: routing (level, expert called, prediction)
identical on every tick and lane (``diff_traces`` names the first
divergence), learned state allclose at rtol 1e-4 / atol 1e-5, ring
buffers equal, and the host-side counters — ``pipeline_stats``,
``fault_stats``, ``fleet_log``, ``commit_log``, ``commit_stats`` ages —
equal to the reference's exactly.

This file: the queue at D = 1 and 2 against the reference; D = 0 bitwise
the sequential engine at S = 1; the bounded-delay timing (nothing lands
before D ticks, the queue never deeper than D, the bound counted in
ticks, not in expert-calling ticks); annotations invariant to the delay;
option validation.
"""
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.core as J  # noqa: E402
from repro.data import make_stream as j_make_stream  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro_torch.data import make_stream  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from test_torch_engine import (_assert_same_routing, _assert_state_close,  # noqa: E402
                               _bridge, _cfgs)

S = 8
EXPERT = "gpt-3.5-turbo"
# engine options the reference reads at run time, with their defaults
OPTIONS = {"max_delay": 0, "per_lane": False, "pipeline_depth": 0,
           "expert_timeout": None, "max_requeues": 2, "autoscale": None,
           "readiness_commits": False}


def streams(n):
    """The reference's and the port's copy of one ``hatespeech`` stream."""
    return (j_make_stream("hatespeech", seed=0, n_samples=n),
            make_stream("hatespeech", seed=0, n_samples=n))


def port_cfg(hard_budget=None):
    return replace(_cfgs()[1], hard_budget=hard_budget)


class Reference:
    """One reference engine, reconfigured and reset for every run."""

    def __init__(self):
        self.cfg = _cfgs()[0]
        self.engine = J.BatchedCascadeEngine(
            self.cfg, J.SimulatedExpert(streams(S)[0], EXPERT), n_streams=S)

    def start(self, pe, expert, hard_budget=None, **opts):
        """Configure the reference like port engine ``pe`` (options
        ``opts``, ``expert``), reset it, and install its initial state
        into ``pe``; returns the reference engine."""
        je = self.engine
        je.expert = expert
        je.cfg = replace(self.cfg, hard_budget=hard_budget)
        for name, default in OPTIONS.items():
            setattr(je, name, opts.get(name, default))
        je.reset()
        _bridge(je, pe)
        return je

    def pair(self, n, *, hard_budget=None, j_expert=None, p_expert=None,
             **opts):
        """A (reference, port) pair of engines on an n-item stream, the
        port's from the reference's initial state.  ``j_expert`` /
        ``p_expert`` wrap each side's stream (default: the simulated
        expert)."""
        js, ps = streams(n)
        jx = (j_expert or (lambda s: J.SimulatedExpert(s, EXPERT)))(js)
        px = (p_expert or (lambda s: P.SimulatedExpert(s, EXPERT)))(ps)
        pe = P.BatchedCascadeEngine(port_cfg(hard_budget), px, n_streams=S,
                                    device="cpu", **opts)
        je = self.start(pe, jx, hard_budget=hard_budget, **opts)
        return je, pe, js, ps


def assert_matches(je, jm, pe, pm):
    """The contract of the module docstring, for a finished pair."""
    _assert_same_routing(je.history, pe.history)
    assert np.array_equal(jm["predictions"], pm["predictions"])
    assert jm["expert_calls"] == pm["expert_calls"]
    assert pe._cache_n == je._cache_n and pe._cache_ptr == je._cache_ptr
    for i in range(len(pe.levels)):
        assert np.array_equal(np.asarray(je._cache_x[i]),
                              pe._cache_x[i].numpy())
        assert np.array_equal(np.asarray(je._cache_y[i]),
                              pe._cache_y[i].numpy())
    _assert_state_close(je, pe)
    assert pe.pipeline_stats == je.pipeline_stats
    assert pe.fault_stats == je.fault_stats
    assert pe.fleet_log == je.fleet_log
    assert pe.commit_log == [tuple(int(v) for v in c) for c in je.commit_log]
    for key in ("lanes", "age_sum", "age_max"):
        assert pe.commit_stats[key] == je.commit_stats[key], key


def states_equal(a_levels, b_levels) -> bool:
    """Bitwise equality of two port engines' learned state."""
    return all(torch.equal(x, y)
               for a, b in zip(a_levels, b_levels) for attr in P.STATE_ATTRS
               for x, y in zip(tree_leaves(getattr(a, attr)),
                               tree_leaves(getattr(b, attr))))


def assert_port_runs_equal(a, ma, b, mb):
    """Two port runs: identical routing and bitwise state."""
    _assert_same_routing(a.history, b.history)
    assert np.array_equal(ma["predictions"], mb["predictions"])
    assert ma["expert_calls"] == mb["expert_calls"]
    assert states_equal(a.levels, b.levels)


@pytest.fixture(scope="module")
def ref():
    return Reference()


# ---------------------------------------------------------------------------
# the queue against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("delay", [1, 2])
def test_async_queue_matches_jax(ref, delay):
    je, pe, js, ps = ref.pair(128, max_delay=delay)
    jm, pm = je.run(js), pe.run(ps)
    assert_matches(je, jm, pe, pm)
    assert len(pe._pending) == 0 and pe.commit_stats["lanes"] > 0
    ages = [c - t for t, _s, c in pe.commit_log]
    assert max(ages) == delay and pe.commit_stats["age_max"] == delay
    levels = np.concatenate(pe.history["level"])
    assert (levels < len(pe.levels)).any()      # students answer too


def test_delay0_bitwise_parity_s1():
    _, ps = streams(64)
    seq = P.OnlineCascade(port_cfg(), P.SimulatedExpert(ps, EXPERT),
                          device="cpu")
    bat = P.BatchedCascadeEngine(port_cfg(), P.SimulatedExpert(ps, EXPERT),
                                 n_streams=1, max_delay=0, device="cpu")
    ms, mb = seq.run(ps), bat.run(ps)
    assert np.array_equal(ms["predictions"], mb["predictions"])
    assert ms["expert_calls"] == mb["expert_calls"]
    _assert_same_routing(seq.history, bat.history)
    assert states_equal(seq.levels, bat.levels)


# ---------------------------------------------------------------------------
# bounded-delay semantics
# ---------------------------------------------------------------------------
def _port_engine(n, **kw):
    _, ps = streams(n)
    hb = kw.pop("hard_budget", None)
    eng = P.BatchedCascadeEngine(port_cfg(hb), P.SimulatedExpert(ps, EXPERT),
                                 n_streams=S, device="cpu", **kw)
    return eng, ps


def _params_at_init(eng, init):
    return all(torch.equal(x, y) for lvl, leaves in zip(eng.levels, init)
               for x, y in zip(tree_leaves(lvl.params), leaves))


def test_bounded_delay_update_timing():
    """Annotations commit exactly D ticks later: provisional answers at
    once (expert_labels -1), nothing lands before, the queue never holds
    more than D routed ticks, and flush drains the rest."""
    D = 2
    eng, ps = _port_engine(3 * S, max_delay=D)
    init = [tree_leaves(lvl.params) for lvl in eng.levels]
    docs = ps.docs
    out = eng.process_tick(range(S), docs[:S])
    assert out["expert_called"].all()              # beta0 = 1: all jump
    assert (out["expert_labels"] == -1).all()
    assert len(eng._pending) == 1 and _params_at_init(eng, init)
    eng.process_tick(range(S, 2 * S), docs[S:2 * S])
    assert len(eng._pending) == 2 and _params_at_init(eng, init)
    eng.process_tick(range(2 * S, 3 * S), docs[2 * S:3 * S])
    assert len(eng._pending) == 2                  # bounded depth
    assert not _params_at_init(eng, init)          # tick 1 landed
    assert eng._cache_n[0] > 0
    assert eng.flush() == 2 and len(eng._pending) == 0


def test_delay_bound_holds_without_further_expert_ticks():
    """The bound counts ticks, not expert-calling ticks: with the budget
    spent after tick 1, tick 1's annotations still land at tick 1 + D."""
    D = 2
    eng, ps = _port_engine(5 * S, max_delay=D, hard_budget=S)
    docs = ps.docs
    assert eng.process_tick(range(S), docs[:S])["expert_called"].all()
    out2 = eng.process_tick(range(S, 2 * S), docs[S:2 * S])
    assert not out2["expert_called"].any()
    assert len(eng._pending) == 1
    eng.process_tick(range(2 * S, 3 * S), docs[2 * S:3 * S])
    assert len(eng._pending) == 0 and eng._cache_n[0] > 0


def test_bounded_delay_annotations_are_delay_invariant():
    """Delay moves when labels land, never which: the ring holds the
    simulated expert's table for the called items."""
    eng, ps = _port_engine(S, max_delay=3)
    assert eng.process_tick(range(S), ps.docs[:S])["expert_called"].all()
    eng.flush()
    table = ps.expert_labels(EXPERT)
    size = eng.levels[0].spec.cache_size
    expect = np.zeros(size, np.int32)
    for j in range(S):
        expect[j % size] = table[j]
    np.testing.assert_array_equal(eng._cache_y[0].numpy(), expect)


@pytest.mark.parametrize("bad", [
    {"max_delay": -1}, {"pipeline_depth": -1}, {"expert_timeout": 0.0},
    {"max_requeues": -1}, {"autoscale": (0, 4)}, {"autoscale": (3, 2)},
    {"updates_per_tick": "twice"}])
def test_engine_options_validated(bad):
    with pytest.raises(ValueError):
        _port_engine(S, **bad)
