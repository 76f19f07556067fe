"""The port's failure semantics and elastic expert fleet on the CPU,
against the JAX engine (setup and contract: ``test_torch_async.py``).

* Ticket primitives: ``replace`` splices a requeued shard,
  ``force_resolve`` drops to the -1 sentinel; an injected timeout raises
  ``ExpertShardTimeout`` with its range, an injected death
  ``ExpertWorkerDied``; the fault draws equal the reference's.
* Under ``FlakyExpert`` (the same scripted schedule on both sides) the
  reference's routing, state and ``fault_stats``: a dying worker and
  timed-out shards are each requeued exactly once and the run is bitwise
  the fault-free one; ``max_requeues=0`` drops at once, counted.
* Readiness commits: the reference's commit log, every age within D.
* Autoscale: the reference's ``fleet_log``, and bitwise a fixed-width run.
* The model expert's pool is closed by the engine's ``reset``; the
  process backend labels as the thread backend does, and a killed child
  surfaces as ``ExpertWorkerDied`` and is replaced on the next submit.
"""
import os
import signal
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.core as J  # noqa: E402
from repro.core.experts import _fault_draw as j_fault_draw  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro_torch.core.experts import (ExpertShardTimeout, ExpertTicket,  # noqa: E402
                                      ExpertWorkerDied, FlakyExpert,
                                      ModelExpert, _fault_draw)
from repro_torch.models.students import TinyTFSpec, tinytf_init  # noqa: E402
from test_torch_async import (EXPERT, S, _bridge, assert_matches,  # noqa: E402
                              assert_port_runs_equal, port_cfg, ref,
                              streams)

N = 128


def _flaky(kind, schedule, workers=2):
    """A flaky expert factory over ``kind``'s (J or P) simulated expert,
    with a fresh copy of the scripted ``schedule`` state per side."""
    return lambda s: kind.FlakyExpert(
        kind.SimulatedExpert(s, EXPERT, workers=workers),
        schedule=schedule())


def _pair(ref, schedule, **opts):
    return ref.pair(N, j_expert=_flaky(J, schedule),
                    p_expert=_flaky(P, schedule), **opts)


def _clean_port(je, **opts):
    """A fault-free port engine over a 2-worker pool, from the reference
    engine ``je``'s initial state (call before ``je`` runs)."""
    eng = P.BatchedCascadeEngine(port_cfg(), P.SimulatedExpert(
        streams(N)[1], EXPERT, workers=2), n_streams=S, device="cpu",
        **opts)
    _bridge(je, eng)
    return eng


# ---------------------------------------------------------------------------
# ticket-level failure primitives
# ---------------------------------------------------------------------------
def test_ticket_replace_and_force_resolve():
    t = ExpertTicket(shards=[(0, 2, np.array([1, 2], np.int32)),
                             (2, 4, np.array([3, 4], np.int32))])
    t.replace(2, 4, ExpertTicket(labels=np.array([7, 8], np.int32)))
    np.testing.assert_array_equal(t.result(), [1, 2, 7, 8])
    t.force_resolve(0, 2, np.full(2, -1, np.int32))
    np.testing.assert_array_equal(t.result(), [-1, -1, 7, 8])
    with pytest.raises(ValueError):
        t.replace(1, 3, ExpertTicket(labels=np.zeros(2, np.int32)))


def test_flaky_timeout_and_dead_worker_shards():
    _, ps = streams(8)
    docs = ps.docs[:8]
    ex = FlakyExpert(P.SimulatedExpert(ps, EXPERT, workers=2),
                     schedule=lambda seq, j: "timeout" if j == 0 else "die")
    ticket = ex.submit_many(list(range(8)), docs)
    with pytest.raises(ExpertShardTimeout) as ei:
        ticket.result_slice(0, 8, timeout=0.01)
    assert (ei.value.lo, ei.value.hi) == (0, 4)
    assert not ticket.item_done(0) and ticket.item_done(4)
    with pytest.raises(ExpertWorkerDied) as ed:
        ticket.result_slice(4, 8)
    assert (ed.value.lo, ed.value.hi) == (4, 8)
    assert ex.injected == {"timeout": 1, "die": 1, "slow": 0}


def test_fault_draws_match_reference():
    draws = [_fault_draw(7, seq, j, salt) for seq in range(20)
             for j in range(4) for salt in "tds"]
    assert draws == [j_fault_draw(7, seq, j, salt) for seq in range(20)
                     for j in range(4) for salt in "tds"]
    assert all(0.0 <= d < 1.0 for d in draws) and len(set(draws)) > 100


# ---------------------------------------------------------------------------
# requeues and drops against the reference
# ---------------------------------------------------------------------------
def _die_then_timeouts():
    """Submit 3's shard 0 dies once; the first attempt of every 5th
    submit's shard 0 times out (retries get fresh sequence numbers)."""
    first = set()

    def schedule(seq, j):
        if seq == 3 and j == 0:
            return "die"
        if j == 0 and seq % 5 == 0 and seq not in first:
            first.add(seq)
            return "timeout"
        return None

    return schedule


def test_requeue_exactly_once_matches_jax(ref):
    je, pe, js, ps = _pair(ref, _die_then_timeouts, max_delay=2,
                           expert_timeout=0.01, max_requeues=3)
    clean = _clean_port(je, max_delay=2)
    jm, pm = je.run(js), pe.run(ps)
    assert_matches(je, jm, pe, pm)
    fs = pe.fault_stats
    assert fs["worker_deaths"] == 1 and fs["timeouts"] > 0
    assert fs["requeues"] == fs["timeouts"] + fs["worker_deaths"]
    assert fs["dropped_annotations"] == 0
    assert pe.expert.injected == je.expert.injected
    # requeues re-derive the same labels: bitwise the fault-free run
    assert_port_runs_equal(clean, clean.run(ps), pe, pm)
    assert len(pe._pending) == 0


def test_zero_max_requeues_drops_immediately_matches_jax(ref):
    je, pe, js, ps = _pair(ref, lambda: (lambda seq, j: "die"),
                           max_delay=2, max_requeues=0)
    jm, pm = je.run(js), pe.run(ps)
    assert_matches(je, jm, pe, pm)
    fs = pe.fault_stats
    assert fs["requeues"] == 0 and fs["dropped_annotations"] > 0
    # every deferred item is dropped, none commits
    assert fs["dropped_annotations"] == pm["expert_calls"]
    assert pe.commit_stats["lanes"] == 0 and pe._cache_n[0] == 0


# ---------------------------------------------------------------------------
# readiness commits and the fleet
# ---------------------------------------------------------------------------
def test_readiness_commits_match_jax(ref):
    D = 3
    je, pe, js, ps = ref.pair(
        N, max_delay=D, readiness_commits=True,
        j_expert=lambda s: J.SimulatedExpert(s, EXPERT, workers=2),
        p_expert=lambda s: P.SimulatedExpert(s, EXPERT, workers=2))
    base = _clean_port(je, max_delay=D)
    jm, pm = je.run(js), pe.run(ps)
    assert_matches(je, jm, pe, pm)
    cs = pe.commit_stats
    assert cs["lanes"] > 0 and 0 <= cs["age_max"] <= D
    base.run(ps)
    assert (cs["age_sum"] / cs["lanes"] < base.commit_stats["age_sum"]
            / base.commit_stats["lanes"])


def test_autoscale_matches_jax_and_fixed_width(ref):
    je, pe, js, ps = ref.pair(
        N, max_delay=2, autoscale=(1, 4),
        j_expert=lambda s: J.SimulatedExpert(s, EXPERT, workers="auto"),
        p_expert=lambda s: P.SimulatedExpert(s, EXPERT, workers="auto"))
    fixed = _clean_port(je, max_delay=2)
    jm, pm = je.run(js), pe.run(ps)
    assert_matches(je, jm, pe, pm)
    assert pe.fleet_log and pe.fault_stats["scale_ups"] > 0
    assert pe.expert.workers == je.expert.workers
    assert_port_runs_equal(fixed, fixed.run(ps), pe, pm)
    # reset restores the fleet's lower bound
    pe.reset()
    assert pe.expert.workers == 1 and pe.fleet_log == []


# ---------------------------------------------------------------------------
# the model expert's pool: lifecycle and the process backend
# ---------------------------------------------------------------------------
def _tiny_expert_params():
    spec = TinyTFSpec(vocab=64, max_len=8, d_model=16, n_heads=2,
                      n_layers=1, d_ff=32, n_classes=2)
    return tinytf_init(torch.Generator().manual_seed(0), spec, "cpu"), spec


def test_model_expert_pool_closed_on_engine_reset():
    params, spec = _tiny_expert_params()
    _, ps = streams(16)
    before = threading.active_count()
    for _ in range(3):
        ex = ModelExpert(params=params, spec=spec, workers=2, device="cpu")
        eng = P.BatchedCascadeEngine(port_cfg(), ex, n_streams=S,
                                     max_delay=2, device="cpu")
        ex.poll(ex.submit_many([0, 1], ps.docs[:2]))
        assert threading.active_count() > before
        eng.reset()
        assert ex._executor is None
        eng.close()                               # idempotent
    assert threading.active_count() <= before + 1


def test_process_backend_matches_thread_and_rebuilds():
    params, spec = _tiny_expert_params()
    _, ps = streams(8)
    idxs, docs = list(range(8)), ps.docs[:8]
    th = ModelExpert(params=params, spec=spec, workers=2, device="cpu")
    pr = ModelExpert(params=params, spec=spec, workers=2, backend="process",
                     device="cpu")
    try:
        want = th.poll(th.submit_many(idxs, docs))
        np.testing.assert_array_equal(pr.poll(pr.submit_many(idxs, docs)),
                                      want)
        # children killed: the next ticket fails as a dead worker (or, if
        # the pool already noticed, runs on a rebuilt one), and the submit
        # after it runs on a rebuilt pool
        old = pr._executor
        for pid in list(old._processes):
            os.kill(pid, signal.SIGKILL)
        ticket = pr.submit_many(idxs, docs)
        try:
            np.testing.assert_array_equal(
                ticket.result_slice(0, 8, timeout=60), want)
            assert pr._executor is not old
        except ExpertWorkerDied:
            pass
        np.testing.assert_array_equal(pr.poll(pr.submit_many(idxs, docs)),
                                      want)
        assert pr._executor is not old
    finally:
        pr.close()
        th.close()
    assert pr._executor is None


def test_serve_cli_model_expert_process_backend():
    import io
    from contextlib import redirect_stdout
    from repro_torch.launch import serve
    buf = io.StringIO()
    with redirect_stdout(buf):
        serve.main(["--device", "cpu", "--ladder", "kernel-ci", "--expert",
                    "model", "--expert-backend", "process",
                    "--expert-workers", "2", "--samples", "32", "--batch",
                    "16", "--async-delay", "1", "--expert-timeout", "60",
                    "--log-every", "0"])
    out = buf.getvalue()
    assert "served 32 queries" in out and "expert_workers=2" in out
