"""The port's expert pool and per-lane commits
(``BatchedCascadeEngine(per_lane=True)``, ``core/experts.py``) on the
CPU, against the JAX engine (setup and contract: ``test_torch_async.py``).

* Per-lane commits at D = 2 over a pool of 4 workers with an adversarial
  latency schedule: the reference's routing, state and commit log.
* W and latency invariance, port against port: W in {1, 2, 4} under four
  latency schedules give identical routing, bitwise state and the same
  commit log, per lane and per tick.
* W=1 and W=4 resumed from one warm per-lane checkpoint (``chip_smoke.py``
  phase 8 (b)): students answer some lanes of the served ticks, the runs
  are bitwise equal with one commit log, and the JAX engine restored from
  the same checkpoint matches the W=4 run.  Every W pair here must route
  a share of its items to the students.
* Per-lane commits at S = 1 are the sequential engine's per-item update
  schedule, bitwise.
* The commit log: every annotated lane exactly once, within D ticks, in
  (submit tick, lane) order; mean age below the per-tick drain's.
* ``lanes_due`` and ``shard_bounds`` equal the reference functions over a
  grid; the lazy, latent simulated ticket; ``result_slice`` blocking per
  shard; the legacy ticket forms; the model expert's pool labels equal
  per-shard ``label_batch`` for every W, reproducibly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core.batched import lanes_due as j_lanes_due  # noqa: E402
from repro.core.experts import shard_bounds as j_shard_bounds  # noqa: E402
import repro.core as J  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro_torch.core.batched import lanes_due  # noqa: E402
from repro_torch.core.experts import (ExpertTicket, poll_ticket,  # noqa: E402
                                      poll_ticket_partial, shard_bounds)
from repro_torch.models.students import TinyTFSpec, tinytf_init  # noqa: E402
from test_torch_async import (EXPERT, S, assert_matches,  # noqa: E402
                              assert_port_runs_equal, port_cfg, ref,
                              streams)

# adversarial per-shard latency schedules, in non-blocking done() probes
LATENCIES = {
    "none": None,
    "constant": 4,
    "alternating": lambda seq, j: 7 if (seq + j) % 2 else 0,
    "pseudo_random": lambda seq, j: (seq * 2654435761 + j * 40503) % 9,
}


# the warm run's ticks: on the CI ladder (hatespeech, S = 8, per-lane
# commits at D = 2) students first answer at tick 3
WARM_TICKS, SERVED_TICKS = 2, 8


def _port_engine(ps, *, workers=1, latency=None, per_lane=True, D=2, s=S):
    return P.BatchedCascadeEngine(
        port_cfg(), P.SimulatedExpert(ps, EXPERT, workers=workers,
                                      latency=latency),
        n_streams=s, max_delay=D, per_lane=per_lane, device="cpu")


def _port_run(n, **kw):
    _, ps = streams(n)
    eng = _port_engine(ps, **kw)
    return eng, eng.run(ps)


def student_share(level_counts) -> float:
    """The share of items a student answered (the last level is the
    expert), from per-level item counts."""
    return 1.0 - level_counts[-1] / level_counts.sum()


def test_per_lane_pool_matches_jax(ref):
    lat = LATENCIES["pseudo_random"]
    je, pe, js, ps = ref.pair(
        128, max_delay=2, per_lane=True,
        j_expert=lambda s: J.SimulatedExpert(s, EXPERT, workers=4,
                                             latency=lat),
        p_expert=lambda s: P.SimulatedExpert(s, EXPERT, workers=4,
                                             latency=lat))
    jm, pm = je.run(js), pe.run(ps)
    assert_matches(je, jm, pe, pm)
    # per-lane spreads commits inside the window: ages 1 and 2 both occur
    assert {c - t for t, _s, c in pe.commit_log} >= {1, 2}


@pytest.mark.parametrize("max_delay", [0, 2])
def test_worker_and_latency_invariance_bitwise(max_delay):
    ref_eng, m_ref = _port_run(96, workers=1, D=max_delay)
    for workers in (2, 4):
        for name, latency in LATENCIES.items():
            eng, m = _port_run(96, workers=workers, latency=latency,
                               D=max_delay)
            assert_port_runs_equal(ref_eng, m_ref, eng, m)
            assert eng.commit_log == ref_eng.commit_log, (workers, name)
    assert student_share(np.asarray(m_ref["level_fractions"])) > 0


def test_per_tick_mode_is_worker_invariant_too():
    a, ma = _port_run(96, workers=1, per_lane=False)
    b, mb = _port_run(96, workers=4, per_lane=False,
                      latency=LATENCIES["pseudo_random"])
    assert_port_runs_equal(a, ma, b, mb)
    assert a.commit_log == b.commit_log
    assert student_share(np.asarray(ma["level_fractions"])) > 0


def test_w_pair_resumed_from_one_warm_checkpoint(ref, tmp_path):
    """Phase 8 (b) of ``chip_smoke.py`` on the CPU: a per-lane engine
    served the ticks before the students first answer, saved, and
    restored into W=1 and W=4 (pseudo-random latency) and into the JAX
    engine; the next ticks route items to students and to the pool."""
    lat = LATENCIES["pseudo_random"]
    js, ps = streams((WARM_TICKS + SERVED_TICKS) * S)
    warm = _port_engine(ps)
    for t in range(WARM_TICKS):
        idxs = list(range(t * S, (t + 1) * S))
        warm.process_tick(idxs, [ps.docs[i] for i in idxs])
    path = str(tmp_path / "warm")
    warm.save_state(path)
    assert student_share(warm.level_counts.sum(axis=0)) == 0
    counts0 = warm.level_counts.sum(axis=0)
    runs = {}
    for w in (1, 4):
        eng = _port_engine(ps, workers=w, latency=lat if w > 1 else None)
        if w == 4:          # the JAX engine, configured like this one
            je = ref.start(eng, J.SimulatedExpert(js, EXPERT, workers=4,
                                                  latency=lat),
                           max_delay=2, per_lane=True)
            je.restore_state(path)
        eng.restore_state(path)
        runs[w] = (eng, eng.run(ps))
    for eng, _ in runs.values():
        assert student_share(eng.level_counts.sum(axis=0) - counts0) > 0
        called = np.stack(eng.history["expert_called"]).sum(axis=1)
        assert ((0 < called) & (called < S)).any()     # ragged ticks
    assert_port_runs_equal(*runs[1], *runs[4])
    assert runs[1][0].commit_log == runs[4][0].commit_log
    assert_matches(je, je.run(js), *runs[4])


def test_per_lane_s1_bitwise_parity_with_sequential():
    _, ps = streams(64)
    seq = P.OnlineCascade(port_cfg(), P.SimulatedExpert(ps, EXPERT),
                          device="cpu")
    eng = P.BatchedCascadeEngine(port_cfg(), P.SimulatedExpert(ps, EXPERT),
                                 n_streams=1, per_lane=True, device="cpu")
    ms, me = seq.run(ps), eng.run(ps)
    assert_port_runs_equal(seq, ms, eng, me)


def test_commit_log_exactly_once_bounded_ordered():
    D = 2
    eng, _ = _port_run(128, workers=2, D=D,
                       latency=LATENCIES["alternating"])
    log = eng.commit_log
    called = np.concatenate(eng.history["expert_called"])
    assert len(log) == int(called.sum())            # exactly once
    keys = [(t, s) for t, s, _c in log]
    assert len(set(keys)) == len(keys) and keys == sorted(keys)
    ages = np.array([c - t for t, _s, c in log])
    assert 0 <= ages.min() and ages.max() <= D
    per_tick, _ = _port_run(128, workers=1, per_lane=False, D=D)

    def mean_age(e):
        return e.commit_stats["age_sum"] / e.commit_stats["lanes"]

    assert mean_age(eng) < mean_age(per_tick)


def test_lanes_due_and_shard_bounds_match_reference():
    for k in range(0, 13):
        for D in range(0, 5):
            for age in range(0, 6):
                for per_lane in (False, True):
                    assert (lanes_due(k, age, D, per_lane)
                            == j_lanes_due(k, age, D, per_lane))
        for w in range(1, 9):
            assert shard_bounds(k, w) == j_shard_bounds(k, w)


# ---------------------------------------------------------------------------
# tickets
# ---------------------------------------------------------------------------
def test_simulated_expert_ticket_is_lazy_and_latent():
    _, ps = streams(16)
    exp = P.SimulatedExpert(ps, EXPERT, workers=2,
                            latency=lambda seq, j: 2 + j)
    table = ps.expert_labels(EXPERT)
    ticket = exp.submit_many(list(range(8)), ps.docs[:8])
    assert exp.poll(ticket, block=False) is None
    mask, labels = poll_ticket_partial(ticket)
    assert not mask.any() and (labels == -1).all()
    mask, labels = poll_ticket_partial(ticket)
    assert mask[:4].all() and not mask[4:].any()     # partial completion
    np.testing.assert_array_equal(labels[:4], table[:4])
    assert (labels[4:] == -1).all()
    mask, labels = exp.poll_partial(ticket)
    assert mask.all()
    np.testing.assert_array_equal(labels, table[:8])
    np.testing.assert_array_equal(exp.poll(ticket), table[:8])


def test_ticket_result_slice_blocks_per_shard():
    class _Probe:
        def __init__(self, labels):
            self.labels = labels
            self.resolved = False

        def done(self):
            return self.resolved

        def result(self):
            self.resolved = True
            return self.labels

    a = _Probe(np.array([1, 2], np.int32))
    b = _Probe(np.array([3, 4, 5], np.int32))
    ticket = ExpertTicket(shards=[(0, 2, a), (2, 5, b)])
    assert not ticket.done() and ticket.item_done(0) is False
    np.testing.assert_array_equal(ticket.result_slice(0, 2), [1, 2])
    assert a.resolved and not b.resolved
    np.testing.assert_array_equal(ticket.ready_mask(),
                                  [True, True, False, False, False])
    np.testing.assert_array_equal(ticket.result_slice(1, 4), [2, 3, 4])
    np.testing.assert_array_equal(ticket.result(), [1, 2, 3, 4, 5])
    assert ticket.done()


def test_ticket_legacy_forms():
    t1 = ExpertTicket(labels=np.array([7, 8], np.int32))
    assert t1.done()
    np.testing.assert_array_equal(t1.result_slice(1, 2), [8])
    with pytest.raises(ValueError):
        ExpertTicket()
    with pytest.raises(ValueError):
        ExpertTicket(labels=np.zeros(1, np.int32),
                     shards=[(0, 1, np.zeros(1, np.int32))])

    class _Fut:
        ready = False

        def done(self):
            return self.ready

        def result(self):
            return np.array([4, 5, 6], np.int32)

    t2 = ExpertTicket(future=_Fut())
    with pytest.raises(ValueError):
        t2.ready_mask()                     # length unknown in flight
    assert t2.item_done(99) is False
    t2._shards[0][2].ready = True
    np.testing.assert_array_equal(t2.ready_mask(), [True] * 3)
    with pytest.raises(IndexError):
        t2.item_done(99)
    np.testing.assert_array_equal(poll_ticket(t2, block=False), [4, 5, 6])


def test_model_expert_pool_deterministic_labels():
    _, ps = streams(24)
    spec = TinyTFSpec(vocab=256, max_len=32, d_model=32, n_heads=2,
                      n_layers=1, d_ff=64, n_classes=2)
    params = tinytf_init(torch.Generator().manual_seed(0), spec, "cpu")
    idxs, docs = list(range(12)), ps.docs[:12]
    labels = {}
    for w in (1, 4):
        ex = P.ModelExpert(params=params, spec=spec, workers=w,
                           device="cpu")
        try:
            got = ex.poll(ex.submit_many(idxs, docs))
            expect = np.concatenate([ex.label_batch(idxs[lo:hi],
                                                    docs[lo:hi])
                                     for lo, hi in shard_bounds(12, w)])
            np.testing.assert_array_equal(got, expect)
            np.testing.assert_array_equal(
                got, ex.poll(ex.submit_many(idxs, docs)))
            labels[w] = got
        finally:
            ex.close()
    np.testing.assert_array_equal(labels[1], labels[4])
