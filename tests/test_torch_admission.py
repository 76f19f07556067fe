"""The port's arrival schedules and continuous-batching front-end
(``repro_torch.core.admission``) against the JAX package's, on the CPU.

* The schedules (``lockstep`` / ``poisson`` / ``burst``) equal the
  reference's element by element over a few seeds and rates.
* Lifecycle properties over a fake engine that records what the
  front-end submits (reference ``tests/test_admission.py``): every
  admitted stream retires exactly once, no lane serves two streams in a
  tick, occupancy stays within the budget, admission is FCFS — and the
  port's admission log and submitted ticks equal the reference
  front-end's on the same schedule.
* The all-at-t=0 lockstep schedule through the front-end is bitwise the
  port's classic ``run`` at D0-P0, D2-P0, D0-P2 and D2-P2.
* Staggered Poisson and burst schedules: the port's admission log,
  records and routing equal the reference front-end's on the same
  schedule, state close at rtol 1e-4 / atol 1e-5.
* The frozen regime (``hard_budget=0``): each staggered stream is
  bitwise the port's sequential ``OnlineCascade`` keyed as that stream.
* An empty tick advances the commit deadlines and runs no forward; the
  occupancy arguments are validated; the front-end's checkpoint resumes
  bitwise and refuses another admission policy; the serve CLI runs
  ``--arrivals`` and ``--checkpoint-every`` / ``--restore``.

Setup: the CI-sized kernel ladder of ``tests/test_torch_engine.py``,
``hatespeech``, 64-96 items, lane budgets 4-8.
"""
import io
from contextlib import redirect_stdout

import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                                   # pragma: no cover
    from _hypothesis_stubs import given, settings, st

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.core as J  # noqa: E402
import repro.data as JD  # noqa: E402
import repro_torch.core as P  # noqa: E402
import repro_torch.data as PD  # noqa: E402
from repro.analysis.sanitize import diff_traces  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from test_torch_async import (EXPERT, Reference, port_cfg,  # noqa: E402
                              states_equal, streams)
from test_torch_engine import _assert_state_close, _records  # noqa: E402

N = 96


def _staggered(n=N):
    return PD.poisson_requests(n, rate=0.7, mean_len=5, seed=3)


def _as_tuples(reqs):
    return [(r.rid, r.arrival, tuple(r.items)) for r in reqs]


def port_engine(ps, lanes, cfg=None, ex=None, **opts):
    return P.BatchedCascadeEngine(
        cfg or port_cfg(), P.SimulatedExpert(ps, EXPERT, **(ex or {})),
        n_streams=lanes, device="cpu", **opts)


def _record_fields(fe):
    return {rid: (r.arrival, r.admit, r.lane, r.done, r.retired, r.shed,
                  r.items_done, r.expert_calls, r.predictions, r.levels,
                  r.commit_ticks)
            for rid, r in fe.records.items()}


@pytest.fixture(scope="module")
def ref():
    return Reference()


# ---------------------------------------------------------------------------
# the schedules
# ---------------------------------------------------------------------------
SCHEDULES = {
    "lockstep-8": ("lockstep", 50, {"n_lanes": 8}),
    "lockstep-64": ("lockstep", 30, {"n_lanes": 64}),
    "poisson-0": ("poisson", 2048, {"rate": 8, "mean_len": 8, "seed": 0}),
    "poisson-3": ("poisson", 96, {"rate": 0.7, "mean_len": 5, "seed": 3}),
    "poisson-1": ("poisson", 96, {"rate": 1, "mean_len": 5, "seed": 3}),
    "burst-0": ("burst", 2048, {"burst": 96, "every": 8, "mean_len": 8,
                                "seed": 0}),
    "burst-7": ("burst", 96, {"burst": 5, "every": 3, "mean_len": 4,
                              "seed": 7}),
}


@pytest.mark.parametrize("case", list(SCHEDULES))
def test_schedules_match_reference(case):
    kind, n, kw = SCHEDULES[case]
    mine = PD.arrival_schedule(kind, n, **dict(kw))
    theirs = JD.arrival_schedule(kind, n, **dict(kw))
    assert _as_tuples(mine) == _as_tuples(theirs)
    assert sorted(i for r in mine for i in r.items) == list(range(n))


def test_schedules_validate_like_reference():
    for bad in (lambda m: m.poisson_requests(8, rate=0),
                lambda m: m.burst_requests(8, burst=0),
                lambda m: m.lockstep_requests(8, 0),
                lambda m: m.arrival_schedule("trickle", 8)):
        for mod in (PD, JD):
            with pytest.raises(ValueError):
                bad(mod)


# ---------------------------------------------------------------------------
# lifecycle properties (a fake engine: admission logic alone)
# ---------------------------------------------------------------------------
class _FakeStream:
    def __init__(self, n):
        self.docs = list(range(n))

    def __len__(self):
        return len(self.docs)


class _FakeEngine:
    """The tick surface the front-end drives, recording each tick."""

    def __init__(self, n_streams):
        self.n_streams = n_streams
        self.pipeline_depth = 0
        self.t = 0
        self.commit_log = None
        self.ticks = []           # (t, lanes, stream_ids, stream_ticks)

    def process_tick(self, indices, docs, *, lanes=None, stream_ids=None,
                     stream_ticks=None):
        self.t += 1
        k = len(indices)
        self.ticks.append((self.t, list(lanes), list(stream_ids),
                           list(stream_ticks)))
        return {"tick": self.t, "indices": np.asarray(indices, np.int64),
                "lanes": np.asarray(lanes, np.int64),
                "predictions": np.zeros(k, np.int64),
                "levels": np.zeros(k, np.int64),
                "expert_called": np.zeros(k, bool),
                "cost_units": np.zeros(k),
                "expert_labels": np.full(k, -1, np.int32)}

    def drain(self):
        return []

    def flush(self):
        return 0


def _requests(mod, schedule):
    reqs, start, arrival = [], 0, 0
    for rid, (gap, length) in enumerate(schedule):
        arrival += gap
        reqs.append(mod.Request(rid=rid, arrival=arrival,
                                items=tuple(range(start, start + length))))
        start += length
    return reqs


def _check_lifecycle(schedule, budget, policy, queue_limit):
    reqs = _requests(PD, schedule)
    total = sum(len(r.items) for r in reqs)
    eng = _FakeEngine(budget)
    fe = P.CascadeFrontEnd(eng, _FakeStream(total), admission=policy,
                           queue_limit=queue_limit)
    fe.serve(reqs)
    seen = {}
    for _t, lanes, sids, sticks in eng.ticks:
        assert len(lanes) <= budget
        assert lanes == sorted(set(lanes)) and len(set(sids)) == len(sids)
        for sid, tick in zip(sids, sticks):
            seen.setdefault(sid, []).append(tick)
    for ticks in seen.values():
        assert ticks == list(range(1, len(ticks) + 1))
    shed = {r.rid for r in reqs if fe.records[r.rid].shed}
    assert not shed or policy == "shed"
    admitted = [rid for rid, _, _ in fe.admission_log]
    assert admitted == [r.rid for r in sorted(
        reqs, key=lambda r: (max(r.arrival, 1), r.rid)) if r.rid not in shed]
    for r in reqs:
        rec = fe.records[r.rid]
        if rec.shed:
            assert rec.admit == -1 and rec.items_done == 0
            continue
        assert rec.items_done == rec.n_items == len(seen[r.rid])
        assert 0 < max(r.arrival, 1) <= rec.admit <= rec.done < rec.retired
    # the reference front-end makes the same decisions on the same ticks
    jeng = _FakeEngine(budget)
    jfe = J.CascadeFrontEnd(jeng, _FakeStream(total), admission=policy,
                            queue_limit=queue_limit)
    jfe.serve(_requests(JD, schedule))
    assert fe.admission_log == jfe.admission_log
    assert eng.ticks == jeng.ticks
    assert fe.stats == jfe.stats
    assert fe.metrics()["tta_p99"] == jfe.metrics()["tta_p99"]


@given(st.lists(st.tuples(st.integers(0, 3), st.integers(1, 5)),
                min_size=1, max_size=12),
       st.integers(1, 4), st.sampled_from(["queue", "shed"]),
       st.integers(0, 2))
@settings(max_examples=40, deadline=None, derandomize=True)
def test_lifecycle_properties(schedule, budget, policy, queue_limit):
    _check_lifecycle(schedule, budget, policy, queue_limit)


@pytest.mark.parametrize("schedule,budget,policy,queue_limit", [
    ([(0, 3), (1, 2), (2, 4), (0, 1)], 2, "queue", 0),
    ([(0, 4)] * 6, 2, "shed", 1)], ids=["underload", "overload-shed"])
def test_lifecycle_smoke(schedule, budget, policy, queue_limit):
    _check_lifecycle(schedule, budget, policy, queue_limit)


# ---------------------------------------------------------------------------
# lockstep through the front-end == the classic run, bitwise
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("max_delay,depth", [(0, 0), (2, 0), (0, 2), (2, 2)],
                         ids=["D0-P0", "D2-P0", "D0-P2", "D2-P2"])
def test_lockstep_schedule_bitwise(max_delay, depth):
    S, n = 8, 64
    _, ps = streams(n)
    opts = {"max_delay": max_delay, "pipeline_depth": depth}
    classic = port_engine(ps, S, **opts)
    m_ref = classic.run(ps)
    eng = port_engine(ps, S, commit_log=True, **opts)
    fe = P.CascadeFrontEnd(eng, ps)
    fe.serve(PD.lockstep_requests(n, S))
    m = fe.metrics()
    assert m["answered"] == m["requests"] == S
    # one tick more than the classic run: the tick that retires every
    # stream is an empty one
    assert m["ticks"] == n // S + 1 and m["idle_ticks"] == 1
    assert np.array_equal(m_ref["predictions"], m["predictions"])
    assert m_ref["expert_calls"] == eng.expert_calls_total
    for key in ("level", "expert_called", "cost", "pred"):
        assert np.array_equal(np.concatenate(classic.history[key]),
                              np.concatenate(eng.history[key])), key
    assert states_equal(classic.levels, eng.levels)
    assert np.array_equal(classic.total_cost, eng.total_cost)
    # the same annotations commit in the same order (the empty last tick
    # moves the commit tick of the ones still pending at the stream end)
    assert [c[:2] for c in classic.commit_log] == \
        [c[:2] for c in eng.commit_log]
    assert not eng._pending and not eng._ring
    assert sum(len(r.commit_ticks) for r in fe.records.values()) == \
        len(eng.commit_log)


# ---------------------------------------------------------------------------
# staggered schedules against the reference front-end
# ---------------------------------------------------------------------------
STAGGERED = {
    "poisson-D0": (lambda m: m.poisson_requests(N, rate=0.7, mean_len=5,
                                                seed=3),
                   {}, {}, {}),
    "burst-shed-D2-P2": (lambda m: m.burst_requests(N, burst=12, every=3,
                                                    mean_len=4, seed=7),
                         {"max_delay": 2, "pipeline_depth": 2},
                         {"workers": 2},
                         {"admission": "shed", "queue_limit": 2}),
}


@pytest.mark.parametrize("case", list(STAGGERED))
def test_staggered_matches_reference(ref, case):
    schedule, opts, ex, policy = STAGGERED[case]
    js, ps = streams(N)
    pe = port_engine(ps, 8, ex=ex, commit_log=True, **opts)
    je = ref.start(pe, J.SimulatedExpert(js, EXPERT, **ex), **opts)
    jfe = J.CascadeFrontEnd(je, js, **policy)
    jfe.serve(schedule(JD))
    pfe = P.CascadeFrontEnd(pe, ps, **policy)
    pfe.serve(schedule(PD))
    assert pfe.admission_log == jfe.admission_log
    assert _record_fields(pfe) == _record_fields(jfe)
    assert pfe.stats == jfe.stats
    div = diff_traces(_records(je.history), _records(pe.history))
    assert div is None, div.describe()
    assert pe.commit_log == [tuple(int(v) for v in c) for c in je.commit_log]
    assert np.array_equal(pe.expert_calls, je.expert_calls)
    assert np.array_equal(pe.items_seen, je.items_seen)
    pm, jm = pfe.metrics(), jfe.metrics()
    assert np.array_equal(pm["predictions"], jm["predictions"])
    for key in ("tta_p50", "tta_p99", "queue_delay_mean", "occupancy_mean",
                "idle_ticks", "shed", "answered"):
        assert pm[key] == jm[key], key
    assert pm["shed"] > 0 if policy else pm["idle_ticks"] > 1
    _assert_state_close(je, pe)


@pytest.mark.parametrize("max_delay,depth", [(0, 0), (2, 2)],
                         ids=["D0-P0", "D2-P2"])
def test_frozen_regime_matches_sequential(max_delay, depth):
    """hard_budget=0 (no jumps, expert calls or updates): every admitted
    stream reproduces, item for item, a sequential cascade keyed as that
    stream, whatever lane, tick or co-occupants served it."""
    _, ps = streams(N)
    cfg0 = port_cfg(hard_budget=0)
    reqs = _staggered()
    eng = port_engine(ps, 4, cfg=cfg0, max_delay=max_delay,
                      pipeline_depth=depth)
    fe = P.serve_requests(eng, ps, reqs)
    assert fe.metrics()["answered"] == len(reqs)
    for r in reqs:
        casc = P.OnlineCascade(cfg0, P.SimulatedExpert(ps, EXPERT),
                               device="cpu")
        casc.stream_id = r.rid
        outs = [casc.process(i, ps.docs[i]) for i in r.items]
        rec = fe.records[r.rid]
        assert rec.predictions == [int(o["prediction"]) for o in outs]
        assert rec.levels == [int(o["level"]) for o in outs]


# ---------------------------------------------------------------------------
# the engine surface the front-end rests on
# ---------------------------------------------------------------------------
def test_empty_tick_advances_commit_deadlines():
    _, ps = streams(8)
    eng = port_engine(ps, 2, max_delay=2)
    out = eng.process_tick([0, 1], [ps.docs[0], ps.docs[1]])
    assert out["expert_called"].all() and len(eng._pending) == 1
    assert np.array_equal(out["lanes"], [0, 1])
    before = [lvl.forwards for lvl in eng.levels]
    snap = [[x.clone() for x in lvl.params.values()
             if isinstance(x, torch.Tensor)] for lvl in eng.levels]
    idle = eng.process_tick([], [])          # age 1: not yet due
    assert len(eng._pending) == 1 and idle["predictions"].shape == (0,)
    assert idle["lanes"].shape == (0,) and eng.t == 2
    eng.process_tick([], [])                 # age 2 == D: commits
    assert len(eng._pending) == 0
    assert eng.commit_log == [(1, 0, 3), (1, 1, 3)]
    # the idle ticks ran no route pass (the commit's updates are not
    # forwards), and the commit moved the students
    assert [lvl.forwards for lvl in eng.levels] == before
    assert any(not torch.equal(a, b) for lvl, ss in zip(eng.levels, snap)
               for a, b in zip([x for x in lvl.params.values()
                                if isinstance(x, torch.Tensor)], ss))
    assert eng.items_seen.tolist() == [1, 1]


def test_occupancy_lanes_account_and_validate():
    _, ps = streams(8)
    eng = port_engine(ps, 4)
    out = eng.process_tick([0, 1], [ps.docs[0], ps.docs[1]], lanes=[1, 3],
                           stream_ids=[7, 9], stream_ticks=[1, 1])
    assert np.array_equal(out["lanes"], [1, 3])
    assert eng.items_seen.tolist() == [0, 1, 0, 1]
    assert eng.expert_calls.tolist() == [0, 1, 0, 1]
    docs = [ps.docs[0], ps.docs[1]]
    for kw, match in (({"lanes": [1, 0]}, "strictly increasing"),
                      ({"lanes": [2, 9]}, "strictly increasing"),
                      ({"lanes": [0]}, "one entry per tick position"),
                      ({"stream_ids": [5]}, "stream_ids"),
                      ({"stream_ticks": [1]}, "stream_ticks")):
        with pytest.raises(ValueError, match=match):
            eng.process_tick([0, 1], docs, **kw)
    with pytest.raises(ValueError, match="admission"):
        P.CascadeFrontEnd(eng, ps, admission="drop-all")


def test_frontend_save_restore_resume(tmp_path):
    _, ps = streams(N)
    reqs = _staggered()
    full = port_engine(ps, 4, max_delay=2, commit_log=True)
    full_fe = P.serve_requests(full, ps, reqs)

    part = P.CascadeFrontEnd(port_engine(ps, 4, max_delay=2,
                                         commit_log=True), ps)
    part.serve(reqs, max_ticks=6, finalize=False)
    path = str(tmp_path / "fe")
    part.save_state(path)
    res_eng = port_engine(ps, 4, max_delay=2, commit_log=True)
    res = P.CascadeFrontEnd(res_eng, ps)
    res.restore_state(path, reqs)
    assert res_eng.t == 6
    res.serve(reqs)
    assert res.admission_log == full_fe.admission_log
    assert _record_fields(res) == _record_fields(full_fe)
    assert np.array_equal(res.metrics()["predictions"],
                          full_fe.metrics()["predictions"])
    assert states_equal(full.levels, res_eng.levels)
    other = P.CascadeFrontEnd(port_engine(ps, 4, max_delay=2), ps,
                              admission="shed", queue_limit=2)
    with pytest.raises(ValueError, match="policy mismatch"):
        other.restore_state(path, reqs)
    assert other.engine.t == 0               # refused before any restore


def test_serve_cli_arrivals_and_checkpoints(tmp_path):
    base = ["--device", "cpu", "--ladder", "kernel-ci", "--expert",
            "simulated", "--log-every", "0", "--seed", "5"]

    def cli(*extra):
        buf = io.StringIO()
        with redirect_stdout(buf):
            serve.main(base + list(extra))
        return buf.getvalue()

    out = cli("--samples", "64", "--batch", "8", "--arrivals", "poisson",
              "--arrival-rate", "0.8", "--request-len", "6",
              "--async-delay", "2", "--pipeline-depth", "2")
    assert "served 64 items of" in out and "time-to-answer p50=" in out
    assert "occupancy=" in out and "shed=0" in out, out
    out = cli("--samples", "64", "--lane-budget", "4", "--arrivals",
              "burst", "--burst-size", "8", "--arrival-rate", "2",
              "--admission", "shed", "--queue-limit", "1")
    assert "lanes=4" in out and "shed=0" not in out, out
    path = str(tmp_path / "live")
    full = cli("--samples", "64", "--batch", "8", "--async-delay", "2",
               "--checkpoint-every", "3", "--checkpoint-path", path)
    resumed = cli("--samples", "64", "--batch", "8", "--async-delay", "2",
                  "--restore", path)
    assert "resuming at tick 6, item 48" in resumed
    assert "served 16 queries" in resumed
    if not torch.cuda.is_available():
        # no fallback: without --device cpu the front-end wants the card
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve.main(["--ladder", "kernel-ci", "--expert", "simulated",
                        "--samples", "16", "--arrivals", "poisson",
                        "--restore", path])
    tail = [ln for ln in full.splitlines()
            if ln.startswith(("accuracy=", "level fractions"))]
    tail_r = [ln for ln in resumed.splitlines()
              if ln.startswith(("accuracy=", "level fractions"))]
    # expert calls and level fractions cover the whole stream either way
    assert tail[0].split()[1:] == tail_r[0].split()[1:] and \
        tail[1] == tail_r[1], (full, resumed)
