"""The port's pipelined route passes
(``BatchedCascadeEngine(pipeline_depth=...)``) on the CPU, against the
JAX engine (setup and contract: ``test_torch_async.py``).

* Depth 0 is bitwise the sequential engine at S = 1.
* Depth 2 against the reference in four regimes, with the reference's
  ``pipeline_stats`` exactly: the learning regime (stale speculation on
  every committing tick: refetches), composed with ``max_delay=2``
  (update fences, no refetch), near a hard budget (budget fences), and
  the converged regime (no expert traffic: no refetch, no fence); depth
  1 in the first two.  In each, depths 1 and 2 route as depth 0 does,
  with bitwise state.
* The driver API: at most P ticks in flight, FIFO results that map back
  through "indices"; ``process_tick`` and ``flush`` refuse in-flight
  ticks; ``reset`` clears the ring and reproduces the run.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro_torch.core as P  # noqa: E402
from test_torch_async import (EXPERT, S, _assert_same_routing,  # noqa: E402
                              assert_matches, assert_port_runs_equal,
                              port_cfg, ref, streams)

REGIMES = {
    # name: (items, hard budget, max_delay, pipeline depth)
    "learning": (128, None, 0, 2),
    "learning-depth1": (128, None, 0, 1),
    "async": (128, None, 2, 2),
    "async-depth1": (128, None, 2, 1),
    "budget": (128, 25, 0, 2),
    "converged": (128, 0, 0, 2),
}


def _port(n, P_depth, hard_budget=None, D=0):
    _, ps = streams(n)
    eng = P.BatchedCascadeEngine(port_cfg(hard_budget),
                                 P.SimulatedExpert(ps, EXPERT), n_streams=S,
                                 pipeline_depth=P_depth, max_delay=D,
                                 device="cpu")
    return eng, ps


def test_depth0_bitwise_parity_s1():
    _, ps = streams(64)
    seq = P.OnlineCascade(port_cfg(), P.SimulatedExpert(ps, EXPERT),
                          device="cpu")
    bat = P.BatchedCascadeEngine(port_cfg(), P.SimulatedExpert(ps, EXPERT),
                                 n_streams=1, pipeline_depth=0, device="cpu")
    assert_port_runs_equal(seq, seq.run(ps), bat, bat.run(ps))


@pytest.mark.parametrize("regime", list(REGIMES))
def test_pipelined_matches_jax(ref, regime):
    n, hb, D, depth = REGIMES[regime]
    je, pe, js, ps = ref.pair(n, hard_budget=hb, max_delay=D,
                              pipeline_depth=depth)
    jm, pm = je.run(js), pe.run(ps)
    assert_matches(je, jm, pe, pm)
    st = pe.pipeline_stats
    assert st["submitted"] == st["resolved"] == n // S
    if regime.startswith("learning"):
        assert st["refetches"] > 0
    elif regime.startswith("async"):
        assert st["update_fences"] > 0 and st["refetches"] == 0
    elif regime == "budget":
        assert st["budget_fences"] > 0 and pm["expert_calls"] <= hb
    else:
        assert st["refetches"] == st["update_fences"] \
            == st["budget_fences"] == 0
        assert pm["expert_calls"] == 0
    # any depth routes as depth 0 does, with bitwise state
    e0, _ = _port(n, 0, hb, D)
    m0 = e0.run(ps)
    for depth in (1, 2):
        eP, _ = _port(n, depth, hb, D)
        assert_port_runs_equal(e0, m0, eP, eP.run(ps))


# ---------------------------------------------------------------------------
# driver API
# ---------------------------------------------------------------------------
def test_submit_resolve_api_fifo_and_latency_bound():
    depth, ticks = 2, 6
    eng, ps = _port(S * ticks, depth, hard_budget=0)
    seen = []
    for tk in range(ticks):
        idxs = list(range(tk * S, (tk + 1) * S))
        seen += eng.submit_tick(idxs, [ps.docs[i] for i in idxs])
        assert len(eng._ring) <= depth
        if tk + 1 > depth:
            assert len(seen) == tk + 1 - depth
    seen.append(eng.resolve_tick())
    seen += eng.drain()
    assert eng.resolve_tick() is None
    assert [o["tick"] for o in seen] == list(range(1, ticks + 1))
    got = np.concatenate([o["indices"] for o in seen])
    np.testing.assert_array_equal(got, np.arange(S * ticks))


def test_process_tick_and_flush_reject_inflight_ticks():
    eng, ps = _port(2 * S, 2, D=2)
    eng.submit_tick(list(range(S)), ps.docs[:S])
    with pytest.raises(RuntimeError):
        eng.process_tick(list(range(S, 2 * S)), ps.docs[S:2 * S])
    with pytest.raises(RuntimeError):
        eng.flush()
    eng.drain()
    out = eng.process_tick(list(range(S, 2 * S)), ps.docs[S:2 * S])
    assert out["predictions"].shape == (S,)
    assert eng.flush() >= 0 and len(eng._pending) == 0


def test_reset_clears_pipeline_and_reproduces():
    eng, ps = _port(96, 2)
    m1 = eng.run(ps)
    h1 = {k: list(v) for k, v in eng.history.items()}
    eng.submit_tick(list(range(S)), ps.docs[:S])
    assert len(eng._ring) == 1
    eng.reset()
    assert len(eng._ring) == 0 and eng.pipeline_stats["submitted"] == 0
    m2 = eng.run(ps)
    np.testing.assert_array_equal(m1["predictions"], m2["predictions"])
    assert m1["expert_calls"] == m2["expert_calls"]
    _assert_same_routing(h1, eng.history)


def test_serve_cli_pipeline_depth_prints_the_same_run():
    """The CLI's engine-matrix flags on the CPU: ``--pipeline-depth 2``
    prints the same accuracy, expert calls and level fractions as depth
    0 under the async queue, a 4-worker pool, per-lane commits,
    autoscale and a shard deadline."""
    import io
    from contextlib import redirect_stdout
    from repro_torch.launch import serve
    base = ["--device", "cpu", "--ladder", "kernel-ci", "--expert",
            "simulated", "--samples", "96", "--batch", "16", "--seed", "5",
            "--log-every", "0", "--async-delay", "2", "--expert-workers",
            "4", "--per-lane-commit", "--autoscale", "1:4",
            "--expert-timeout", "1"]
    lines = {}
    for depth in ("0", "2"):
        buf = io.StringIO()
        with redirect_stdout(buf):
            serve.main(base + ["--pipeline-depth", depth])
        out = buf.getvalue()
        assert "served 96 queries" in out and "annotation commits" in out
        lines[depth] = [ln for ln in out.splitlines()
                        if ln.startswith(("accuracy=", "level fractions"))]
    assert len(lines["0"]) == 2 and lines["0"] == lines["2"]
