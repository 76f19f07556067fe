"""The port's runtime sanitizers (``repro_torch.analysis.sanitize``) on the
CPU, mirroring ``tests/test_sanitize.py`` and held against the JAX
package's sanitizer.

* The differ on hand-built traces (exact first-divergence coordinates),
  trace persistence, the enable surface, and the two switchboards'
  independence.
* The determinism trace on the port's engines: the corrupted-params
  acceptance fixture is named at (tick 8, level 1, "params"); ``reset``
  and ``restore_state`` drop the trace; sequential and batched S=1
  traces are equal, state digests included; digests cover a leaf's
  contiguous bytes (a transposed view digests as its copy, bf16 as its
  16-bit words).
* Cross-package, on the CI kernel ladder from the JAX engine's bridged
  state with the same untrained model expert: the sequential and the
  S=8 batched traces of both packages diff to None on every field but
  ``state``; the bridged initial state digests equally in both; a trace
  saved by either package loads in the other.  Each engine's distinct
  call signatures equal the JAX engine's compile counts, name by name
  (the JAX state is re-materialised strongly typed first:
  ``deferral_init``'s ``jnp.full`` bias is weak-typed and costs the JAX
  engine one extra trace of each function taking it, a JAX artifact the
  port has no counterpart of).
* The lock sanitizer: unguarded reads and writes raise, disable restores
  bare access, instrumenting is idempotent, the pools (the simulated
  expert's shards, the model expert on 4 threads and on 2 spawned
  processes) run clean, an order cycle raises.
* The retrace probe is the identity when off and counts new signatures.
* ``serve --sanitize determinism,locks,retrace --trace-out`` on the CPU,
  both engines; depth 0 and depth 2 traces equal.
"""
import io
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
from repro.analysis import sanitize as jsan  # noqa: E402
from repro.models import students as JS  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro_torch.analysis import sanitize as san  # noqa: E402
from repro_torch.bridge import to_torch  # noqa: E402
from repro_torch.core.experts import ExpertTicket  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import students as PS  # noqa: E402
from repro_torch.tree import tree_leaves, tree_unflatten  # noqa: E402
from test_torch_engine import _bridge, _cfgs, _streams  # noqa: E402

ATTRS = ("params", "opt_state", "dparams", "dopt_state")
EXPERT_TF = dict(vocab=256, max_len=32, d_model=32, n_heads=2, n_layers=1,
                 d_ff=64, n_classes=2)


@pytest.fixture(autouse=True)
def _sanitizers_restored():
    """Both switchboards start all-off and get their modes back after."""
    prior = (san.active_modes(), jsan.active_modes())
    for m in (san, jsan):
        m.disable()
        m.reset_retrace()
    yield
    for m, modes in zip((san, jsan), prior):
        m.disable()
        m.reset_retrace()
        if modes:
            m.enable(modes)


# ---------------------------------------------------------------------------
# the differ on hand-built records
# ---------------------------------------------------------------------------
def rec(t, *, level=(0, 0), called=(0, 0), pred=(1, 1), rng=(11, 22),
        cache_n=(4, 4), cache_ptr=(0, 0), state=None):
    """One synthetic 2-lane, 2-level tick record."""
    return {"t": t, "level": list(level), "called": list(called),
            "pred": list(pred), "rng": list(rng), "cache_n": list(cache_n),
            "cache_ptr": list(cache_ptr),
            "state": dict(state) if state else
            {f"{li}.{a}": 7 for li in range(2) for a in ATTRS}}


def _state(**over):
    st = {f"{li}.{a}": 7 for li in range(2) for a in ATTRS}
    st.update({k.replace("_", ".", 1): v for k, v in over.items()})
    return st


DIFF_CASES = {
    "identical": ([rec(t) for t in range(5)], [rec(t) for t in range(5)],
                  None),
    "rng_names_tick_and_lane": (
        [rec(0), rec(1), rec(2)], [rec(0), rec(1), rec(2, rng=(11, 99))],
        dict(tick=2, lane=1, field="rng", a=22, b=99)),
    "routing_names_lane": (
        [rec(0), rec(1, level=(0, 2), called=(0, 1))],
        [rec(0), rec(1, level=(0, 1), called=(0, 1))],
        dict(tick=1, lane=1, field="level")),
    "state_names_level_and_attr": (
        [rec(0), rec(1)],
        [rec(0), rec(1, state=_state(**{"1_opt_state": 8}))],
        dict(tick=1, level=1, attr="opt_state", field="state", lane=None)),
    "params_before_echoes": (
        [rec(3)], [rec(3, state=_state(**{f"1_{a}": 9 for a in ATTRS}))],
        dict(tick=3, level=1, attr="params")),
    "rng_before_state": (
        [rec(0)], [rec(0, rng=(11, 99),
                       state={f"{li}.{a}": 9 for li in range(2)
                              for a in ATTRS})],
        dict(field="rng", lane=1)),
    "cache_mirror_names_level": (
        [rec(0, cache_ptr=(0, 3))], [rec(0, cache_ptr=(0, 4))],
        dict(field="cache_ptr", level=1)),
    "length_mismatch": (
        [rec(0), rec(1), rec(2)], [rec(0), rec(1)],
        dict(field="length", tick=2, index=2, a=3, b=2)),
    "tick_number": ([rec(0), rec(1)], [rec(0), rec(5)],
                    dict(field="t", a=1, b=5)),
}


@pytest.mark.parametrize("case", list(DIFF_CASES))
def test_diff_traces_hand_built(case):
    a, b, want = DIFF_CASES[case]
    d = san.diff_traces(a, b)
    if want is None:
        assert d is None
        return
    for key, val in want.items():
        assert getattr(d, key) == val, (key, d.describe())
    # the JAX package's differ names the same point
    assert jsan.diff_traces(a, b) == jsan.Divergence(**vars(d))


def test_describe_and_trace_objects():
    d = san.diff_traces([rec(0), rec(1), rec(2)],
                        [rec(0), rec(1), rec(2, rng=(11, 99))])
    assert "tick 2, lane 1" in d.describe()
    ta, tb = san.Trace(), san.Trace()
    for t in range(3):
        ta.append(rec(t))
        tb.append(rec(t))
    assert san.diff_traces(ta, tb) is None and len(ta) == 3


def test_save_load_roundtrip(tmp_path):
    tr = san.Trace()
    for t in range(4):
        tr.append(rec(t, rng=(t, t + 1)))
    path = str(tmp_path / "trace.jsonl")
    tr.save(path)
    back = san.Trace.load(path)
    assert back.ticks == tr.ticks
    assert san.diff_traces(tr, back) is None


def test_concat_traces_needs_abutting_segments():
    a, b = san.Trace(), san.Trace()
    a.ticks, b.ticks = [rec(1), rec(2)], [rec(3)]
    assert [r["t"] for r in san.concat_traces(a, b).ticks] == [1, 2, 3]
    assert san.concat_traces(None, b) is b
    with pytest.raises(ValueError, match="do not abut"):
        san.concat_traces(b, a)


# ---------------------------------------------------------------------------
# enable surface
# ---------------------------------------------------------------------------
def test_enable_disable_roundtrip_and_unknown_mode():
    san.enable({"determinism"})
    assert san.determinism_on()
    san.disable({"determinism"})
    assert not san.determinism_on()
    with pytest.raises(ValueError, match="unknown sanitize mode"):
        san.enable({"quantum"})


def test_enable_from_env(monkeypatch):
    monkeypatch.setenv(san.ENV_VAR, "determinism, retrace")
    assert san.enable_from_env() == {"determinism", "retrace"}
    assert san.determinism_on() and san.retrace_on()
    san.disable()
    monkeypatch.delenv(san.ENV_VAR)
    assert san.enable_from_env() == set() and san.active_modes() == set()


def test_determinism_trace_restores_prior_state():
    with san.determinism_trace():
        assert san.determinism_on()
    assert not san.determinism_on()
    san.enable({"determinism"})
    with san.determinism_trace():
        pass
    assert san.determinism_on()


def test_switchboards_are_independent():
    san.enable({"determinism", "retrace"})
    assert jsan.active_modes() == set()
    san.disable()
    jsan.enable({"determinism"})
    assert san.active_modes() == set() and not san.determinism_on()


# ---------------------------------------------------------------------------
# digests
# ---------------------------------------------------------------------------
class _Lvl:
    def __init__(self, params):
        self.params = params


def test_state_digest_covers_contiguous_and_bf16_bytes():
    import zlib
    gen = torch.Generator().manual_seed(0)
    w = torch.randn((6, 5), generator=gen)
    h = torch.randn((7,), generator=gen).to(torch.bfloat16)
    got = san.state_digests([_Lvl({"w": w.t(), "h": h})], attrs=("params",))
    # tree order sorts keys ("h" before "w"); bf16 as its 16-bit words
    want = zlib.crc32(h.view(torch.int16).numpy().tobytes())
    want = zlib.crc32(np.ascontiguousarray(w.numpy().T).tobytes(), want)
    assert got == {"0.params": want & 0xFFFFFFFF}
    same = san.state_digests([_Lvl({"w": w.t().contiguous(), "h": h})],
                             attrs=("params",))
    assert same == got


# ---------------------------------------------------------------------------
# the determinism trace on the port's engines
# ---------------------------------------------------------------------------
def _port(n_streams=None, **opts):
    _, pcfg = _cfgs()
    _, ps = _streams()
    ex = P.SimulatedExpert(ps, **opts.pop("expert_kw", {}))
    if n_streams is None:
        return P.OnlineCascade(pcfg, ex, device="cpu"), ps
    return (P.BatchedCascadeEngine(pcfg, ex, n_streams=n_streams,
                                   device="cpu", **opts), ps)


def test_corrupted_params_named_exactly():
    a, ps = _port(2)
    b, _ = _port(2)
    with san.determinism_trace():
        for start in range(0, 40, 2):
            idxs = [start, start + 1]
            docs = [ps.docs[i] for i in idxs]
            if b.t == 7:
                lv = b.levels[1]
                leaves = tree_leaves(lv.params)
                leaves[0] = leaves[0].clone()
                leaves[0][0] += 1.0
                lv.params = tree_unflatten(lv.params, leaves)
            a.process_tick(idxs, docs)
            b.process_tick(idxs, docs)
        a.flush(), b.flush()
    d = san.diff_traces(san.trace_of(a), san.trace_of(b))
    assert d is not None and d.field == "state"
    assert (d.tick, d.level, d.attr) == (8, 1, "params"), d.describe()
    assert "level 1, attr 'params'" in d.describe()


def test_no_trace_when_off_and_reset_drops_it():
    eng, ps = _port(2)
    eng.run(ps)
    assert san.trace_of(eng) is None
    seq, _ = _port()
    with san.determinism_trace():
        eng.reset()
        eng.run(ps)
        for i in range(4):
            seq.process(i, ps.docs[i])
    assert len(san.trace_of(eng)) == 32 and len(san.trace_of(seq)) == 4
    eng.reset()
    seq.reset()
    assert san.trace_of(eng) is None and san.trace_of(seq) is None


def test_restore_drops_trace(tmp_path):
    for n_streams in (None, 2):
        eng, ps = _port(n_streams)
        path = str(tmp_path / f"ck{n_streams}")
        if n_streams is None:
            for i in range(4):
                eng.process(i, ps.docs[i])
        else:
            eng.process_tick([0, 1], ps.docs[:2])
        eng.save_state(path)
        with san.determinism_trace():
            if n_streams is None:
                eng.process(4, ps.docs[4])
            else:
                eng.process_tick([2, 3], ps.docs[2:4])
        assert san.trace_of(eng) is not None
        eng.restore_state(path)
        assert san.trace_of(eng) is None


def test_sequential_and_batched_s1_traces_equal():
    seq, ps = _port()
    bat, _ = _port(1)
    with san.determinism_trace():
        seq.run(ps)
        bat.run(ps)
    ta, tb = san.trace_of(seq), san.trace_of(bat)
    assert len(ta) == len(tb) == len(ps)
    d = san.diff_traces(ta, tb)
    assert d is None, d.describe()
    assert any(r["level"][0] < 3 for r in ta.ticks)   # students answer


# ---------------------------------------------------------------------------
# the port against the JAX package: traces and signatures
# ---------------------------------------------------------------------------
def _strong(engine):
    """Re-materialise a JAX engine's state strongly typed (same values)."""
    for lvl in engine.levels:
        for attr in ATTRS:
            setattr(lvl, attr, jax.tree_util.tree_map(
                lambda x: jnp.array(np.asarray(x)), getattr(lvl, attr)))


@pytest.fixture(scope="module")
def cross():
    """Both packages' sequential and S=8 engines on one stream, from the
    JAX engines' bridged state, with one untrained model expert (W=1),
    under determinism and retrace: traces, signature counts and the
    bridged initial state's digests."""
    prior = (san.active_modes(), jsan.active_modes())
    jcfg, pcfg = _cfgs()
    js, ps = _streams()
    jspec = JS.TinyTFSpec(**EXPERT_TF)
    jp = JS.tinytf_init(jax.random.PRNGKey(0), jspec)
    out = {}
    try:
        for m in (san, jsan):
            m.enable({"determinism", "retrace"})
        for name, n_streams in (("sequential", None), ("batched", 8)):
            for m in (san, jsan):
                m.reset_retrace()
            jx = J.ModelExpert(params=jp, spec=jspec)
            px = P.ModelExpert(
                params=to_torch(jax.tree_util.tree_map(np.asarray, jp),
                                "cpu"),
                spec=PS.TinyTFSpec(**EXPERT_TF), device="cpu")
            if n_streams is None:
                je, pe = J.OnlineCascade(jcfg, jx), P.OnlineCascade(
                    pcfg, px, device="cpu")
            else:
                je = J.BatchedCascadeEngine(jcfg, jx, n_streams=n_streams)
                pe = P.BatchedCascadeEngine(pcfg, px, n_streams=n_streams,
                                            device="cpu")
            _bridge(je, pe)
            _strong(je)
            digests = (jsan.state_digests(je.levels),
                       san.state_digests(pe.levels))
            jm, pm = je.run(js), pe.run(ps)
            jx.close(), px.close()
            out[name] = dict(
                traces=(jsan.trace_of(je), san.trace_of(pe)),
                counts=(jsan.retrace_report(), san.retrace_report()),
                digests=digests, calls=(jm["expert_calls"],
                                        pm["expert_calls"]))
    finally:
        for m, modes in zip((san, jsan), prior):
            m.disable()
            m.reset_retrace()
            if modes:
                m.enable(modes)
    return out


def _stateless(trace):
    return [{k: v for k, v in r.items() if k != "state"}
            for r in trace.ticks]


@pytest.mark.parametrize("engine", ["sequential", "batched"])
def test_traces_match_jax_engine(cross, engine):
    jt, pt = cross[engine]["traces"]
    assert len(jt) == len(pt) > 0
    d = san.diff_traces(_stateless(jt), _stateless(pt))
    assert d is None, d.describe()
    levels = [lv for r in pt.ticks for lv in r["level"]]
    assert min(levels) < 3 and max(levels) == 3   # students and expert
    assert cross[engine]["calls"][0] == cross[engine]["calls"][1]
    # the bridged initial state digests equally in both packages
    assert cross[engine]["digests"][0] == cross[engine]["digests"][1]


@pytest.mark.parametrize("engine", ["sequential", "batched"])
def test_signatures_match_jax_compile_counts(cross, engine):
    jc, pc = cross[engine]["counts"]
    assert pc == jc
    if engine == "batched":
        assert {f"route_pass[{i}]" for i in range(3)} <= set(pc)
        assert pc["expert.predict"] > 1       # shard sizes vary
        assert pc["cache_scatter"] == 1
    else:
        assert {"lr.predict_and_defer", "ssm.deferral_step",
                "tinytf_flash.student_step", "expert.predict"} <= set(pc)
    assert all(k.split(".")[-1] in ("student_step", "deferral_step",
                                    "predict_and_defer", "predict")
               or k in ("cache_scatter",) or k.startswith("route_pass")
               for k in pc)


def test_traces_cross_packages_as_jsonl(cross, tmp_path):
    jt, pt = cross["batched"]["traces"]
    pj, jj = str(tmp_path / "port.jsonl"), str(tmp_path / "jax.jsonl")
    pt.save(pj)
    jt.save(jj)
    from_port = jsan.Trace.load(pj)
    from_jax = san.Trace.load(jj)
    assert from_port.ticks == pt.ticks and from_jax.ticks == jt.ticks
    assert jsan.diff_traces(_stateless(from_port),
                            _stateless(jt)) is None
    assert san.diff_traces(_stateless(from_jax), _stateless(pt)) is None


# ---------------------------------------------------------------------------
# lock sanitizer
# ---------------------------------------------------------------------------
def test_unguarded_shards_access_raises():
    san.enable({"locks"})
    ticket = ExpertTicket(labels=np.array([1, 0, 1]))
    with pytest.raises(san.LockSanitizerError,
                       match=r"_shards read .* guarded-by"):
        ticket._shards
    with ticket._lock:
        assert len(ticket._shards) == 1
    assert ticket.done()
    with pytest.raises(san.LockSanitizerError, match="write"):
        ticket._shards = []


def test_disable_restores_bare_access_and_instrumenting_is_idempotent():
    san.enable({"locks"})
    ticket = ExpertTicket(labels=np.array([1, 0]))
    first = san.instrument_locks()
    assert san.instrument_locks() == first
    assert {"ExpertTicket._shards", "ModelExpert._executor",
            "ModelExpert._streams", "SimulatedExpert._submit_seq",
            "FlakyExpert._submit_seq"} <= set(first)
    san.disable({"locks"})
    assert len(ticket._shards) == 1
    # the port's instrumentation is the port's: the JAX classes are bare
    from repro.core.experts import ExpertTicket as JTicket
    assert len(JTicket(labels=np.array([1]))._shards) == 1


@pytest.mark.parametrize("expert", ["simulated", "thread", "process"])
def test_w4_pool_runs_clean_under_lock_sanitizer(expert):
    """The simulated expert's shards and the model expert's pool, on
    threads and on spawned processes (the children are not instrumented;
    the parent's tickets and pool are)."""
    san.enable({"locks"})
    _, pcfg = _cfgs()
    _, ps = _streams()
    if expert == "simulated":
        ex = P.SimulatedExpert(ps, workers=4)
    else:
        spec = PS.TinyTFSpec(**EXPERT_TF)
        ex = P.ModelExpert(params=PS.tinytf_init(
            torch.Generator().manual_seed(0), spec, torch.device("cpu")),
            spec=spec, workers=4 if expert == "thread" else 2,
            backend=expert, device="cpu")
    eng = P.BatchedCascadeEngine(pcfg, ex, n_streams=8, max_delay=2,
                                 per_lane=True, device="cpu")
    try:
        m = eng.run(ps)
    finally:
        eng.close()
    assert m["expert_calls"] > 0
    assert san.lock_order_violations() == []


def test_lock_order_cycle_detected():
    la, lb = san.tracked_rlock("A"), san.tracked_rlock("B")
    try:
        with la:
            with lb:
                pass
        with pytest.raises(san.LockOrderError, match="cycle"):
            with lb:
                with la:
                    pass
        assert len(san.lock_order_violations()) == 1
    finally:
        san._held.stack = []
        san.uninstrument_locks()


# ---------------------------------------------------------------------------
# retrace probe
# ---------------------------------------------------------------------------
def test_probe_is_identity_when_off():
    def f(x):
        return x
    assert san.trace_probe("f", f) is f


def test_probe_counts_new_signatures_not_calls():
    san.enable({"retrace"})
    step = san.trace_probe("step", lambda x, k=None: x * 2)
    step(torch.ones(4))
    step(torch.ones(4))
    assert san.retrace_report() == {"step": 1}
    step(torch.ones(8))
    step(torch.ones(8, dtype=torch.float64))
    step(torch.ones(4), k=torch.ones(()))
    assert san.retrace_report() == {"step": 4}
    assert san.retrace_check(limit=4) == {}
    assert san.retrace_check(limit=3) == {"step": 4}
    san.reset_retrace()
    step(torch.ones(4))                       # seen before the reset
    assert san.retrace_report() == {}


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------
def _cli(argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        serve.main(argv)
    return buf.getvalue()


@pytest.mark.parametrize("engine", ["batched", "sequential"])
def test_serve_cli_sanitize_and_trace_out(tmp_path, engine):
    base = ["--device", "cpu", "--ladder", "kernel-ci", "--expert",
            "simulated", "--samples", "48", "--log-every", "0",
            "--engine", engine]
    if engine == "batched":
        base += ["--batch", "8"]
    a, b = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
    out = _cli(base + ["--sanitize", "determinism,locks,retrace",
                       "--trace-out", a])
    n = 6 if engine == "batched" else 48
    assert f"determinism trace: {n} tick record(s) -> {a}" in out, out
    assert "lock sanitizer: clean run, 0 order violation(s)" in out
    assert "retrace sanitizer:" in out and "UNEXPECTED" not in out
    assert san.active_modes() == set()        # the CLI's modes are undone
    extra = ["--pipeline-depth", "2"] if engine == "batched" else []
    _cli(base + extra + ["--sanitize", "determinism", "--trace-out", b])
    d = san.diff_traces(san.Trace.load(a), san.Trace.load(b))
    assert d is None, d.describe()
    out = _cli(base + ["--trace-out", b])
    assert "no determinism trace was recorded" in out
