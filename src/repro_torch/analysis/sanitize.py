"""cascade-san on the port: runtime sanitizers for the PyTorch engines.

The port's own copy of the reference's ``analysis/sanitize.py``, with its
names, its JSONL trace schema and its three modes.  The switchboard is
the port's own: enabling a mode here enables nothing in the JAX package,
and the reverse holds too.  Every mode costs nothing when off: the
engines' hook sites guard on one set lookup (``determinism_on()``) or
call a function ``trace_probe`` returned unchanged, and nothing below
imports torch or numpy when the module is imported.

Determinism sanitizer
---------------------
``enable({"determinism"})`` makes every engine tick append one record to
a per-engine :class:`Trace`: crc32 digests of each ``STATE_ATTRS`` entry
per level, the tick's routing (chosen level / expert called / prediction
per lane), per-lane digests of the tick-RNG draws it consumed, and the
ring-buffer fill / ptr mirrors.  :func:`diff_traces` takes two traces —
``workers=1`` against ``4``, ``pipeline_depth=0`` against ``2``, a resume
against the uninterrupted run, the card against the CPU — and names the
FIRST point they part at (tick, lane, level, attr) granularity.  The
per-lane RNG digests hash numpy draws, so they are equal to the JAX
engine's on the same stream, and the record schema is shared: a trace
saved by either package loads in the other.

A state digest covers each leaf's raw C-order bytes (a bf16 leaf its
16-bit words), taken from ``.contiguous()`` tensors in
``repro_torch.tree.tree_leaves`` order, which sorts dict keys as
``jax.tree.leaves`` does.  All leaves of a tick go to the host in one
copy per device, which synchronises with the device: the trace is taken
where the reference takes it, after the tick's due commits.

Lock sanitizer
--------------
``enable({"locks"})`` instruments the ``# guarded-by:`` annotations of
``repro_torch.core.experts`` (the annotations cascade-lint CAS004 checks
statically): a read or write of an annotated attribute without its lock
held raises :class:`LockSanitizerError` at the access, and acquisitions
are tracked on a per-thread held stack, so an inconsistent order across
the pool's locks raises :class:`LockOrderError` (a cycle in the order
graph).

Retrace sanitizer
-----------------
PyTorch stages nothing, so a "compile" here is a call with a signature
the probe has not seen: ``enable({"retrace"})`` makes the engines wrap
each staged function with :func:`trace_probe`, which keys every call on
the tree of ``(shape, dtype)`` of its array leaves plus the type of each
other argument — what makes XLA retrace — and counts the new keys.
``retrace_report()`` gives the distinct signatures per function (the
capture set a CUDA graph of it would need) and ``retrace_check(limit)``
flags a shape leaking into a signature.

Enable with ``enable`` / ``disable``, with ``serve --sanitize
determinism,locks,retrace``, or from the environment
(``CASCADE_SANITIZE``, read by ``enable_from_env``).
"""
from __future__ import annotations

import ast
import contextlib
import json
import os
import re
import sys
import threading
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Set, Tuple

MODES = ("determinism", "locks", "retrace")

ENV_VAR = "CASCADE_SANITIZE"

_active: Set[str] = set()
_state_lock = threading.Lock()


class SanitizerError(RuntimeError):
    """Base class for sanitizer-detected invariant violations."""


class LockSanitizerError(SanitizerError):
    """A ``# guarded-by:`` attribute was touched without its lock held."""


class LockOrderError(SanitizerError):
    """Two locks were acquired in inconsistent order (deadlock hazard)."""


# ---------------------------------------------------------------------------
# mode switchboard
# ---------------------------------------------------------------------------
def enable(modes: Iterable[str]) -> None:
    """Turn on the given sanitizer modes (subset of :data:`MODES`)."""
    modes = set(modes)
    bad = modes - set(MODES)
    if bad:
        raise ValueError(f"unknown sanitize mode(s) {sorted(bad)}; "
                         f"choose from {MODES}")
    with _state_lock:
        _active.update(modes)
    if "locks" in modes:
        instrument_locks()


def disable(modes: Optional[Iterable[str]] = None) -> None:
    """Turn off the given modes (all when ``modes`` is None)."""
    modes = set(MODES) if modes is None else set(modes)
    with _state_lock:
        _active.difference_update(modes)
    if "locks" in modes:
        uninstrument_locks()


def active_modes() -> Set[str]:
    """The currently enabled sanitizer modes."""
    return set(_active)


def enable_from_env(var: str = ENV_VAR) -> Set[str]:
    """Enable the comma-separated modes named in ``$CASCADE_SANITIZE``;
    a no-op when the variable is unset or empty.  Returns the set."""
    raw = os.environ.get(var, "")
    modes = {m.strip() for m in raw.split(",") if m.strip()}
    if modes:
        enable(modes)
    return modes


# ---------------------------------------------------------------------------
# determinism sanitizer: per-tick trace + first-divergence differ
# ---------------------------------------------------------------------------
def determinism_on() -> bool:
    """Fast engine-side guard: is the determinism tracer recording?"""
    return "determinism" in _active


def retrace_on() -> bool:
    """Fast engine-side guard: is the retrace counter installed?"""
    return "retrace" in _active


class Trace:
    """One engine run's per-tick records (the determinism trace).

    Each record is a plain dict (JSON-serializable)::

        {"t":     tick number,
         "level": [chosen level per lane]      (nlev = went to expert),
         "called": [0/1 expert-called per lane],
         "pred":  [emitted prediction per lane],
         "rng":   [crc32 of lane's consumed (jump, action) draws],
         "cache_n": [ring fill per level], "cache_ptr": [ptr per level],
         "state": {"<level>.<attr>": crc32 of the state tree's leaves}}

    Traces of runs with the same tick shapes (same S, same stream) are
    comparable tick by tick with :func:`diff_traces`; the sequential
    engine records one 1-lane record per item, so it aligns with a
    batched ``n_streams=1`` trace.
    """

    def __init__(self) -> None:
        self.ticks: List[dict] = []

    def __len__(self) -> int:
        return len(self.ticks)

    def append(self, rec: dict) -> None:
        """Append one tick record."""
        self.ticks.append(rec)

    def save(self, path: str) -> None:
        """Write the trace as JSON-lines (one tick record per line)."""
        with open(path, "w", encoding="utf-8") as fh:
            for rec in self.ticks:
                fh.write(json.dumps(rec) + "\n")

    @staticmethod
    def load(path: str) -> "Trace":
        """Read a trace written by :meth:`save` (of either package)."""
        tr = Trace()
        with open(path, "r", encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if line:
                    tr.append(json.loads(line))
        return tr


def trace_of(engine) -> Optional[Trace]:
    """The trace recorded on ``engine`` (None when never recorded)."""
    return getattr(engine, "_san_trace", None)


def concat_traces(a: Optional[Trace], b: Optional[Trace]
                  ) -> Optional[Trace]:
    """Join two trace segments end to end (a checkpointed run's trace
    before the save and the resumed engine's after it), comparable with
    an uninterrupted run's.  ``b``'s first tick must follow ``a``'s last.
    """
    if a is None or b is None:
        return b if a is None else a
    if a.ticks and b.ticks:
        last, first = a.ticks[-1].get("t"), b.ticks[0].get("t")
        if last is not None and first is not None and first != last + 1:
            raise ValueError(
                f"trace segments do not abut: first ends at tick {last}, "
                f"second starts at tick {first}")
    out = Trace()
    out.ticks = list(a.ticks) + list(b.ticks)
    return out


def drop_trace(engine) -> None:
    """Discard ``engine``'s recorded trace (the engines call this from
    ``reset()`` and ``restore_state()``, so the state the engine then
    holds starts a fresh, comparable trace)."""
    if getattr(engine, "_san_trace", None) is not None:
        engine._san_trace = None


def lane_rng_digests(u_jump, u_act) -> List[int]:
    """Per-lane crc32 of the consumed tick-RNG draws.

    ``u_jump`` / ``u_act`` are the raw (nlev, S) jump / action draws; lane
    s's digest covers its column of both (jump as float64, action as
    float32 — the dtypes the engines consume them at), so a lane whose
    key stream diverged is named directly by the differ.
    """
    import numpy as np
    uj = np.asarray(u_jump, np.float64).reshape(len(u_jump), -1)
    ua = np.asarray(u_act, np.float32).reshape(len(u_act), -1)
    out = []
    for s in range(uj.shape[1]):
        crc = zlib.crc32(np.ascontiguousarray(uj[:, s]).tobytes())
        crc = zlib.crc32(np.ascontiguousarray(ua[:, s]).tobytes(), crc)
        out.append(crc & 0xFFFFFFFF)
    return out


def _leaf_bytes(leaf):
    """A leaf's raw C-order bytes: a flat uint8 tensor on the leaf's
    device (a bf16 leaf's 16-bit words as they are), or a numpy uint8
    array for a leaf that is not a tensor."""
    import numpy as np
    import torch
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().contiguous().reshape(-1).view(torch.uint8)
    return np.ascontiguousarray(np.asarray(leaf)).reshape(-1).view(np.uint8)


def _to_host(parts: list) -> list:
    """numpy copies of ``parts`` (uint8 tensors or arrays): the tensors of
    each device concatenated and copied to the host at once."""
    import numpy as np
    import torch
    out = list(parts)
    by_dev: Dict[Any, List[int]] = {}
    for j, p in enumerate(parts):
        if isinstance(p, torch.Tensor):
            by_dev.setdefault(p.device, []).append(j)
    for idx in by_dev.values():
        host = torch.cat([parts[j] for j in idx]).cpu().numpy()
        ends = np.cumsum([parts[j].numel() for j in idx])
        for j, chunk in zip(idx, np.split(host, ends[:-1])):
            out[j] = chunk
    return out


def state_digests(levels, attrs: Optional[Tuple[str, ...]] = None
                  ) -> Dict[str, int]:
    """crc32 per ``"<level>.<attr>"`` over the state tree's leaf bytes.

    ``attrs`` defaults to the engines' ``STATE_ATTRS`` (params,
    opt_state, dparams, dopt_state).  Bitwise-equal state trees digest
    identically; any leaf-level difference changes the digest, so the
    differ can name exactly which (level, attr) moved first.
    """
    from repro_torch.tree import tree_leaves
    if attrs is None:
        from repro_torch.core.cascade import STATE_ATTRS
        attrs = STATE_ATTRS
    keys, counts, parts = [], [], []
    for li, lvl in enumerate(levels):
        for attr in attrs:
            leaves = tree_leaves(getattr(lvl, attr))
            keys.append(f"{li}.{attr}")
            counts.append(len(leaves))
            parts.extend(_leaf_bytes(x) for x in leaves)
    host = iter(_to_host(parts))
    out: Dict[str, int] = {}
    for key, n in zip(keys, counts):
        crc = 0
        for _ in range(n):
            crc = zlib.crc32(next(host).tobytes(), crc)
        out[key] = crc & 0xFFFFFFFF
    return out


def record_tick(engine, *, t: int, level, called, pred, u_jump, u_act,
                cache_n, cache_ptr, levels) -> None:
    """Append one tick record to ``engine``'s trace (engine hook).

    Called by ``OnlineCascade.process`` and
    ``BatchedCascadeEngine._route_resolve`` at the end of every tick,
    only when :func:`determinism_on`.  All digesting happens here, so the
    engines hold no sanitizer logic beyond the one guarded call.
    """
    import numpy as np
    tr = getattr(engine, "_san_trace", None)
    if tr is None:
        tr = Trace()
        engine._san_trace = tr
    tr.append({
        "t": int(t),
        "level": [int(x) for x in np.atleast_1d(level)],
        "called": [int(bool(x)) for x in np.atleast_1d(called)],
        "pred": [int(x) for x in np.atleast_1d(pred)],
        "rng": lane_rng_digests(u_jump, u_act),
        "cache_n": [int(x) for x in cache_n],
        "cache_ptr": [int(x) for x in cache_ptr],
        "state": state_digests(levels),
    })


@contextlib.contextmanager
def determinism_trace():
    """Context manager: record determinism traces for a ``with`` block.

    Enables the determinism sanitizer (restoring its prior off state on
    exit — an enable that predates the block stays on); read each
    engine's trace with :func:`trace_of` after its run.
    """
    was_on = determinism_on()
    enable({"determinism"})
    try:
        yield
    finally:
        if not was_on:
            disable({"determinism"})


@dataclass
class Divergence:
    """The first point two determinism traces disagree.

    ``tick`` is the engine tick number (record field ``t``); ``index``
    its position in the trace.  ``lane`` / ``level`` / ``attr`` are set
    when the diverging field has that granularity (routing arrays name
    the lane, cache mirrors the level, state digests the (level, attr)
    pair).  ``a`` / ``b`` are the two observed values.
    """

    tick: int
    index: int
    field: str
    lane: Optional[int] = None
    level: Optional[int] = None
    attr: Optional[str] = None
    a: Any = None
    b: Any = None

    def describe(self) -> str:
        """Human-readable one-liner naming the divergence point."""
        where = f"tick {self.tick}"
        if self.lane is not None:
            where += f", lane {self.lane}"
        if self.level is not None:
            where += f", level {self.level}"
        if self.attr is not None:
            where += f", attr {self.attr!r}"
        return (f"first divergence at {where}: field {self.field!r} "
                f"({self.a!r} vs {self.b!r})")


#: trace record fields compared per lane (divergence names the lane)
_LANE_FIELDS = ("rng", "level", "called", "pred")
#: trace record fields compared per level (divergence names the level)
_LEVEL_FIELDS = ("cache_n", "cache_ptr")
#: state-attr comparison order: parameters before their optimizer and
#: deferral shadows, so a corrupted params tree is named "params", not a
#: same-tick downstream echo
_ATTR_ORDER = ("params", "opt_state", "dparams", "dopt_state")


def _state_key_order(key: str) -> Tuple[int, int, str]:
    li, _, attr = key.partition(".")
    rank = _ATTR_ORDER.index(attr) if attr in _ATTR_ORDER \
        else len(_ATTR_ORDER)
    return (int(li) if li.isdigit() else -1, rank, attr)


def diff_traces(a, b) -> Optional[Divergence]:
    """First divergence between two traces, or None when identical.

    ``a`` / ``b`` are :class:`Trace` objects (or raw record lists).
    Records are compared in order: tick number, per-lane consumed-RNG
    digests, routing (chosen level, expert called, prediction — per
    lane), ring-buffer mirrors (per level), then the per-(level, attr)
    state digests.  A field a record lacks compares as empty.  A length
    mismatch diverges at the first missing record.
    """
    ra = a.ticks if isinstance(a, Trace) else list(a)
    rb = b.ticks if isinstance(b, Trace) else list(b)
    for i, (x, y) in enumerate(zip(ra, rb)):
        if x.get("t") != y.get("t"):
            return Divergence(tick=int(x.get("t", i)), index=i, field="t",
                              a=x.get("t"), b=y.get("t"))
        t = int(x.get("t", i))
        for f in _LANE_FIELDS:
            xs, ys = x.get(f, []), y.get(f, [])
            if len(xs) != len(ys):
                return Divergence(tick=t, index=i, field=f,
                                  a=len(xs), b=len(ys))
            for lane, (xa, yb) in enumerate(zip(xs, ys)):
                if xa != yb:
                    return Divergence(tick=t, index=i, field=f, lane=lane,
                                      a=xa, b=yb)
        for f in _LEVEL_FIELDS:
            xs, ys = x.get(f, []), y.get(f, [])
            if len(xs) != len(ys):
                return Divergence(tick=t, index=i, field=f,
                                  a=len(xs), b=len(ys))
            for li, (xa, yb) in enumerate(zip(xs, ys)):
                if xa != yb:
                    return Divergence(tick=t, index=i, field=f, level=li,
                                      a=xa, b=yb)
        sx, sy = x.get("state", {}), y.get("state", {})
        for key in sorted(set(sx) | set(sy), key=_state_key_order):
            if sx.get(key) != sy.get(key):
                li, _, attr = key.partition(".")
                return Divergence(tick=t, index=i, field="state",
                                  level=int(li), attr=attr,
                                  a=sx.get(key), b=sy.get(key))
    if len(ra) != len(rb):
        i = min(len(ra), len(rb))
        longer = ra if len(ra) > len(rb) else rb
        return Divergence(tick=int(longer[i].get("t", i)), index=i,
                          field="length", a=len(ra), b=len(rb))
    return None


# ---------------------------------------------------------------------------
# lock sanitizer: runtime guarded-by enforcement + lock-order cycles
# ---------------------------------------------------------------------------
#: same annotation syntax as cascade-lint CAS004
_GUARD_RE = re.compile(r"#\s*guarded-by:\s*(\w+)")

#: constructor family — the object is not yet / no longer shared
_EXEMPT_METHODS = {"__init__", "__post_init__", "__del__", "__new__"}

_lock_patches: List[Tuple[type, str, Any]] = []
_held = threading.local()                 # per-thread stack of held locks
_order_edges: Dict[str, Set[str]] = {}    # lock key -> keys acquired under
_order_violations: List[str] = []


def _in_constructor(obj) -> bool:
    """True when a constructor-family frame of ``obj`` is on the stack."""
    frame = sys._getframe(2)
    for _ in range(32):
        if frame is None:
            return False
        if (frame.f_code.co_name in _EXEMPT_METHODS
                and frame.f_locals.get("self") is obj):
            return True
        frame = frame.f_back
    return False


def _lock_is_owned(lock) -> bool:
    owned = getattr(lock, "_is_owned", None)
    if owned is None:
        return True          # cannot introspect: stay permissive
    return bool(owned())


class _GuardedAttr:
    """Data descriptor enforcing ``# guarded-by:`` at attribute access.

    Installed over the annotated attribute on the class, wrapping the
    original slot descriptor when the class uses ``__slots__``, else
    storing in the instance ``__dict__`` under the same name with the
    class-level default (a dataclass field's) as the fallback, so
    existing instances keep working and uninstrumenting restores them.
    """

    _MISSING = object()

    def __init__(self, name: str, lock_name: str, cls_name: str,
                 slot=None, default=_MISSING):
        self._name = name
        self._lock_name = lock_name
        self._cls_name = cls_name
        self._slot = slot
        self._default = default

    def _check(self, obj, op: str) -> None:
        lock = getattr(obj, self._lock_name, None)
        if lock is None:
            return                    # lock not created yet (constructor)
        if _lock_is_owned(lock):
            return
        if _in_constructor(obj):
            return
        raise LockSanitizerError(
            f"{self._cls_name}.{self._name} {op} without holding "
            f"self.{self._lock_name} (declared '# guarded-by: "
            f"{self._lock_name}')")

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        self._check(obj, "read")
        if self._slot is not None:
            return self._slot.__get__(obj, objtype)
        val = obj.__dict__.get(self._name, self._default)
        if val is self._MISSING:
            raise AttributeError(self._name)
        return val

    def __set__(self, obj, value):
        self._check(obj, "write")
        if self._slot is not None:
            self._slot.__set__(obj, value)
        else:
            obj.__dict__[self._name] = value


class _TrackedLock:
    """Thin per-access proxy over a real RLock that records ordering."""

    __slots__ = ("_real", "_key")

    def __init__(self, real, key: str):
        self._real = real
        self._key = key

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        """Acquire the real lock, recording the acquisition order."""
        _note_acquire(self._key, self._real)
        if timeout == -1:
            ok = self._real.acquire(blocking)
        else:
            ok = self._real.acquire(blocking, timeout)
        if not ok:
            _note_release(self._real)
        return ok

    def release(self) -> None:
        """Release the real lock and pop it from the held stack."""
        self._real.release()
        _note_release(self._real)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def _is_owned(self) -> bool:
        return _lock_is_owned(self._real)


class _LockAttr:
    """Data descriptor wrapping a lock attribute in a tracking proxy."""

    def __init__(self, name: str, cls_name: str, slot=None):
        self._name = name
        self._key = f"{cls_name}.{name}"
        self._slot = slot

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        if self._slot is not None:
            real = self._slot.__get__(obj, objtype)
        else:
            real = obj.__dict__.get(self._name)
        if real is None:
            return real
        return _TrackedLock(real, self._key)

    def __set__(self, obj, value):
        if self._slot is not None:
            self._slot.__set__(obj, value)
        else:
            obj.__dict__[self._name] = value


def _held_stack() -> List[Tuple[str, int]]:
    stack = getattr(_held, "stack", None)
    if stack is None:
        stack = _held.stack = []
    return stack


def _note_acquire(key: str, real) -> None:
    stack = _held_stack()
    rid = id(real)
    if any(r == rid for _, r in stack):
        stack.append((key, rid))       # re-entrant: no new edge
        return
    cycle = None
    with _state_lock:
        for held_key, _ in stack:
            if held_key != key:
                _order_edges.setdefault(held_key, set()).add(key)
        if _find_cycle():
            cycle = " -> ".join(sorted(_order_edges))
            msg = (f"lock order cycle involving {key} while holding "
                   f"{[k for k, _ in stack]} (order graph: {cycle})")
            _order_violations.append(msg)
    stack.append((key, rid))
    if cycle is not None:
        raise LockOrderError(_order_violations[-1])


def _note_release(real) -> None:
    stack = _held_stack()
    rid = id(real)
    for i in range(len(stack) - 1, -1, -1):
        if stack[i][1] == rid:
            del stack[i]
            return


def _find_cycle() -> bool:
    """DFS cycle check over the acquisition-order graph (keys)."""
    WHITE, GRAY, BLACK = 0, 1, 2
    color = {k: WHITE for k in _order_edges}

    def visit(u: str) -> bool:
        color[u] = GRAY
        for v in _order_edges.get(u, ()):
            c = color.get(v, WHITE)
            if c == GRAY:
                return True
            if c == WHITE and visit(v):
                return True
        color[u] = BLACK
        return False

    return any(color[k] == WHITE and visit(k) for k in list(color))


def lock_order_violations() -> List[str]:
    """Every lock-order cycle observed since instrumentation."""
    return list(_order_violations)


def _guarded_attrs_from_source(source: str) -> Dict[str, Dict[str, str]]:
    """Parse ``# guarded-by:`` annotations -> {class: {attr: lock}}.

    The convention cascade-lint CAS004 checks statically; the lock
    sanitizer instruments whatever the annotations declare, so the
    static and the runtime checker cannot drift apart.
    """
    tree = ast.parse(source)
    lines = source.splitlines()
    out: Dict[str, Dict[str, str]] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        guarded: Dict[str, str] = {}
        for sub in ast.walk(node):
            if isinstance(sub, (ast.Assign, ast.AnnAssign)):
                ln = sub.lineno
                m = _GUARD_RE.search(lines[ln - 1]) if ln <= len(lines) \
                    else None
                if not m:
                    continue
                targets = sub.targets if isinstance(sub, ast.Assign) \
                    else [sub.target]
                for tgt in targets:
                    if (isinstance(tgt, ast.Attribute)
                            and isinstance(tgt.value, ast.Name)
                            and tgt.value.id == "self"):
                        guarded[tgt.attr] = m.group(1)
                    elif isinstance(tgt, ast.Name):
                        guarded[tgt.id] = m.group(1)
        if guarded:
            out[node.name] = guarded
    return out


def _class_attr(cls, name: str):
    """``(original, slot)``: the class attribute ``name`` as found on the
    class (``_MISSING`` if none) and, when that is a data descriptor (a
    ``__slots__`` member), the descriptor to delegate storage to."""
    import inspect
    orig = inspect.getattr_static(cls, name, _GuardedAttr._MISSING)
    slot = orig if hasattr(orig, "__set__") and hasattr(
        orig, "__get__") and not isinstance(
        orig, (_GuardedAttr, _LockAttr)) else None
    return orig, slot


def instrument_locks(module=None) -> List[str]:
    """Install runtime guarded-by enforcement on ``module``'s classes.

    ``module`` defaults to ``repro_torch.core.experts`` (imported here,
    not when this module is imported).  Idempotent; returns the list of
    instrumented ``Class.attr`` names.  Undo with
    :func:`uninstrument_locks`.
    """
    if _lock_patches:
        return [f"{cls.__name__}.{name}" for cls, name, _ in _lock_patches]
    if module is None:
        import repro_torch.core.experts as module
    import inspect
    per_class = _guarded_attrs_from_source(inspect.getsource(module))
    installed: List[str] = []
    for cls_name, guarded in per_class.items():
        cls = getattr(module, cls_name, None)
        if cls is None:
            continue
        for attr, lock_name in guarded.items():
            orig, slot = _class_attr(cls, attr)
            # a plain class attribute (a dataclass field's default) is
            # what an instance without its own value reads
            default = (_GuardedAttr._MISSING if slot is not None
                       else orig)
            setattr(cls, attr, _GuardedAttr(attr, lock_name, cls_name,
                                            slot=slot, default=default))
            _lock_patches.append((cls, attr, orig))
            installed.append(f"{cls_name}.{attr}")
        for lock_name in sorted(set(guarded.values())):
            orig, slot = _class_attr(cls, lock_name)
            setattr(cls, lock_name, _LockAttr(lock_name, cls_name,
                                              slot=slot))
            _lock_patches.append((cls, lock_name, orig))
            installed.append(f"{cls_name}.{lock_name}")
    return installed


def uninstrument_locks() -> None:
    """Restore every class patched by :func:`instrument_locks`."""
    while _lock_patches:
        cls, name, orig = _lock_patches.pop()
        if orig is _GuardedAttr._MISSING:
            try:
                delattr(cls, name)
            except AttributeError:
                pass
        else:
            setattr(cls, name, orig)
    with _state_lock:
        _order_edges.clear()
        del _order_violations[:]


def tracked_rlock(key: str):
    """A standalone order-tracked RLock (for tests and ad-hoc use)."""
    return _TrackedLock(threading.RLock(), key)


# ---------------------------------------------------------------------------
# retrace sanitizer: distinct call signatures per staged function
# ---------------------------------------------------------------------------
_retrace_counts: Dict[str, int] = {}


def _signature(x) -> Any:
    """What a trace would key ``x`` on: the ``(shape, dtype)`` of an array
    (a tensor or a numpy array), the structure of a dict / list / tuple
    with its leaves' keys, and the type of anything else."""
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        return ("array", tuple(x.shape), str(x.dtype))
    if isinstance(x, dict):
        return ("dict", tuple((k, _signature(x[k])) for k in sorted(x)))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, tuple(_signature(v) for v in x))
    return type(x).__name__


def trace_probe(name: str, fn: Callable) -> Callable:
    """Wrap ``fn`` so each call with a signature it has not seen bumps a
    named counter.

    The engines call this on every function the reference stages with
    ``jax.jit``, when they build it; the count is what the reference's
    compile count would be for the same calls.  Returns ``fn`` unchanged
    when the retrace sanitizer is off (no wrapper, no counter).
    """
    if not retrace_on():
        return fn
    seen: Set[Any] = set()

    def probed(*args, **kwargs):
        key = (_signature(args), _signature(kwargs))
        with _state_lock:
            if key not in seen:
                seen.add(key)
                _retrace_counts[name] = _retrace_counts.get(name, 0) + 1
        return fn(*args, **kwargs)

    return probed


def retrace_report() -> Dict[str, int]:
    """Distinct signatures per probed function (name -> count)."""
    with _state_lock:
        return dict(_retrace_counts)


def reset_retrace() -> None:
    """Zero the counters (call before the run being measured); a
    signature a probe has already seen does not count again."""
    with _state_lock:
        _retrace_counts.clear()


def retrace_check(limit: int) -> Dict[str, int]:
    """Probed functions with more than ``limit`` distinct signatures.

    The engines bound route-pass shapes by bucketing gathered lane
    subsets (O(log S) shapes), so a count past a generous limit means a
    shape or dtype is leaking into a signature.  Returns the offenders
    (empty = clean).
    """
    with _state_lock:
        return {k: v for k, v in _retrace_counts.items() if v > limit}
