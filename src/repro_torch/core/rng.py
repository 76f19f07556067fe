"""Per-tick RNG discipline shared by OnlineCascade and BatchedCascadeEngine.

Algorithm 1 consumes randomness at three points per stream item: the
per-level DAgger jump draws, the (optional) sampled deferral actions, and
the per-level cache mini-batch sampling for the student updates.  To make
the sequential reference and the batched engine *provably equivalent on a
1-stream batch*, both derive every draw from keys pre-split per tick:

    SeedSequence((seed, stream_id, t))  ->  spawn one child per purpose

Each purpose gets its own independent child generator, so an engine that
pre-draws vectors (the batched engine draws all jump uniforms at once)
consumes exactly the same values as one that draws lazily inside the level
walk (the reference short-circuits after the exit level).  Unused draws
never shift later ones — there is no shared sequential stream to desync.

``stream_id`` is the lane index: the reference implementation is lane 0,
and lane s of a batched engine uses ``(seed, s, t)``.  Cache sampling is a
per-cascade (not per-lane) purpose; the batched engine draws it from the
lane-0 tick keys, which is what makes its single update per tick coincide
with the reference's per-item update when S == 1.

A verbatim copy of ``repro.core.rng`` (importing it would pull in jax
through ``repro/core/__init__``); the tests pin identical draws.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class TickRngs:
    """Independent generators for one (stream, tick) pair."""
    jump: np.random.Generator      # DAgger jump uniforms, one per level
    action: np.random.Generator    # sampled-action uniforms, one per level
    cache: List[np.random.Generator]   # per-level cache mini-batch sampling


def tick_rngs(seed: int, stream_id: int, t: int, n_levels: int) -> TickRngs:
    """Pre-split keys for tick ``t`` (1-based) of stream ``stream_id``."""
    ss = np.random.SeedSequence((seed & 0x7FFFFFFF, stream_id, t))
    children = ss.spawn(2 + n_levels)
    return TickRngs(
        jump=np.random.default_rng(children[0]),
        action=np.random.default_rng(children[1]),
        cache=[np.random.default_rng(c) for c in children[2:]],
    )


def generator_state(rng: np.random.Generator) -> dict:
    """JSON-able snapshot of a generator mid-stream (checkpointing).

    The per-tick discipline makes most randomness reconstructible from
    (seed, stream_id, t) alone, but a pending tick's cache generators may
    have consumed draws (a partially committed per-lane record) — their
    exact bit-generator state is what makes a resume-from-checkpoint run
    bitwise identical to the uninterrupted one (checkpoint/ckpt.py)."""
    return rng.bit_generator.state


def generator_from_state(state: dict) -> np.random.Generator:
    """Rebuild a generator from a ``generator_state`` snapshot."""
    bg = getattr(np.random, state["bit_generator"])()
    bg.state = state
    return np.random.Generator(bg)


def sample_cache_indices(rng: np.random.Generator, cache_n: int,
                         batch_size: int) -> np.ndarray:
    """Mini-batch indices over a cache holding ``cache_n`` items.

    With replacement while the cache is filling, without once it can cover
    the batch — the reference FIFO-cache sampling rule, factored out so the
    vectorized ring buffer draws identical indices.
    """
    if cache_n < batch_size:
        return rng.integers(0, cache_n, size=batch_size)
    return rng.choice(cache_n, size=batch_size, replace=False)
