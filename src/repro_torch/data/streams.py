"""Synthetic benchmark streams mirroring the paper's four datasets.

The real corpora (IMDB / HateSpeech / ISEAR / FEVER) are not available in
this offline container, so we generate seeded token streams that expose the
*same structural knobs the paper's analysis depends on* (DESIGN.md §4):

* dataset size, class count, class imbalance (HateSpeech 1:7.95),
* a **linear (bag-of-words) signal** — what logistic regression can learn,
* an **order signal** (marker-permutation encoding, BoW-invariant) — what
  only the sequence-aware tiny-transformer student can learn,
* length-correlated difficulty: longer docs dilute the signal and raise the
  simulated expert's error rate (paper Table 5),
* per-doc categories for the category-shift scenario (§5.4).

The expert LLM is simulated as ground truth + a per-dataset error rate
matched to the paper's Table 1 LLM rows, biased toward long inputs.

The port's copy of ``repro.data.streams``: stream generation, the LM
batches the zoo's prompts come from, and the arrival schedules of the
admission front-end (``Request``, ``lockstep_requests``,
``poisson_requests``, ``burst_requests``, ``arrival_schedule``).  The
tests pin ``make_stream`` docs, labels and expert labels,
``lm_batches`` and every schedule bit-for-bit against the reference.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

VOCAB = 30_000
_N_CATEGORIES = 3          # the last category is withheld in the shift run
_MARKERS_PER_CLASS = 8     # marker tokens used by the order signal
_KEYWORDS_PER_CLASS = 40


@dataclass(frozen=True)
class StreamSpec:
    """Generator recipe for one benchmark stream (Table-1 statistics)."""

    name: str
    n_samples: int
    n_classes: int
    class_probs: tuple
    lr_separability: float        # per-token prob of a class-keyword token
    order_separability: float     # per-slot prob of a marker permutation
    mean_len: int
    len_sigma: float              # log-normal spread
    expert_acc: Dict[str, float]  # expert name -> paper accuracy
    length_difficulty: float = 0.5  # exponent tying expert error to length


BENCHMARKS: Dict[str, StreamSpec] = {
    # 25k balanced binary reviews; GPT-3.5 94.15 / Llama-2 93.33 (Table 1).
    "imdb": StreamSpec(
        name="imdb", n_samples=25_000, n_classes=2, class_probs=(0.5, 0.5),
        lr_separability=0.055, order_separability=0.04,
        mean_len=200, len_sigma=0.6,
        expert_acc={"gpt-3.5-turbo": 0.9415, "llama-2-70b-chat": 0.9333}),
    # 10,703 posts, 1:7.95 imbalance; GPT-3.5 83.34 / Llama-2 77.81.
    "hatespeech": StreamSpec(
        name="hatespeech", n_samples=10_703, n_classes=2,
        class_probs=(0.8883, 0.1117),
        lr_separability=0.08, order_separability=0.03,
        mean_len=80, len_sigma=0.7,
        expert_acc={"gpt-3.5-turbo": 0.8334, "llama-2-70b-chat": 0.7781}),
    # 7,666 across 7 balanced emotions; GPT-3.5 70.34 / Llama-2 68.23.
    "isear": StreamSpec(
        name="isear", n_samples=7_666, n_classes=7,
        class_probs=tuple([1 / 7] * 7),
        lr_separability=0.030, order_separability=0.05,
        mean_len=40, len_sigma=0.5,
        expert_acc={"gpt-3.5-turbo": 0.7034, "llama-2-70b-chat": 0.6823}),
    # 6,512 claims, binary, reasoning-heavy: LR ~ chance, TF learnable.
    "fever": StreamSpec(
        name="fever", n_samples=6_512, n_classes=2, class_probs=(0.5, 0.5),
        lr_separability=0.006, order_separability=0.10,
        mean_len=30, len_sigma=0.4,
        expert_acc={"gpt-3.5-turbo": 0.7998, "llama-2-70b-chat": 0.7715}),
}


def benchmark_spec(name: str) -> StreamSpec:
    """The committed :data:`BENCHMARKS` spec for dataset ``name``."""
    return BENCHMARKS[name]


@dataclass
class Stream:
    """A generated document stream plus its cached expert annotations."""

    spec: StreamSpec
    docs: List[np.ndarray]
    labels: np.ndarray            # ground truth
    categories: np.ndarray
    lengths: np.ndarray
    _expert_cache: dict = field(default_factory=dict)
    seed: int = 0
    # position -> index in the originally-generated corpus; identity for
    # freshly generated streams, a permutation after reorder().  Expert
    # annotation noise is drawn per ORIGINAL index, so the same doc gets
    # the same simulated-LLM label in every stream order
    orig_idx: Optional[np.ndarray] = None

    def __len__(self):
        return len(self.docs)

    def _orig_idx(self) -> np.ndarray:
        if self.orig_idx is None:
            return np.arange(len(self.docs))
        return self.orig_idx

    def expert_labels(self, expert: str) -> np.ndarray:
        """Simulated LLM annotations: ground truth corrupted at the paper's
        per-dataset error rate, biased toward longer docs (Table 5).

        The flip/wrong-class draws are tied to each doc's ORIGINAL corpus
        index, not its stream position — a reordered stream (length /
        category shift runs) annotates every doc identically to the
        default order, so distribution-shift experiments compare the same
        teacher on the same data, merely permuted."""
        if expert in self._expert_cache:
            return self._expert_cache[expert]
        spec = self.spec
        acc = spec.expert_acc[expert]
        # zlib.crc32, NOT hash(): str hashing is salted per process
        # (PYTHONHASHSEED), which made expert annotations — and every
        # downstream accuracy number — nondeterministic across runs.
        rng = np.random.default_rng(
            zlib.crc32(f"{self.seed}:{expert}:{spec.name}".encode()))
        rel = (self.lengths / max(np.mean(self.lengths), 1.0)) \
            ** spec.length_difficulty
        raw = rel / np.mean(rel) * (1.0 - acc)
        err = np.clip(raw, 0.0, 0.49)
        # renormalize after clipping so the mean error matches the paper
        for _ in range(4):
            scale = (1.0 - acc) / max(np.mean(err), 1e-9)
            err = np.clip(err * scale, 0.0, 0.49)
        # per-original-index draws (err itself is per-doc: a function of
        # the doc's own length and the permutation-invariant corpus mean)
        oi = self._orig_idx()
        flip_u = rng.random(len(self.docs))
        wrong_off = rng.integers(0, spec.n_classes - 1, len(self.docs))
        flip = flip_u[oi] < err
        wrong = (self.labels + 1 + wrong_off[oi]) % spec.n_classes
        out = np.where(flip, wrong, self.labels).astype(np.int32)
        self._expert_cache[expert] = out
        return out

    def reorder(self, order: str) -> "Stream":
        """'length' (ascending, §5.4) or 'category' (last category moved to
        the stream tail, the Comedy analogue)."""
        if order == "length":
            idx = np.argsort(self.lengths, kind="stable")
        elif order == "category":
            held = self.categories == (_N_CATEGORIES - 1)
            idx = np.concatenate([np.where(~held)[0], np.where(held)[0]])
        elif order == "default":
            return self
        else:
            raise ValueError(order)
        return Stream(
            spec=self.spec,
            docs=[self.docs[i] for i in idx],
            labels=self.labels[idx],
            categories=self.categories[idx],
            lengths=self.lengths[idx],
            seed=self.seed,
            orig_idx=self._orig_idx()[idx],
        )


def _marker_tokens(n_classes: int) -> np.ndarray:
    base = VOCAB - 500
    return np.arange(base, base + max(n_classes, 2))


def _keyword_tokens(c: int) -> np.ndarray:
    base = VOCAB - 5000 + c * _KEYWORDS_PER_CLASS
    return np.arange(base, base + _KEYWORDS_PER_CLASS)


def _category_tokens(g: int) -> np.ndarray:
    base = VOCAB - 2000 + g * 50
    return np.arange(base, base + 50)


def make_stream(name: str, seed: int = 0,
                order: str = "default",
                n_samples: Optional[int] = None) -> Stream:
    """Generate the named benchmark stream deterministically."""
    spec = BENCHMARKS[name]
    if n_samples is not None:
        from dataclasses import replace
        spec = replace(spec, n_samples=n_samples)
    # zlib.crc32, NOT hash(): str hashing is salted per process, which
    # silently regenerated a different corpus every run
    rng = np.random.default_rng(zlib.crc32(f"{seed}:{name}".encode()))
    n = spec.n_samples
    labels = rng.choice(spec.n_classes, size=n, p=np.array(spec.class_probs))
    cats = rng.integers(0, _N_CATEGORIES, size=n)
    lengths = np.clip(
        rng.lognormal(np.log(spec.mean_len), spec.len_sigma, n),
        12, spec.mean_len * 12).astype(np.int32)
    markers = _marker_tokens(spec.n_classes)
    k = len(markers)

    # Zipf-ish background over the first 25k token ids.
    bg_n = VOCAB - 5000
    ranks = np.arange(1, bg_n + 1)
    bg_p = 1.0 / ranks
    bg_p /= bg_p.sum()

    docs = []
    for i in range(n):
        L = int(lengths[i])
        y = int(labels[i])
        body = rng.choice(bg_n, size=L, p=bg_p)
        # linear (BoW) signal
        kw_mask = rng.random(L) < spec.lr_separability
        n_kw = int(kw_mask.sum())
        if n_kw:
            body[kw_mask] = rng.choice(_keyword_tokens(y), size=n_kw)
        # category tokens
        cat_mask = rng.random(L) < 0.05
        n_cat = int(cat_mask.sum())
        if n_cat:
            body[cat_mask] = rng.choice(_category_tokens(int(cats[i])),
                                        size=n_cat)
        # order signal: class-rotated marker permutation (BoW-invariant)
        n_slots = rng.binomial(max(L // (k + 1), 1), spec.order_separability
                               * (k + 1))
        segments = [body]
        for _ in range(max(n_slots, 1) if spec.order_separability > 0 else 0):
            perm = np.roll(markers, -y)
            segments.append(perm)
        doc = np.concatenate(segments)
        rng.shuffle(doc[:0])  # keep order of marker runs; body order random
        # interleave marker runs at random positions
        if len(segments) > 1:
            insert_at = np.sort(rng.integers(0, L + 1, len(segments) - 1))
            parts, prev = [], 0
            for j, pos in enumerate(insert_at):
                parts.append(body[prev:pos])
                parts.append(segments[j + 1])
                prev = pos
            parts.append(body[prev:])
            doc = np.concatenate(parts)
        docs.append(doc.astype(np.int32))

    stream = Stream(spec=spec, docs=docs, labels=labels.astype(np.int32),
                    categories=cats.astype(np.int32),
                    lengths=np.array([len(d) for d in docs], np.int32),
                    seed=seed)
    return stream.reorder(order)


# ---------------------------------------------------------------------------
# LM pretraining corpus (the zoo's prompts)
# ---------------------------------------------------------------------------
def lm_batches(vocab: int, batch: int, seq: int, steps: int, seed: int = 0):
    """Synthetic LM batches: Zipf tokens with Markov bigram structure so the
    loss has learnable signal."""
    rng = np.random.default_rng(seed)
    n_states = 64
    trans = rng.dirichlet(np.ones(n_states) * 0.2, size=n_states)
    emit_base = rng.integers(0, max(vocab - n_states * 8, 1), size=n_states)
    for _ in range(steps):
        toks = np.empty((batch, seq + 1), np.int32)
        state = rng.integers(0, n_states, size=batch)
        for t in range(seq + 1):
            offs = rng.integers(0, 8, size=batch)
            toks[:, t] = (emit_base[state] + offs) % vocab
            nxt = np.empty_like(state)
            for b in range(batch):
                nxt[b] = rng.choice(n_states, p=trans[state[b]])
            state = nxt
        yield {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


# ---------------------------------------------------------------------------
# Arrival schedules (the admission front-end, core/admission.py)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Request:
    """One stream-of-queries request for the admission front-end.

    ``rid`` is the request's RNG stream identity (the ``stream_id`` an
    isolated sequential run of the same request would use, core/rng.py);
    ``arrival`` the 1-based front-end tick it becomes admissible at (0
    means "before serving starts"); ``items`` the indices into the base
    stream's corpus it consumes, in order.  A schedule partitions
    ``range(n_items)`` across its requests, so one ``SimulatedExpert``
    over the base stream annotates every request."""
    rid: int
    arrival: int
    items: tuple


def lockstep_requests(n_items: int, n_lanes: int) -> List[Request]:
    """The all-at-t=0 schedule: ``n_lanes`` requests, request r taking
    the stride-``n_lanes`` subsequence r, r+S, r+2S, ... — exactly the
    item -> lane mapping of ``BatchedCascadeEngine.run``, so serving it
    through the front-end is bitwise the classic lockstep run."""
    if n_lanes < 1:
        raise ValueError("n_lanes must be >= 1")
    return [Request(rid=r, arrival=0,
                    items=tuple(range(r, n_items, n_lanes)))
            for r in range(min(n_lanes, n_items))]


def _segment_lengths(n_items: int, mean_len: int, rng) -> List[int]:
    """Partition n_items into contiguous request lengths ~ Geometric."""
    if mean_len < 1:
        raise ValueError("mean_len must be >= 1")
    lens: List[int] = []
    left = n_items
    cap = max(8 * mean_len, 1)
    while left > 0:
        k = min(int(rng.geometric(1.0 / mean_len)), cap, left)
        lens.append(k)
        left -= k
    return lens


def poisson_requests(n_items: int, *, rate: float, mean_len: int = 8,
                     seed: int = 0) -> List[Request]:
    """Open-loop Poisson arrivals over contiguous corpus segments: request
    r is the next ``~Geometric(1/mean_len)`` items; inter-arrival gaps are
    Exponential(1/rate) ticks (``rate`` in requests per tick), binned to
    integer arrival ticks.  Fully determined by ``(n_items, rate,
    mean_len, seed)``."""
    if rate <= 0:
        raise ValueError("rate must be > 0 requests/tick")
    rng = np.random.default_rng(
        zlib.crc32(f"arrivals:poisson:{seed}:{rate}:{mean_len}".encode()))
    lens = _segment_lengths(n_items, mean_len, rng)
    gaps = rng.exponential(1.0 / rate, size=len(lens))
    arrivals = 1 + np.floor(np.cumsum(gaps)).astype(np.int64)
    reqs, start = [], 0
    for r, k in enumerate(lens):
        reqs.append(Request(rid=r, arrival=int(arrivals[r]),
                            items=tuple(range(start, start + k))))
        start += k
    return reqs


def burst_requests(n_items: int, *, burst: int = 8, every: int = 4,
                   mean_len: int = 8, seed: int = 0) -> List[Request]:
    """Bursty arrivals: groups of ``burst`` requests land together every
    ``every`` ticks — the overload shape the shedding policy is for."""
    if burst < 1 or every < 1:
        raise ValueError("burst and every must be >= 1")
    rng = np.random.default_rng(
        zlib.crc32(f"arrivals:burst:{seed}:{burst}:{every}:"
                   f"{mean_len}".encode()))
    lens = _segment_lengths(n_items, mean_len, rng)
    reqs, start = [], 0
    for r, k in enumerate(lens):
        reqs.append(Request(rid=r, arrival=1 + (r // burst) * every,
                            items=tuple(range(start, start + k))))
        start += k
    return reqs


def arrival_schedule(kind: str, n_items: int, **kw) -> List[Request]:
    """Named schedule for the serve CLI: ``lockstep`` (all at t=0, stride
    partition; takes ``n_lanes``), ``poisson`` (open-loop, contiguous
    segments), ``burst`` (grouped arrivals)."""
    if kind == "lockstep":
        return lockstep_requests(n_items, kw.pop("n_lanes"))
    if kind == "poisson":
        return poisson_requests(n_items, **kw)
    if kind == "burst":
        return burst_requests(n_items, **kw)
    raise ValueError(f"unknown arrival schedule {kind!r} "
                     "(expected lockstep|poisson|burst)")
