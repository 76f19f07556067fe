"""Online cascade learning — the paper's Algorithm 1 (port of
``repro.core.cascade``).

A cascade of students topped by an expert, with learned deferral MLPs
between levels, all updated online from expert demonstrations:

  for x_t in stream:
      for m_i in m_1 .. m_N:
          at probability beta_i:  jump to m_N           (DAgger)
          pred_i = m_i(x_t)
          defer  = f_i(pred_i)                          (learned MLP)
          if m_i is m_N or not defer:
              y_hat = argmax(pred_i); cache x_t if expert labeled; break
      update m_1..m_{N-1} on caches                     (imitation)
      update f_1..f_{N-1} from Eq.(1)/Eq.(5) gradients
      decay beta

Two ladders: the paper's ``lr -> tinytf`` (``default_cascade_config``;
``large=True`` adds ``tinytf_large``), whose dense students are plain
PyTorch, and the kernel ladder ``lr -> tinytf_flash -> ssm``
(``kernel_cascade_config``), whose upper levels' route passes launch the
hand-written CUDA kernels on a CUDA device.  A level's forwards count
themselves in ``_Level.forwards``; its imitation and gate updates
differentiate the plain PyTorch path with autograd, as the reference
differentiates its jnp path.  ``CascadeConfig.hard_budget`` caps the
expert calls and ``sample_actions`` samples each deferral from the gate
instead of thresholding it at 0.5, as in the reference.

State keeps the reference's layout (``STATE_ATTRS``: student params +
optimizer state, deferral params + optimizer state), so
``_Level.load_state_tree`` installs a reference level's exported state
directly, and ``OnlineCascade.save_state`` / ``restore_state`` write and
read the reference's checkpoint (``repro_torch.checkpoint``): a
checkpoint of either package's sequential engine resumes in the other.  Every tensor lives on the engine's ``device``
(CUDA unless the caller passes ``device="cpu"``); the FIFO caches and all
routing stay on the host, as in the reference.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis import sanitize as _san
from repro_torch.checkpoint import (CheckpointError, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.core.deferral import (
    DeferralSpec, deferral_grads_weighted, deferral_init, deferral_prob,
    deferral_update_terms, reexploration_floor)
from repro_torch.core.rng import sample_cache_indices, tick_rngs
from repro_torch.data.features import hash_bow, hash_ids
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.kernel_students import (
    SSMStudentSpec, TinyTFFlashSpec, ssm_student_init,
    ssm_student_loss_weighted, ssm_student_predict, tinytf_flash_init,
    tinytf_flash_loss_weighted, tinytf_flash_predict)
from repro_torch.models.students import (
    LRSpec, MLPSpec, TinyTFSpec, lr_init, lr_loss_weighted, lr_predict,
    mlp_init, mlp_loss_weighted, mlp_predict, tinytf_init,
    tinytf_loss_weighted, tinytf_predict)
from repro_torch.optim import adam, ogd_sqrt_t
from repro_torch.tree import tree_leaves, tree_unflatten


@dataclass(frozen=True)
class LevelSpec:
    """Per-level hyperparameters (paper App. B.3 Tables 3/4 columns)."""

    kind: str                     # one of LEVEL_KINDS
    cost: float                   # c_i (model cost units, LR = 1)
    cache_size: int = 8
    batch_size: int = 8
    student_lr: float = 0.5       # OGD eta0 (lr) / adam lr
    deferral_lr: float = 7e-4     # paper Tables 3/4 "Learning Rate"
    beta_decay: float = 0.97      # paper "Decaying Factor"
    beta_floor: float = 0.05      # re-exploration floor0 (core.deferral)
    calibration_factor: float = 0.4


@dataclass(frozen=True)
class CascadeConfig:
    """Whole-cascade configuration: levels, cost model, and RNG seed."""

    levels: Tuple[LevelSpec, ...]
    n_classes: int
    expert_cost: float            # c_N in model cost units
    mu: float = 2e-6              # cost weighting factor (user budget knob)
    beta0: float = 1.0            # initial DAgger jump probability
    n_features: int = 2048        # hashed BoW dim for LR / MLP
    tf_spec: Optional[TinyTFSpec] = None
    mlp_spec: Optional[MLPSpec] = None
    tf_flash_spec: Optional[TinyTFFlashSpec] = None
    ssm_spec: Optional[SSMStudentSpec] = None
    sample_actions: bool = False  # sample action_i ~ f_i; default
                                  # thresholds the gate at 0.5
    hard_budget: Optional[int] = None  # max expert calls (None = mu-driven)
    seed: int = 0


# the student kinds a level can be
LEVEL_KINDS = ("lr", "mlp", "tinytf", "tinytf_large", "tinytf_flash", "ssm")


def default_cascade_config(n_classes: int, mu: float = 2e-6,
                           expert_cost: float = 1.0e6,
                           beta0: float = 1.0,
                           large: bool = False,
                           seed: int = 0) -> CascadeConfig:
    """The paper's small cascade (LR -> BERT-ish -> LLM) with the
    reference's fixed costs; ``large=True`` adds a second, bigger
    transformer level (the BERT-large analogue)."""
    levels = [
        LevelSpec(kind="lr", cost=1.0, cache_size=8, batch_size=8,
                  student_lr=0.5, beta_decay=0.97, calibration_factor=0.4),
        LevelSpec(kind="tinytf", cost=550.0, cache_size=16, batch_size=8,
                  student_lr=1e-3, beta_decay=0.95, calibration_factor=0.3),
    ]
    if large:
        levels.append(LevelSpec(kind="tinytf_large", cost=2200.0,
                                cache_size=32, batch_size=16,
                                student_lr=7e-4, beta_decay=0.95,
                                calibration_factor=0.4))
    return CascadeConfig(levels=tuple(levels), n_classes=n_classes,
                         expert_cost=expert_cost, mu=mu, beta0=beta0,
                         tf_spec=TinyTFSpec(n_classes=n_classes), seed=seed)


def kernel_cascade_config(n_classes: int, mu: float = 2e-6,
                          expert_cost: float = 1.0e6,
                          beta0: float = 1.0, seed: int = 0,
                          tf_flash_spec: Optional[TinyTFFlashSpec] = None,
                          ssm_spec: Optional[SSMStudentSpec] = None
                          ) -> CascadeConfig:
    """The kernel-path ladder: LR -> tinytf_flash -> ssm (-> expert), with
    the upper levels' c_i recomputed from the analytic FLOP model
    (``metrics.costs``) — the same values as the reference's."""
    from repro_torch.metrics.costs import (
        lr_flops, ssm_student_flops, tinytf_flash_flops)
    tf_spec = replace(tf_flash_spec or TinyTFFlashSpec(),
                      n_classes=n_classes)
    ssm_sp = replace(ssm_spec or SSMStudentSpec(), n_classes=n_classes)
    base = lr_flops(LRSpec(n_classes=n_classes))
    cost_tf = tinytf_flash_flops(tf_spec) / base
    cost_ssm = ssm_student_flops(ssm_sp) / base
    levels = (
        LevelSpec(kind="lr", cost=1.0, cache_size=8, batch_size=8,
                  student_lr=0.5, beta_decay=0.97, calibration_factor=0.4),
        LevelSpec(kind="tinytf_flash", cost=cost_tf, cache_size=16,
                  batch_size=8, student_lr=1e-3, beta_decay=0.95,
                  calibration_factor=0.3),
        LevelSpec(kind="ssm", cost=cost_ssm, cache_size=32, batch_size=16,
                  student_lr=7e-4, beta_decay=0.95,
                  calibration_factor=0.4),
    )
    return CascadeConfig(levels=levels, n_classes=n_classes,
                         expert_cost=expert_cost, mu=mu, beta0=beta0,
                         tf_flash_spec=tf_spec, ssm_spec=ssm_sp, seed=seed)


# The four per-level state trees that define a cascade's learned state.
STATE_ATTRS = ("params", "opt_state", "dparams", "dopt_state")

_HISTORY_KEYS = ("level", "pred", "expert_called", "cost", "J")


def make_history(limit: Optional[int]) -> Optional[Dict[str, list]]:
    """Per-item diagnostic buffers for a serving engine: ``None`` keeps
    unbounded lists, ``k > 0`` the most recent k entries, ``0`` none."""
    if limit is None:
        return {k: [] for k in _HISTORY_KEYS}
    if limit < 0:
        raise ValueError(f"history_limit must be >= 0 or None, got {limit}")
    if limit == 0:
        return None
    return {k: deque(maxlen=limit) for k in _HISTORY_KEYS}


def level_generator(seed: int, level: int) -> torch.Generator:
    """The CPU generator level ``level``'s initial weights are drawn from
    (a pure function of the cascade seed; not ``jax.random``'s bits)."""
    ss = np.random.SeedSequence((seed & 0x7FFFFFFF, level))
    gen = torch.Generator()
    gen.manual_seed(int(ss.generate_state(1)[0]))
    return gen


def _grads(loss_fn, params, *args):
    """d loss_fn(params, *args) / d params, with the params' layout."""
    leaves = tree_leaves(params)
    req = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(params, req), *args)
        grads = torch.autograd.grad(loss, req, allow_unused=True)
    return tree_unflatten(params, [torch.zeros_like(p) if g is None else g
                                   for p, g in zip(leaves, grads)])


class _Level:
    """Runtime state for one cascade level (student + deferral + cache)."""

    def __init__(self, spec: LevelSpec, cfg: CascadeConfig,
                 gen: torch.Generator, device: torch.device,
                 defer_cost: Optional[float] = None):
        self.spec = spec
        self.cfg = cfg
        self.device = device
        # mu * c_{i+1}: the penalty this level pays per deferral (Eq. 1).
        self.mu_defer_cost = cfg.mu * (cfg.expert_cost if defer_cost is None
                                       else defer_cost)
        C = cfg.n_classes
        if spec.kind == "lr":
            self.sspec = LRSpec(n_features=cfg.n_features, n_classes=C)
            self.params = lr_init(self.sspec, device)
            self.opt = ogd_sqrt_t(spec.student_lr)
            feat_shape, feat_dtype = (cfg.n_features,), np.float32
            self._predict_batch = lr_predict
            self._loss = lr_loss_weighted
        elif spec.kind == "tinytf_flash":
            self.sspec = replace(cfg.tf_flash_spec or TinyTFFlashSpec(),
                                 n_classes=C)
            self.params = tinytf_flash_init(gen, self.sspec, device)
            self.opt = adam(spec.student_lr)
            feat_shape, feat_dtype = (self.sspec.max_len,), np.int32
            sspec = self.sspec
            self._predict_batch = \
                lambda p, xb: tinytf_flash_predict(p, xb, sspec)
            self._loss = lambda p, xb, yb, w: tinytf_flash_loss_weighted(
                p, xb, yb, w, sspec)
        elif spec.kind == "ssm":
            self.sspec = replace(cfg.ssm_spec or SSMStudentSpec(),
                                 n_classes=C)
            self.params = ssm_student_init(gen, self.sspec, device)
            self.opt = adam(spec.student_lr)
            feat_shape, feat_dtype = (self.sspec.max_len,), np.int32
            sspec = self.sspec
            self._predict_batch = \
                lambda p, xb: ssm_student_predict(p, xb, sspec)
            self._loss = lambda p, xb, yb, w: ssm_student_loss_weighted(
                p, xb, yb, w, sspec)
        elif spec.kind == "mlp":
            self.sspec = replace(cfg.mlp_spec or MLPSpec(),
                                 n_features=cfg.n_features, n_classes=C)
            self.params = mlp_init(gen, self.sspec, device)
            self.opt = adam(spec.student_lr)
            feat_shape, feat_dtype = (cfg.n_features,), np.float32
            self._predict_batch = mlp_predict
            self._loss = mlp_loss_weighted
        elif spec.kind in ("tinytf", "tinytf_large"):
            base = cfg.tf_spec or TinyTFSpec(n_classes=C)
            if spec.kind == "tinytf_large":
                base = replace(base, d_model=base.d_model * 2,
                               n_layers=base.n_layers + 2,
                               d_ff=base.d_ff * 2)
            self.sspec = replace(base, n_classes=C)
            self.params = tinytf_init(gen, self.sspec, device)
            self.opt = adam(spec.student_lr)
            feat_shape, feat_dtype = (self.sspec.max_len,), np.int32
            sspec = self.sspec
            self._predict_batch = lambda p, xb: tinytf_predict(p, xb, sspec)
            self._loss = lambda p, xb, yb, w: tinytf_loss_weighted(
                p, xb, yb, w, sspec)
        else:
            raise ValueError(f"unknown level kind {spec.kind!r}; the "
                             f"known kinds are {', '.join(LEVEL_KINDS)}")
        self.opt_state = self.opt.init(self.params)

        self.dspec = DeferralSpec(n_classes=C)
        self.dparams = deferral_init(gen, self.dspec, device)
        # Adam at the paper's per-level rate x20, as the reference
        self.dopt = adam(spec.deferral_lr * 20)
        self.dopt_state = self.dopt.init(self.dparams)
        self._stage_steps()

        self.beta = cfg.beta0
        # FIFO cache D of expert-labeled items (host, as the reference)
        self.cache_x = np.zeros((spec.cache_size,) + feat_shape, feat_dtype)
        self.cache_y = np.zeros((spec.cache_size,), np.int32)
        self.cache_n = 0
        self.cache_ptr = 0
        # forwards run by this level (route passes, gate calibration and
        # single-item predicts) — what the kernels' launch counters are
        # checked against on the kernel ladder — and the same split by
        # padded batch
        self.forwards = 0
        self.forwards_by_batch = {}
        # initial state for reset(); updates build new tensors and never
        # write in place, so keeping the references is enough
        self._init_state = (self.params, self.opt_state,
                            self.dparams, self.dopt_state)

    def _stage_steps(self) -> None:
        """The level's staged functions, each behind the retrace
        sanitizer's probe under the reference's name (the function itself
        unless the mode was on when the level was built).  The forwards
        are probed unbound and take the level first, and the steps close
        over the optimizers and the loss, so the level holds no reference
        to itself."""
        probe = _san.trace_probe
        kind = self.spec.kind
        opt, dopt, loss = self.opt, self.dopt, self._loss
        mu_c, calib = self.mu_defer_cost, self.spec.calibration_factor

        def student_step(params, opt_state, xb, yb, w):
            return opt.step(params, _grads(loss, params, xb, yb, w),
                            opt_state)

        def student_step_k(params, opt_state, xb, yb, w, k):
            return opt.step_k(params, _grads(loss, params, xb, yb, w),
                              opt_state, k)

        def deferral_grads(dparams, probs, y, reach, w):
            z, mcl = deferral_update_terms(probs, y, mu_c)
            return deferral_grads_weighted(dparams, probs, z, reach, mcl,
                                           w, calib)

        def deferral_step(dparams, dopt_state, probs, y, reach, w):
            return dopt.step(dparams,
                             deferral_grads(dparams, probs, y, reach, w),
                             dopt_state)

        def deferral_step_k(dparams, dopt_state, probs, y, reach, w, k):
            return dopt.step_k(dparams,
                               deferral_grads(dparams, probs, y, reach, w),
                               dopt_state, k)

        self._predict_and_defer = probe(f"{kind}.predict_and_defer",
                                        _Level.route_pass)
        self._predict = probe(f"{kind}.predict", _Level.predict)
        self._student_step = probe(f"{kind}.student_step", student_step)
        self._student_step_k = probe(f"{kind}.student_step_k",
                                     student_step_k)
        self._deferral_step = probe(f"{kind}.deferral_step", deferral_step)
        self._deferral_step_k = probe(f"{kind}.deferral_step_k",
                                      deferral_step_k)

    def reset(self):
        """Restore the freshly-initialized state (a new stream)."""
        (self.params, self.opt_state,
         self.dparams, self.dopt_state) = self._init_state
        self.beta = self.cfg.beta0
        self.cache_x[:] = 0
        self.cache_y[:] = 0
        self.cache_n = 0
        self.cache_ptr = 0
        self.forwards = 0
        self.forwards_by_batch = {}

    def state_tree(self) -> dict:
        """The level's learned state (STATE_ATTRS order)."""
        return {a: getattr(self, a) for a in STATE_ATTRS}

    def load_state_tree(self, tree: dict, device: DeviceLike = None) -> None:
        """Install a numpy ``state_tree`` (a checkpoint's, or one exported
        from either package) on ``device``, which is the level's own:
        every leaf is checked against the current attribute's layout,
        shape and dtype before any is replaced (``bridge``)."""
        if device is not None and torch.device(device) != self.device:
            raise ValueError(f"level state lives on {self.device}, not "
                             f"{device}")
        from repro_torch.bridge import load_level_state
        load_level_state(self, tree)

    # -- forwards (the kernel path on the kernel ladder) ---------------
    def _count_forward(self, B: int) -> None:
        self.forwards += 1
        self.forwards_by_batch[B] = self.forwards_by_batch.get(B, 0) + 1

    @torch.no_grad()
    def route_pass(self, params, dparams, xb):
        """Batched student predict + deferral gate over ``xb`` (B, ...):
        returns device tensors (probs (B, C), dprob (B,)).  At a (1, ...)
        batch this is the reference's ``predict_and_defer``."""
        self._count_forward(xb.shape[0])
        probs = self._predict_batch(params, xb)
        return probs, deferral_prob(dparams, probs)

    @torch.no_grad()
    def predict(self, params, x):
        """Single-item student predict (no gate): ``x`` one feature row on
        the level's device -> (C,) probs.  The budget fallback and the
        ensemble run it; it counts as a forward at batch 1."""
        self._count_forward(1)
        return self._predict_batch(params, x[None])[0]

    # -- cache -------------------------------------------------------------
    def cache_add(self, x: np.ndarray, y: int):
        """FIFO-insert one expert demonstration into the level's cache."""
        self.cache_x[self.cache_ptr] = x
        self.cache_y[self.cache_ptr] = y
        self.cache_ptr = (self.cache_ptr + 1) % self.spec.cache_size
        self.cache_n = min(self.cache_n + 1, self.spec.cache_size)

    def student_update(self, rng: np.random.Generator):
        """One imitation step on a cache mini-batch drawn from ``rng``."""
        if self.cache_n == 0:
            return
        bs = min(self.spec.batch_size, self.spec.cache_size)
        idx = sample_cache_indices(rng, self.cache_n, bs)
        xb = torch.from_numpy(self.cache_x[idx]).to(self.device)
        yb = torch.from_numpy(self.cache_y[idx]).to(self.device)
        w = torch.ones((bs,), dtype=torch.float32, device=self.device)
        self.apply_student_update(xb, yb, w)

    # -- shared update application (both engines commit through these) ---
    @torch.no_grad()
    def apply_student_update(self, xb, yb, w, k=None):
        """One weighted imitation step (gradient of the plain path); ``k``
        (a 0-d float32 tensor) selects the lr-scaled ``step_k`` variant."""
        if k is None:
            self.params, self.opt_state = self._student_step(
                self.params, self.opt_state, xb, yb, w)
        else:
            self.params, self.opt_state = self._student_step_k(
                self.params, self.opt_state, xb, yb, w, k)

    @torch.no_grad()
    def apply_deferral_update(self, probs, y, reach, w, k=None):
        """One weighted deferral-gate step from Eq. (1)/Eq. (5) terms."""
        if k is None:
            self.dparams, self.dopt_state = self._deferral_step(
                self.dparams, self.dopt_state, probs, y, reach, w)
        else:
            self.dparams, self.dopt_state = self._deferral_step_k(
                self.dparams, self.dopt_state, probs, y, reach, w, k)

    def featurize(self, doc: np.ndarray) -> np.ndarray:
        """Map a raw doc to this level's input (hashed BoW or token ids)."""
        if self.spec.kind in ("lr", "mlp"):
            return hash_bow(doc, self.cfg.n_features)
        return hash_ids(doc, self.sspec.vocab, self.sspec.max_len)


def check_fingerprint(meta: dict, fingerprint: dict) -> None:
    """Raise ``CheckpointError`` unless a checkpoint's metadata agrees
    with an engine's fingerprint on every key."""
    for key, val in fingerprint.items():
        if meta.get(key) != val:
            raise CheckpointError(
                f"checkpoint/engine mismatch on {key}: checkpoint "
                f"has {meta.get(key)!r}, engine has {val!r}")


def build_levels(config: CascadeConfig, device: torch.device) -> List[_Level]:
    """The cascade's levels, each initialised from its own seeded CPU
    generator, with deferral costs c_{i+1} (the expert's for the last)."""
    return [
        _Level(spec, config, level_generator(config.seed, i), device,
               defer_cost=(config.levels[i + 1].cost
                           if i + 1 < len(config.levels)
                           else config.expert_cost))
        for i, spec in enumerate(config.levels)]


class OnlineCascade:
    """Algorithm 1, one item at a time: ``process(idx, doc)`` handles one
    stream item.

    Runs on ``device`` (CUDA by default; pass ``device="cpu"``
    explicitly to run on the CPU)."""

    def __init__(self, config: CascadeConfig, expert,
                 history_limit: Optional[int] = None,
                 device: DeviceLike = None):
        self.cfg = config
        self.expert = expert
        self.device = resolve_device(device)
        self.levels: List[_Level] = build_levels(config, self.device)
        # lane id in the per-tick RNG discipline (core.rng): the
        # sequential reference is lane 0 of a batched engine
        self.stream_id = 0
        self.t = 0
        self.expert_calls = 0
        self.total_cost = 0.0
        self.level_counts = np.zeros(len(config.levels) + 1, np.int64)
        self.J_cum = 0.0
        self.history = make_history(history_limit)

    def reset(self):
        """Back to item 0 of a fresh stream."""
        for lvl in self.levels:
            lvl.reset()
        self.t = 0
        self.expert_calls = 0
        self.total_cost = 0.0
        self.level_counts[:] = 0
        self.J_cum = 0.0
        if self.history is not None:
            for v in self.history.values():
                v.clear()
        # a recorded determinism trace belongs to the old stream
        _san.drop_trace(self)

    def close(self) -> None:
        """Shut down the expert's worker pool, if it has one."""
        close = getattr(self.expert, "close", None)
        if close is not None:
            close()

    # -- live-state checkpoints (as the batched engine's) ---------------
    def _fingerprint(self) -> dict:
        return {"engine": "sequential", "n_levels": len(self.levels),
                "seed": self.cfg.seed, "n_classes": self.cfg.n_classes}

    def save_state(self, path: str) -> str:
        """Checkpoint learned + accounting state mid-stream: the levels
        (STATE_ATTRS, beta, FIFO cache) and the scalars.  The per-item
        RNG is a pure function of (seed, stream_id, t), so resuming at
        item ``t`` replays the uninterrupted run bitwise."""
        tree = {
            "levels": [lvl.state_tree() for lvl in self.levels],
            "cache_x": [lvl.cache_x.copy() for lvl in self.levels],
            "cache_y": [lvl.cache_y.copy() for lvl in self.levels],
            "level_counts": self.level_counts,
        }
        meta = {
            **self._fingerprint(),
            "t": self.t, "stream_id": self.stream_id,
            "beta": [float(lvl.beta) for lvl in self.levels],
            "cache_n": [lvl.cache_n for lvl in self.levels],
            "cache_ptr": [lvl.cache_ptr for lvl in self.levels],
            "expert_calls": self.expert_calls,
            "total_cost": self.total_cost,
            "J_cum": self.J_cum,
        }
        return save_checkpoint(path, tree, meta)

    def restore_state(self, path: str) -> None:
        """Restore a ``save_state`` checkpoint (of either package) into
        this same-config cascade, on its device; raises
        ``CheckpointError`` on a config mismatch."""
        tree, meta = restore_checkpoint(path)
        check_fingerprint(meta, self._fingerprint())
        for i, lvl in enumerate(self.levels):
            lvl.load_state_tree(tree["levels"][i])
            lvl.beta = float(meta["beta"][i])
            lvl.cache_x[:] = np.asarray(tree["cache_x"][i])
            lvl.cache_y[:] = np.asarray(tree["cache_y"][i])
            lvl.cache_n = int(meta["cache_n"][i])
            lvl.cache_ptr = int(meta["cache_ptr"][i])
        self.level_counts[:] = np.asarray(tree["level_counts"])
        self.t = int(meta["t"])
        self.stream_id = int(meta["stream_id"])
        self.expert_calls = int(meta["expert_calls"])
        self.total_cost = float(meta["total_cost"])
        self.J_cum = float(meta["J_cum"])
        _san.drop_trace(self)

    def _predict_and_defer(self, i: int, x: np.ndarray):
        lvl = self.levels[i]
        xb = torch.from_numpy(np.ascontiguousarray(x[None])).to(self.device)
        probs, dprob = lvl._predict_and_defer(lvl, lvl.params, lvl.dparams,
                                              xb)
        return probs.cpu().numpy()[0], float(dprob.cpu().numpy()[0])

    # -- cost of deferring FROM level i (to i+1) -----------------------
    def _defer_cost(self, i: int) -> float:
        if i + 1 < len(self.levels):
            return self.levels[i + 1].spec.cost
        return self.cfg.expert_cost

    def _budget_exhausted(self) -> bool:
        hb = self.cfg.hard_budget
        return hb is not None and self.expert_calls >= hb

    def process(self, idx: int, doc: np.ndarray) -> dict:
        """Run one episode of the MDP; returns prediction + diagnostics."""
        cfg = self.cfg
        self.t += 1
        n_levels = len(self.levels)
        rngs = tick_rngs(cfg.seed, self.stream_id, self.t, n_levels)
        u_jump = rngs.jump.random(n_levels)
        # the action draws use the tick's own `action` generator, so jump
        # and cache draws are the same with or without them; they also
        # feed the determinism trace
        u_act = (rngs.action.random(n_levels)
                 if cfg.sample_actions or _san.determinism_on() else None)
        feat_cache: Dict[int, np.ndarray] = {}

        def feat(i):
            if i not in feat_cache:
                feat_cache[i] = self.levels[i].featurize(doc)
            return feat_cache[i]

        probs_list, dprob_list = [], []
        prediction = None
        chosen_level = None
        expert_called = False
        episode_cost_units = 0.0

        for i, lvl in enumerate(self.levels):
            # DAgger jump: at probability beta_i, query the expert directly.
            if not self._budget_exhausted() and u_jump[i] < lvl.beta:
                chosen_level = len(self.levels)
                expert_called = True
                break
            probs, dprob = self._predict_and_defer(i, feat(i))
            probs_list.append(probs)
            dprob_list.append(dprob)
            episode_cost_units += lvl.spec.cost
            if cfg.sample_actions:
                # compare at float32 like the batched engine; both
                # operands are exact in either precision
                defer = float(np.float32(u_act[i])) < dprob
            else:
                defer = dprob > 0.5
            if self._budget_exhausted() and i == n_levels - 1:
                defer = False          # budget gate: cannot reach expert
            if not defer:
                prediction = int(np.argmax(probs))
                chosen_level = i
                break
        else:
            chosen_level = len(self.levels)
            expert_called = True

        if expert_called and self._budget_exhausted():
            # fall back to the last student instead of the expert, costed
            # like any evaluation of that level.  The reference keeps this
            # guard although the budget gates above already keep a spent
            # budget's walk from the expert; the batched engine's overflow
            # lanes are where the same rule runs
            lvl = self.levels[-1]
            x = torch.from_numpy(feat(n_levels - 1)).to(self.device)
            probs = lvl._predict(lvl, lvl.params, x).cpu().numpy()
            prediction = int(np.argmax(probs))
            chosen_level = n_levels - 1
            expert_called = False
            episode_cost_units += lvl.spec.cost

        y_expert = None
        if expert_called:
            y_expert = self.expert.label(idx, doc)
            prediction = y_expert
            self.expert_calls += 1
            episode_cost_units += self.cfg.expert_cost
            # every annotated item calibrates EVERY gate: levels the walk
            # never consulted get their probs/dprob computed here, against
            # the pre-update student (training-side, not costed)
            for i in range(len(probs_list), n_levels):
                probs, dprob = self._predict_and_defer(i, feat(i))
                probs_list.append(probs)
                dprob_list.append(dprob)
            for i, lvl in enumerate(self.levels):
                lvl.cache_add(feat(i), y_expert)
            for i, lvl in enumerate(self.levels):
                lvl.student_update(rngs.cache[i])
            dev = self.device
            y_arr = torch.tensor([y_expert], dtype=torch.int32, device=dev)
            w_one = torch.ones((1,), dtype=torch.float32, device=dev)
            reach = np.float32(1.0)
            for lvl, probs, dp in zip(self.levels, probs_list, dprob_list):
                lvl.apply_deferral_update(
                    torch.from_numpy(probs[None]).to(dev), y_arr,
                    torch.tensor([reach], dtype=torch.float32, device=dev),
                    w_one)
                reach = np.float32(reach * np.float32(dp))

        # J(pi, t) bookkeeping (Eq. 1): use observed branch costs
        J_t = cfg.mu * episode_cost_units
        self.J_cum += J_t

        # decay beta (per level), floored by the re-exploration schedule
        for lvl in self.levels:
            lvl.beta = max(lvl.beta * lvl.spec.beta_decay,
                           reexploration_floor(lvl.spec.beta_floor, self.t))

        self.total_cost += episode_cost_units
        self.level_counts[chosen_level if not expert_called
                          else len(self.levels)] += 1
        if self.history is not None:
            self.history["level"].append(
                len(self.levels) if expert_called else chosen_level)
            self.history["pred"].append(prediction)
            self.history["expert_called"].append(expert_called)
            self.history["cost"].append(episode_cost_units)
            self.history["J"].append(J_t)
        if _san.determinism_on():
            # one 1-lane record per item: the sequential engine is lane 0
            # of a batched engine, and its trace aligns with a batched
            # n_streams=1 trace tick for tick
            _san.record_tick(
                self, t=self.t,
                level=[n_levels if expert_called else chosen_level],
                called=[expert_called], pred=[prediction],
                u_jump=u_jump.reshape(n_levels, 1),
                u_act=u_act.reshape(n_levels, 1),
                cache_n=[lvl.cache_n for lvl in self.levels],
                cache_ptr=[lvl.cache_ptr for lvl in self.levels],
                levels=self.levels)
        return {
            "prediction": prediction,
            "level": chosen_level,
            "expert_called": expert_called,
            "cost_units": episode_cost_units,
            "expert_label": y_expert,
        }

    def run(self, stream, log_every: int = 0) -> dict:
        """Process an entire stream; returns summary metrics."""
        preds = np.zeros(len(stream), np.int32)
        for i, doc in enumerate(stream.docs):
            out = self.process(i, doc)
            preds[i] = out["prediction"]
            if log_every and (i + 1) % log_every == 0:
                acc = float(np.mean(preds[:i + 1] == stream.labels[:i + 1]))
                print(f"[{i+1}/{len(stream)}] acc={acc:.4f} "
                      f"expert_calls={self.expert_calls}")
        labels = stream.labels
        acc = float(np.mean(preds == labels))
        metrics = {"accuracy": acc, "expert_calls": self.expert_calls,
                   "total_cost_units": self.total_cost,
                   "level_fractions": (self.level_counts
                                       / max(len(stream), 1)).tolist(),
                   "predictions": preds}
        if stream.spec.n_classes == 2:
            pos = labels == 1
            tp = float(np.sum((preds == 1) & pos))
            metrics["recall"] = tp / max(float(np.sum(pos)), 1.0)
            pp = float(np.sum(preds == 1))
            metrics["precision"] = tp / max(pp, 1.0)
            metrics["f1"] = (2 * metrics["precision"] * metrics["recall"]
                             / max(metrics["precision"] + metrics["recall"],
                                   1e-9))
        return metrics
