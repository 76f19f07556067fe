"""Offline knowledge-distillation baseline (§4; port of
``repro.core.distill``).

The stream is split 50/50: the first half provides distillation labels
(expert annotations, up to the budget N), the second half is the test
set.  Students are trained offline (epochs over the annotated pool) and
evaluated frozen — no ensemble, no cascade, no online adaptation: the
paper's "Distilled LR" / "Distilled BERT" rows.  The students are the
dense ``lr`` and ``tinytf`` (plain PyTorch, as the reference's are plain
jnp), trained on ``device`` (CUDA unless ``"cpu"``).
"""
from __future__ import annotations

from dataclasses import replace
from typing import Dict

import numpy as np
import torch

from repro_torch.core.experts import fit_epochs
from repro_torch.data.features import hash_bow, hash_ids
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.students import (
    LRSpec, TinyTFSpec, lr_init, lr_loss, lr_predict, tinytf_init,
    tinytf_loss, tinytf_predict)
from repro_torch.optim import adam


def distill_students(stream, expert, budget_n: int,
                     n_features: int = 2048,
                     tf_spec: TinyTFSpec = None,
                     epochs: int = 5, batch: int = 8, lr: float = 1e-3,
                     seed: int = 0,
                     device: DeviceLike = None) -> Dict[str, dict]:
    """Returns {'lr': {...}, 'tinytf': {...}} with test accuracy / recall,
    and ``"test_idx"``.  One ``np.random.default_rng(seed)`` draws the
    training items, then the lr epochs' permutations, then the tinytf
    epochs'; lr starts from zeros under ``adam(0.05)``, tinytf from
    ``tinytf_init`` seeded at ``seed + 1`` under ``adam(lr)``."""
    dev = resolve_device(device)
    n = len(stream)
    half = n // 2
    n_classes = stream.spec.n_classes
    tf_spec = replace(tf_spec or TinyTFSpec(n_classes=n_classes),
                      n_classes=n_classes)

    rng = np.random.default_rng(seed)
    train_idx = rng.choice(half, size=min(budget_n, half), replace=False)
    test_idx = np.arange(half, n)

    y_train = np.array([expert.label(int(i), stream.docs[int(i)])
                        for i in train_idx], np.int32)
    y_test = stream.labels[test_idx]
    y_dev = torch.from_numpy(y_train).to(dev)

    def rows(idx, featurize, *args):
        return torch.from_numpy(np.stack(
            [featurize(stream.docs[int(i)], *args) for i in idx])).to(dev)

    results = {}
    # ---- logistic regression ----
    Xtr = rows(train_idx, hash_bow, n_features)
    Xte = rows(test_idx, hash_bow, n_features)
    params = lr_init(LRSpec(n_features=n_features, n_classes=n_classes), dev)
    params = fit_epochs(params, adam(0.05), lr_loss, Xtr, y_dev, epochs,
                        batch, rng)
    preds = torch.argmax(lr_predict(params, Xte), dim=-1).cpu().numpy()
    results["lr"] = _metrics(preds, y_test, n_classes)

    # ---- tiny transformer ----
    Itr = rows(train_idx, hash_ids, tf_spec.vocab, tf_spec.max_len)
    Ite = rows(test_idx, hash_ids, tf_spec.vocab, tf_spec.max_len)
    params = tinytf_init(torch.Generator().manual_seed(seed + 1), tf_spec,
                         dev)

    def tf_loss(p, xb, yb):
        return tinytf_loss(p, xb, yb, tf_spec)

    params = fit_epochs(params, adam(lr), tf_loss, Itr, y_dev, epochs, batch,
                        rng)
    preds = np.concatenate([
        torch.argmax(tinytf_predict(params, Ite[s:s + 256], tf_spec),
                     dim=-1).cpu().numpy()
        for s in range(0, len(Ite), 256)])
    results["tinytf"] = _metrics(preds, y_test, n_classes)
    results["test_idx"] = test_idx
    return results


def _metrics(preds, labels, n_classes):
    out = {"accuracy": float(np.mean(preds == labels))}
    if n_classes == 2:
        pos = labels == 1
        tp = float(np.sum((preds == 1) & pos))
        out["recall"] = tp / max(float(np.sum(pos)), 1.0)
    return out
