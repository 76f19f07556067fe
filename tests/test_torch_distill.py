"""The port's offline distillation baseline (``repro_torch.core.distill``)
against the JAX package's ``distill_students`` on the CPU.

A CI stream (imdb, 128 items: 64 to distill from, 64 to test on), CI
widths (512 hashed features; tinytf vocab 256, max_len 32, d_model 32, 2
heads, 1 layer, d_ff 64), budget 64, 5 epochs of batch 8, tinytf at lr
3e-3, the simulated expert of each package on the same stream (both
students predict both classes there: recall strictly between 0 and 1):

* ``test_idx`` equal;
* lr accuracy and recall equal (both start from zeros);
* tinytf accuracy and recall equal, with the port's ``tinytf_init``
  replaced by the reference's ``tinytf_init(PRNGKey(seed + 1))`` through
  the bridge (the reference's initial weights, not jax.random's bits in
  the port);
* the shared training loop's permutations come from one generator: a
  port run from its own init is reproducible and reports every metric.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.core.distill import distill_students as j_distill  # noqa: E402
from repro.core.experts import SimulatedExpert as JSimulated  # noqa: E402
from repro.data import make_stream as j_make_stream  # noqa: E402
from repro.models import students as JS  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro_torch.bridge import to_torch  # noqa: E402
from repro_torch.core import distill as PD  # noqa: E402
from repro_torch.data import make_stream  # noqa: E402
from repro_torch.models import students as PS  # noqa: E402

N_ITEMS, BUDGET, SEED = 128, 64, 4
TF_KW = dict(vocab=256, max_len=32, d_model=32, n_heads=2, n_layers=1,
             d_ff=64)
KW = dict(n_features=512, epochs=5, batch=8, lr=3e-3, seed=SEED)


@pytest.fixture(scope="module")
def reference():
    js = j_make_stream("imdb", seed=0, n_samples=N_ITEMS)
    return j_distill(js, JSimulated(js), BUDGET,
                     tf_spec=JS.TinyTFSpec(**TF_KW), **KW)


def _port(monkeypatch=None):
    ps = make_stream("imdb", seed=0, n_samples=N_ITEMS)
    if monkeypatch is not None:
        def reference_init(gen, spec, device):
            jspec = JS.TinyTFSpec(**{**TF_KW, "n_classes": spec.n_classes})
            init = JS.tinytf_init(jax.random.PRNGKey(SEED + 1), jspec)
            return to_torch(jax.tree_util.tree_map(np.asarray, init), device)
        monkeypatch.setattr(PD, "tinytf_init", reference_init)
    return P.distill_students(ps, P.SimulatedExpert(ps), BUDGET,
                              tf_spec=PS.TinyTFSpec(**TF_KW), device="cpu",
                              **KW)


def test_distill_matches_reference(reference, monkeypatch):
    got = _port(monkeypatch)
    assert np.array_equal(got["test_idx"], reference["test_idx"])
    assert np.array_equal(got["test_idx"], np.arange(N_ITEMS // 2, N_ITEMS))
    for student in ("lr", "tinytf"):
        assert got[student] == reference[student], student
        assert 0.0 < got[student]["recall"] < 1.0, student


def test_distill_from_port_init_is_reproducible():
    a, b = _port(), _port()
    for student in ("lr", "tinytf"):
        assert a[student] == b[student]
        assert 0.0 <= a[student]["accuracy"] <= 1.0
