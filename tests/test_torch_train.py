"""Training in the port vs the JAX package on the CPU: ``train_loss``,
its gradients, ``loss_chunk``, ``remat``, one AdamW step,
``launch.train`` and the kernels' autograd Function.

The models start from the reference's own ``init_params(PRNGKey(0))``
at the smoke config in fp32, carried across with
``bridge.load_zoo_params``; batches come from ``lm_batches`` (numpy,
seeded), B = 2 x S = 32.  The CROSS models train over the zero memory
``launch.train`` gives them (seamless' 32 frames, the vision stub's
image embeddings).  One CPU thread: the embedding's gradient
accumulates in an order that varies with the threads otherwise.
Tolerances, each with its reason:

* the loss, its xent and aux: 1e-5 relative (the same fp32 arithmetic
  in another summation order; measured ~3e-7);
* every gradient leaf: 1e-4 x max|reference leaf| (two layers of fp32
  products and their transposes; measured ~3e-6);
* ``loss_chunk`` 8 against 0: 1e-6 relative on the loss, 1e-5 x
  max|leaf| on the gradients (the same sums, cut in 4 chunks);
* ``remat`` on against off: bitwise (the same operations recomputed);
* one AdamW step (lr 1e-3): 0.1 lr per weight.  A first Adam step moves
  each weight by about lr x sign(g); where |g| is within the two
  packages' gradient rounding of zero, the direction can tilt (measured
  up to 0.025 lr);
* the kernels' autograd Function with the twin standing in for the
  kernel: bitwise plain autograd through the twin.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_get_smoke  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro.optim import adamw as j_adamw  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import restore_checkpoint  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import lm_batches  # noqa: E402
from repro_torch.kernels.autograd import TwinGrad, with_twin_grad  # noqa: E402
from repro_torch.kernels.flash_attention.ops import _twin as flash_twin  # noqa: E402
from repro_torch.kernels.moe_gmm.ref import gmm_ref  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import _twin as ssd_twin  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

ARCHS = ("internlm2-1.8b", "mixtral-8x22b", "mamba2-370m",
         "jamba-1.5-large-398b", "seamless-m4t-medium",
         "llama-3.2-vision-11b")
B, S, CHUNK = 2, 32, 8
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
CHUNK_LOSS_TOL, CHUNK_GRAD_TOL = 1e-6, 1e-5
LR, STEP_TOL = 1e-3, 0.1
_J_INIT = jax.jit(j_tf.init_params, static_argnums=1)
_REF = {}


def _fp32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def _reference(arch):
    """The reference's params, batch, loss, metrics and gradients at the
    smoke config in fp32 (computed once per arch)."""
    if arch not in _REF:
        jcfg = _fp32(j_get_smoke(arch))
        jparams = _J_INIT(jax.random.PRNGKey(0), jcfg)
        batch = next(lm_batches(jcfg.vocab, B, S, 1, seed=0))
        cfg = _fp32(get_smoke_config(arch))
        memory = {k: v.numpy() for k, v in
                  t_train.memory_stub(cfg, B, S, "cpu").items()}
        jbatch = {k: jnp.asarray(v) for k, v in {**batch, **memory}.items()}
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            lambda p: j_tf.train_loss(p, jbatch, jcfg, remat=False),
            has_aux=True))(jparams)
        _REF[arch] = dict(jcfg=jcfg, jparams=jparams, jbatch=jbatch,
                          params=jax.tree.map(np.asarray, jparams),
                          batch={**batch, **memory}, loss=float(loss),
                          metrics={k: float(v) for k, v in metrics.items()},
                          grads=jax.tree.map(np.asarray, grads))
    return _REF[arch]


def _port(arch):
    ref = _reference(arch)
    cfg = _fp32(get_smoke_config(arch))
    params = bridge.load_zoo_params(ref["params"], cfg, "cpu")
    batch = {k: torch.from_numpy(np.array(v)) for k, v in ref["batch"].items()}
    return cfg, params, batch


def _rel(a, b):
    return abs(a - b) / abs(b)


def _max_err(got, want):
    return float(np.abs(got.detach().float().numpy() - want).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_the_reference(arch):
    """``train_loss`` and every gradient leaf against ``jax.grad`` of the
    reference's; ``loss_chunk`` > 0 against 0; ``remat`` on against
    off."""
    ref = _reference(arch)
    cfg, params, batch = _port(arch)
    loss, metrics, grads = t_train.loss_and_grads(params, batch, cfg,
                                                  remat=False)
    assert _rel(float(loss), ref["loss"]) <= LOSS_TOL
    for k in ("xent", "aux"):
        assert abs(float(metrics[k]) - ref["metrics"][k]) \
            <= LOSS_TOL * abs(ref["loss"]), k
    if cfg.moe is not None:
        assert float(metrics["aux"]) > 0
    ref_leaves = jax.tree.leaves(ref["grads"])
    assert len(tree_leaves(grads)) == len(ref_leaves)
    for i, (g, r) in enumerate(zip(tree_leaves(grads), ref_leaves)):
        assert g is not None and g.shape == r.shape, i
        assert _max_err(g, r) <= GRAD_TOL * np.abs(r).max(), i

    def run(**kw):
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        out, _ = t_tf.train_loss(p, batch, cfg, **kw)
        out.backward()
        return out.detach(), [t.grad for t in tree_leaves(p)]

    chunked, cgrads = run(remat=False, loss_chunk=CHUNK)
    assert _rel(float(chunked), float(loss)) <= CHUNK_LOSS_TOL
    for g, c in zip(tree_leaves(grads), cgrads):
        assert float((g - c).abs().max()) <= CHUNK_GRAD_TOL * float(
            g.abs().max())
    remat, rgrads = run(remat=True)
    assert torch.equal(remat, loss)
    assert all(torch.equal(g, r) for g, r in zip(tree_leaves(grads), rgrads))


def test_adamw_step_matches_the_reference():
    """One step of the reference's defaults (b2 0.95, weight decay 0.1,
    clip 1.0) from the reference's and the port's own gradients."""
    ref = _reference("internlm2-1.8b")
    cfg, params, batch = _port("internlm2-1.8b")
    _, _, grads = t_train.loss_and_grads(params, batch, cfg, remat=False)
    jopt = j_adamw(LR)
    jparams, _ = jax.jit(jopt.step)(ref["jparams"], ref["grads"],
                                    jopt.init(ref["jparams"]))
    opt = adamw(LR)
    state = opt.init(params)
    new, new_state = opt.step(params, grads, state)
    assert int(new_state["count"]) == 1
    for p, r in zip(tree_leaves(new), jax.tree.leaves(jparams)):
        assert p.dtype == torch.float32
        assert _max_err(p, np.asarray(r)) <= STEP_TOL * LR


def test_train_on_the_cpu_lowers_the_loss_and_checkpoints(tmp_path):
    """``train(device="cpu")`` on the smoke config: the loss falls, and
    ``restore_checkpoint`` reads the parameters back in the port's tree
    (paths, shapes and dtypes checked by ``bridge.load_zoo_params``)."""
    arch = "internlm2-1.8b"
    losses = t_train.train(arch, smoke=True, steps=6, batch=B, seq=S,
                           lr=1e-2, seed=0, ckpt=str(tmp_path),
                           log_every=3, device="cpu")
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    tree, meta = restore_checkpoint(str(tmp_path), bf16="torch")
    assert meta == {"arch": arch, "steps": 6, "final_loss": losses[-1]}
    params = bridge.load_zoo_params(tree["params"], get_smoke_config(arch),
                                    "cpu")
    assert all(bool(torch.isfinite(t.float()).all())
               for t in tree_leaves(params))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            t_train.train(arch, steps=1, batch=B, seq=S)
    with pytest.raises(ValueError, match="multiple of the period"):
        t_train.model_config("jamba-1.5-large-398b", smoke=True, layers=3)


def test_train_cli_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", [
        "train", "--arch", "mamba2-370m", "--smoke", "--steps", "2",
        "--batch", "2", "--seq", "32", "--remat", "--device", "cpu"])
    t_train.main()
    assert "first loss" in capsys.readouterr().out.splitlines()[-1]


# ---------------------------------------------------------------------------
# the kernels' autograd Function, the twin standing in for the kernel
# ---------------------------------------------------------------------------
def _op_case(op):
    """(twin, inputs) of one kernel op at a small shape."""
    gen = torch.Generator().manual_seed(3)

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen)).requires_grad_()

    if op == "flash":
        twin = lambda q, k, v: flash_twin(  # noqa: E731
            q, k, v, causal=True, window=12, sm_scale=16 ** -0.5)
        return twin, (rnd(2, 24, 4, 16), rnd(2, 24, 2, 16),
                      rnd(2, 24, 2, 16))
    if op == "moe_gmm":
        return gmm_ref, (rnd(3, 5, 8), rnd(3, 8, 6))
    twin = lambda *a: ssd_twin(  # noqa: E731
        *a, chunk=8, return_state=True)
    adt = (-torch.rand((2, 16, 3), generator=gen)).requires_grad_()
    return twin, (rnd(2, 16, 3, 4), adt,
                  torch.rand((2, 16, 3), generator=gen).requires_grad_(),
                  rnd(2, 16, 5), rnd(2, 16, 5), rnd(2, 3, 4, 5))


def _grads(outs, inputs, seed=4):
    outs = outs if isinstance(outs, tuple) else (outs,)
    gen = torch.Generator().manual_seed(seed)
    loss = sum((o * torch.randn(o.shape, generator=gen)).sum() for o in outs)
    return torch.autograd.grad(loss, inputs)


@pytest.mark.parametrize("op", ["flash", "moe_gmm", "ssd"])
def test_twin_grad_equals_plain_autograd_through_the_twin(op):
    """``TwinGrad``'s gradients (to every input, through every output:
    the SSD's y and final state) equal plain autograd through the twin,
    bitwise, in each input's dtype and shape."""
    twin, inputs = _op_case(op)
    want = _grads(twin(*inputs), inputs)
    got = _grads(TwinGrad.apply(twin, twin, *inputs), inputs)
    for g, w, x in zip(got, want, inputs):
        assert g.dtype == x.dtype and g.shape == x.shape
        assert torch.equal(g, w)


def test_twin_grad_launches_the_kernel_once_and_again_under_checkpoint():
    """A call that needs no gradient launches the kernel alone; one that
    does launches it once in the forward, and ``torch.utils.checkpoint``'s
    recompute launches it again; the gradient is the twin's either way."""
    twin, inputs = _op_case("moe_gmm")
    calls = []

    def kernel(*a):
        calls.append(1)
        return twin(*a)

    with torch.no_grad():
        out = with_twin_grad(kernel, twin, *inputs)
    assert len(calls) == 1 and out.grad_fn is None
    detached = [t.detach() for t in inputs]
    assert with_twin_grad(kernel, twin, *detached).grad_fn is None
    assert len(calls) == 2
    want = _grads(twin(*inputs), inputs)
    got = _grads(with_twin_grad(kernel, twin, *inputs), inputs)
    assert len(calls) == 3 and all(map(torch.equal, got, want))
    ckpt = torch.utils.checkpoint.checkpoint(
        lambda *a: with_twin_grad(kernel, twin, *a), *inputs,
        use_reentrant=False)
    assert len(calls) == 4
    got = _grads(ckpt, inputs)
    assert len(calls) == 5 and all(map(torch.equal, got, want))
