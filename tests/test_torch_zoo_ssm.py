"""The port's Mamba2 block and SSD scan at the zoo's shapes vs the JAX
package's on the CPU.

Inputs are made with numpy from a seed (parameters: the reference's own
``init_mamba(PRNGKey)`` exported as numpy) and handed to both packages.
On the CPU ``ops.ssd_scan`` runs its plain twin.  Tolerances, each with
its reason:

* the SSD scan at chunk 256 / state 128 against the Pallas op in
  interpret mode (``y``) and ``ssd_chunked`` (the final state): 2e-3
  absolute and relative, the tolerance the JAX package pins between its
  own op and ref (fp32 sums over a 256-token chunk and 128 states in
  another order);
* the plain twins of the CUDA kernel's four passes, composed, against
  ``ssd_scan_chunked_ref``: 1e-5 absolute and relative (the same fp32
  function; sums over a chunk regrouped), and against the JAX package
  at the 2e-3 above;
* the Mamba2 block (``mamba_forward`` with its states,
  ``mamba_decode_step``, ``_causal_conv``): 1e-4, fp32 products through
  the in-projection, the scan and the out-projection in another order;
* the port's own init: bitwise where it must not move (the cascade's
  CPU draws), shapes and dtypes on ``meta``.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_get_smoke  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as j_ssd  # noqa: E402
from repro.models import ssm as j_ssm  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: E402
from repro_torch.kernels.ssd_scan.kernel import (  # noqa: E402
    select_variant, smem_bytes)
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_cb_ref, ssd_chunk_scan_ref, ssd_chunk_state_ref, ssd_scan_chunked_ref,
    ssd_scan_passes_ref, ssd_scan_ref, ssd_state_pass_ref)
from repro_torch.models import ssm as t_ssm  # noqa: E402
from repro_torch.models.layers import dense_init, trunc_normal  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

SSD_TOL = 2e-3
BLOCK_TOL = 1e-4
ARCHS = ("mamba2-370m", "jamba-1.5-large-398b")


def _np(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _fp32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def _ssd_inputs(seed, Bsz, S, H, hp, N):
    rng = np.random.default_rng(seed)
    x = _np(rng, Bsz, S, H, hp)
    dt = np.log1p(np.exp(_np(rng, Bsz, S, H) - 2.0)).astype(np.float32)
    adt = (-np.arange(1, H + 1, dtype=np.float32) * dt).astype(np.float32)
    return x, adt, dt, _np(rng, Bsz, S, N), _np(rng, Bsz, S, N)


# ---------------------------------------------------------------------------
# the SSD scan at the zoo's chunk 256 x state 128
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("Bsz,S,H,hp", [(1, 256, 2, 64), (2, 512, 1, 32)])
def test_ssd_scan_state_at_the_zoo_shape(Bsz, S, H, hp):
    """``y`` against the Pallas op (interpret mode), the final state
    against ``ssd_chunked``'s, both at chunk 256 and N 128."""
    N, chunk = 128, 256
    ins = _ssd_inputs(7 + S, Bsz, S, H, hp, N)
    y, h = ssd_scan(*map(_t, ins), chunk=chunk, return_state=True)
    assert y.shape == (Bsz, S, H, hp) and h.shape == (Bsz, H, hp, N)
    assert h.dtype == torch.float32
    j_y = j_ssd(*map(jnp.asarray, ins), chunk=chunk, interpret=True)
    _close(y, j_y, SSD_TOL)
    jy2, jh = j_ssm.ssd_chunked(*map(jnp.asarray, ins), chunk)
    _close(y, jy2, SSD_TOL)
    _close(h, jh, SSD_TOL)
    # without the state, the same y
    assert torch.equal(ssd_scan(*map(_t, ins), chunk=chunk), y)


def test_ssd_scan_from_an_initial_state():
    """Two halves, the second started from the first's final state, give
    the whole sequence's y and state (as ``ssd_chunked`` does)."""
    Bsz, S, H, hp, N = 1, 512, 2, 16, 128
    ins = list(map(_t, _ssd_inputs(3, Bsz, S, H, hp, N)))
    y, h = ssd_scan(*ins, chunk=256, return_state=True)
    first = [t[:, :256] for t in ins]
    second = [t[:, 256:] for t in ins]
    y1, h1 = ssd_scan(*first, chunk=256, return_state=True)
    y2, h2 = ssd_scan(*second, chunk=256, init_state=h1, return_state=True)
    _close(torch.cat([y1, y2], 1), y, SSD_TOL)
    _close(h2, h, SSD_TOL)
    jy, jh = j_ssm.ssd_chunked(*(jnp.asarray(t.numpy()) for t in second),
                               256, init_state=jnp.asarray(h1.numpy()))
    _close(y2, jy, SSD_TOL)
    _close(h2, jh, SSD_TOL)


def test_ssd_scan_state_matches_the_recurrence():
    """The chunked twin's state is the sequential recurrence's."""
    Bsz, S, H, hp, N = 2, 96, 2, 8, 16
    ins = list(map(_t, _ssd_inputs(5, Bsz, S, H, hp, N)))
    y, h = ssd_scan_chunked_ref(*ins, 32, return_state=True)
    _close(y, ssd_scan_ref(*ins), SSD_TOL)
    # the recurrence's last state, by hand
    x, adt, dt, B, _ = ins
    hs = torch.zeros((Bsz, H, hp, N))
    for t in range(S):
        hs = hs * torch.exp(adt[:, t])[..., None, None] + torch.einsum(
            "bh,bn,bhp->bhpn", dt[:, t], B[:, t], x[:, t])
    _close(h, hs, SSD_TOL)


# the plain twins of the four passes, at CI sizes: chunk 32 and 64, state
# 16, several chunks, a ragged head dim
PASS_CASES = {
    # name: (Bsz, S, H, hp, N, chunk)
    "chunk 32, 4 chunks": (2, 128, 3, 16, 16, 32),
    "chunk 64, 3 chunks, hp 10": (1, 192, 2, 10, 16, 64),
    "chunk 64, one chunk, hp 7": (2, 64, 2, 7, 16, 64),
}


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("case", sorted(PASS_CASES))
def test_ssd_passes_compose_to_the_chunked_twin(case, init):
    """C·Bᵀ, the chunk states, the state passing and the chunk scan,
    composed, give ``ssd_scan_chunked_ref``'s y and final state, with and
    without an initial state; each pass's output has its documented
    shape (C·Bᵀ zero above the diagonal, cum of A·dt per chunk)."""
    Bsz, S, H, hp, N, chunk = PASS_CASES[case]
    ins = list(map(_t, _ssd_inputs(11 + S + hp, Bsz, S, H, hp, N)))
    h0 = (0.5 * _t(np.random.default_rng(S).standard_normal((Bsz, H, hp, N)))
          if init else None)
    y, h = ssd_scan_passes_ref(*ins, chunk, init_state=h0,
                               return_state=True)
    ry, rh = ssd_scan_chunked_ref(*ins, chunk, init_state=h0,
                                  return_state=True)
    torch.testing.assert_close(y, ry, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(h, rh, atol=1e-5, rtol=1e-5)
    x, adt, dt, B, C = ins
    nc = S // chunk
    cb = ssd_cb_ref(B, C, chunk)
    assert cb.shape == (Bsz, nc, chunk, chunk)
    assert torch.equal(cb, cb.tril())
    st, cum = ssd_chunk_state_ref(x, adt, dt, B, chunk)
    assert st.shape == (Bsz, nc, H, hp, N) and cum.shape == (Bsz, nc, H,
                                                              chunk)
    torch.testing.assert_close(
        cum[:, -1], torch.cumsum(adt[:, S - chunk:], 1).transpose(1, 2))
    ent, hf = ssd_state_pass_ref(st, cum, h0)
    assert torch.equal(ent[:, 0], torch.zeros_like(st[:, 0]) if h0 is None
                       else h0)
    assert torch.equal(hf, h)
    assert torch.equal(ssd_chunk_scan_ref(x, dt, C, cb, cum, ent, chunk), y)


@pytest.mark.parametrize("case", sorted(PASS_CASES))
def test_ssd_passes_match_jax(case):
    """The composed passes against the JAX package's ``ssd_chunked`` (y
    and the final state, from the first half's state) and the Pallas op
    in interpret mode (y)."""
    Bsz, S, H, hp, N, chunk = PASS_CASES[case]
    ins = _ssd_inputs(13 + S + hp, Bsz, S, H, hp, N)
    h0 = (0.5 * np.random.default_rng(S + 1).standard_normal(
        (Bsz, H, hp, N))).astype(np.float32)
    y, h = ssd_scan_passes_ref(*map(_t, ins), chunk, init_state=_t(h0),
                               return_state=True)
    jy, jh = j_ssm.ssd_chunked(*map(jnp.asarray, ins), chunk,
                               init_state=jnp.asarray(h0))
    _close(y, jy, SSD_TOL)
    _close(h, jh, SSD_TOL)
    y0 = ssd_scan_passes_ref(*map(_t, ins), chunk)
    _close(y0, j_ssd(*map(jnp.asarray, ins), chunk=chunk, interpret=True),
           SSD_TOL)


def test_ssd_variants_are_picked_from_the_shapes():
    """The cascade's chunk 64 keeps the whole-chunk kernel; the zoo's
    chunk 256 (and 255, S - 1 of a prefill check) takes the chunk-parallel
    passes within shared memory; nothing re-chunks."""
    assert select_variant(64, 32, 64) == "whole"
    assert select_variant(32, 16, 32) == "whole"
    for L in (256, 255, 100):
        assert select_variant(64, 128, L) == "parallel"
    assert smem_bytes(64, 128, 256) > 232_448
    # the largest pass: the chunk state's two-stage ring of x and B
    assert smem_bytes(64, 128, 256, "parallel") == 109_568
    with pytest.raises(ValueError, match="no variant"):
        select_variant(128, 128, 256)


# ---------------------------------------------------------------------------
# the Mamba2 block
# ---------------------------------------------------------------------------
def _block(arch, seed=0):
    cfg, jcfg = _fp32(get_smoke_config(arch)), _fp32(j_get_smoke(arch))
    jp = j_ssm.init_mamba(jax.random.PRNGKey(seed), jcfg)
    # O(1) dt bias spread, so the decays are not all ~1
    jp = dict(jp, dt_bias=jnp.linspace(-3.0, 1.0, jp["dt_bias"].shape[0]))
    return cfg, jcfg, jp, {k: _t(v) for k, v in jp.items()}


@pytest.mark.parametrize("K,with_prev", [(4, False), (4, True), (1, True)])
def test_causal_conv_matches(K, with_prev):
    rng = np.random.default_rng(K + 10 * with_prev)
    x, w, b = _np(rng, 2, 9, 12), _np(rng, K, 12), _np(rng, 12)
    prev = _np(rng, 2, K - 1, 12) if with_prev else None
    out, new = t_ssm._causal_conv(_t(x), _t(w), _t(b),
                                  None if prev is None else _t(prev))
    jout, jnew = j_ssm._causal_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        None if prev is None else jnp.asarray(prev))
    _close(out, jout, BLOCK_TOL)
    assert new.shape == jnew.shape
    _close(new, jnew, 0.0)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("S,states", [(64, False), (45, False), (45, True)])
def test_mamba_forward_with_state_matches(arch, S, states):
    """out and both states at the smoke config, S a multiple of the
    chunk (32) and ragged, from zero and from given states."""
    cfg, jcfg, jp, tp = _block(arch)
    d_in, H, d_xbc = t_ssm.dims(cfg)
    s = cfg.ssm
    rng = np.random.default_rng(S + 100 * states)
    x = _np(rng, 2, S, cfg.d_model)
    conv0 = _np(rng, 2, s.d_conv - 1, d_xbc) if states else None
    h0 = _np(rng, 2, H, s.head_dim, s.d_state, scale=0.3) if states \
        else None
    for impl in (None, t_ssm.ssd_kernel):
        out, (conv, h) = t_ssm.mamba_forward(
            tp, _t(x), cfg, conv_prev=None if conv0 is None else _t(conv0),
            ssm_state=None if h0 is None else _t(h0), return_state=True,
            ssd_impl=impl)
        jout, (jconv, jh) = j_ssm.mamba_forward(
            jp, jnp.asarray(x), jcfg,
            conv_prev=None if conv0 is None else jnp.asarray(conv0),
            ssm_state=None if h0 is None else jnp.asarray(h0),
            return_state=True)
        _close(out, jout, BLOCK_TOL)
        _close(conv, jconv, BLOCK_TOL)
        _close(h, jh, BLOCK_TOL)
        assert h.dtype == torch.float32 and h.shape == jh.shape
    if not states:
        _close(t_ssm.mamba_forward(tp, _t(x), cfg), jout, BLOCK_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_mamba_decode_steps_match(arch):
    """A ragged prefill's states, then 4 decode steps, each against the
    reference's; the last state equals a prefill over all the tokens."""
    cfg, jcfg, jp, tp = _block(arch, seed=1)
    rng = np.random.default_rng(3)
    x = _np(rng, 2, 41, cfg.d_model)
    _, (conv, h) = t_ssm.mamba_forward(tp, _t(x[:, :37]), cfg,
                                       return_state=True,
                                       ssd_impl=t_ssm.ssd_kernel)
    _, (jconv, jh) = j_ssm.mamba_forward(jp, jnp.asarray(x[:, :37]), jcfg,
                                         return_state=True)
    for t in range(37, 41):
        out, (conv, h) = t_ssm.mamba_decode_step(tp, _t(x[:, t:t + 1]), cfg,
                                                 conv, h)
        jout, (jconv, jh) = j_ssm.mamba_decode_step(
            jp, jnp.asarray(x[:, t:t + 1]), jcfg, jconv, jh)
        _close(out, jout, BLOCK_TOL)
        _close(conv, jconv, BLOCK_TOL)
        _close(h, jh, BLOCK_TOL)
    _, (_, h_all) = t_ssm.mamba_forward(tp, _t(x), cfg, return_state=True)
    _close(h, h_all, BLOCK_TOL)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def test_init_mamba_cpu_draws_do_not_move():
    """The cascade's ``ssm`` student draws on the CPU: the same numbers as
    drawing in-projection, conv, dt and out-projection in turn."""
    cfg = _fp32(get_smoke_config("mamba2-370m"))
    d_in, H, d_xbc = t_ssm.dims(cfg)
    s = cfg.ssm
    got = t_ssm.init_mamba(torch.Generator().manual_seed(5), cfg)
    g = torch.Generator().manual_seed(5)
    want_in = dense_init(g, cfg.d_model, 2 * d_in + 2 * s.d_state + H)
    want_conv = trunc_normal(g, (s.d_conv, d_xbc), d_xbc ** -0.5)
    u = torch.rand((H,), generator=g)
    dt_init = torch.exp(u * (math.log(0.1) - math.log(1e-3))
                        + math.log(1e-3))
    want_out = dense_init(g, d_in, cfg.d_model)
    assert torch.equal(got["in_proj"], want_in)
    assert torch.equal(got["conv_w"], want_conv)
    assert torch.equal(got["dt_bias"],
                       dt_init + torch.log(-torch.expm1(-dt_init)))
    assert torch.equal(got["out_proj"], want_out)
    sp = torch.nn.functional.softplus(got["dt_bias"])
    assert float(sp.min()) >= 1e-3 * 0.999 and float(sp.max()) <= 0.1 * 1.001


@pytest.mark.parametrize("arch", ARCHS)
def test_init_mamba_meta_is_the_reference_tree(arch):
    """``gen=None`` builds the reference's leaves (shapes, dtypes) on
    ``meta``, at full width."""
    cfg = get_config(arch)
    from repro.configs import get_config as j_get_config
    jtree = jax.eval_shape(lambda: j_ssm.init_mamba(jax.random.PRNGKey(0),
                                                    j_get_config(arch)))
    mine = t_ssm.init_mamba(None, cfg)
    assert set(mine) == set(jtree)
    for k, v in mine.items():
        assert v.device.type == "meta"
        assert tuple(v.shape) == tuple(jtree[k].shape), k
        assert str(v.dtype).split(".")[-1] == str(jtree[k].dtype), k
    assert {str(mine[k].dtype) for k in ("A_log", "dt_bias", "D",
                                         "gate_norm", "conv_b")} \
        == {"torch.float32"}
    assert sum(t.numel() for t in tree_leaves(mine)) > 0
