"""Port kernels' plain versions vs the JAX package's ops and refs (CPU).

On the CPU each port op (``repro_torch.kernels.*.ops``) runs its plain
PyTorch twin; the JAX op runs its Pallas kernel in interpret mode, as the
JAX package's own tests run it.  Inputs are made with numpy from a seed
and handed to both.  Tolerances: 2e-5 fp32 / 2e-2 bf16 for flash and
decode attention, 2e-3 for the SSD scan against ``ssd_scan_ref`` (the
tolerances the JAX package pins between its own op and ref), 1e-4 for
the fp32 grouped matmul (sums of up to 512 fp32 products in another
order; the JAX package pins 1e-3) and one bf16 ulp (2**-7 relative) for
bf16.  Cases: the kernel ladder's CI shapes, the grouped-matmul shapes
of ``tests/test_kernels.py`` plus ragged ones, and the edge cases the
CUDA kernels are held to on the card (window, non-causal, GQA, bf16,
head dim 120, garbage in empty ring slots, a (W,) pos).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import decode_attention as j_decode  # noqa: E402
from repro.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref as j_decode_ref)
from repro.kernels.flash_attention import flash_attention as j_flash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as j_attn_ref  # noqa: E402
from repro.kernels.moe_gmm import moe_expert_ffn as j_expert_ffn  # noqa: E402
from repro.models.moe import _expert_ffn as j_model_expert_ffn  # noqa: E402
from repro.kernels.moe_gmm import moe_gmm as j_gmm  # noqa: E402
from repro.kernels.moe_gmm.ref import expert_ffn_ref as j_expert_ffn_ref  # noqa: E402
from repro.kernels.moe_gmm.ref import gmm_ref as j_gmm_ref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as j_ssd  # noqa: E402
from repro.kernels.ssd_scan.ref import ssd_scan_ref as j_ssd_ref  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.decode_attention.ref import decode_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.moe_gmm import moe_gmm  # noqa: E402
from repro_torch.kernels.moe_gmm.ref import gmm_ref  # noqa: E402
from repro_torch.models.moe import _expert_ffn  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_scan_chunked_ref, ssd_scan_ref)

FP32_TOL = 2e-5
BF16_TOL = 2e-2
SSD_TOL = 2e-3


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(a, dtype=dtype)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------
FLASH_CASES = {
    # name: (B, S, H, K, hd, causal, window, block, bf16)
    "ci-path": (3, 32, 2, 2, 16, True, None, 16, False),
    "window": (2, 32, 2, 2, 16, True, 8, 16, False),
    "non-causal": (2, 32, 2, 2, 16, False, None, 16, False),
    "gqa": (2, 32, 4, 2, 16, True, None, 16, False),
    "bf16": (2, 32, 2, 2, 16, True, None, 16, True),
    "hd120": (1, 32, 2, 1, 120, True, None, 16, False),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_plain_matches_jax(case):
    B, S, H, K, hd, causal, window, block, bf16 = FLASH_CASES[case]
    rng = np.random.default_rng(100 + sorted(FLASH_CASES).index(case))
    q, k, v = _np(rng, B, S, H, hd), _np(rng, B, S, K, hd), \
        _np(rng, B, S, K, hd)
    tdt = torch.bfloat16 if bf16 else torch.float32
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    tol = BF16_TOL if bf16 else FP32_TOL
    out = flash_attention(_t(q, tdt), _t(k, tdt), _t(v, tdt), causal=causal,
                          window=window, block_q=block, block_kv=block)
    assert out.shape == (B, S, H, hd) and out.dtype == tdt
    j_op = j_flash(_j(q, jdt), _j(k, jdt), _j(v, jdt), causal=causal,
                   window=window, block_q=block, block_kv=block)
    j_ref = j_attn_ref(*(_j(a, jdt).transpose(0, 2, 1, 3) for a in (q, k, v)),
                       causal=causal, window=window).transpose(0, 2, 1, 3)
    got = out.float().numpy()
    for want in (j_op, j_ref):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)
    # the port's ref (B, H, S, hd layout) is what the op runs on the CPU
    direct = attention_ref(*(_t(a, tdt).transpose(1, 2) for a in (q, k, v)),
                           causal=causal, window=window).transpose(1, 2)
    assert torch.equal(direct, out)


def test_flash_block_args_do_not_change_the_result():
    rng = np.random.default_rng(7)
    q, k, v = (_t(_np(rng, 2, 32, 2, 16)) for _ in range(3))
    a = flash_attention(q, k, v, block_q=8, block_kv=8)
    b = flash_attention(q, k, v)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("nvalid", [1, 7, 17, 32])
def test_decode_plain_matches_jax_ring_tails(nvalid):
    """The readout's shape (G=1, W=max_len) with odd valid tails."""
    B, W, H, hd = 2, 32, 2, 16
    rng = np.random.default_rng(200 + nvalid)
    q, k, v = _np(rng, B, 1, H, hd), _np(rng, B, W, H, hd), \
        _np(rng, B, W, H, hd)
    pos = np.where(np.arange(W) < nvalid, np.arange(W), -1).astype(np.int32)
    pos_b = np.broadcast_to(pos[None], (B, W)).copy()
    out = decode_attention(_t(q), _t(k), _t(v), torch.from_numpy(pos_b),
                           block_kv=16)
    j_op = j_decode(_j(q), _j(k), _j(v), jnp.asarray(pos_b), block_kv=16)
    j_ref = j_decode_ref(_j(q)[:, 0].reshape(B, H, 1, hd), _j(k), _j(v),
                         jnp.asarray(pos_b)).reshape(B, 1, H, hd)
    for want in (j_op, j_ref):
        np.testing.assert_allclose(out.numpy(), np.asarray(want),
                                   atol=FP32_TOL, rtol=FP32_TOL)
    # a (W,) pos broadcasts to the same answer
    out_w = decode_attention(_t(q), _t(k), _t(v), torch.from_numpy(pos))
    assert torch.equal(out_w, out)
    # finite garbage in the empty slots leaves the output unchanged
    if nvalid < W:
        kg, vg = k.copy(), v.copy()
        kg[:, nvalid:] = 77.0
        vg[:, nvalid:] = -1e4 * _np(rng, B, W - nvalid, H, hd)
        out_g = decode_attention(_t(q), _t(kg), _t(vg),
                                 torch.from_numpy(pos_b))
        np.testing.assert_allclose(out_g.numpy(), out.numpy(), atol=1e-6)


@pytest.mark.parametrize("bf16", [False, True])
def test_decode_plain_matches_jax_gqa(bf16):
    B, W, H, K, hd = 2, 32, 4, 2, 16
    rng = np.random.default_rng(300 + bf16)
    q, k, v = _np(rng, B, 1, H, hd), _np(rng, B, W, K, hd), \
        _np(rng, B, W, K, hd)
    pos = np.where(rng.random((B, W)) < 0.7, np.arange(W)[None], -1)
    pos[:, 0] = 0
    pos = pos.astype(np.int32)
    tdt = torch.bfloat16 if bf16 else torch.float32
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    tol = BF16_TOL if bf16 else FP32_TOL
    out = decode_attention(_t(q, tdt), _t(k, tdt), _t(v, tdt),
                           torch.from_numpy(pos), block_kv=16)
    j_op = j_decode(_j(q, jdt), _j(k, jdt), _j(v, jdt), jnp.asarray(pos),
                    block_kv=16)
    j_ref = j_decode_ref(_j(q, jdt)[:, 0].reshape(B, K, H // K, hd),
                         _j(k, jdt), _j(v, jdt),
                         jnp.asarray(pos)).reshape(B, 1, H, hd)
    for want in (j_op, j_ref):
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)
    direct = decode_attention_ref(_t(q, tdt)[:, 0].reshape(B, K, H // K, hd),
                                  _t(k, tdt), _t(v, tdt),
                                  torch.from_numpy(pos))
    assert torch.equal(direct.reshape(B, 1, H, hd), out)


# the split of the cache across blocks (the CUDA kernel's "split" variant)
SPLIT_CASES = {
    # name: (B, K, W, splits)
    "zoo decode": (2, 8, 2048, 16),
    "cascade batch 64": (64, 4, 128, 1),
    "cascade bucket 8": (8, 4, 128, 1),
    "W below a split": (1, 1, 40, 1),
    "W not a multiple": (1, 1, 1000, 7),
    "ragged last split": (1, 2, 3000, 23),
}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_decode_num_splits(case):
    from repro_torch.kernels.decode_attention.kernel import (
        MIN_SPLIT_SLOTS, num_splits, select_variant, split_bounds)
    B, K, W, want = SPLIT_CASES[case]
    n = num_splits(B, K, W)
    assert n == want
    assert select_variant(B, K, W) == ("split" if n > 1 else "single")
    bounds = split_bounds(W, n)
    assert len(bounds) == n
    assert bounds[0][0] == 0 and bounds[-1][1] == W
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert all(hi > lo for lo, hi in bounds)
    if n > 1:     # every split but the ragged last is long enough
        assert all(hi - lo >= MIN_SPLIT_SLOTS for lo, hi in bounds[:-1])
        assert n * B * K <= 2 * 132


@pytest.mark.parametrize("n_split", [1, 2, 3, 16])
@pytest.mark.parametrize("pos_kind", ["lens", "split empty", "none valid"])
@pytest.mark.parametrize("bf16", [False, True])
def test_decode_split_ref_matches_jax(n_split, pos_kind, bf16):
    """The split-and-combine arithmetic against the JAX op (interpret
    mode) and ref, W = 200 so that 3 and 16 splits leave a ragged last
    split: a split whose every slot is empty must weigh 0, a cache with no
    valid slot must average its values."""
    from repro_torch.kernels.decode_attention.kernel import split_bounds
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_split_ref)
    B, W, H, K, hd = 2, 200, 4, 2, 16
    rng = np.random.default_rng(500 + 10 * n_split + len(pos_kind) + bf16)
    q, k, v = _np(rng, B, 1, H, hd), _np(rng, B, W, K, hd), \
        _np(rng, B, W, K, hd)
    ar = np.arange(W)
    if pos_kind == "lens":
        lens = rng.integers(1, W + 1, (B, 1))
        pos = np.where(ar[None] < lens, ar[None], -1)
    elif pos_kind == "split empty":
        bounds = split_bounds(W, max(n_split, 2))
        lo, hi = bounds[len(bounds) // 2]
        pos = np.broadcast_to(np.where((ar >= lo) & (ar < hi), -1, ar),
                              (B, W))
    else:
        pos = np.full((B, W), -1)
    pos = np.ascontiguousarray(pos, dtype=np.int32)
    assert len(split_bounds(W, n_split)) == n_split
    tdt = torch.bfloat16 if bf16 else torch.float32
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    tol = BF16_TOL if bf16 else FP32_TOL
    qg = _t(q, tdt)[:, 0].reshape(B, K, H // K, hd)
    out = decode_attention_split_ref(qg, _t(k, tdt), _t(v, tdt),
                                     torch.from_numpy(pos), n_split)
    assert out.shape == (B, K, H // K, hd) and out.dtype == tdt
    j_op = j_decode(_j(q, jdt), _j(k, jdt), _j(v, jdt), jnp.asarray(pos))
    j_ref = j_decode_ref(_j(q, jdt)[:, 0].reshape(B, K, H // K, hd),
                         _j(k, jdt), _j(v, jdt), jnp.asarray(pos))
    got = out.float().numpy()
    for want in (np.asarray(j_op, np.float32).reshape(got.shape),
                 np.asarray(j_ref, np.float32)):
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# SSD scan
# ---------------------------------------------------------------------------
SSD_CASES = {
    # name: (Bsz, S, H, hp, N, chunk)
    "ci-path": (2, 32, 2, 16, 8, 16),
    "one-chunk": (2, 16, 3, 8, 4, 16),
    "chunk-gt-seq": (1, 24, 2, 8, 8, 64),
}


@pytest.mark.parametrize("case", sorted(SSD_CASES))
def test_ssd_plain_matches_jax(case):
    Bsz, S, H, hp, N, chunk = SSD_CASES[case]
    rng = np.random.default_rng(400 + sorted(SSD_CASES).index(case))
    x = _np(rng, Bsz, S, H, hp)
    dt = np.log1p(np.exp(_np(rng, Bsz, S, H))).astype(np.float32)
    adt = (-0.4 * dt).astype(np.float32)
    B, C = _np(rng, Bsz, S, N), _np(rng, Bsz, S, N)
    out = ssd_scan(_t(x), _t(adt), _t(dt), _t(B), _t(C), chunk=chunk)
    j_op = j_ssd(_j(x), _j(adt), _j(dt), _j(B), _j(C), chunk=chunk)
    j_ref = j_ssd_ref(_j(x), _j(adt), _j(dt), _j(B), _j(C))
    for want in (j_op, j_ref):
        np.testing.assert_allclose(out.numpy(), np.asarray(want),
                                   atol=SSD_TOL, rtol=SSD_TOL)
    seq = ssd_scan_ref(_t(x), _t(adt), _t(dt), _t(B), _t(C))
    np.testing.assert_allclose(out.numpy(), seq.numpy(), atol=SSD_TOL,
                               rtol=SSD_TOL)
    assert torch.equal(out, ssd_scan_chunked_ref(
        _t(x), _t(adt), _t(dt), _t(B), _t(C), min(chunk, S)))


def test_ssd_rejects_ragged_sequence():
    x = torch.zeros((1, 24, 1, 4))
    a = torch.zeros((1, 24, 1))
    b = torch.zeros((1, 24, 2))
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd_scan(x, a, a, b, b, chunk=16)


# ---------------------------------------------------------------------------
# grouped matmul (moe_gmm)
# ---------------------------------------------------------------------------
GMM_TOL = 1e-4
GMM_SHAPES = [(4, 64, 256, 512), (8, 32, 128, 128), (2, 128, 512, 256)]


@pytest.mark.parametrize("shape", GMM_SHAPES)
def test_gmm_plain_matches_jax(shape):
    """The shapes of ``tests/test_kernels.py``; the JAX op runs its Pallas
    kernel in interpret mode (block sizes do not change its result)."""
    E, C, D, F = shape
    rng = np.random.default_rng(500 + GMM_SHAPES.index(shape))
    x = _np(rng, E, C, D)
    w = (0.05 * _np(rng, E, D, F)).astype(np.float32)
    out = moe_gmm(_t(x), _t(w))
    assert out.shape == (E, C, F) and out.dtype == torch.float32
    j_op = j_gmm(_j(x), _j(w), block_c=min(C, 64), block_f=128,
                 block_d=128)
    for want in (j_op, j_gmm_ref(_j(x), _j(w))):
        np.testing.assert_allclose(out.numpy(), np.asarray(want),
                                   atol=GMM_TOL, rtol=GMM_TOL)
    assert torch.equal(out, gmm_ref(_t(x), _t(w)))


@pytest.mark.parametrize("bf16", [False, True])
def test_expert_ffn_plain_matches_jax(bf16):
    """The MoE expert FFN the model serves (``models/moe.py``
    ``_expert_ffn``: three ``moe_gmm`` products, SiLU * h in the model
    dtype) against the reference model's ``_expert_ffn``; in fp32 also
    against the JAX op ``moe_expert_ffn`` (Pallas, interpret mode) and
    ``expert_ffn_ref``, whose fp32 SiLU * h is the same there."""
    E, C, D, F = 4, 64, 128, 256
    rng = np.random.default_rng(510 + bf16)
    x = _np(rng, E, C, D)
    w_in, w_g = (0.05 * _np(rng, E, D, F) for _ in range(2))
    w_o = 0.05 * _np(rng, E, F, D)
    tdt = torch.bfloat16 if bf16 else torch.float32
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    names = ("w_in", "w_gate", "w_out")
    p_t = {n: _t(a, tdt) for n, a in zip(names, (w_in, w_g, w_o))}
    p_j = {n: _j(a, jdt) for n, a in zip(names, (w_in, w_g, w_o))}
    out = _expert_ffn(_t(x, tdt), p_t, None)
    assert out.dtype == tdt and out.shape == (E, C, D)
    wants = [j_model_expert_ffn(_j(x, jdt), p_j, None)]
    if not bf16:
        args_j = [_j(x)] + [p_j[n] for n in names]
        wants += [j_expert_ffn(*args_j), j_expert_ffn_ref(*args_j)]
    got = out.float().numpy()
    for want in wants:
        want = np.asarray(want, np.float32)
        if bf16:     # one bf16 ulp of the output's largest magnitude
            tol = 2.0 ** -7 * float(np.abs(want).max())
            np.testing.assert_allclose(got, want, atol=tol, rtol=0)
        else:
            np.testing.assert_allclose(got, want, atol=GMM_TOL,
                                       rtol=GMM_TOL)


@pytest.mark.parametrize("shape", [(3, 5, 7, 9), (2, 1, 130, 129),
                                   (1, 129, 33, 17), (2, 4, 0, 8)])
def test_gmm_plain_ragged_and_strided(shape):
    """Any C, D and F (the CUDA kernel masks its ragged edges; the TPU
    kernel asserts divisibility), strided inputs, and an empty
    contraction, against the port's own fp32 einsum."""
    E, C, D, F = shape
    rng = np.random.default_rng(sum(shape))
    x, w = _t(_np(rng, E, C, D)), _t(_np(rng, E, D, F))
    want = torch.einsum("ecd,edf->ecf", x.double(), w.double())
    np.testing.assert_allclose(moe_gmm(x, w).numpy(), want.numpy(),
                               atol=GMM_TOL, rtol=GMM_TOL)
    xt = _t(_np(rng, E, D, C)).transpose(1, 2)         # (E, C, D) view
    wt = _t(_np(rng, E, F, D)).transpose(1, 2)         # (E, D, F) view
    np.testing.assert_allclose(
        moe_gmm(xt, wt).numpy(),
        torch.einsum("ecd,edf->ecf", xt.double(), wt.double()).numpy(),
        atol=GMM_TOL, rtol=GMM_TOL)


# ---------------------------------------------------------------------------
# variant choice: tensor cores ("tc") or CUDA cores ("simt"), from dtype,
# shapes, strides and base alignment alone (no card needed)
# ---------------------------------------------------------------------------
BF16 = torch.bfloat16


def _unaligned(*shape, dtype=BF16):
    """A CPU tensor whose base address is one element (2 bytes in bf16,
    4 in fp32) past a 16-byte one."""
    n = int(np.prod(shape))
    base = torch.empty(n + 8, dtype=dtype)
    off = (-base.data_ptr() // base.element_size()) % 8 + 1
    t = base[off:off + n].view(shape)
    assert t.data_ptr() % 16 == t.element_size()
    return t


GMM_VARIANT_CASES = {
    # name: (x, w) builders, expected variant
    "zoo prefill up (meta)": (lambda: (
        torch.empty((8, 640, 6144), dtype=BF16, device="meta"),
        torch.empty((8, 6144, 16384), dtype=BF16, device="meta")), "tc"),
    "zoo prefill down (meta)": (lambda: (
        torch.empty((8, 640, 16384), dtype=BF16, device="meta"),
        torch.empty((8, 16384, 6144), dtype=BF16, device="meta")), "tc"),
    "zoo decode up (meta)": (lambda: (
        torch.empty((8, 4, 6144), dtype=BF16, device="meta"),
        torch.empty((8, 6144, 16384), dtype=BF16, device="meta")), "tc"),
    "ragged readable (cpu)": (lambda: (
        torch.empty((3, 130, 1000), dtype=BF16),
        torch.empty((3, 1000, 1040), dtype=BF16)), "tc"),
    "decode C=5 (cpu)": (lambda: (
        torch.empty((2, 5, 1000), dtype=BF16),
        torch.empty((2, 1000, 1040), dtype=BF16)), "tc"),
    "fp32 (meta)": (lambda: (
        torch.empty((8, 640, 6144), device="meta"),
        torch.empty((8, 6144, 16384), device="meta")), "simt"),
    "fp32 (cpu)": (lambda: (torch.empty((2, 16, 64)),
                            torch.empty((2, 64, 64))), "simt"),
    "D 777 (cpu)": (lambda: (torch.empty((2, 5, 777), dtype=BF16),
                             torch.empty((2, 777, 1024), dtype=BF16)),
                    "simt"),
    "F 1029 (meta)": (lambda: (
        torch.empty((3, 130, 1000), dtype=BF16, device="meta"),
        torch.empty((3, 1000, 1029), dtype=BF16, device="meta")), "simt"),
    # an odd F or D in a slice of a wider tensor: the rows stay 16-byte
    # multiples, so TMA reads them (and the epilogue stores odd F singly)
    "F 1029 slice of F 1040 (cpu)": (lambda: (
        torch.empty((3, 130, 1000), dtype=BF16),
        torch.empty((3, 1000, 1040), dtype=BF16)[..., :1029]), "tc"),
    "F 1029 slice of F 1040 (meta)": (lambda: (
        torch.empty((2, 5, 1000), dtype=BF16, device="meta"),
        torch.empty((2, 1000, 1040), dtype=BF16, device="meta")[..., :1029]),
        "tc"),
    "D 1001 slice of D 1008 (cpu)": (lambda: (
        torch.empty((2, 5, 1008), dtype=BF16)[..., :1001],
        torch.empty((2, 1008, 1024), dtype=BF16)[:, :1001]), "tc"),
    "transposed x (cpu)": (lambda: (
        torch.empty((2, 64, 16), dtype=BF16).transpose(1, 2),
        torch.empty((2, 64, 64), dtype=BF16)), "simt"),
    "unaligned base (cpu)": (lambda: (_unaligned(2, 16, 64),
                                      torch.empty((2, 64, 64), dtype=BF16)),
                             "simt"),
    "empty D (cpu)": (lambda: (torch.empty((2, 4, 0), dtype=BF16),
                               torch.empty((2, 0, 8), dtype=BF16)), "simt"),
}


@pytest.mark.parametrize("case", sorted(GMM_VARIANT_CASES))
def test_gmm_select_variant(case):
    from repro_torch.kernels.moe_gmm.kernel import select_variant
    make, want = GMM_VARIANT_CASES[case]
    assert select_variant(*make()) == want


FLASH_VARIANT_CASES = {
    # name: (q, k, v) builders, expected variant
    "zoo prefill (meta)": (lambda: (
        torch.empty((2, 2048, 48, 128), dtype=BF16, device="meta"),
        torch.empty((2, 2048, 8, 128), dtype=BF16, device="meta"),
        torch.empty((2, 2048, 8, 128), dtype=BF16, device="meta")), "tc"),
    "hd 64 (cpu)": (lambda: tuple(torch.empty((1, 64, 2, 64), dtype=BF16)
                                  for _ in range(3)), "tc"),
    "cascade fp32 (meta)": (lambda: tuple(
        torch.empty((64, 128, 4, 32), device="meta") for _ in range(3)),
        "tiled"),
    "fp32 hd 128 (cpu)": (lambda: tuple(torch.empty((1, 16, 2, 128))
                                        for _ in range(3)), "tiled"),
    "fp32 hd 16 (cpu)": (lambda: tuple(torch.empty((3, 32, 2, 16))
                                       for _ in range(3)), "tiled"),
    "fp32 hd 64 GQA (cpu)": (lambda: (
        torch.empty((2, 64, 8, 64)), torch.empty((2, 64, 2, 64)),
        torch.empty((2, 64, 2, 64))), "tiled"),
    # the cascade's q/k/v: (x @ W).reshape(B, L, H, hd) views
    "cascade fp32 projection views (cpu)": (lambda: tuple(
        (torch.empty((8, 128, 128)) @ torch.empty((128, 128)))
        .reshape(8, 128, 4, 32) for _ in range(3)), "tiled"),
    "fp32 hd 120 (cpu)": (lambda: tuple(torch.empty((1, 16, 2, 120))
                                        for _ in range(3)), "simt"),
    "fp32 head-dim stride (cpu)": (lambda: (
        torch.empty((1, 16, 32, 2)).transpose(2, 3),
        torch.empty((1, 16, 2, 32)), torch.empty((1, 16, 2, 32))), "simt"),
    "fp32 row stride 33 (cpu)": (lambda: (
        torch.empty((1, 16, 2, 33))[..., :32], torch.empty((1, 16, 2, 32)),
        torch.empty((1, 16, 2, 32))), "simt"),
    "fp32 unaligned base (cpu)": (lambda: (
        _unaligned(1, 16, 2, 32, dtype=torch.float32),
        torch.empty((1, 16, 2, 32)), torch.empty((1, 16, 2, 32))), "simt"),
    # h2o-danube-3-4b's head dim: the 128-wide tc instance
    "hd 120 (cpu)": (lambda: tuple(torch.empty((1, 16, 2, 120), dtype=BF16)
                                   for _ in range(3)), "tc"),
    "hd 96 bf16 (cpu)": (lambda: tuple(torch.empty((1, 16, 2, 96),
                                                   dtype=BF16)
                                       for _ in range(3)), "simt"),
    "hd 32 bf16 (meta)": (lambda: tuple(
        torch.empty((4, 128, 4, 32), dtype=BF16, device="meta")
        for _ in range(3)), "simt"),
    "head-dim stride (cpu)": (lambda: (
        torch.empty((1, 16, 64, 2), dtype=BF16).transpose(2, 3),
        torch.empty((1, 16, 2, 64), dtype=BF16),
        torch.empty((1, 16, 2, 64), dtype=BF16)), "simt"),
    "unaligned base (cpu)": (lambda: (
        _unaligned(1, 16, 2, 64), torch.empty((1, 16, 2, 64), dtype=BF16),
        torch.empty((1, 16, 2, 64), dtype=BF16)), "simt"),
}


@pytest.mark.parametrize("case", sorted(FLASH_VARIANT_CASES))
def test_flash_select_variant(case):
    from repro_torch.kernels.flash_attention.kernel import select_variant
    make, want = FLASH_VARIANT_CASES[case]
    assert select_variant(*make()) == want


@pytest.mark.parametrize("case", [
    "tiled on hd 120", "tiled on bf16", "tiled on row stride 65",
    "tiled on unaligned base", "tc on fp32", "tc on bf16 hd 32",
    "tc on bf16 hd 96", "cuda"])
def test_flash_forced_choice_never_falls_back(case):
    """A forced variant the operands do not allow, or one the kernel does
    not have, raises; it never falls back to another variant."""
    from repro_torch.kernels.flash_attention.kernel import launch_choice
    hd = {"tiled on hd 120": 120, "tc on bf16 hd 32": 32,
          "tc on bf16 hd 96": 96}.get(case, 64)
    dtype = BF16 if case in ("tiled on bf16", "tc on bf16 hd 32",
                             "tc on bf16 hd 96") else torch.float32
    q = torch.empty((2, 64, 4, hd), dtype=dtype, device="meta")
    if case == "tiled on row stride 65":
        q = torch.empty((2, 64, 4, 65))[..., :64]
    if case == "tiled on unaligned base":
        q = _unaligned(2, 64, 4, 64, dtype=torch.float32)
    k = v = torch.empty((2, 64, 4, hd), dtype=dtype, device=q.device)
    variant = {"tc on fp32": "tc", "tc on bf16 hd 32": "tc",
               "tc on bf16 hd 96": "tc", "cuda": "cuda"}.get(case, "tiled")
    with pytest.raises(ValueError):
        launch_choice(q, k, v, variant)


@pytest.mark.parametrize("B,hd,variant,want", [
    (8, 32, None, "tiled"), (64, 32, None, "tiled"),
    (8, 32, "simt", "simt"), (8, 32, "tiled", "tiled"),
    (3, 16, None, "tiled"), (3, 16, "simt", "simt")])
def test_flash_launch_choice(B, hd, variant, want):
    """The cascade's q/k/v at buckets 8 and 64 and ``TINY_TF_CI``'s: the
    selected variant, and forced variants the operands allow."""
    from repro_torch.kernels.flash_attention.kernel import launch_choice
    q = torch.empty((B, 128, 4, hd), device="meta")
    assert launch_choice(q, q, q, variant) == want


def test_build_hash_covers_every_csrc_file():
    """Every file under ``kernels/csrc`` is a listed source or header, so
    the content hash that names the built library covers it (an edit to
    an unlisted header would load a stale library)."""
    from repro_torch.kernels import _build
    on_disk = {p.name for p in _build.CSRC.iterdir() if p.is_file()}
    assert on_disk == set(_build.SOURCES + _build.HEADERS)


# ---------------------------------------------------------------------------
# dispatch: a non-CPU tensor never takes the plain path
# ---------------------------------------------------------------------------
def test_meta_tensors_go_to_the_kernel_launcher_and_raise():
    """Only a CPU tensor runs the plain twin; any other device takes the
    kernel's way.  A ``meta`` tensor (the dry-run's count) reaches the
    kernel's shape function, which launches nothing and leaves every
    launch count as it was; the CUDA launcher itself still refuses it
    instead of falling back."""
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_cuda)
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda)
    from repro_torch.kernels.moe_gmm.kernel import moe_gmm_cuda
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
    launchers = (flash_attention_cuda, decode_attention_cuda,
                 ssd_scan_cuda, moe_gmm_cuda)
    before = [f.launches for f in launchers]
    q = torch.empty((1, 8, 1, 4), device="meta")
    pos = torch.empty((1, 8), dtype=torch.int32, device="meta")
    a = torch.empty((1, 8, 1), device="meta")
    b = torch.empty((1, 8, 2), device="meta")
    x = torch.empty((2, 4, 8), device="meta")
    w = torch.empty((2, 8, 16), device="meta")
    outs = [flash_attention(q, q, q), decode_attention(q[:, :1], q, q, pos),
            ssd_scan(q, a, a, b, b, chunk=8), moe_gmm(x, w),
            _expert_ffn(x, {"w_in": w, "w_gate": w,
                            "w_out": w.transpose(1, 2)}, None)]
    shapes = [(1, 8, 1, 4), (1, 1, 1, 4), (1, 8, 1, 4), (2, 4, 16),
              (2, 4, 8)]
    assert [tuple(o.shape) for o in outs] == shapes
    assert all(o.is_meta for o in outs)
    assert [f.launches for f in launchers] == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError, match="CUDA tensors"):
        decode_attention_cuda(q[:, :1], q, q, pos)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_scan_cuda(q, a, a, b, b, chunk=8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        moe_gmm_cuda(x, w)
