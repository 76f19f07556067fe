"""The port's CUDA kernels on the card (skipped where there is no GPU).

Run on a GPU machine with
  python -m pytest -q -m gpu tests/test_torch_gpu.py
Each kernel is held against its plain PyTorch twin on the same CUDA
inputs (fp32 2e-5 for attention, 1e-3 for the SSD scan, bf16 2e-2; the
grouped matmul 1e-5 (fp32) and 1e-2 (bf16) of the twin's largest
magnitude, as is bf16 flash attention on its tensor-core variant), its
launch counter must move by exactly one per call, and a CPU tensor must
never reach it.  For ``moe_gmm`` and flash attention each case also
asserts which variant (``"tc"`` tensor cores, also at Danube's head
dim 120; ``"simt"`` CUDA cores) the launch took (flash: also
``"tiled"``, fp32 register tiles, forced against ``"simt"`` on one
input).  The CUDA engine must route a short
stream like the CPU engine does, on the kernel ladder and on the paper's
default ``lr -> tinytf`` ladder; a hard expert budget must hold on the
card; the model expert must label on the card as on the CPU; and the
zoo's smoke models (Mixtral, the seven other decoder-only
architectures and the two CROSS ones with their memory) must serve on
the card as on the CPU.  Flash is also held at the CROSS models'
non-causal shapes (Sq != Skv, a ragged last kv tile at 1600 memory
slots) and decode attention over a memory whose every slot is valid.  The SSD scan's
chunk-parallel variant (the zoo's chunk 256 x state 128, at
mamba2-370m's and Jamba's layer shapes), each of its four passes against
its plain pass, and both variants' final state are held to the twin, and decode attention at Llama-3-405B's
16 query heads a kv head.  The engine
matrix: pipelined depth 2 routes as depth 0 with bitwise state, stage B
waits for the level-0 copy's event (device work queued ahead of it with
``torch.cuda._sleep``), and the model expert's pool threads run on
streams of their own.  Occupancy and checkpoints: an empty tick on the
kernel ladder launches nothing and a 1-lane tick pads to bucket 8; an
engine resume is bitwise on the card; a checkpoint written on the card
restores on the CPU and routes the same.  Sanitizers: the determinism
trace at depth 2 equals depth 0's on the card, state digests included,
and the card's equals the CPU's on every field but the state; the model
expert's W=4 pool runs clean under the lock sanitizer, which catches an
unguarded ticket read.  Gradients: a CUDA call of flash, ``moe_gmm`` or
the SSD scan that needs one launches the kernel once and returns
autograd's gradient through the plain twin (within 1e-6 x max|twin
grad|, at a small shape and at the training path's), one that needs
none launches the kernel alone, decode attention raises under grad, and
a smoke-config training step with remat on the card equals the CPU's.
The dry-run: a smoke config's probes on the card count the FLOPs and
launches of their ``meta`` count, and their bytes and peak memory agree
with it within ``launch.dryrun.AGREE``.
Nothing here imports JAX (the GPU machine has none).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.decode_attention.kernel import (  # noqa: E402
    decode_attention_cuda)
from repro_torch.kernels.decode_attention.ref import decode_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_cuda)
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.moe_gmm import moe_gmm  # noqa: E402
from repro_torch.kernels.moe_gmm.kernel import moe_gmm_cuda  # noqa: E402
from repro_torch.kernels.moe_gmm.ref import gmm_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: E402
from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_scan_chunked_ref  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _randn(gen, *shape, dtype=torch.float32, device="cuda"):
    return torch.randn(shape, generator=gen).to(device, dtype)


@pytest.mark.parametrize("B,S,H,K,hd,causal,window,dtype", [
    (64, 128, 4, 4, 32, True, None, torch.float32),    # serving shape
    (3, 32, 2, 2, 16, True, None, torch.float32),      # CI shape
    (2, 96, 4, 4, 32, True, 40, torch.float32),
    (2, 64, 8, 2, 64, False, None, torch.float32),
    (2, 128, 4, 4, 32, True, None, torch.bfloat16),
    (1, 70, 2, 1, 120, True, None, torch.float32),
])
def test_flash_kernel_matches_plain(cuda, B, S, H, K, hd, causal, window,
                                    dtype):
    gen = torch.Generator().manual_seed(0)
    q = _randn(gen, B, S, H, hd, dtype=dtype)
    k = _randn(gen, B, S, K, hd, dtype=dtype)
    v = _randn(gen, B, S, K, hd, dtype=dtype)
    n0 = flash_attention_cuda.launches
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == n0 + 1
    ref = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal,
                        window=window).transpose(1, 2)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


def _decode_pos(kind, gen, B, K, W):
    """Slot positions: "lens" random valid prefixes (B, W); "ring" the
    zoo's (W,) ring with its last 300 slots empty; "empty" no valid slot;
    "split empty" every slot valid but those of one whole split; "all"
    every slot valid, (W,) arange (cross-attention over a memory)."""
    from repro_torch.kernels.decode_attention.kernel import (num_splits,
                                                              split_bounds)
    ar = torch.arange(W)
    if kind == "lens":
        lens = torch.randint(1, W + 1, (B,), generator=gen)
        pos = torch.where(ar[None] < lens[:, None], ar[None], -1)
    elif kind == "ring":
        pos = torch.where(ar < W - 300, ar, -1)
    elif kind == "empty":
        pos = torch.full((B, W), -1)
    elif kind == "all":
        pos = ar
    else:
        bounds = split_bounds(W, num_splits(B, K, W))
        lo, hi = bounds[len(bounds) // 2]
        pos = torch.where((ar >= lo) & (ar < hi), -1, ar)[None].expand(B, W)
    return pos.to("cuda", torch.int32)


@pytest.mark.parametrize("B,W,H,K,hd,dtype,pos_kind", [
    (64, 128, 4, 4, 32, torch.float32, "lens"),    # cascade, batch 64
    (2, 32, 2, 2, 16, torch.float32, "lens"),
    (4, 200, 8, 2, 64, torch.float32, "lens"),
    (4, 128, 4, 4, 32, torch.bfloat16, "lens"),
    (8, 128, 4, 4, 32, torch.float32, "lens"),     # cascade bucket 8
    (2, 2048, 48, 8, 128, torch.bfloat16, "ring"),  # zoo decode
    (2, 2048, 48, 8, 128, torch.bfloat16, "empty"),
    (8, 128, 4, 4, 32, torch.float32, "empty"),
    (2, 2048, 48, 8, 128, torch.bfloat16, "split empty"),
    (2, 1024, 8, 2, 64, torch.float32, "split empty"),  # 8 splits
    (2, 1000, 8, 2, 64, torch.bfloat16, "lens"),  # 7 splits, ragged last
    (2, 300, 32, 2, 64, torch.float32, "lens"),   # G 16: scored 8 at a time
    (2, 2048, 128, 8, 128, torch.bfloat16, "ring"),  # llama3-405b: G 16
    (2, 512, 32, 2, 128, torch.float32, "lens"),  # G 16 x hd 128 in fp32
    (2, 300, 4, 2, 256, torch.float32, "lens"),   # hd 256: two load rounds
    (3, 130, 6, 3, 120, torch.bfloat16, "lens"),  # 240-byte rows: scalar
    (2, 1600, 32, 8, 128, torch.bfloat16, "all"),  # vision cross: ragged
    (2, 2048, 16, 16, 64, torch.bfloat16, "all"),  # seamless cross
])
def test_decode_kernel_matches_plain(cuda, B, W, H, K, hd, dtype, pos_kind):
    from repro_torch.kernels.decode_attention.kernel import select_variant
    gen = torch.Generator().manual_seed(1)
    q = _randn(gen, B, 1, H, hd, dtype=dtype)
    k = _randn(gen, B, W, K, hd, dtype=dtype)
    v = _randn(gen, B, W, K, hd, dtype=dtype)
    pos = _decode_pos(pos_kind, gen, B, K, W)
    variant = select_variant(B, K, W)
    n0 = decode_attention_cuda.launches
    v0 = dict(decode_attention_cuda.launches_by_variant)
    out = decode_attention(q, k, v, pos)
    torch.cuda.synchronize()
    assert decode_attention_cuda.launches == n0 + 1
    moved = {n: c - v0[n]
             for n, c in decode_attention_cuda.launches_by_variant.items()}
    assert moved == {n: int(n == variant) for n in moved}
    pos_b = pos if pos.ndim == 2 else pos[None].expand(B, W)
    ref = decode_attention_ref(q[:, 0].reshape(B, K, H // K, hd), k, v,
                               pos_b).reshape(B, 1, H, hd)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    if pos_kind == "empty":    # every slot counts: nothing is inert
        return
    # empty slots are inert whatever they hold
    kg, vg = k.clone(), v.clone()
    inval = (pos_b < 0)[:, :, None, None].expand_as(kg)
    kg[inval], vg[inval] = 1e4, -1e4
    torch.testing.assert_close(decode_attention(q, kg, vg, pos), out,
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("n_split", [2, 3, 16])
def test_decode_forced_splits_match_plain(cuda, n_split):
    """The split path at the cascade's shape (fp32, G 1, hd 32), which
    the chooser serves unsplit; 3 splits leave a ragged last one."""
    gen = torch.Generator().manual_seed(4)
    B, W, H, hd = 8, 128, 4, 32
    q = _randn(gen, B, 1, H, hd)
    k, v = _randn(gen, B, W, H, hd), _randn(gen, B, W, H, hd)
    pos = _decode_pos("lens", gen, B, H, W)
    v0 = decode_attention_cuda.launches_by_variant["split"]
    out = decode_attention_cuda(q, k, v, pos, n_split=n_split)
    torch.cuda.synchronize()
    assert decode_attention_cuda.launches_by_variant["split"] == v0 + 1
    ref = decode_attention_ref(q[:, 0].reshape(B, H, 1, hd), k, v,
                               pos).reshape(B, 1, H, hd)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("Bsz,S,H,hp,N,chunk,strided", [
    (64, 128, 6, 64, 32, 64, False),   # serving shape
    (8, 128, 6, 64, 32, 64, False),    # serving dims, bucket 8
    (2, 32, 2, 16, 8, 16, False),      # CI shape
    (3, 96, 2, 32, 16, 32, False),
    (8, 128, 6, 64, 32, 64, True),     # x read through a stride
    (2, 30, 3, 10, 6, 15, False),      # no dimension a multiple of 4
])
def test_ssd_kernel_matches_plain(cuda, Bsz, S, H, hp, N, chunk, strided):
    gen = torch.Generator().manual_seed(2)
    x = _randn(gen, Bsz, S, H, 2 * hp if strided else hp)
    x = x[..., ::2] if strided else x
    dt = torch.nn.functional.softplus(_randn(gen, Bsz, S, H) - 2.0)
    adt = -torch.arange(1, H + 1, device="cuda").float() * dt
    B = _randn(gen, Bsz, S, N)
    C = _randn(gen, Bsz, S, N)
    n0 = ssd_scan_cuda.launches
    out = ssd_scan(x, adt, dt, B, C, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan_cuda.launches == n0 + 1
    ref = ssd_scan_chunked_ref(x, adt, dt, B, C, chunk)
    torch.testing.assert_close(out, ref, atol=1e-3, rtol=1e-3)


def _ssd_inputs(seed, Bsz, S, H, hp, N, strided=False, model_a=False):
    """O(1) x, B, C; dt = softplus(randn - 2); A = -(1 .. H), or with
    ``model_a`` spread over Mamba2's initial range [-16, -1] (at Jamba's
    256 heads -(1 .. H) drives |cum A dt| to ~8e3 in a chunk, where fp32
    rounding of the cumsum alone moves y by ~5e-3: the float64 rule of
    chip_smoke.py holds those rows)."""
    gen = torch.Generator().manual_seed(seed)
    x = _randn(gen, Bsz, S, H, 2 * hp if strided else hp)
    x = x[..., ::2] if strided else x
    dt = torch.nn.functional.softplus(_randn(gen, Bsz, S, H) - 2.0)
    a = (1 + 15 * torch.arange(H, device="cuda").float() / max(H - 1, 1)
         if model_a else torch.arange(1, H + 1, device="cuda").float())
    B, C = _randn(gen, Bsz, S, N), _randn(gen, Bsz, S, N)
    return x, -a * dt, dt, B, C, 0.5 * _randn(gen, Bsz, H, hp, N)


@pytest.mark.parametrize("Bsz,S,H,hp,N,chunk,strided,model_a", [
    (2, 512, 4, 64, 128, 256, False, False),    # the zoo's chunk and state
    (1, 255, 2, 64, 128, 255, False, False),    # S - 1 of a prefill check
    (1, 512, 3, 32, 128, 256, True, False),     # hp 32, x through a stride
    (2, 200, 2, 30, 20, 100, False, False),     # no dimension a multiple of 8
    (2, 2048, 32, 64, 128, 256, False, True),   # mamba2-370m's layer
    (2, 2048, 256, 64, 128, 256, False, True),  # Jamba's layer
    (1, 300, 4, 64, 128, 300, False, True),     # a ragged chunk of 300
])
def test_ssd_parallel_kernel_matches_plain(cuda, Bsz, S, H, hp, N, chunk,
                                           strided, model_a):
    """The chunk-parallel kernels: y and the final state against the twin,
    from zero and from an initial state; a null state pointer gives the
    same y bit for bit; every launch takes "parallel" at the chunk asked
    for, one launch a call."""
    x, adt, dt, B, C, h0 = _ssd_inputs(5, Bsz, S, H, hp, N, strided,
                                       model_a)
    v0 = ssd_scan_cuda.launches_by_variant["parallel"]
    n0 = ssd_scan_cuda.launches
    y, h = ssd_scan(x, adt, dt, B, C, chunk=chunk, return_state=True)
    y_only = ssd_scan(x, adt, dt, B, C, chunk=chunk)
    y1, h1 = ssd_scan(x, adt, dt, B, C, chunk=chunk, init_state=h0,
                      return_state=True)
    torch.cuda.synchronize()
    assert ssd_scan_cuda.launches_by_variant["parallel"] == v0 + 3
    assert ssd_scan_cuda.launches == n0 + 3
    assert torch.equal(y, y_only)
    for init, got_y, got_h in ((None, y, h), (h0, y1, h1)):
        ry, rh = ssd_scan_chunked_ref(x, adt, dt, B, C, chunk,
                                      init_state=init, return_state=True)
        torch.testing.assert_close(got_y, ry, atol=1e-3, rtol=1e-3)
        torch.testing.assert_close(got_h, rh, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("Bsz,S,H,hp,N,chunk,variant", [
    (8, 128, 6, 64, 32, 64, "parallel"),  # the cascade's shape
    (2, 200, 2, 64, 16, 100, "whole"),    # a chunk "parallel" would take
])
def test_ssd_forced_variant_matches_plain(cuda, Bsz, S, H, hp, N, chunk,
                                          variant):
    """Each variant forced onto a shape the chooser gives the other one;
    a variant the shape does not allow raises."""
    gen = torch.Generator().manual_seed(7)
    x = _randn(gen, Bsz, S, H, hp)
    dt = torch.nn.functional.softplus(_randn(gen, Bsz, S, H) - 2.0)
    adt = -torch.arange(1, H + 1, device="cuda").float() * dt
    B, C = _randn(gen, Bsz, S, N), _randn(gen, Bsz, S, N)
    v0 = ssd_scan_cuda.launches_by_variant[variant]
    y, h = ssd_scan_cuda(x, adt, dt, B, C, chunk=chunk, return_state=True,
                         variant=variant)
    torch.cuda.synchronize()
    assert ssd_scan_cuda.launches_by_variant[variant] == v0 + 1
    ry, rh = ssd_scan_chunked_ref(x, adt, dt, B, C, chunk, return_state=True)
    torch.testing.assert_close(y, ry, atol=1e-3, rtol=1e-3)
    torch.testing.assert_close(h, rh, atol=1e-3, rtol=1e-3)
    # head dim 128: beyond "parallel"'s 64
    with pytest.raises(ValueError, match="cannot take"):
        ssd_scan_cuda(torch.cat([x, x], -1), adt, dt, B, C, chunk=chunk,
                      variant="parallel")


@pytest.mark.parametrize("Bsz,S,H,hp,N,chunk,init", [
    (2, 2048, 32, 64, 128, 256, False),   # mamba2-370m's layer
    (2, 2048, 32, 64, 128, 256, True),
    (1, 200, 3, 30, 20, 100, True),       # ragged chunk, hp and state
])
def test_ssd_passes_match_plain_passes(cuda, Bsz, S, H, hp, N, chunk, init):
    """Each pass of "parallel" alone against its plain twin (``ref.py``),
    fed the twins' outputs of the passes before it; no pass counts as a
    launch of the op."""
    from repro_torch.kernels.ssd_scan.kernel import (ssd_passes_cuda,
                                                     ssd_scratch)
    from repro_torch.kernels.ssd_scan.ref import (
        ssd_cb_ref, ssd_chunk_scan_ref, ssd_chunk_state_ref,
        ssd_state_pass_ref)
    x, adt, dt, B, C, h0 = _ssd_inputs(9, Bsz, S, H, hp, N, model_a=True)
    h0 = h0 if init else None
    L = chunk
    cb, (st, cum) = ssd_cb_ref(B, C, L), ssd_chunk_state_ref(x, adt, dt, B,
                                                             L)
    ent, hf = ssd_state_pass_ref(st, cum, h0)
    y = ssd_chunk_scan_ref(x, dt, C, cb, cum, ent, L)
    n0 = ssd_scan_cuda.launches

    def run(passes, **kw):
        s = ssd_scratch(Bsz, S, H, hp, N, L, "cuda")
        s["cb"].zero_()
        s["cb"][..., :L, :L] = cb
        s["cum"][..., :L] = cum
        s["cum"][..., L:] = cum[..., -1:]
        s["st"].copy_(ent if passes == ["chunk_scan"] else st)
        ssd_passes_cuda(x, adt, dt, B, C, chunk=L, passes=passes,
                        scratch=s, init_state=h0, **kw)
        torch.cuda.synchronize()
        return s

    tol = dict(atol=1e-3, rtol=1e-3)
    s = ssd_scratch(Bsz, S, H, hp, N, L, "cuda")
    ssd_passes_cuda(x, adt, dt, B, C, chunk=L, passes=["cb"], scratch=s)
    torch.cuda.synchronize()
    torch.testing.assert_close(s["cb"][..., :L, :L].tril(), cb, **tol)
    s = run(["chunk_state"])
    torch.testing.assert_close(s["cum"][..., :L].float(), cum, **tol)
    torch.testing.assert_close(s["st"], st, **tol)
    hout = torch.empty_like(hf)
    s = run(["state_pass"], h_final=hout)
    torch.testing.assert_close(s["st"], ent, **tol)
    torch.testing.assert_close(hout, hf, **tol)
    yk = torch.empty_like(x, memory_format=torch.contiguous_format)
    run(["chunk_scan"], y=yk)
    torch.testing.assert_close(yk, y, **tol)
    assert ssd_scan_cuda.launches == n0


def test_ssd_whole_kernel_returns_its_state(cuda):
    """The cascade's kernel ("whole", chunk 64) with both state pointers:
    y unchanged bit for bit, the state against the twin."""
    gen = torch.Generator().manual_seed(6)
    Bsz, S, H, hp, N = 8, 128, 6, 64, 32
    x = _randn(gen, Bsz, S, H, hp)
    dt = torch.nn.functional.softplus(_randn(gen, Bsz, S, H) - 2.0)
    adt = -torch.arange(1, H + 1, device="cuda").float() * dt
    B, C = _randn(gen, Bsz, S, N), _randn(gen, Bsz, S, N)
    h0 = 0.5 * _randn(gen, Bsz, H, hp, N)
    v0 = ssd_scan_cuda.launches_by_variant["whole"]
    y = ssd_scan(x, adt, dt, B, C, chunk=64)
    y2, h = ssd_scan(x, adt, dt, B, C, chunk=64, return_state=True)
    y3, h3 = ssd_scan(x, adt, dt, B, C, chunk=64, init_state=h0,
                      return_state=True)
    torch.cuda.synchronize()
    assert ssd_scan_cuda.launches_by_variant["whole"] == v0 + 3
    assert torch.equal(y, y2)
    for init, got_y, got_h in ((None, y2, h), (h0, y3, h3)):
        ry, rh = ssd_scan_chunked_ref(x, adt, dt, B, C, 64,
                                      init_state=init, return_state=True)
        torch.testing.assert_close(got_y, ry, atol=1e-3, rtol=1e-3)
        torch.testing.assert_close(got_h, rh, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("E,C,D,F,dtype", [
    (8, 4, 512, 1024, torch.bfloat16),     # decode tile (C <= 8)
    (4, 64, 256, 512, torch.float32),      # tests/test_kernels.py shapes
    (8, 32, 128, 128, torch.float32),
    (2, 128, 512, 256, torch.float32),
    (3, 130, 100, 257, torch.bfloat16),    # ragged C, D, F
    (2, 5, 33, 9, torch.float32),
    (1, 1, 1, 1, torch.float32),
])
def test_gmm_kernel_matches_plain(cuda, E, C, D, F, dtype):
    gen = torch.Generator().manual_seed(3)
    x = _randn(gen, E, C, D, dtype=dtype)
    w = _randn(gen, E, D, F, dtype=dtype)
    n0 = moe_gmm_cuda.launches
    out = moe_gmm(x, w)
    torch.cuda.synchronize()
    assert moe_gmm_cuda.launches == n0 + 1
    ref = gmm_ref(x, w)
    assert out.dtype == ref.dtype and out.shape == (E, C, F)
    tol = (1e-2 if dtype == torch.bfloat16 else 1e-5) * \
        float(ref.float().abs().max())
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)
    # strided views read through their strides
    xt = _randn(gen, E, D, C, dtype=dtype).transpose(1, 2)
    wt = _randn(gen, E, F, D, dtype=dtype).transpose(1, 2)
    ref = gmm_ref(xt, wt)
    tol = (1e-2 if dtype == torch.bfloat16 else 1e-5) * \
        float(ref.float().abs().max())
    torch.testing.assert_close(moe_gmm(xt, wt).float(), ref.float(),
                               atol=tol, rtol=0)


def _variant_delta(launcher, before):
    """The variants launched since ``before`` (a copy of the counts)."""
    return {v: n - before[v]
            for v, n in launcher.launches_by_variant.items()}


@pytest.mark.parametrize("E,C,D,F,variant", [
    (2, 640, 1024, 2048, "tc"),       # zoo-like prefill tile
    (3, 130, 1000, 1040, "tc"),       # ragged, TMA-readable
    (2, 5, 1000, 1040, "tc"),         # ragged decode tile
    (2, 9, 512, 1024, "tc"),          # first C on the prefill tile
    (8, 1, 6144, 1024, "tc"),         # decode C = 1, 4, 8
    (8, 4, 2048, 1024, "tc"),
    (2, 8, 16384, 768, "tc"),         # decode, a long D in one block
    (3, 130, 1000, 1031, "simt"),     # F row not a multiple of 16 bytes
    (2, 5, 777, 1029, "simt"),
])
def test_gmm_variants_match_plain(cuda, E, C, D, F, variant):
    """bf16 on both variants of ``moe_gmm``: the tc tiles (prefill C > 8,
    decode C <= 8) and the rows TMA cannot read, each at 1e-2 of the
    twin's largest magnitude."""
    from repro_torch.kernels.moe_gmm.kernel import select_variant
    gen = torch.Generator().manual_seed(E * C + D + F)
    x = _randn(gen, E, C, D, dtype=torch.bfloat16)
    w = _randn(gen, E, D, F, dtype=torch.bfloat16)
    assert select_variant(x, w) == variant
    before = dict(moe_gmm_cuda.launches_by_variant)
    out = moe_gmm(x, w)
    torch.cuda.synchronize()
    assert _variant_delta(moe_gmm_cuda, before) == {
        "tc": int(variant == "tc"), "simt": int(variant == "simt")}
    ref = gmm_ref(x, w)
    tol = 1e-2 * float(ref.float().abs().max())
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)


@pytest.mark.parametrize("C", [130, 5])
def test_gmm_odd_f_slice_takes_tc(cuda, C):
    """w = a slice of F 1029 out of F 1040: rows of 2080 bytes that TMA
    reads, and an odd F whose last column (and odd rows, whose pairs are
    not 4-byte aligned) the tc epilogue writes one element at a time —
    on both tiles, at 1e-2 of the twin's largest magnitude."""
    from repro_torch.kernels.moe_gmm.kernel import select_variant
    gen = torch.Generator().manual_seed(C)
    x = _randn(gen, 3, C, 1000, dtype=torch.bfloat16)
    w = _randn(gen, 3, 1000, 1040, dtype=torch.bfloat16)[..., :1029]
    assert select_variant(x, w) == "tc"
    before = dict(moe_gmm_cuda.launches_by_variant)
    out = moe_gmm(x, w)
    torch.cuda.synchronize()
    assert _variant_delta(moe_gmm_cuda, before) == {"tc": 1, "simt": 0}
    ref = gmm_ref(x, w)
    tol = 1e-2 * float(ref.float().abs().max())
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)


def test_gmm_transposed_x_takes_simt(cuda):
    """A transposed x (D not contiguous) cannot be read by TMA: the scalar
    variant serves it, and right."""
    from repro_torch.kernels.moe_gmm.kernel import select_variant
    gen = torch.Generator().manual_seed(11)
    x = _randn(gen, 2, 1024, 64, dtype=torch.bfloat16).transpose(1, 2)
    w = _randn(gen, 2, 1024, 512, dtype=torch.bfloat16)
    assert select_variant(x, w) == "simt"
    before = dict(moe_gmm_cuda.launches_by_variant)
    out = moe_gmm(x, w)
    torch.cuda.synchronize()
    assert _variant_delta(moe_gmm_cuda, before) == {"tc": 0, "simt": 1}
    ref = gmm_ref(x, w)
    tol = 1e-2 * float(ref.float().abs().max())
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)


@pytest.mark.parametrize("B,S,H,K,hd,causal,window", [
    (2, 1024, 8, 2, 128, True, None),     # zoo-like, GQA 4
    (1, 1000, 4, 2, 128, True, None),     # ragged S
    (1, 2048, 2, 1, 128, True, 1024),     # window inside S
    (2, 512, 12, 2, 128, False, None),    # non-causal, GQA 6
    (1, 2048, 4, 4, 64, True, None),      # hd 64
    (2, 300, 6, 1, 64, True, 100),        # hd 64, ragged, window
    # non-causal, S = (Sq, Skv): the CROSS models' shapes
    (2, (2048, 1600), 32, 8, 128, False, None),  # vision cross, ragged tail
    (2, (256, 2048), 16, 16, 64, False, None),   # seamless cross prefill
    (2, 2048, 16, 16, 64, False, None),          # seamless encoder
])
def test_flash_tc_variant_matches_plain(cuda, B, S, H, K, hd, causal,
                                        window):
    """bf16 flash attention on the tensor cores at 1e-2 of the twin's
    largest magnitude (p is rounded to bf16 before the PV product).  A
    pair S is (Sq, Skv)."""
    from repro_torch.kernels.flash_attention.kernel import select_variant
    Sq, Skv = S if isinstance(S, tuple) else (S, S)
    gen = torch.Generator().manual_seed(Sq + Skv + H + hd)
    q = _randn(gen, B, Sq, H, hd, dtype=torch.bfloat16)
    k = _randn(gen, B, Skv, K, hd, dtype=torch.bfloat16)
    v = _randn(gen, B, Skv, K, hd, dtype=torch.bfloat16)
    assert select_variant(q, k, v) == "tc"
    before = dict(flash_attention_cuda.launches_by_variant)
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert _variant_delta(flash_attention_cuda, before) == {
        "tc": 1, "simt": 0, "tiled": 0}
    ref = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal,
                        window=window).transpose(1, 2)
    tol = 1e-2 * float(ref.float().abs().max())
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)


@pytest.mark.parametrize("B,Sq,Skv,H,K,causal,window", [
    (2, 2048, 2048, 32, 8, True, None),   # Danube's GQA 4 (window >= S)
    (1, 2048, 2048, 8, 2, True, 1000),    # a window below S
    (2, 1000, 1000, 8, 2, True, None),    # ragged S
    (1, 300, 700, 8, 4, False, None),     # non-causal, Sq != Skv
    (2, 2048, 1600, 32, 8, False, None),  # non-causal, ragged last kv tile
])
def test_flash_tc_head_dim_120_matches_plain(cuda, B, Sq, Skv, H, K, causal,
                                             window):
    """bf16 at h2o-danube-3-4b's head dim 120 takes "tc" (the 128-wide
    instance; TMA zero-fills columns 120..127) and agrees with the twin
    at the bf16 tolerance, 2e-2."""
    from repro_torch.kernels.flash_attention.kernel import select_variant
    gen = torch.Generator().manual_seed(Sq + Skv + H)
    q = _randn(gen, B, Sq, H, 120, dtype=torch.bfloat16)
    k = _randn(gen, B, Skv, K, 120, dtype=torch.bfloat16)
    v = _randn(gen, B, Skv, K, 120, dtype=torch.bfloat16)
    assert select_variant(q, k, v) == "tc"
    before = dict(flash_attention_cuda.launches_by_variant)
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert _variant_delta(flash_attention_cuda, before) == {
        "tc": 1, "simt": 0, "tiled": 0}
    ref = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal,
                        window=window).transpose(1, 2)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("case", ["fp32", "hd 96", "strided q"])
def test_flash_simt_variant_cases(cuda, case):
    """fp32 whose rows cp.async cannot copy (a row stride of 65
    elements), a bf16 head dim outside ``TC_HEAD_DIMS`` and a q whose
    head-dim stride is not 1 take the scalar variant, and agree with the
    twin."""
    from repro_torch.kernels.flash_attention.kernel import select_variant
    gen = torch.Generator().manual_seed(12)
    dtype = torch.float32 if case == "fp32" else torch.bfloat16
    hd = 96 if case == "hd 96" else 64
    q = _randn(gen, 2, 256, 4, hd, dtype=dtype)
    if case == "strided q":
        q = _randn(gen, 2, 256, hd, 4, dtype=dtype).transpose(2, 3)
    if case == "fp32":
        q = _randn(gen, 2, 256, 4, hd + 1, dtype=dtype)[..., :hd]
    k = _randn(gen, 2, 256, 2, hd, dtype=dtype)
    v = _randn(gen, 2, 256, 2, hd, dtype=dtype)
    assert select_variant(q, k, v) == "simt"
    before = dict(flash_attention_cuda.launches_by_variant)
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert _variant_delta(flash_attention_cuda, before) == {
        "tc": 0, "simt": 1, "tiled": 0}
    ref = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2)).transpose(1, 2)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("B,S,H,K,hd,causal,window", [
    (64, 128, 4, 4, 32, True, None),    # the cascade's buckets
    (32, 128, 4, 4, 32, True, None),
    (16, 128, 4, 4, 32, True, None),
    (8, 128, 4, 4, 32, True, None),
    (3, 32, 2, 2, 16, True, None),      # TINY_TF_CI
    (2, 100, 4, 4, 32, True, None),     # ragged S
    (4, 128, 4, 4, 32, True, 48),       # windows inside a tile
    (4, 128, 4, 4, 32, True, 16),
    (4, 128, 4, 4, 32, False, None),    # non-causal
    (4, 128, 8, 2, 32, True, None),     # GQA 4
    (2, 200, 4, 2, 64, True, 72),       # hd 64, ragged, window
    (2, 130, 4, 4, 128, False, None),   # hd 128, ragged
    # non-causal, S = (Sq, Skv): the CROSS smoke models' cross prefill
    (2, (64, 16), 4, 2, 32, False, None),   # vision: Skv below one tile
    (2, (16, 64), 4, 4, 32, False, None),
])
def test_flash_tiled_variant_matches_plain(cuda, B, S, H, K, hd, causal,
                                           window):
    """fp32 on the register-tiled variant at 2e-5 of the twin (IEEE fp32
    FMAs: only the order of summation differs).  A pair S is (Sq,
    Skv)."""
    from repro_torch.kernels.flash_attention.kernel import select_variant
    Sq, Skv = S if isinstance(S, tuple) else (S, S)
    gen = torch.Generator().manual_seed(B * Sq + Skv + H + hd)
    q = _randn(gen, B, Sq, H, hd)
    k = _randn(gen, B, Skv, K, hd)
    v = _randn(gen, B, Skv, K, hd)
    assert select_variant(q, k, v) == "tiled"
    before = dict(flash_attention_cuda.launches_by_variant)
    n0 = flash_attention_cuda.launches
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == n0 + 1
    assert _variant_delta(flash_attention_cuda, before) == {
        "tc": 0, "simt": 0, "tiled": 1}
    ref = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal,
                        window=window).transpose(1, 2)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("B", [64, 32, 16, 8])
def test_flash_forced_tiled_matches_forced_simt(cuda, B):
    """One input at each of the cascade's buckets through both fp32
    variants, each forced: they agree within 2e-5."""
    gen = torch.Generator().manual_seed(B)
    q, k, v = (_randn(gen, B, 128, 4, 32) for _ in range(3))
    before = dict(flash_attention_cuda.launches_by_variant)
    a = flash_attention_cuda(q, k, v, variant="tiled")
    b = flash_attention_cuda(q, k, v, variant="simt")
    torch.cuda.synchronize()
    assert _variant_delta(flash_attention_cuda, before) == {
        "tc": 0, "simt": 1, "tiled": 1}
    torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-5)


def test_expert_ffn_kernel_matches_plain(cuda):
    """The model's expert FFN (``models/moe.py`` ``_expert_ffn``) on the
    card (three kernel launches) vs on the CPU (the twins)."""
    from repro_torch.models.moe import _expert_ffn
    gen = torch.Generator().manual_seed(4)
    E, C, D, F = 4, 64, 128, 256
    x = _randn(gen, E, C, D)
    p = {"w_in": 0.05 * _randn(gen, E, D, F),
         "w_gate": 0.05 * _randn(gen, E, D, F),
         "w_out": 0.05 * _randn(gen, E, F, D)}
    n0 = moe_gmm_cuda.launches
    out = _expert_ffn(x, p, None)
    torch.cuda.synchronize()
    assert moe_gmm_cuda.launches == n0 + 3
    ref = _expert_ffn(x.cpu(), {n: t.cpu() for n, t in p.items()}, None)
    torch.testing.assert_close(out.cpu(), ref, atol=1e-5, rtol=1e-5)


def test_zoo_smoke_model_serves_like_the_cpu(cuda):
    """mixtral-8x22b-smoke in fp32: prefill and 3 greedy decode steps on
    the card (kernels) and the CPU (twins) from the same weights."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as tfm
    from repro_torch.tree import tree_map
    cfg = dataclasses.replace(get_smoke_config("mixtral-8x22b"),
                              dtype="float32")
    p_cpu = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    p_gpu = tree_map(lambda t: t.cuda(), p_cpu)
    toks = torch.randint(0, cfg.vocab, (2, 64),
                         generator=torch.Generator().manual_seed(1))
    n0 = moe_gmm_cuda.launches
    with torch.no_grad():
        lc, cc = tfm.prefill(p_cpu, {"tokens": toks}, cfg)
        lg, cg = tfm.prefill(p_gpu, {"tokens": toks.cuda()}, cfg)
        torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=1e-4)
        for step in range(3):
            nxt = lc.argmax(-1)[:, None]
            lc, cc = tfm.decode_step(p_cpu, cc, nxt, 64 + step, cfg)
            lg, cg = tfm.decode_step(p_gpu, cg, nxt.cuda(), 64 + step, cfg)
            torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=1e-4)
    assert moe_gmm_cuda.launches == n0 + 3 * cfg.n_layers * 4


@pytest.mark.parametrize("arch", [
    "jamba-1.5-large-398b", "mamba2-370m", "internlm2-1.8b", "qwen3-8b",
    "h2o-danube-3-4b", "llama3-405b", "dbrx-132b"])
def test_zoo_arch_smoke_serves_like_the_cpu(cuda, arch):
    """Each decoder-only architecture's smoke config in fp32: prefill
    (S = 45: a ragged MAMBA chunk) and 3 greedy decode steps on the card
    (kernels) and the CPU (twins) from the same weights."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as tfm
    from repro_torch.tree import tree_map
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    p_cpu = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    p_gpu = tree_map(lambda t: t.cuda(), p_cpu)
    toks = torch.randint(0, cfg.vocab, (2, 45),
                         generator=torch.Generator().manual_seed(1))
    n0 = ssd_scan_cuda.launches
    with torch.no_grad():
        lc, cc = tfm.prefill(p_cpu, {"tokens": toks}, cfg)
        lg, cg = tfm.prefill(p_gpu, {"tokens": toks.cuda()}, cfg)
        torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=1e-4)
        for step in range(3):
            nxt = lc.argmax(-1)[:, None]
            lc, cc = tfm.decode_step(p_cpu, cc, nxt, 45 + step, cfg)
            lg, cg = tfm.decode_step(p_gpu, cg, nxt.cuda(), 45 + step, cfg)
            torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=1e-4)
    n_mamba = cfg.n_periods * cfg.period.count("mamba")
    assert ssd_scan_cuda.launches == n0 + n_mamba


@pytest.mark.parametrize("arch", ["seamless-m4t-medium",
                                  "llama-3.2-vision-11b"])
def test_zoo_cross_smoke_serves_like_the_cpu(cuda, arch):
    """Each CROSS architecture's smoke config in fp32, with its memory
    (seamless: 80 frames; the vision model: 16 image embeddings): prefill
    and 3 greedy decode steps on the card (kernels) and the CPU (twins)
    from the same weights; two flash calls a CROSS layer and one an
    encoder or ATTN layer in the prefill, decode attention alike a
    step."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as tfm
    from repro_torch.tree import tree_map
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    p_cpu = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    p_gpu = tree_map(lambda t: t.cuda(), p_cpu)
    gen = torch.Generator().manual_seed(1)
    b_cpu = {"tokens": torch.randint(0, cfg.vocab, (2, 64), generator=gen)}
    if cfg.encoder is not None:
        b_cpu["frames"] = torch.randn((2, 80, cfg.d_model), generator=gen)
    else:
        b_cpu["image_embeds"] = torch.randn(
            (2, cfg.n_image_tokens, cfg.d_model), generator=gen)
    b_gpu = {k: t.cuda() for k, t in b_cpu.items()}
    n_cross = cfg.n_periods * cfg.period.count("cross")
    n_attn = cfg.n_layers - n_cross
    n_enc = cfg.encoder.n_layers if cfg.encoder is not None else 0
    f0, d0 = flash_attention_cuda.launches, decode_attention_cuda.launches
    with torch.no_grad():
        lc, cc = tfm.prefill(p_cpu, b_cpu, cfg)
        lg, cg = tfm.prefill(p_gpu, b_gpu, cfg)
        torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=1e-4)
        assert flash_attention_cuda.launches == f0 + n_attn + 2 * n_cross \
            + n_enc
        for step in range(3):
            nxt = lc.argmax(-1)[:, None]
            lc, cc = tfm.decode_step(p_cpu, cc, nxt, 64 + step, cfg)
            lg, cg = tfm.decode_step(p_gpu, cg, nxt.cuda(), 64 + step, cfg)
            torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=1e-4)
    assert decode_attention_cuda.launches == d0 + 3 * (n_attn + 2 * n_cross)


def test_cpu_tensors_never_reach_the_kernels(cuda):
    counters = (flash_attention_cuda, decode_attention_cuda, ssd_scan_cuda,
                moe_gmm_cuda)
    before = [c.launches for c in counters]
    q = torch.randn((1, 16, 2, 8))
    flash_attention(q, q, q)
    decode_attention(q[:, :1], q, q, torch.arange(16, dtype=torch.int32))
    a = torch.randn((1, 16, 2)) * 0.1
    b = torch.randn((1, 16, 4))
    ssd_scan(q, -a.abs(), a.abs(), b, b, chunk=8)
    moe_gmm(torch.randn((2, 4, 8)), torch.randn((2, 8, 16)))
    assert [c.launches for c in counters] == before


def test_cuda_engine_routes_like_the_cpu_engine(cuda):
    """The CI ladder on a short stream: identical routing on the card and
    on the CPU, from the same seeded initial weights."""
    from repro_torch.core import (BatchedCascadeEngine, SimulatedExpert,
                                  kernel_cascade_config)
    from repro_torch.data import make_stream
    from repro_torch.models.kernel_students import TINY_SSM_CI, TINY_TF_CI
    stream = make_stream("hatespeech", seed=0, n_samples=48)
    cfg = kernel_cascade_config(2, mu=3e-6, tf_flash_spec=TINY_TF_CI,
                                ssm_spec=TINY_SSM_CI)
    runs = {}
    for dev in ("cpu", "cuda"):
        eng = BatchedCascadeEngine(cfg, SimulatedExpert(stream),
                                   n_streams=8, device=dev)
        m = eng.run(stream)
        runs[dev] = (m["predictions"], np.concatenate(
            [np.asarray(x) for x in eng.history["level"]]),
            [lvl.forwards for lvl in eng.levels])
    assert np.array_equal(runs["cpu"][0], runs["cuda"][0])
    assert np.array_equal(runs["cpu"][1], runs["cuda"][1])
    assert runs["cpu"][2] == runs["cuda"][2]


def _default_ladder_run(dev, stream, **cfg_kw):
    from dataclasses import replace
    from repro_torch.core import (BatchedCascadeEngine, SimulatedExpert,
                                  default_cascade_config)
    cfg = replace(default_cascade_config(2, mu=3e-6), **cfg_kw)
    eng = BatchedCascadeEngine(cfg, SimulatedExpert(stream), n_streams=8,
                               device=dev)
    m = eng.run(stream)
    return eng, m


def test_default_ladder_routes_like_the_cpu(cuda):
    """The paper's lr -> tinytf ladder at full width on a short stream:
    identical routing on the card and on the CPU, from the same seeded
    initial weights."""
    from repro_torch.data import make_stream
    stream = make_stream("hatespeech", seed=0, n_samples=48)
    runs = {}
    for dev in ("cpu", "cuda"):
        eng, m = _default_ladder_run(dev, stream)
        runs[dev] = (m["predictions"], np.concatenate(
            [np.asarray(x) for x in eng.history["level"]]),
            [lvl.forwards for lvl in eng.levels])
    assert np.array_equal(runs["cpu"][0], runs["cuda"][0])
    assert np.array_equal(runs["cpu"][1], runs["cuda"][1])
    assert runs["cpu"][2] == runs["cuda"][2]


def test_hard_budget_holds_on_the_card(cuda):
    from repro_torch.data import make_stream
    stream = make_stream("imdb", seed=0, n_samples=256)
    for budget in (5, 21):
        eng, m = _default_ladder_run("cuda", stream, hard_budget=budget)
        assert m["expert_calls"] == eng.expert_calls_total == budget
        # overflow lanes answered from the last student's fallback
        assert eng.levels[-1].forwards_by_batch.get(1, 0) >= 1


def test_model_expert_labels_on_the_card_equal_the_cpus(cuda):
    from repro_torch.core import ModelExpert, train_model_expert
    from repro_torch.data import make_stream
    from repro_torch.tree import tree_map
    stream = make_stream("imdb", seed=0, n_samples=256)
    cpu = train_model_expert(stream, 2, d_model=64, n_layers=2, epochs=1,
                             seed=1, device="cpu")
    gpu = ModelExpert(params=tree_map(lambda t: t.cuda(), cpu.params),
                      spec=cpu.spec, workers=2, device="cuda")
    idxs = list(range(len(stream)))
    want = cpu.label_batch(idxs, stream.docs)
    assert np.array_equal(gpu.label_batch(idxs, stream.docs), want)
    assert np.array_equal(gpu.poll(gpu.submit_many(idxs, stream.docs)),
                          want)
    gpu.close()


# ---------------------------------------------------------------------------
# the engine matrix on the card
# ---------------------------------------------------------------------------
def _ci_ladder():
    from repro_torch.core import kernel_cascade_config
    from repro_torch.models.kernel_students import TINY_SSM_CI, TINY_TF_CI
    return kernel_cascade_config(2, mu=3e-6, tf_flash_spec=TINY_TF_CI,
                                 ssm_spec=TINY_SSM_CI)


@pytest.mark.parametrize("max_delay", [0, 2])
def test_pipelined_depth2_matches_depth0_on_the_card(cuda, max_delay):
    """Depth 2 against depth 0 on CUDA: identical routing and bitwise
    learned state (route passes and commits share one stream)."""
    from repro_torch.core import (STATE_ATTRS, BatchedCascadeEngine,
                                  SimulatedExpert)
    from repro_torch.data import make_stream
    from repro_torch.tree import tree_leaves
    stream = make_stream("hatespeech", seed=0, n_samples=128)
    runs = {}
    for depth in (0, 2):
        eng = BatchedCascadeEngine(_ci_ladder(), SimulatedExpert(stream),
                                   n_streams=8, max_delay=max_delay,
                                   pipeline_depth=depth, device=cuda)
        runs[depth] = (eng, eng.run(stream))
    (e0, m0), (e2, m2) = runs[0], runs[2]
    assert np.array_equal(m0["predictions"], m2["predictions"])
    assert m0["expert_calls"] == m2["expert_calls"]
    for key in ("level", "expert_called"):
        assert np.array_equal(np.concatenate(e0.history[key]),
                              np.concatenate(e2.history[key]))
    st = e2.pipeline_stats
    assert st["refetches"] + st["update_fences"] > 0
    for a, b in zip(e0.levels, e2.levels):
        for attr in STATE_ATTRS:
            for x, y in zip(tree_leaves(getattr(a, attr)),
                            tree_leaves(getattr(b, attr))):
                assert torch.equal(x, y), attr


def test_stage_b_waits_for_the_level0_copy(cuda):
    """~50 ms of device work queued ahead of the copies: a read that did
    not wait for the copy's event would see a stale pinned buffer."""
    from dataclasses import replace
    from repro_torch.core import BatchedCascadeEngine, SimulatedExpert
    from repro_torch.data import make_stream
    from repro_torch.transfer import HostPrefetch, PinnedStaging
    sleep_cycles = 100_000_000            # ~50 ms at the H100's clock
    x = torch.arange(4096, dtype=torch.float32, device=cuda)
    stale = HostPrefetch([x * 0.0])       # leaves zeros in a pinned block
    stale.result()
    del stale
    torch.cuda._sleep(sleep_cycles)
    got = HostPrefetch([x * 2.0]).result()[0].copy()
    assert np.array_equal(got, np.arange(4096, dtype=np.float32) * 2.0)
    # staged uploads: a buffer whose copy is still queued is not refilled
    staging = PinnedStaging(cuda)
    torch.cuda._sleep(sleep_cycles)
    a = staging.upload(np.full(8, 1.0, np.float32))
    b = staging.upload(np.full(8, 2.0, np.float32))
    assert staging.buffers() == 2
    assert a.cpu().tolist() == [1.0] * 8 and b.cpu().tolist() == [2.0] * 8
    # the engine's stage B reads the level-0 outputs its dispatch
    # produced (hard budget 0: no lane jumps, level 0 serves every lane)
    stream = make_stream("hatespeech", seed=0, n_samples=8)
    idxs, docs = list(range(8)), stream.docs[:8]
    cfg = replace(_ci_ladder(), hard_budget=0)
    eng = BatchedCascadeEngine(cfg, SimulatedExpert(stream), n_streams=8,
                               pipeline_depth=1, device=cuda)
    ref = BatchedCascadeEngine(cfg, SimulatedExpert(stream), n_streams=8,
                               device=cuda)
    want = ref.process_tick(idxs, docs)
    torch.cuda._sleep(sleep_cycles)
    assert eng.submit_tick(idxs, docs) == []
    handles = eng._ring[0].handles
    probs, dprob = (h.copy() for h in handles.result())
    assert np.array_equal(probs, handles.tensors[0].cpu().numpy())
    assert np.array_equal(dprob, handles.tensors[1].cpu().numpy())
    out = eng.resolve_tick()
    assert np.array_equal(out["predictions"], want["predictions"])
    assert np.array_equal(out["levels"], want["levels"])


def test_pool_workers_run_on_their_own_streams(cuda):
    from repro_torch.core import ModelExpert
    from repro_torch.data import make_stream
    from repro_torch.models.students import TinyTFSpec, tinytf_init
    spec = TinyTFSpec(vocab=256, max_len=32, d_model=32, n_heads=2,
                      n_layers=1, d_ff=64, n_classes=2)
    params = tinytf_init(torch.Generator().manual_seed(0), spec, cuda)
    stream = make_stream("imdb", seed=0, n_samples=64)
    idxs, docs = list(range(64)), stream.docs
    ex = ModelExpert(params=params, spec=spec, workers=4, device=cuda)
    try:
        want = ex.label_batch(idxs, docs)
        assert np.array_equal(ex.poll(ex.submit_many(idxs, docs)), want)
        streams = ex.worker_streams()
        assert 1 <= len(streams) <= 4
        assert all(s != torch.cuda.default_stream() for s in streams)
        assert len({s.cuda_stream for s in streams}) == len(streams)
    finally:
        ex.close()


# ---------------------------------------------------------------------------
# occupancy ticks and live-state checkpoints on the card
# ---------------------------------------------------------------------------
def _kernel_counts():
    return (flash_attention_cuda.launches, decode_attention_cuda.launches,
            ssd_scan_cuda.launches)


def test_empty_and_one_lane_ticks_on_the_kernel_ladder(cuda):
    """An empty tick launches no kernel and raises no CUDA error; a
    1-lane tick pads every level it reaches to bucket 8, and each kernel
    launches as often as the layer forwards counted."""
    from repro_torch.core import BatchedCascadeEngine, SimulatedExpert
    from repro_torch.data import make_stream
    stream = make_stream("imdb", seed=0, n_samples=16)
    eng = BatchedCascadeEngine(_ci_ladder(), SimulatedExpert(stream),
                               n_streams=16, max_delay=1, device=cuda)
    eng.process_tick([0, 1], stream.docs[:2], lanes=[3, 9])
    before = _kernel_counts()
    fw = [lvl.forwards for lvl in eng.levels]
    out = eng.process_tick([], [])              # commits tick 1, no route
    torch.cuda.synchronize()
    assert _kernel_counts() == before and out["lanes"].shape == (0,)
    assert [lvl.forwards for lvl in eng.levels] == fw
    for lvl in eng.levels:
        lvl.forwards, lvl.forwards_by_batch = 0, {}
    before = _kernel_counts()
    eng.process_tick([2], stream.docs[2:3], lanes=[5], stream_ids=[7],
                     stream_ticks=[1])
    torch.cuda.synchronize()
    tf, ssm = eng.levels[1], eng.levels[2]
    assert set(tf.forwards_by_batch) | set(ssm.forwards_by_batch) <= {8}
    got = [a - b for a, b in zip(_kernel_counts(), before)]
    assert got == [tf.sspec.n_layers * tf.forwards, tf.forwards,
                   ssm.sspec.n_layers * ssm.forwards]
    assert eng.items_seen[5] == 1 and eng.items_seen.sum() == 3


def _ckpt_engine(dev, stream, **opts):
    from repro_torch.core import BatchedCascadeEngine, SimulatedExpert
    return BatchedCascadeEngine(
        _ci_ladder(), SimulatedExpert(stream, workers=2, latency=1),
        n_streams=8, device=dev, **opts)


def _serve_ticks(eng, stream, lo, hi):
    S = eng.n_streams
    for t in range(lo, hi):
        idxs = list(range(t * S, (t + 1) * S))
        eng.process_tick(idxs, [stream.docs[i] for i in idxs])


def test_engine_resume_is_bitwise_on_the_card(cuda, tmp_path):
    from repro_torch.core import STATE_ATTRS
    from repro_torch.data import make_stream
    from repro_torch.tree import tree_leaves
    stream = make_stream("hatespeech", seed=0, n_samples=128)
    opts = {"max_delay": 2, "per_lane": True}
    full = _ckpt_engine(cuda, stream, **opts)
    m_full = full.run(stream)
    part = _ckpt_engine(cuda, stream, **opts)
    _serve_ticks(part, stream, 0, 7)
    part.save_state(str(tmp_path / "ck"))
    res = _ckpt_engine(cuda, stream, **opts)
    res.restore_state(str(tmp_path / "ck"))
    assert all(t.device.type == "cuda" for t in res._cache_x)
    m_res = res.run(stream)
    assert np.array_equal(m_full["predictions"][56:],
                          m_res["predictions"][56:])
    assert full.commit_log == res.commit_log
    for a, b in zip(full.levels, res.levels):
        for attr in STATE_ATTRS:
            for x, y in zip(tree_leaves(getattr(a, attr)),
                            tree_leaves(getattr(b, attr))):
                assert x.device.type == "cuda" and torch.equal(x, y), attr


def test_card_checkpoint_restores_on_the_cpu(cuda, tmp_path):
    """Saved on the card at tick 7, finished on the card and, from the
    same checkpoint, on the CPU: identical routing."""
    from repro_torch.data import make_stream
    stream = make_stream("hatespeech", seed=0, n_samples=128)
    opts = {"max_delay": 2, "per_lane": True}
    part = _ckpt_engine(cuda, stream, **opts)
    _serve_ticks(part, stream, 0, 7)
    part.save_state(str(tmp_path / "ck"))
    runs = {}
    for dev in ("cuda", "cpu"):
        eng = _ckpt_engine(dev, stream, **opts)
        eng.restore_state(str(tmp_path / "ck"))
        m = eng.run(stream)
        runs[dev] = (m["predictions"][56:], m["expert_calls"],
                     np.concatenate(eng.history["level"]))
    assert np.array_equal(runs["cuda"][0], runs["cpu"][0])
    assert runs["cuda"][1] == runs["cpu"][1]
    assert np.array_equal(runs["cuda"][2], runs["cpu"][2])


# ---------------------------------------------------------------------------
# the runtime sanitizers on the card (chip_smoke.py phase 10 (a), (d), (e)
# at small size)
# ---------------------------------------------------------------------------
@pytest.fixture
def sanitizers():
    from repro_torch.analysis import sanitize as san
    prior = san.active_modes()
    san.disable()
    yield san
    san.disable()
    if prior:
        san.enable(prior)


def _traced_run(san, dev, stream, **opts):
    from repro_torch.core import BatchedCascadeEngine, SimulatedExpert
    eng = BatchedCascadeEngine(_ci_ladder(), SimulatedExpert(stream),
                               n_streams=8, device=dev, **opts)
    with san.determinism_trace():
        eng.run(stream)
    return san.trace_of(eng)


def test_determinism_trace_depth2_equals_depth0_on_the_card(cuda,
                                                            sanitizers):
    from repro_torch.data import make_stream
    stream = make_stream("imdb", seed=0, n_samples=128)
    a = _traced_run(sanitizers, cuda, stream)
    b = _traced_run(sanitizers, cuda, stream, pipeline_depth=2)
    assert len(a) == 16
    d = sanitizers.diff_traces(a, b)
    assert d is None, d.describe()


def test_determinism_trace_on_the_card_equals_the_cpus(cuda, sanitizers):
    """Every field but the state digests (fp32 sums differ in the last
    bits between the card and the CPU), the RNG digests included."""
    from repro_torch.data import make_stream
    stream = make_stream("imdb", seed=0, n_samples=48)
    a, b = (_traced_run(sanitizers, dev, stream) for dev in (cuda, "cpu"))
    strip = [[{k: v for k, v in r.items() if k != "state"}
              for r in tr.ticks] for tr in (a, b)]
    d = sanitizers.diff_traces(*strip)
    assert d is None, d.describe()
    assert [r["rng"] for r in a.ticks] == [r["rng"] for r in b.ticks]


def test_lock_sanitizer_on_the_card_pool(cuda, sanitizers):
    from repro_torch.core import (BatchedCascadeEngine, ExpertTicket,
                                  ModelExpert)
    from repro_torch.data import make_stream
    from repro_torch.models.students import TinyTFSpec, tinytf_init
    stream = make_stream("imdb", seed=0, n_samples=64)
    spec = TinyTFSpec(d_model=32, n_layers=1, d_ff=128, n_classes=2)
    sanitizers.enable({"locks"})
    ex = ModelExpert(params=tinytf_init(torch.Generator().manual_seed(0),
                                        spec, cuda),
                     spec=spec, workers=4, device=cuda)
    eng = BatchedCascadeEngine(_ci_ladder(), ex, n_streams=8, max_delay=2,
                               per_lane=True, device=cuda)
    try:
        eng.run(stream)
        assert ex.worker_streams()
    finally:
        eng.close()
    assert sanitizers.lock_order_violations() == []
    with pytest.raises(sanitizers.LockSanitizerError):
        ExpertTicket(labels=np.array([1]))._shards


# ---------------------------------------------------------------------------
# gradients: the kernels' forwards carry their plain twins' gradients
# ---------------------------------------------------------------------------
def _grad_case(op, size):
    """(op on the card, its twin, the kernel's counter, inputs needing a
    gradient) at a small shape or at the training path's: internlm2-1.8b's
    attention (B 4 x S 2048, 16 / 8 heads of 128, bf16), mixtral-8x22b's
    expert projection (one group of 2048 tokens: capacity 640, d_model
    6144 x d_ff 16384, bf16), mamba2-370m's SSD (B 4 x S 2048, 32 heads
    of 64, state 128, chunk 256)."""
    import functools
    from repro_torch.kernels.flash_attention.ops import _twin as flash_twin
    from repro_torch.kernels.ssd_scan.ops import _twin as ssd_twin
    gen = torch.Generator().manual_seed(7)
    path = size == "path"

    def rnd(*shape, dtype=torch.float32, scale=1.0):
        return (scale * _randn(gen, *shape)).to(dtype).requires_grad_()

    if op == "flash":
        B, S, H, K, hd, dt, win = ((4, 2048, 16, 8, 128, torch.bfloat16,
                                    None) if path else
                                   (2, 48, 4, 2, 32, torch.float32, 20))
        fn = functools.partial(flash_attention, causal=True, window=win)
        twin = functools.partial(flash_twin, causal=True, window=win,
                                 sm_scale=hd ** -0.5)
        return fn, twin, flash_attention_cuda, (
            rnd(B, S, H, hd, dtype=dt), rnd(B, S, K, hd, dtype=dt),
            rnd(B, S, K, hd, dtype=dt))
    if op == "moe_gmm":
        E, C, D, F, dt = ((8, 640, 6144, 16384, torch.bfloat16) if path
                          else (3, 10, 64, 48, torch.float32))
        return moe_gmm, gmm_ref, moe_gmm_cuda, (
            rnd(E, C, D, dtype=dt), rnd(E, D, F, dtype=dt, scale=D ** -0.5))
    Bsz, S, H, hp, N, L = ((4, 2048, 32, 64, 128, 256) if path
                           else (2, 128, 3, 16, 8, 64))
    fn = functools.partial(ssd_scan, chunk=L, return_state=True)
    twin = functools.partial(ssd_twin, chunk=L, return_state=True)
    dt = 0.1 * torch.rand((Bsz, S, H), generator=gen)
    adt = (-dt * torch.arange(1, H + 1)).cuda().requires_grad_()
    ins = (rnd(Bsz, S, H, hp), adt, dt.cuda().requires_grad_(),
           rnd(Bsz, S, N), rnd(Bsz, S, N), rnd(Bsz, H, hp, N, scale=0.1))
    return (lambda x, a, d, b, c, h0: fn(x, a, d, b, c, init_state=h0),
            twin, ssd_scan_cuda, ins)


def _backward(outs, inputs):
    outs = outs if isinstance(outs, tuple) else (outs,)
    gen = torch.Generator().manual_seed(8)
    ups = [_randn(gen, *o.shape).to(o.dtype) for o in outs]
    return torch.autograd.grad(outs, inputs, ups)


@pytest.mark.parametrize("size", ["small", "path"])
@pytest.mark.parametrize("op", ["flash", "moe_gmm", "ssd"])
def test_kernel_op_gradient_is_the_twins(cuda, op, size):
    """A CUDA call that needs a gradient launches the kernel once (its
    output is the kernel's, still on the graph) and its gradient to every
    input (the SSD's through y and the final state) is autograd's through
    the twin on the same inputs, within 1e-6 x max|twin grad| (the same
    operations on the same inputs)."""
    fn, twin, launcher, inputs = _grad_case(op, size)
    n0 = launcher.launches
    out = fn(*inputs)
    torch.cuda.synchronize()
    assert launcher.launches == n0 + 1
    with torch.no_grad():
        plain_out = fn(*inputs)
    first = out[0] if isinstance(out, tuple) else out
    assert first.grad_fn is not None
    assert torch.equal(first, plain_out[0] if isinstance(out, tuple)
                       else plain_out)
    got = _backward(out, inputs)
    torch.cuda.synchronize()
    assert launcher.launches == n0 + 2       # the backward launches none
    want = _backward(twin(*inputs), inputs)
    for g, w, x in zip(got, want, inputs):
        assert g.dtype == x.dtype and g.shape == x.shape
        scale = float(w.float().abs().max())
        assert scale > 0
        torch.testing.assert_close(g.float(), w.float(), rtol=0,
                                   atol=1e-6 * scale)


def test_decode_attention_raises_under_grad(cuda):
    gen = torch.Generator().manual_seed(9)
    q = _randn(gen, 2, 1, 4, 32).requires_grad_()
    kv = _randn(gen, 2, 16, 2, 32)
    pos = torch.arange(16, dtype=torch.int32, device="cuda")
    n0 = decode_attention_cuda.launches
    with pytest.raises(RuntimeError, match="decode_attention has no "
                                           "gradient"):
        decode_attention(q, kv, kv, pos)
    assert decode_attention_cuda.launches == n0
    with torch.no_grad():
        out = decode_attention(q, kv, kv, pos)
    assert out.grad_fn is None and decode_attention_cuda.launches == n0 + 1


@pytest.mark.parametrize("op", ["flash", "moe_gmm", "ssd"])
def test_kernel_op_without_grad_launches_the_kernel_alone(cuda, op):
    """No gradient needed (grad mode off, or detached inputs): one launch
    and the kernel's output, off the graph."""
    fn, _, launcher, inputs = _grad_case(op, "small")
    n0 = launcher.launches
    with torch.no_grad():
        a = fn(*inputs)
    b = fn(*(t.detach() for t in inputs))
    torch.cuda.synchronize()
    assert launcher.launches == n0 + 2
    a, b = (a[0], b[0]) if isinstance(a, tuple) else (a, b)
    assert a.grad_fn is None and b.grad_fn is None and torch.equal(a, b)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mixtral-8x22b",
                                  "mamba2-370m"])
def test_zoo_smoke_train_step_on_the_card_like_the_cpu(cuda, arch):
    """One ``train_loss`` step of the smoke config in fp32, remat on: the
    card (kernel forwards, twin backwards) against the CPU (twins) from
    the same weights: loss within 1e-5 relative, every gradient leaf
    within 1e-4 x max|CPU leaf| (fp32 in another order), and the kernels
    launched twice a layer (forward and recompute)."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import lm_batches
    from repro_torch.launch.train import loss_and_grads
    from repro_torch.models import transformer as tfm
    from repro_torch.tree import tree_leaves, tree_map
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    p_cpu = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    p_gpu = tree_map(lambda t: t.cuda(), p_cpu)
    b = next(lm_batches(cfg.vocab, 2, 64, 1, seed=0))
    b_cpu = {k: torch.from_numpy(v) for k, v in b.items()}
    counters = (flash_attention_cuda, moe_gmm_cuda, ssd_scan_cuda)
    n0 = [c.launches for c in counters]
    lg, _, gg = loss_and_grads(p_gpu, {k: v.cuda() for k, v in
                                       b_cpu.items()}, cfg, remat=True)
    torch.cuda.synchronize()
    moved = [c.launches - n for c, n in zip(counters, n0)]
    lc, _, gc = loss_and_grads(p_cpu, b_cpu, cfg, remat=True)
    assert abs(float(lg) - float(lc)) <= 1e-5 * abs(float(lc))
    for g, c in zip(tree_leaves(gg), tree_leaves(gc)):
        torch.testing.assert_close(g.cpu(), c, rtol=0,
                                   atol=1e-4 * float(c.abs().max()))
    n_attn = cfg.n_periods * cfg.period.count("attn")
    n_mamba = cfg.n_periods * cfg.period.count("mamba")
    n_moe = cfg.n_periods * len(cfg.moe_period_idx) if cfg.moe else 0
    assert moved == [2 * n_attn, 2 * 3 * n_moe, 2 * n_mamba]


@pytest.mark.parametrize("arch,kind", [
    ("internlm2-1.8b", "train"), ("mixtral-8x22b", "prefill"),
    ("mamba2-370m", "prefill"), ("jamba-1.5-large-398b", "train"),
    ("seamless-m4t-medium", "decode"), ("llama-3.2-vision-11b", "prefill")])
def test_dryrun_probe_on_the_card_equals_its_meta_count(cuda, arch, kind):
    """A smoke config's probes on the card: FLOPs by dtype and launches
    by variant equal the probe's ``meta`` count, bytes and the measured
    peak within ``dryrun.AGREE`` (``dryrun.probe_problems``), and each
    kernel's launcher moved by what the probes' counts imply."""
    import dataclasses
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import InputShape
    shape = {"train": InputShape("train_4k", "train", 128, 2),
             "prefill": InputShape("prefill_32k", "prefill", 256, 2),
             "decode": InputShape("decode_32k", "decode", 256, 2)}[kind]
    counters = {"flash_attention": flash_attention_cuda,
                "moe_gmm": moe_gmm_cuda, "ssd_scan": ssd_scan_cuda,
                "decode_attention": decode_attention_cuda}
    n0 = {k: c.launches for k, c in counters.items()}
    rec = dryrun.dryrun_one(arch, dataclasses.replace(shape), device="cuda",
                            smoke=True, reps=1, verbose=False)
    torch.cuda.synchronize()
    moved = {k: c.launches - n0[k] for k, c in counters.items()}
    want = dict.fromkeys(counters, 0)
    for row in rec["probes"]:
        assert "ms" in row, row
        assert row["count_equal"], row
        assert dryrun.probe_problems(row) == [], row
        for k, n in row["card_count"].items():
            if k.startswith("launches:"):
                want[k.split(":")[1]] += 3 * n       # warm-up, counted, 1
    assert moved == want and sum(want.values()) > 0
    assert rec["measured"]["ms"] > 0 and rec["measured"]["kind"]
