"""Chip smoke test of the PyTorch/CUDA port: builds the kernels, holds
each against its plain PyTorch version on the card, serves the kernel
ladder end to end at full width, and checks the served students.

  python3 chip_smoke.py            (from the repository root; one GPU)

Phases (any failure exits non-zero and prints no result line):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc``;
  3. each kernel against its plain version on the card — at the serving
     shapes (batch 64 and the smallest bucket, 8; inputs captured from
     the students' own forwards) and at the edge cases (flash: window,
     non-causal, GQA, bf16, head dim 120, ragged length; decode: garbage
     in empty ring slots, a (W,) pos, GQA, bf16; SSD: O(1) random
     inputs at the path shape, its tolerance scaled to the plain
     output's magnitude where that is below 1) — with the kernel's,
     the plain version's and, where one PyTorch call computes the same
     function, that call's time, beside the analytic bound;
  4. ``serve_stream_batched`` on the ``kernel`` ladder (lr ->
     tinytf_flash -> ssm at the default widths), imdb, batch 64, 2048
     items, simulated expert: every kernel's launch count over this run
     must be > 0 and equal the layers x forwards the engine counted;
  5. the served levels' final params: kernel path vs plain path logits
     at batch 64 — same argmax on every row, logits within tolerance.
The line before the last is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent

PEAK_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (data sheet)
PEAK_FP32_FLOP_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores
# SSD: 1e-3 scaled by the plain output's largest magnitude when that is
# below 1 (the served students' SSD outputs are ~1e-4; an absolute 1e-3
# would pass a kernel that returned zeros)
TOL = {"flash_attention": 2e-5, "decode_attention": 2e-5, "ssd_scan": 1e-3,
       "bf16": 2e-2}
LOGIT_TOL = {"tinytf_flash": 1e-4, "ssm": 2e-3}
REPLACES = {
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:29",
    "decode_attention": "src/repro/kernels/decode_attention/kernel.py:27",
    "ssd_scan": "src/repro/kernels/ssd_scan/kernel.py:24",
}
SOURCE = {k: f"src/repro_torch/kernels/csrc/{k}.cu" for k in REPLACES}


class SmokeFailure(RuntimeError):
    """A phase's check did not hold."""


def _fail(msg: str) -> None:
    raise SmokeFailure(msg)


def _setup():
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py must run from a checkout of the repository "
              f"(no src/repro_torch under {ROOT})", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("CUDA is not available: chip_smoke.py needs a GPU",
              file=sys.stderr)
        sys.exit(3)
    return torch


torch = _setup()
import numpy as np  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.decode_attention.kernel import (  # noqa: E402
    decode_attention_cuda)
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref)
from repro_torch.kernels.flash_attention import ops as fl_ops  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_cuda)
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_scan_chunked_ref  # noqa: E402

LAUNCHERS = {"flash_attention": flash_attention_cuda,
             "decode_attention": decode_attention_cuda,
             "ssd_scan": ssd_scan_cuda}


# ---------------------------------------------------------------------------
# plain versions (same inputs, model layout) and library yardsticks
# ---------------------------------------------------------------------------
def flash_plain(q, k, v, causal=True, window=None):
    return attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), causal=causal, window=window,
                         sm_scale=q.shape[-1] ** -0.5).transpose(1, 2)


def flash_library(q, k, v, causal=True, window=None):
    assert window is None
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=causal).transpose(1, 2)


def decode_plain(q, k, v, pos):
    B, _, H, hd = q.shape
    K = k.shape[2]
    if pos.ndim == 1:
        pos = pos[None].expand(B, pos.shape[0])
    return decode_attention_ref(q[:, 0].reshape(B, K, H // K, hd), k, v,
                                pos, sm_scale=hd ** -0.5).reshape(B, 1, H, hd)


def decode_library(q, k, v, pos):
    B, _, H, hd = q.shape
    if pos.ndim == 1:
        pos = pos[None].expand(B, pos.shape[0])
    mask = (pos >= 0)[:, None, None, :]
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask).transpose(1, 2)


# ---------------------------------------------------------------------------
# analytic bounds: max(bytes / HBM rate, FLOPs / fp32 rate)
# ---------------------------------------------------------------------------
def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def _bound(nbytes, flops):
    tb = nbytes / PEAK_BYTES_PER_S * 1e3
    tf = flops / PEAK_FP32_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def flash_bound(q, k, v, causal=True, window=None):
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    qp = torch.arange(Sq)[:, None]
    kp = torch.arange(Skv)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= kp > qp - window
    pairs = int(mask.sum())
    flops = B * H * pairs * 4 * hd                # q.k and p.v
    return _bound(_nbytes(q, k, v, q), flops)


def decode_bound(q, k, v, pos):
    B, _, H, hd = q.shape
    W, K = k.shape[1], k.shape[2]
    if pos.ndim == 1:
        pos = pos[None].expand(B, W)
    valid = int((pos >= 0).sum())                 # slots this data needs
    kv_bytes = 2 * valid * K * hd * k.element_size()
    flops = valid * H * 4 * hd
    return _bound(_nbytes(q, pos, q) + kv_bytes, flops)


def ssd_bound(x, adt, dt, B, C, chunk):
    Bsz, S, H, hp = x.shape
    N = B.shape[-1]
    L = chunk
    tri = L * (L + 1) // 2
    per_chunk = 2 * tri * N + 2 * tri * hp + 2 * L * hp * N + 2 * hp * N * L
    flops = Bsz * H * (S // L) * per_chunk
    return _bound(_nbytes(x, adt, dt, B, C, x), flops)


# ---------------------------------------------------------------------------
# timing with CUDA events
# ---------------------------------------------------------------------------
def time_ms(fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def phase_card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        _fail(f"nvidia-smi failed: {out.stderr}")
    line = out.stdout.strip().splitlines()[0]
    print(line, flush=True)
    return line


def phase_build():
    path, secs, log = _build.build()
    print(f"[build] {path.relative_to(ROOT)} in {secs:.2f} s", flush=True)
    for ln in log.splitlines():
        if ln.startswith("==") or "Used" in ln or "spill" in ln:
            print(f"[build] {ln.strip()}")
    _build.library()


def capture_path_inputs(batch, tf_spec, ssm_spec, tokens, gen):
    """Run one kernel-path forward of each upper student at full width
    and record the inputs each op gets there (the shapes and values the
    main path gives the kernels)."""
    from repro_torch.models import kernel_students as ks
    got = {}
    real = {n: getattr(ks, n) for n in
            ("flash_attention", "decode_attention", "ssd_scan")}

    def rec(name):
        def f(*args, **kw):
            got.setdefault(name, (args, kw))
            return real[name](*args, **kw)
        return f

    dev = torch.device("cuda")
    tf_params = ks.tinytf_flash_init(gen, tf_spec, dev)
    ssm_params = ks.ssm_student_init(gen, ssm_spec, dev)
    try:
        for name in real:
            setattr(ks, name, rec(name))
        with torch.no_grad():
            ks.tinytf_flash_logits(tf_params, tokens[:batch], tf_spec)
            ks.ssm_student_logits(ssm_params, tokens[:batch], ssm_spec)
    finally:
        for name, fn in real.items():
            setattr(ks, name, fn)
    return got


def check(name, label, kernel_fn, plain_fn, tol, results, library_fn=None,
          bound=None, timed=False, scaled=False):
    torch.cuda.synchronize()
    out = kernel_fn()
    torch.cuda.synchronize()
    ref = plain_fn()
    err = max_err(out, ref)
    if not math.isfinite(err) or not bool(torch.isfinite(out).all()):
        _fail(f"{name} [{label}]: non-finite output")
    ref_max = float(ref.float().abs().max())
    if scaled:
        tol = tol * min(1.0, ref_max)
    row = {"max_abs_err": err, "tol": tol, "max_abs_ref": ref_max}
    if timed:
        row["kernel_ms"] = time_ms(kernel_fn)
        row["plain_ms"] = time_ms(plain_fn)
        row["library_ms"] = time_ms(library_fn) if library_fn else None
        row["bound_ms"], row["bound_by"] = bound
    print(f"[check] {name:16s} {label:28s} " + " ".join(
        f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
        for k, v in row.items()), flush=True)
    if err > tol:
        _fail(f"{name} [{label}]: max_abs_err {err} > tol {tol}")
    results.setdefault(name, []).append((label, row))
    return row


def phase_kernels(tokens):
    from repro_torch.models.kernel_students import (SSMStudentSpec,
                                                    TinyTFFlashSpec)
    results = {}
    gen = torch.Generator().manual_seed(1234)
    for batch in (64, 8):
        got = capture_path_inputs(batch, TinyTFFlashSpec(), SSMStudentSpec(),
                                  tokens, gen)
        timed = batch == 64
        (q, k, v), kw = got["flash_attention"]
        check("flash_attention", f"path B={batch} causal fp32",
              lambda: fl_ops.flash_attention(q, k, v, **kw),
              lambda: flash_plain(q, k, v), TOL["flash_attention"], results,
              lambda: flash_library(q, k, v), flash_bound(q, k, v), timed)
        (q, k, v, pos), kw = got["decode_attention"]
        check("decode_attention", f"path B={batch} pads fp32",
              lambda: dec_ops.decode_attention(q, k, v, pos, **kw),
              lambda: decode_plain(q, k, v, pos), TOL["decode_attention"],
              results, lambda: decode_library(q, k, v, pos),
              decode_bound(q, k, v, pos), timed)
        (x, adt, dt, B, C), kw = got["ssd_scan"]
        check("ssd_scan", f"path B={batch} chunk {kw['chunk']}",
              lambda: ssd_ops.ssd_scan(x, adt, dt, B, C, **kw),
              lambda: ssd_scan_chunked_ref(x, adt, dt, B, C, kw["chunk"]),
              TOL["ssd_scan"], results, None,
              ssd_bound(x, adt, dt, B, C, kw["chunk"]), timed, scaled=True)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen).to("cuda", dtype)

    # flash edge cases
    for label, (B, S, H, K, hd, causal, window, dtype) in {
            "window 48": (4, 128, 4, 4, 32, True, 48, torch.float32),
            "non-causal": (4, 128, 4, 4, 32, False, None, torch.float32),
            "GQA H8/K2": (4, 128, 8, 2, 32, True, None, torch.float32),
            "bf16": (4, 128, 4, 4, 32, True, None, torch.bfloat16),
            "hd 120": (2, 128, 4, 2, 120, True, None, torch.float32),
            "ragged S=100": (2, 100, 4, 4, 32, True, None, torch.float32),
    }.items():
        q, k, v = rnd(B, S, H, hd, dtype=dtype), rnd(B, S, K, hd,
                                                       dtype=dtype), \
            rnd(B, S, K, hd, dtype=dtype)
        tol = TOL["bf16"] if dtype == torch.bfloat16 else \
            TOL["flash_attention"]
        check("flash_attention", label,
              lambda: fl_ops.flash_attention(q, k, v, causal=causal,
                                             window=window),
              lambda: flash_plain(q, k, v, causal, window), tol, results)

    # SSD on O(1) inputs at the path shape, where a wrong decay or state
    # update cannot hide under the small outputs of the served students
    (x, _, _, Bp, _), kw = got["ssd_scan"]
    _, S, H, hp = x.shape
    N, chunk = Bp.shape[-1], kw["chunk"]
    for Bsz in (64, 8):
        xr, Br, Cr = rnd(Bsz, S, H, hp), rnd(Bsz, S, N), rnd(Bsz, S, N)
        dtr = F.softplus(rnd(Bsz, S, H) - 2.0)
        adtr = -torch.arange(1, H + 1, device="cuda").float() * dtr
        check("ssd_scan", f"random O(1) B={Bsz}",
              lambda: ssd_ops.ssd_scan(xr, adtr, dtr, Br, Cr, chunk=chunk),
              lambda: ssd_scan_chunked_ref(xr, adtr, dtr, Br, Cr, chunk),
              TOL["ssd_scan"], results, scaled=True)

    # decode edge cases
    B, W, H, hd = 8, 128, 4, 32
    q, k, v = rnd(B, 1, H, hd), rnd(B, W, H, hd), rnd(B, W, H, hd)
    lens = torch.randint(1, W + 1, (B,), generator=gen)
    ar = torch.arange(W)
    pos = torch.where(ar[None] < lens[:, None], ar[None],
                      torch.full_like(ar, -1)[None]).to("cuda", torch.int32)
    kg, vg = k.clone(), v.clone()
    inval = (pos < 0)[:, :, None, None].expand_as(kg)
    kg[inval] = 1e4 * rnd(B, W, H, hd)[inval]
    vg[inval] = 1e4 * rnd(B, W, H, hd)[inval]
    check("decode_attention", "garbage in empty slots",
          lambda: dec_ops.decode_attention(q, kg, vg, pos),
          lambda: dec_ops.decode_attention(q, k, v, pos),
          TOL["decode_attention"], results)
    pos1 = torch.where(ar < 77, ar, torch.full_like(ar, -1))
    pos1 = pos1.to("cuda", torch.int32)
    check("decode_attention", "(W,) pos",
          lambda: dec_ops.decode_attention(q, k, v, pos1),
          lambda: decode_plain(q, k, v, pos1), TOL["decode_attention"],
          results)
    qg, kk, vv = rnd(B, 1, 8, hd), rnd(B, W, 2, hd), rnd(B, W, 2, hd)
    check("decode_attention", "GQA H8/K2",
          lambda: dec_ops.decode_attention(qg, kk, vv, pos),
          lambda: decode_plain(qg, kk, vv, pos), TOL["decode_attention"],
          results)
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    check("decode_attention", "bf16",
          lambda: dec_ops.decode_attention(qb, kb, vb, pos),
          lambda: decode_plain(qb, kb, vb, pos), TOL["bf16"], results)
    return results


def phase_serve():
    from repro_torch.launch.serve import serve_stream_batched
    for fn in LAUNCHERS.values():
        fn.launches = 0
    t0 = time.time()
    m = serve_stream_batched("imdb", 2048, 3e-7, batch=64, seed=0,
                             log_every=0, ladder="kernel", device="cuda")
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {n: fn.launches for n, fn in LAUNCHERS.items()}
    eng = m["engine"]
    lv = {lvl.spec.kind: lvl for lvl in eng.levels}
    tf, ssm = lv["tinytf_flash"], lv["ssm"]
    expect = {"flash_attention": tf.sspec.n_layers * tf.forwards,
              "decode_attention": tf.forwards,
              "ssd_scan": ssm.sspec.n_layers * ssm.forwards}
    print(f"[serve] items_per_sec={m['items_per_sec']:.1f} "
          f"wall_s={wall:.2f} accuracy={m['accuracy']:.4f} "
          f"expert_calls={m['expert_calls']} level_fractions="
          f"{[round(f, 4) for f in m['level_fractions']]}")
    print(f"[serve] forwards per level: "
          f"{ {lvl.spec.kind: lvl.forwards for lvl in eng.levels} } "
          f"launches: {launches} expected: {expect}", flush=True)
    for n in LAUNCHERS:
        if launches[n] <= 0:
            _fail(f"{n} was never launched on the serving path")
        if launches[n] != expect[n]:
            _fail(f"{n}: {launches[n]} launches != {expect[n]} "
                  "layer-forwards the engine counted")
    if not (0.0 <= m["accuracy"] <= 1.0) or m["expert_calls"] <= 0:
        _fail(f"implausible serving metrics {m['accuracy']}, "
              f"{m['expert_calls']}")
    return eng, launches, m


def phase_students(eng, tokens):
    from repro_torch.models.kernel_students import (ssm_student_logits,
                                                    tinytf_flash_logits)
    lv = {lvl.spec.kind: lvl for lvl in eng.levels}
    for kind, fn in (("tinytf_flash", tinytf_flash_logits),
                     ("ssm", ssm_student_logits)):
        lvl = lv[kind]
        with torch.no_grad():
            a = fn(lvl.params, tokens[:64], lvl.sspec, use_kernels=True)
            b = fn(lvl.params, tokens[:64], lvl.sspec, use_kernels=False)
        torch.cuda.synchronize()
        err = max_err(a, b)
        same = bool((a.argmax(-1) == b.argmax(-1)).all())
        print(f"[students] {kind}: max |kernel - plain| logits={err:.3g} "
              f"(tol {LOGIT_TOL[kind]}) argmax equal on all 64 rows: "
              f"{same}", flush=True)
        if not same or err > LOGIT_TOL[kind] or not math.isfinite(err):
            _fail(f"{kind} kernel vs plain path disagree")


def main():
    from repro_torch.data import hash_ids, make_stream
    phase_card()
    phase_build()
    stream = make_stream("imdb", seed=0, n_samples=128)
    tokens = torch.from_numpy(np.stack(
        [hash_ids(d, 4096, 128) for d in stream.docs[:64]])).cuda()
    results = phase_kernels(tokens)
    eng, launches, _ = phase_serve()
    phase_students(eng, tokens)
    record = []
    for name in LAUNCHERS:
        path_rows = [r for lab, r in results[name] if lab.startswith("path")]
        timed = path_rows[0]
        record.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in path_rows),
            "ms": timed["kernel_ms"], "plain_ms": timed["plain_ms"],
            "bound_ms": timed["bound_ms"], "bound_by": timed["bound_by"],
            "library_ms": timed["library_ms"]})
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        sys.exit(1)
