"""Time the port's kernels, and the one PyTorch call that computes the
same function, at the shapes the main paths give them, on random inputs
made from a seed on the card.

  python src/repro_torch/launch/time_kernels.py [--root DIR] [--label X]
      [--kernels ssd_scan,decode_attention]

``--root`` imports ``repro_torch`` from another checkout (its ``src/``),
which builds its own kernels, so that two versions are timed by the same
code on the same inputs; run it as a file, not with ``-m``, so the root
can be chosen before the import.  To compare two commits in one call,
unpack the other one into a directory that ``.gitignore`` lists and run
the two in turns (A, B, B, A).  One JSON line per row: the kernel, the
path, the shape, the variant where the version reports one (``library``
names the PyTorch call of a twin row instead), ``ms`` (the mean of
``--reps`` calls back to back between CUDA events after a warm-up: the
host's work per call is included where it is the longer), ``graph_ms``
(the same calls captured in a CUDA graph and replayed: the device's time
per call without the host's), ``profile_by_kernel`` (device time per
call of each kernel a call launches, from a ``torch.profiler`` trace:
the SSD scan's four passes each under its own kernel's name) and
``profile_ms`` (their sum).
Rows: flash attention at the cascade's buckets 64 / 32 / 16 / 8 (fp32)
and the zoo's prefill (bf16; Mixtral's, Danube's at head dim 120, and,
non-causal, seamless-m4t-medium's encoder and llama-3.2-vision-11b's
cross-attention over its 1600 image tokens) and training (internlm2-1.8b
at 4 x 2048, Mixtral at 1 x 2048), decode attention (the
cascade's readout, Mixtral's step, Llama-3-405B's, 16 query heads a kv
head, and the CROSS models' cross-attention over their whole memory,
every slot valid: the vision model's 1600, seamless' 2048), the SSD
scan (the cascade's buckets, and the zoo's chunk 256 x state 128 at
mamba2-370m's and Jamba's layer shapes, and mamba2-370m's training
step's, 4 x 2048), and ``moe_gmm`` at the zoo's
prefill and decode (bf16, and the fp32 prefill row), each kernel row
with its plain PyTorch version (``plain`` names it:
``attention_ref``, ``decode_attention_ref``, ``ssd_scan_chunked_ref``,
``gmm_ref``) and, but the SSD scan's, with its library twin
(``F.scaled_dot_product_attention`` or ``torch.bmm``).  Where the
version's launchers take them, rows at a forced flash or SSD
``variant`` and decode ``n_split`` show each choice's trade-off (flash
``"simt"`` at the cascade's buckets and at Danube's prefill, beside the
chosen variant; the SSD scan's other variant at the cascade's chunk
64).  Under
``--root`` naming another checkout, a row its launcher refuses (a
``ValueError`` before any launch: a shape an older checkout does not
take) is printed with its ``error``; any other failure ends the run.
``--kernels`` keeps only the named kernels' rows.
Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import inspect
import json
import sys
from pathlib import Path


def _time_ms(torch, fn, reps: int, warmup: int = 5) -> float:
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


def _graph_ms(torch, fn, reps: int, replays: int = 5) -> float:
    """Per-call time of ``reps`` calls captured in one CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * reps)


def _profile_ms(torch, fn, reps: int):
    """Device time per call of each kernel, from a profiler trace."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0][-40:]
            dur = (e.time_range.end - e.time_range.start) / 1e3 / reps
            by_name[name] = by_name.get(name, 0.0) + dur
    return by_name


def _row(torch, fn, reps):
    by_kernel = _profile_ms(torch, fn, reps)
    return {"ms": _time_ms(torch, fn, reps),
            "graph_ms": _graph_ms(torch, fn, reps),
            "profile_by_kernel": by_kernel,
            "profile_ms": sum(by_kernel.values())}


def _variant(launcher, before):
    counts = getattr(launcher, "launches_by_variant", None)
    if counts is None:
        return None
    return "+".join(v for v, n in counts.items() if n > before.get(v, 0))


def _takes(fn, name: str) -> bool:
    return name in inspect.signature(fn).parameters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parents[3]))
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels", default="",
                    help="comma-separated kernels to time (default all)")
    args = ap.parse_args(argv)
    only = {k for k in args.kernels.split(",") if k}
    other_root = (Path(args.root).resolve()
                  != Path(__file__).resolve().parents[3])
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))
    import torch
    if not torch.cuda.is_available():
        print("time_kernels needs a CUDA device", file=sys.stderr)
        return 3
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_cuda)
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_ref)
    from repro_torch.kernels.flash_attention import ops as fl_ops
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.moe_gmm import ops as gmm_ops
    from repro_torch.kernels.moe_gmm.kernel import moe_gmm_cuda
    from repro_torch.kernels.moe_gmm.ref import gmm_ref
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_chunked_ref

    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    rows = []

    def emit(kernel, path, shape, fn, launcher=None, variant=None,
             library=None, plain=None, reps=args.reps):
        """Time ``fn``; the variant is the one its call took (read from
        ``launcher``'s counts) unless given; ``library`` / ``plain`` name
        the function of a twin row."""
        if only and kernel not in only:
            return
        row = {"kernel": kernel, "path": path, "shape": shape}
        if library:
            row["library"] = library
        if plain:
            row["plain"] = plain
        before = dict(getattr(launcher, "launches_by_variant", {}))
        try:
            fn()
        except ValueError as e:
            # a launcher's shape refusal, raised before any launch: kept
            # as a row only for another checkout's (older) kernels
            if not other_root:
                raise
            rows.append({**row, "error": str(e)})
            return
        torch.cuda.synchronize()
        if launcher is not None and variant is None:
            variant = _variant(launcher, before)
        rows.append({**row, "variant": variant, **_row(torch, fn, reps)})

    # flash attention: the cascade's tinytf_flash layer at every bucket
    # (fp32, causal) and the zoo's prefill (bf16; Mixtral's GQA 6 with a
    # window 4096 >= S, and the non-causal CROSS rows)
    def sdpa(q, k, v, causal):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=causal, enable_gqa=q.shape[2] != k.shape[2])

    flash = []
    for B in (64, 32, 16, 8):
        flash.append((f"cascade B={B}", rnd(B, 128, 4, 32),
                      rnd(B, 128, 4, 32), rnd(B, 128, 4, 32), None, True))
    bf = torch.bfloat16
    flash.append(("zoo prefill", rnd(2, 2048, 48, 128, dtype=bf),
                  rnd(2, 2048, 8, 128, dtype=bf),
                  rnd(2, 2048, 8, 128, dtype=bf), 4096, True))
    # h2o-danube-3-4b's head dim 120 ("tc" on its 128-wide instance)
    flash.append(("zoo danube prefill", rnd(2, 2048, 32, 120, dtype=bf),
                  rnd(2, 2048, 8, 120, dtype=bf),
                  rnd(2, 2048, 8, 120, dtype=bf), 4096, True))
    # the vision model's cross-attention prefill (Skv 1600: a ragged last
    # kv tile) and seamless' encoder, both non-causal
    flash.append(("zoo vision cross prefill",
                  rnd(2, 2048, 32, 128, dtype=bf),
                  rnd(2, 1600, 8, 128, dtype=bf),
                  rnd(2, 1600, 8, 128, dtype=bf), None, False))
    flash.append(("zoo seamless encoder prefill",
                  rnd(2, 2048, 16, 64, dtype=bf),
                  rnd(2, 2048, 16, 64, dtype=bf),
                  rnd(2, 2048, 16, 64, dtype=bf), None, False))
    # the training path's forwards: internlm2-1.8b at 4 x 2048 and
    # Mixtral (window 4096) at 1 x 2048
    flash.append(("zoo internlm2 train", rnd(4, 2048, 16, 128, dtype=bf),
                  rnd(4, 2048, 8, 128, dtype=bf),
                  rnd(4, 2048, 8, 128, dtype=bf), None, True))
    flash.append(("zoo mixtral train", rnd(1, 2048, 48, 128, dtype=bf),
                  rnd(1, 2048, 8, 128, dtype=bf),
                  rnd(1, 2048, 8, 128, dtype=bf), 4096, True))
    forced = _takes(flash_attention_cuda, "variant")
    for path, q, k, v, window, causal in flash:
        shape = [list(q.shape), list(k.shape)]
        emit("flash_attention", path, shape,
             lambda: fl_ops.flash_attention(q, k, v, causal=causal,
                                            window=window),
             flash_attention_cuda)
        emit("flash_attention", path, shape, lambda: sdpa(q, k, v, causal),
             library="F.scaled_dot_product_attention")
        emit("flash_attention", path, shape,
             lambda: attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal=causal,
                                   window=window,
                                   sm_scale=q.shape[-1] ** -0.5),
             plain="attention_ref", reps=10)
        if not (path.startswith("cascade") or "danube" in path):
            continue
        # the scalar kernel beside the chosen one
        if forced:
            scale = q.shape[-1] ** -0.5
            emit("flash_attention", path, shape,
                 lambda: flash_attention_cuda(q, k, v, sm_scale=scale,
                                              variant="simt"),
                 variant="forced simt")

    # decode attention: the zoo's step (full ring) and the cascade's
    # pooled readout (valid prefixes, pads at -1) at buckets 64 and 8
    def sdpa_masked(q, k, v, pos):
        pos = pos if pos.ndim == 2 else pos[None].expand(k.shape[0], -1)
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=(pos >= 0)[:, None, None, :],
            enable_gqa=q.shape[2] != k.shape[2])

    W = 2048
    dec = [("zoo decode", rnd(2, 1, 48, 128, dtype=bf),
            rnd(2, W, 8, 128, dtype=bf), rnd(2, W, 8, 128, dtype=bf),
            torch.arange(W, device="cuda", dtype=torch.int32))]
    dec.append(("zoo llama3 decode", rnd(2, 1, 128, 128, dtype=bf),
                rnd(2, W, 8, 128, dtype=bf), rnd(2, W, 8, 128, dtype=bf),
                torch.arange(W, device="cuda", dtype=torch.int32)))
    # cross-attention over the whole memory (every slot valid)
    dec.append(("zoo vision cross decode", rnd(2, 1, 32, 128, dtype=bf),
                rnd(2, 1600, 8, 128, dtype=bf),
                rnd(2, 1600, 8, 128, dtype=bf),
                torch.arange(1600, device="cuda", dtype=torch.int32)))
    dec.append(("zoo seamless cross decode", rnd(2, 1, 16, 64, dtype=bf),
                rnd(2, W, 16, 64, dtype=bf), rnd(2, W, 16, 64, dtype=bf),
                torch.arange(W, device="cuda", dtype=torch.int32)))
    for B in (64, 8):
        lens = torch.randint(1, 129, (B, 1), generator=gen, device="cuda")
        ar = torch.arange(128, device="cuda")
        pos = torch.where(ar[None] < lens, ar[None], -1).to(torch.int32)
        dec.append((f"cascade B={B}", rnd(1, 1, 4, 32).expand(B, 1, 4, 32),
                    rnd(B, 128, 4, 32), rnd(B, 128, 4, 32), pos))
    for path, q, k, v, pos in dec:
        shape = [list(q.shape), list(k.shape)]
        emit("decode_attention", path, shape,
             lambda: dec_ops.decode_attention(q, k, v, pos),
             decode_attention_cuda)
        emit("decode_attention", path, shape,
             lambda: sdpa_masked(q, k, v, pos),
             library="F.scaled_dot_product_attention")
        B, _, H, hd = q.shape
        K = k.shape[2]
        pos2 = pos if pos.ndim == 2 else pos[None].expand(B, -1)
        emit("decode_attention", path, shape,
             lambda: decode_attention_ref(
                 q[:, 0].reshape(B, K, H // K, hd), k, v, pos2,
                 sm_scale=hd ** -0.5),
             plain="decode_attention_ref", reps=10)
    # the split's trade-off: the zoo's step and the cascade's bucket 8 at
    # forced split counts (versions whose launcher takes ``n_split``)
    if _takes(decode_attention_cuda, "n_split"):
        for (path, q, k, v, pos), counts in ((dec[0], (8, 16, 32)),
                                             (dec[-1], (1, 2))):
            pos = pos if pos.ndim == 2 else pos[None].expand(k.shape[0], -1)
            for n in counts:
                emit("decode_attention", path,
                     [list(q.shape), list(k.shape)],
                     lambda: decode_attention_cuda(q, k, v, pos, n_split=n),
                     variant=f"{n} splits")
    # SSD scan at the ssm level's dims, every bucket; then the zoo's
    # chunk 256 x state 128 at mamba2-370m's (32 heads) and Jamba's (256
    # heads) layer shapes, prompts 2 x 2048
    ssd = [(f"cascade B={B}", B, 128, 6, 64, 32, 64)
           for B in (64, 32, 16, 8)]
    ssd += [("zoo mamba2 prefill", 2, 2048, 32, 64, 128, 256),
            ("zoo jamba prefill", 2, 2048, 256, 64, 128, 256),
            ("zoo mamba2 train", 4, 2048, 32, 64, 128, 256)]
    for path, B, S, H, hp, N, chunk in ssd:
        if only and "ssd_scan" not in only:
            break
        x, Bm, Cm = rnd(B, S, H, hp), rnd(B, S, N), rnd(B, S, N)
        dt = torch.nn.functional.softplus(rnd(B, S, H) - 2.0)
        adt = -torch.arange(1, H + 1, device="cuda").float() * dt
        launcher = getattr(ssd_ops, "ssd_scan_cuda", None)
        emit("ssd_scan", path, list(x.shape),
             lambda: ssd_ops.ssd_scan(x, adt, dt, Bm, Cm, chunk=chunk),
             launcher)
        # the long-chunk variant (this checkout's name for it) at the
        # cascade's chunk 64, beside "whole"
        if path.startswith("cascade") and _takes(launcher, "variant"):
            other = [v for v in launcher.launches_by_variant
                     if v != "whole"][0]
            emit("ssd_scan", path, list(x.shape),
                 lambda: launcher(x, adt, dt, Bm, Cm, chunk=chunk,
                                  variant=other),
                 variant=f"forced {other}")
        emit("ssd_scan", path, list(x.shape),
             lambda: ssd_scan_chunked_ref(x, adt, dt, Bm, Cm, chunk),
             plain="ssd_scan_chunked_ref",
             reps=10 if path.startswith("cascade") else 3)
    # moe_gmm at the zoo's expert FFN (8 experts, d_model 6144, d_ff
    # 16384): prefill capacity 640 and decode capacity 4, the up and down
    # projections, and the prefill's up projection in fp32
    E, D, Fd = 8, 6144, 16384
    w_up, w_down = rnd(E, D, Fd, dtype=bf), rnd(E, Fd, D, dtype=bf)
    gmm = [(f"zoo {stage} {proj}", rnd(E, C, w.shape[1], dtype=bf), w)
           for stage, C in (("prefill", 640), ("decode", 4))
           for proj, w in (("up", w_up), ("down", w_down))]
    gmm.append(("fp32 prefill up", gmm[0][1].float(), w_up.float()))
    for path, x, w in gmm:
        reps = 5 if x.dtype == torch.float32 else 10
        shape = [list(x.shape), list(w.shape)]
        emit("moe_gmm", path, shape, lambda: gmm_ops.moe_gmm(x, w),
             moe_gmm_cuda, reps=reps)
        emit("moe_gmm", path, shape, lambda: torch.bmm(x, w),
             library="torch.bmm", reps=reps)
        emit("moe_gmm", path, shape, lambda: gmm_ref(x, w),
             plain="gmm_ref", reps=reps)
    for row in rows:
        print(json.dumps({"label": args.label, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
