"""The dry-run slice in the port vs the JAX package on the CPU: the
configs' counts, ``launch/shapes.py``, ``metrics/roofline.py``, the
kernel ops' ``meta`` branch, ``metrics/cost.py``'s counter and
``launch/dryrun.py``.  Tolerances, each with its reason:

* configs' counts, shape trees (paths, shapes, dtypes), roofline terms
  and 6ND: equal (the same integer and float arithmetic);
* a counted prefill's FLOPs against a closed form from the config, and
  the extrapolated FLOPs and launches against a full-depth count: equal
  (integers below 2**53, the law's divisions are by 1);
* a training step's extrapolated bytes: short of the full-depth count by
  less than 10% (``TRAIN_BYTES_SHORT``: the parameters' gradients are
  quadratic in depth, see the test);
* the extrapolated peak against a full-depth count: within 2%
  (``PEAK_TOL``: the peak is a maximum over time, which the law extends
  phase by phase, so where a probe's peak falls at another point of a
  phase than the full depth's the two part by a few tensors);
* the three kernel bounds ``PERF.md`` prints: to the printed digits.
"""
import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_smoke_config as j_get_smoke  # noqa: E402
from repro.launch import shapes as j_shapes  # noqa: E402
from repro.metrics import roofline as j_roof  # noqa: E402
from repro_torch.configs import (get_config, get_smoke_config,  # noqa: E402
                                 list_architectures)
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as dec_k  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fl_k  # noqa: E402
from repro_torch.kernels.moe_gmm import kernel as gmm_k  # noqa: E402
from repro_torch.kernels.moe_gmm import moe_gmm  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as ssd_k  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import shapes as t_shapes  # noqa: E402
from repro_torch.metrics import roofline as t_roof  # noqa: E402
from repro_torch.metrics.cost import CostCounter  # noqa: E402

ARCHS = list_architectures()
SHAPES = list(t_shapes.INPUT_SHAPES)
PEAK_TOL = 2e-2
TRAIN_BYTES_SHORT = 0.1
ROOT = Path(__file__).resolve().parents[1]
# small shapes of each kind for whole-step runs on meta
SMALL = {"train": t_shapes.InputShape("train_4k", "train", 64, 2),
         "prefill": t_shapes.InputShape("prefill_32k", "prefill", 128, 2),
         "decode": t_shapes.InputShape("decode_32k", "decode", 128, 2)}


def _leaf_paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaf_paths(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_counts_match_reference(arch, smoke):
    mine = (get_smoke_config if smoke else get_config)(arch)
    ref = (j_get_smoke if smoke else j_get_config)(arch)
    assert mine.param_count() == ref.param_count()
    assert mine.active_param_count() == ref.active_param_count()
    assert mine.long_context_window == ref.long_context_window == 8192
    for w in (64, mine.long_context_window):
        a, b = mine.with_window(w), ref.with_window(w)
        assert (a.attn is None) == (b.attn is None)
        if a.attn is not None:
            assert a.attn.window == b.attn.window == w
            assert dataclasses.replace(a.attn, window=mine.attn.window) \
                == mine.attn
        else:
            assert a is mine


# ---------------------------------------------------------------------------
# shapes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch, shape):
    ts, js = t_shapes.INPUT_SHAPES[shape], j_shapes.INPUT_SHAPES[shape]
    assert (ts.name, ts.kind, ts.seq, ts.batch) == (js.name, js.kind,
                                                    js.seq, js.batch)
    mine, ref = get_config(arch), j_get_config(arch)
    assert t_shapes.needs_long_context_override(mine, ts) == \
        j_shapes.needs_long_context_override(ref, js)
    rm, rr = t_shapes.resolve_config(mine, ts), j_shapes.resolve_config(ref,
                                                                        js)
    assert (rm.attn is None and rr.attn is None) or \
        rm.attn.window == rr.attn.window
    got = _leaf_paths(t_shapes.input_specs(mine, ts))
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            j_shapes.input_specs(ref, js))[0]:
        key = "".join(f"/{p.key}" for p in path)
        want[key] = leaf
    assert sorted(got) == sorted(want)
    for k, t in got.items():
        assert t.is_meta, k
        assert tuple(t.shape) == tuple(want[k].shape), k
        assert str(t.dtype).replace("torch.", "") == str(want[k].dtype), k


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------
# the reference's own envelope, built here: the port stores no TPU number
V5E_LIKE = t_roof.HW(name=j_roof.V5E.name, peak_flops=j_roof.V5E.peak_flops,
                     peak_fp32_flops=j_roof.V5E.peak_flops,
                     hbm_bw=j_roof.V5E.hbm_bw, link_bw=j_roof.V5E.ici_bw,
                     hbm_bytes=j_roof.V5E.hbm_bytes)


@pytest.mark.parametrize("flops,nbytes,coll", [
    (1e15, 1e12, 0.0), (3.3e12, 8.1e11, 4.4e10), (0.0, 2e9, 1e9),
    (7.7e13, 0.0, 0.0), (0.0, 0.0, 0.0)])
def test_roofline_terms_match_reference(flops, nbytes, coll):
    want = j_roof.roofline_terms(flops, nbytes, coll, j_roof.V5E)
    assert t_roof.roofline_terms(flops, nbytes, coll, V5E_LIKE) == want
    # by dtype: bf16 at the bf16 peak, as a bare number is
    assert t_roof.roofline_terms({"bfloat16": flops}, nbytes, coll,
                                 V5E_LIKE) == want


def test_roofline_terms_by_dtype_on_the_h100():
    h = t_roof.H100
    t = t_roof.roofline_terms({"bfloat16": 989e12, "float32": 67e12,
                               "float16": 989e12}, 3.35e12, 0.0)
    assert t["compute_s"] == pytest.approx(3.0, rel=1e-15)
    assert t["memory_s"] == pytest.approx(1.0, rel=1e-15)
    assert t["dominant"] == "compute" and t["collective_s"] == 0.0
    assert (h.peak_flops, h.peak_fp32_flops, h.hbm_bw, h.hbm_bytes) == (
        989e12, 67e12, 3.35e12, 80e9)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_6nd_matches_reference(arch):
    for n in (1, 4096 * 256):
        assert t_roof.model_flops_6nd(get_config(arch), n) == \
            j_roof.model_flops_6nd(j_get_config(arch), n)


def _mask_pairs(Sq, Skv, causal, window):
    qp = np.arange(Sq)[:, None]
    kp = np.arange(Skv)[None, :]
    m = np.ones((Sq, Skv), bool)
    if causal:
        m &= kp <= qp
    if window is not None:
        m &= kp > qp - window
    return int(m.sum())


def test_flash_pairs_equal_the_mask():
    rng = np.random.default_rng(0)
    cases = [(0, 5, True, None), (2048, 2048, True, 4096), (1000, 1000,
                                                            True, None)]
    cases += [(int(rng.integers(0, 40)), int(rng.integers(0, 40)),
               bool(rng.integers(2)), [None, 1, 3, 17][rng.integers(4)])
              for _ in range(300)]
    for Sq, Skv, causal, w in cases:
        assert t_roof.flash_pairs(Sq, Skv, causal, w) == \
            _mask_pairs(Sq, Skv, causal, w), (Sq, Skv, causal, w)


@pytest.mark.parametrize("cost,printed", [
    # mamba2-370m's SSD layer: x (2,2048,32,64), N 128, chunk 256
    (lambda: t_roof.ssd_cost((2, 2048, 32, 64), 128, 256), "0.0983"),
    # Danube's flash prefill: q (2,2048,32,120), k/v (2,2048,8,120) bf16
    (lambda: t_roof.flash_cost((2, 2048, 32, 120), (2, 2048, 8, 120),
                               torch.bfloat16, True, 4096), "0.0652"),
    # the gmm prefill up-projection (8,640,6144) x (8,6144,16384) bf16
    (lambda: t_roof.gmm_cost((8, 640, 6144), (8, 6144, 16384),
                             torch.bfloat16), "1.042"),
])
def test_kernel_bounds_are_perf_md_rows(cost, printed):
    ms, by = cost().bound_ms()
    digits = len(printed.split(".")[1])
    assert f"{ms:.{digits}f}" == printed and by == "operations"


# ---------------------------------------------------------------------------
# the kernel ops' meta branch
# ---------------------------------------------------------------------------
def _pair(shape, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    cpu = torch.randn(shape, generator=g).to(dtype)
    return cpu, torch.empty(shape, dtype=dtype, device="meta")


def _count(fn):
    with CostCounter() as c:
        out = fn()
    return out, c


def _same_meta(cpu_out, meta_out):
    cpu_out = cpu_out if isinstance(cpu_out, tuple) else (cpu_out,)
    meta_out = meta_out if isinstance(meta_out, tuple) else (meta_out,)
    assert len(cpu_out) == len(meta_out)
    for a, b in zip(cpu_out, meta_out):
        assert b.is_meta and b.shape == a.shape and b.dtype == a.dtype


def _grads_reach(fn, metas):
    xs = [m.detach().requires_grad_(m.is_floating_point()) for m in metas]
    out = fn(*xs)
    out = out if isinstance(out, tuple) else (out,)
    loss = sum(o.float().sum() for o in out)
    wants = [x for x in xs if x.requires_grad]
    grads = torch.autograd.grad(loss, wants)
    for x, g in zip(wants, grads):
        assert g is not None and g.is_meta and g.shape == x.shape


@pytest.mark.parametrize("dtype,hd,offset,variant", [
    (torch.bfloat16, 64, 0, "tc"), (torch.float32, 32, 0, "tiled"),
    (torch.float32, 24, 0, "simt"),
    # a view whose base is 2 bytes off 16: TMA cannot read it
    (torch.bfloat16, 64, 1, "simt")])
def test_flash_meta_branch(dtype, hd, offset, variant):
    B, S, H, K = 2, 48, 4, 2
    (qc, qm), (kc, km), (vc, vm) = (
        _pair((B, S, n, hd + offset), dtype, i)
        for i, n in enumerate((H, K, K)))
    qc, qm = qc[..., offset:], qm[..., offset:]
    kc, km, vc, vm = (t[..., offset:] for t in (kc, km, vc, vm))
    assert fl_k.select_variant(qm, km, vm) == variant
    kw = dict(causal=True, window=16)
    out, c = _count(lambda: flash_attention(qm, km, vm, **kw))
    _same_meta(flash_attention(qc, kc, vc, **kw), out)
    assert c.launches == {"flash_attention": {variant: 1}}
    cost = t_roof.flash_cost(qm.shape, km.shape, dtype, True, 16)
    assert c.kernel_flops == {cost.dtype: cost.flops}
    assert c.kernel_bytes == cost.nbytes
    _grads_reach(lambda q, k, v: flash_attention(q, k, v, **kw),
                 (qm, km, vm))


@pytest.mark.parametrize("B,W,variant", [(2, 128, "single"),
                                         (2, 2048, "split")])
def test_decode_meta_branch(B, W, variant):
    H, K, hd = 8, 2, 32
    (qc, qm), (kc, km), (vc, vm) = (_pair(s, torch.float32, i) for i, s in
                                    enumerate(((B, 1, H, hd), (B, W, K, hd),
                                               (B, W, K, hd))))
    pc = torch.arange(W, dtype=torch.int32)
    pm = torch.empty((W,), dtype=torch.int32, device="meta")
    assert dec_k.select_variant(B, K, W) == variant
    out, c = _count(lambda: decode_attention(qm, km, vm, pm))
    _same_meta(decode_attention(qc, kc, vc, pc), out)
    assert c.launches == {"decode_attention": {variant: 1}}
    cost = t_roof.decode_cost(qm.shape, km.shape, torch.float32)
    assert c.kernel_flops == {"float32": cost.flops}
    assert c.kernel_bytes == cost.nbytes
    # the split's scratch is allocated on meta as on the card
    n_split = dec_k.num_splits(B, K, W)
    scratch = (B * K * n_split * (H // K) * (hd + 2) * 4
               if n_split > 1 else 0)
    assert c.peak_bytes == out.numel() * 4 + scratch
    # no training path decodes: a gradient raises off the CPU
    with pytest.raises(RuntimeError, match="no gradient"):
        decode_attention(qm.requires_grad_(), km, vm, pm)


@pytest.mark.parametrize("chunk,variant,init,ret", [
    (32, "whole", False, False), (32, "whole", True, True),
    (128, "parallel", True, True), (128, "parallel", False, False)])
def test_ssd_meta_branch(chunk, variant, init, ret):
    Bsz, S, H, hp, N = 2, 256, 3, 16, 32
    shapes = [(Bsz, S, H, hp), (Bsz, S, H), (Bsz, S, H), (Bsz, S, N),
              (Bsz, S, N)]
    pairs = [_pair(s, torch.float32, i) for i, s in enumerate(shapes)]
    cpu = [p[0] for p in pairs]
    cpu[1] = -cpu[1].abs()
    meta = [p[1] for p in pairs]
    hc, hm = _pair((Bsz, H, hp, N), torch.float32, 9) if init else (None,
                                                                    None)
    assert ssd_k.select_variant(hp, N, chunk) == variant
    out, c = _count(lambda: ssd_scan(*meta, chunk=chunk, init_state=hm,
                                     return_state=ret))
    _same_meta(ssd_scan(*cpu, chunk=chunk, init_state=hc, return_state=ret),
               out)
    assert c.launches == {"ssd_scan": {variant: 1}}
    cost = t_roof.ssd_cost(meta[0].shape, N, chunk, init, ret)
    assert c.kernel_flops == {"float32": cost.flops}
    assert c.kernel_bytes == cost.nbytes
    outs = out if ret else (out,)
    scratch = sum(t.numel() * t.element_size() for t in ssd_k.ssd_scratch(
        Bsz, S, H, hp, N, chunk, "meta").values()) \
        if variant == "parallel" else 0
    assert c.peak_bytes == sum(o.numel() * 4 for o in outs) + scratch
    ins = meta + ([hm] if init else [])
    _grads_reach(lambda *a: ssd_scan(*a[:5], chunk=chunk,
                                     init_state=a[5] if init else None,
                                     return_state=ret), ins)


@pytest.mark.parametrize("dtype,variant", [(torch.bfloat16, "tc"),
                                           (torch.float32, "simt")])
def test_gmm_meta_branch(dtype, variant):
    (xc, xm), (wc, wm) = (_pair((4, 24, 64), dtype, 0),
                          _pair((4, 64, 48), dtype, 1))
    assert gmm_k.select_variant(xm, wm) == variant
    out, c = _count(lambda: moe_gmm(xm, wm))
    _same_meta(moe_gmm(xc, wc), out)
    assert c.launches == {"moe_gmm": {variant: 1}}
    cost = t_roof.gmm_cost(xm.shape, wm.shape, dtype)
    assert c.kernel_flops == {cost.dtype: cost.flops}
    assert c.kernel_bytes == cost.nbytes
    _grads_reach(moe_gmm, (xm, wm))


# ---------------------------------------------------------------------------
# whole steps on meta
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_meta_step_runs_and_launches_every_kernel(arch, kind):
    cfg = get_smoke_config(arch)
    shape = SMALL[kind]
    c = dryrun.count_step(*dryrun.build_step(cfg, shape, "meta"))
    kernels = {k.split(":")[1] for k, v in c.items()
               if k.startswith("launches:") and v > 0}
    has_attn = cfg.attn is not None
    want = set()
    if kind == "decode":
        want |= {"decode_attention"} if has_attn else set()
    else:
        want |= {"flash_attention"} if has_attn else set()
        want |= {"ssd_scan"} if cfg.ssm is not None else set()
    want |= {"moe_gmm"} if cfg.moe is not None else set()
    assert kernels == want
    assert c["peak_bytes"] > 0 and c["bytes_accessed"] > 0
    assert c.get("flops:bfloat16", 0) > 0


def test_counted_prefill_flops_are_the_closed_form():
    """internlm2's smoke config: q, k, v, o and the SwiGLU products a
    layer, the flash kernel's causal pairs, the head at the last token."""
    cfg = get_smoke_config("internlm2-1.8b")
    a = cfg.attn
    B, S = 2, 96
    shape = t_shapes.InputShape("prefill_32k", "prefill", S, B)
    c = dryrun.count_step(*dryrun.build_step(cfg, shape, "meta"))
    d, f, T = cfg.d_model, cfg.d_ff, B * S
    proj = 2 * T * d * (2 * a.n_heads * a.head_dim
                        + 2 * a.n_kv_heads * a.head_dim)
    mlp = 3 * 2 * T * d * f
    attn = B * a.n_heads * (S * (S + 1) // 2) * 4 * a.head_dim
    vpad = -(-cfg.vocab // 128) * 128
    head = 2 * B * d * vpad
    assert c["flops:bfloat16"] == cfg.n_layers * (proj + mlp + attn) + head
    assert set(k for k in c if k.startswith("flops:")) == {"flops:bfloat16"}
    assert c["launches:flash_attention:simt"] == cfg.n_layers


def test_law_reproduces_a_bilinear_cost():
    def cost(p, b):
        return {"x": 7 + 3 * p + (11 + 5 * p) * b, "y": 2.5 * p}
    pts = {(p, b): cost(p, b) for p in (2, 3) for b in (1, 2)}
    assert dryrun._law(pts, 40, 256) == cost(40, 256)
    lin = {(p, 1): cost(p, 1) for p in (2, 3)}
    assert dryrun._law(lin, 17, 1) == cost(17, 1)


@pytest.mark.parametrize("arch,kind", [("internlm2-1.8b", "train"),
                                       ("internlm2-1.8b", "prefill"),
                                       ("mamba2-370m", "train"),
                                       ("mamba2-370m", "decode")])
def test_extrapolation_equals_the_full_depth_count(arch, kind):
    """Smoke configs deepened to 6 periods: the probes' law against one
    count at full depth and batch."""
    cfg = dataclasses.replace(get_smoke_config(arch), n_layers=6)
    shape = dataclasses.replace(SMALL[kind], batch=3)
    pts, law = dryrun._probe_points(cfg, shape, True)
    assert law == "bilinear(P,B)"
    counts = {}
    for p, b in pts:
        counts[p, b] = dryrun.count_step(*dryrun.build_step(
            dryrun._with_periods(cfg, p),
            dataclasses.replace(shape, batch=b), "meta"))
    got = dryrun._law(counts, cfg.n_periods, shape.batch)
    full = dryrun.count_step(*dryrun.build_step(cfg, shape, "meta"))
    exact = ["argument_bytes", "output_bytes"]
    if kind != "train":
        exact.append("bytes_accessed")
    else:
        # each period's gradient of its slice of the stacked parameters
        # is a zeros-filled buffer of the whole stack (select's backward),
        # so a training step's bytes grow with P squared: the law's count
        # is short of it, by less than TRAIN_BYTES_SHORT
        assert 0 < 1 - got["bytes_accessed"] / full["bytes_accessed"] \
            < TRAIN_BYTES_SHORT
    for k, v in full.items():
        if k.startswith(("flops:", "launches:")) or k in exact:
            assert got[k] == v, k
    assert got["peak_bytes"] == pytest.approx(full["peak_bytes"],
                                              rel=PEAK_TOL)


def _roofline_report():
    spec = importlib.util.spec_from_file_location(
        "roofline_report", ROOT / "benchmarks" / "roofline_report.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch,kind", [("mixtral-8x22b", "train"),
                                       ("jamba-1.5-large-398b", "prefill"),
                                       ("seamless-m4t-medium", "decode")])
def test_dryrun_one_on_meta_writes_a_record_the_report_reads(arch, kind,
                                                             tmp_path):
    rec = dryrun.dryrun_one(arch, SMALL[kind], device="meta", smoke=True,
                            verbose=False)
    assert rec["mesh"] == "1" and rec["n_devices"] == 1
    assert rec["collective_bytes_per_device"] == 0.0
    assert rec["roofline"]["collective_s"] == 0.0
    assert "measured" not in rec and rec["device"] == "meta"
    assert rec["flops_per_device"] == sum(rec["flops_by_dtype"].values())
    assert rec["hbm_per_device_gb"] > 0 and rec["fits_hbm"]
    path = tmp_path / f"{arch}__{SMALL[kind].name}.json"
    path.write_text(json.dumps(rec))
    report = _roofline_report()
    rows = report.load(str(tmp_path))
    table = report.fmt_table(rows)
    assert arch in table and SMALL[kind].name in table


def test_cli_needs_a_card_unless_meta(tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.main(["--arch", "mamba2-370m", "--shape", "long_500k",
                     "--out", str(tmp_path)])
    assert not list(tmp_path.iterdir())
    dryrun.main(["--arch", "mamba2-370m", "--shape", "long_500k",
                 "--device", "meta", "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "mamba2-370m__long_500k.json").read_text())
    assert rec["extrapolated"] == "linear(P)" and rec["fits_hbm"]
    with pytest.raises(ValueError, match="on meta or runs on the card"):
        dryrun.dryrun_one("mamba2-370m", "long_500k", device="cpu")
