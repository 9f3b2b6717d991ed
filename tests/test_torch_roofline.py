"""The port's roofline (repro_torch/roofline/analysis.py) against the
reference's (repro/roofline/analysis.py), and the meta routes the
dry-run counts through:

  * ``model_flops`` equals the reference's for every arch and shape;
    ``Roofline``'s terms, properties and ``as_dict`` keys are the
    reference's formulas on an H100's figures;
  * ``OpCounter`` counts the matmul-class FLOPs and the bytes of every
    non-view op; ``collective_bytes`` sums a record by the reference's
    five kinds;
  * each kernel's wrapper on meta tensors returns the plain version's
    shapes and dtypes and records one launch's cost: flash_attention's
    FLOPs the plain version's (FlopCounterMode's count of its two
    products), every kernel's bytes its inputs and outputs once, the
    FLOPs of ssm_scan and the two FedDPC kernels their bounds' formulas;
  * ``ssm_scan_ref`` on meta, one counted op, records exactly what
    walking its S steps and their backward counts (S = 4 and 8);
  * moe_ep's bucket ranks (an index_add count, not bincount) are the
    bincount form's, bit for bit, and attention.sdpa's "auto" takes the
    kernel on meta.
"""
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs.base import get_config as ref_get_config
from repro.configs.shapes import SHAPES as REF_SHAPES
from repro.roofline import analysis as ref_analysis
from repro_torch import kernels
from repro_torch.configs.base import all_arch_ids, get_config
from repro_torch.configs.shapes import SHAPES, get_shape
from repro_torch.kernels.feddpc_project import ops as fd_ops
from repro_torch.kernels.feddpc_project import ref as fd_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.ssm_scan import ops as ss_ops
from repro_torch.kernels.ssm_scan import ref as ss_ref
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import attention, moe_ep
from repro_torch.roofline import analysis
from _torch_threads import one_intra_op_thread  # noqa: F401

META = torch.device("meta")


@pytest.mark.parametrize("arch", all_arch_ids())
def test_model_flops_equals_the_references(arch):
    assert set(SHAPES) == set(REF_SHAPES)
    for shape in SHAPES:
        assert analysis.model_flops(get_config(arch), get_shape(shape)) == \
            ref_analysis.model_flops(ref_get_config(arch), REF_SHAPES[shape])


def _pair(**kw):
    fields = dict(arch="a", shape="s", mesh="m", chips=256, flops=3.0e12,
                  hbm_bytes=2.0e10,
                  coll_bytes={"all-reduce": 4 * 10 ** 8, "all-gather": 7},
                  model_flops_total=1.5e14, memory_per_device=9.0e9)
    fields.update(kw)
    return analysis.Roofline(**fields), ref_analysis.Roofline(**fields)


@pytest.mark.parametrize("flops,hbm", [(3.0e12, 2.0e10), (1e9, 5e12),
                                       (1e6, 1e3)])
def test_roofline_terms_are_the_references_on_an_h100(flops, hbm):
    port, ref = _pair(flops=flops, hbm_bytes=hbm)
    assert set(port.as_dict()) == set(ref.as_dict())
    assert port.t_compute == flops / mesh_mod.PEAK_FLOPS_BF16
    assert port.t_memory == hbm / mesh_mod.HBM_BW
    assert port.t_collective == port.coll_total / mesh_mod.NVLINK_BW
    assert (mesh_mod.PEAK_FLOPS_BF16, mesh_mod.HBM_BW,
            mesh_mod.NVLINK_BW) == (989e12, 3.35e12, 450e9)
    assert port.coll_total == ref.coll_total
    assert port.useful_fraction == ref.useful_fraction
    terms = {"compute": port.t_compute, "memory": port.t_memory,
             "collective": port.t_collective}
    assert port.dominant == max(terms, key=terms.get)
    d = port.as_dict()
    assert (d["t_compute_s"], d["t_memory_s"], d["t_collective_s"]) == (
        port.t_compute, port.t_memory, port.t_collective)
    report = analysis.roofline_report(port)
    assert "NVIDIA H100 80GB HBM3 at 700 W" in report
    assert len(report.splitlines()) == len(
        ref_analysis.roofline_report(ref).splitlines())


def test_collective_bytes_sums_by_the_references_kinds():
    assert analysis.COLLECTIVE_OPS == ref_analysis._COLLECTIVE_OPS
    got = analysis.collective_bytes([("all-reduce", 8), ("all-gather", 3),
                                     ("all-reduce", 2)])
    assert got == {"all-gather": 3, "all-reduce": 10, "reduce-scatter": 0,
                   "all-to-all": 0, "collective-permute": 0}


def test_op_counter_counts_matmuls_and_non_view_bytes():
    a = torch.empty(8, 16, device=META)
    b = torch.empty(16, 4, device=META)
    with analysis.OpCounter() as c:
        y = a @ b                        # mm: reads a, b; writes y
        v = y.view(32)                   # a view: nothing
        v.add_(1.0)                      # reads and writes y's 32 floats
        z = torch.empty(5, device=META)  # an allocation: nothing
        z.copy_(v[:5])                   # writes z, reads the slice
    assert c.count.flops == 2 * 8 * 16 * 4
    assert c.count.bytes == (4 * (8 * 16 + 16 * 4 + 32) + 4 * 64
                             + 4 * 10)
    assert c.count.collectives == [] and c.count.kernels == []


def _attention_inputs(device, b=2, sq=5, sk=7, h=4, kv=2, d=8,
                      dtype=torch.float32, all_visible=False):
    g = torch.Generator().manual_seed(0)
    mk = lambda *s: torch.randn(*s, generator=g).to(dtype)
    q, k, v = mk(b, sq, h, d), mk(b, sk, kv, d), mk(b, sk, kv, d)
    qp = torch.arange(sk - sq, sk, dtype=torch.int32)[None].expand(b, sq)
    if all_visible:                    # an encoder's or cross-attention's
        qp = torch.full((b, sq), sk, dtype=torch.int32)
    kp = torch.arange(sk, dtype=torch.int32)[None].expand(b, sk)
    return [t.to(device) for t in (q, k, v, qp, kp)]


@pytest.mark.parametrize("sq,sk,window,all_visible", [
    (5, 7, 0, False), (7, 7, 0, False), (7, 7, 3, False), (1, 7, 4, False),
    (7, 7, 0, True), (5, 7, 0, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attentions_meta_route_counts_the_visible_pairs(
        dtype, sq, sk, window, all_visible):
    """The meta route's FLOPs are 4·D·H for each visible (query, key)
    pair, counted as chip_smoke.py counts the kernel's bound (its
    ``_visible`` mask, written out here) on the serving steps' layout:
    keys at 0 .. Sk-1, the queries the last Sq positions (a causal
    prefill, Sq == Sk; a decode, Sq = 1), with and without a window; or
    every pair where the caller says every key is visible (an
    encoder's self- and cross-attention)."""
    cpu = _attention_inputs("cpu", sq=sq, sk=sk, dtype=dtype,
                            all_visible=all_visible)
    meta = _attention_inputs(META, sq=sq, sk=sk, dtype=dtype,
                             all_visible=all_visible)
    want = fa_ref.attention_ref(*cpu, window=window)
    with kernels.meta_costs() as recs:
        got = fa_ops.flash_attention(*meta, window=window,
                                     all_visible=all_visible)
    assert (got.shape, got.dtype, got.device) == (want.shape, want.dtype,
                                                  META)
    q, k, v, qp, kp = cpu
    ok = (kp[:, None, :] <= qp[:, :, None]) & (kp[:, None, :] >= 0)
    if window:
        ok &= (qp[:, :, None] - kp[:, None, :]) < window
    b, _, h, d = q.shape
    (name, flops, moved), = recs
    assert name == "flash_attention"
    assert flops == 4 * d * h * int(ok.sum())
    with FlopCounterMode(display=False) as fc:      # every pair
        fa_ref.attention_ref(*cpu, window=window)
    assert flops <= fc.get_total_flops()
    assert moved == (kernels.nbytes(q, k, v, want)
                     + 4 * (qp.numel() + kp.numel()))
    assert fa_ops.flash_attention.launches == 0


def _scan_inputs(device, b=2, s=6, d_in=5, n=3, udt=torch.float32,
                 h0=False, fused=False):
    g = torch.Generator().manual_seed(1)
    mk = lambda *sh, dt=torch.float32: torch.randn(*sh, generator=g).to(
        dt).to(device)
    out = dict(u=mk(b, s, d_in, dt=udt), dt=mk(b, s, d_in), b=mk(b, s, n),
               c=mk(b, s, n), a=-mk(d_in, n).abs(), d_skip=mk(d_in),
               h0=mk(b, d_in, n) if h0 else None)
    kw = {}
    if fused:
        kw = dict(dt_bias=mk(d_in), dt_softplus=True, z=mk(b, s, d_in,
                                                           dt=udt))
    return out, kw


@pytest.mark.parametrize("fused,h0,udt", [
    (False, False, torch.float32), (True, True, torch.bfloat16)])
def test_ssm_scans_meta_route_records_its_bounds_formula(fused, h0, udt):
    cpu, kw = _scan_inputs("cpu", udt=udt, h0=h0, fused=fused)
    meta, kw_meta = _scan_inputs(META, udt=udt, h0=h0, fused=fused)
    want = ss_ref.ssm_scan_ref(*cpu.values(), **kw)
    with kernels.meta_costs() as recs:
        got = ss_ops.ssm_scan(*meta.values(), **kw_meta)
    for g, w in zip(got, want):
        assert (g.shape, g.dtype, g.device) == (w.shape, w.dtype, META)
    (name, flops, moved), = recs
    b, s, d_in = cpu["u"].shape
    n = cpu["b"].shape[-1]
    elems = b * s * d_in
    assert name == "ssm_scan"
    assert flops == 6 * elems * n + 3 * elems + (6 * elems if fused else 0)
    inputs = [t for t in list(cpu.values()) + list(kw.values())
              if torch.is_tensor(t)]
    assert moved == kernels.nbytes(*inputs, *want)


def test_the_feddpc_kernels_meta_routes_record_their_bounds():
    k, n = 3, 11
    g = torch.Generator().manual_seed(2)
    d, p, w = (torch.randn(*s, generator=g) for s in ((k, n), (n,), (n,)))
    coefs, scales = torch.rand(k, generator=g), torch.rand(k, generator=g)
    dm, pm, wm, cm, sm = (t.to(META) for t in (d, p, w, coefs, scales))
    with kernels.meta_costs() as recs:
        dots = fd_ops.feddpc_dots(dm, pm)
        new_w, dt = fd_ops.feddpc_batched_epilogue(dm, pm, wm, cm, sm, 0.5)
    want_dots = fd_ref.dots_ref(d, p)
    want_w, want_dt = fd_ref.batched_epilogue_ref(d, p, w, coefs, scales,
                                                  0.5)
    for got, want in ((dots, want_dots), (new_w, want_w), (dt, want_dt)):
        assert (got.shape, got.dtype, got.device) == (want.shape,
                                                      want.dtype, META)
    assert recs == [
        ("feddpc_dots", 4 * k * n + 2 * n,
         kernels.nbytes(d, p, want_dots)),
        ("feddpc_batched_epilogue", 4 * k * n + 3 * n,
         kernels.nbytes(d, p, w, coefs, scales, want_w, want_dt))]
    assert fd_ops.feddpc_dots.launches == 0
    # the wrappers without a meta route refuse meta tensors
    with pytest.raises(ValueError, match="meta"):
        fd_ops.feddpc_guard_dots(dm, pm)


def _walk_or_counted(s, counted, grad_h, fused, udt=torch.float32):
    ins, kw = _scan_inputs(META, s=s, udt=udt, fused=fused)
    for t in list(ins.values()) + list(kw.values()):
        if torch.is_tensor(t):
            t.requires_grad_(True)
    wrt = [t for t in list(ins.values()) + list(kw.values())
           if torch.is_tensor(t)]
    with analysis.OpCounter() as c:
        if counted:
            y, h = ss_ref.ssm_scan_ref(*ins.values(), **kw)
        else:
            y, h = ss_ref._walk(*ins.values(), kw.get("dt_bias"),
                                kw.get("dt_softplus", False), kw.get("z"))
        outs = [y, h] if grad_h else [y]
        grads = torch.autograd.grad(outs, wrt,
                                    [torch.empty_like(o) for o in outs])
    return (c.count.flops, c.count.bytes,
            [(t.shape, t.dtype) for t in (y, h, *grads)])


@pytest.mark.parametrize("s", [4, 8])
@pytest.mark.parametrize("fused,grad_h,udt", [
    (False, False, torch.float32), (True, False, torch.bfloat16),
    (True, True, torch.float32)])
def test_the_plain_scan_on_meta_counts_what_its_walk_counts(s, fused,
                                                            grad_h, udt):
    walk = _walk_or_counted(s, False, grad_h, fused, udt)
    counted = _walk_or_counted(s, True, grad_h, fused, udt)
    assert counted == walk


def test_the_plain_scan_on_meta_without_a_counter_and_on_the_cpu():
    """Outside a counter the counted op records nothing and still gives
    the shapes; on CPU tensors ssm_scan_ref walks as it always did."""
    ins, kw = _scan_inputs(META, fused=True)
    y, h = ss_ref.ssm_scan_ref(*ins.values(), **kw)
    assert y.device == META and h.shape == (2, 5, 3)
    cpu, kw = _scan_inputs("cpu", fused=True)
    y, h = ss_ref.ssm_scan_ref(*cpu.values(), **kw)
    y2, h2 = ss_ref._walk(*cpu.values(), kw["dt_bias"], True, kw["z"])
    assert torch.equal(y, y2) and torch.equal(h, h2)


def test_bucket_ranks_are_bincounts_bit_for_bit():
    rng = np.random.RandomState(5)
    for buckets, n in ((5, 40), (9, 1), (3, 200)):
        key = torch.from_numpy(rng.randint(0, buckets, n)).long()
        order = torch.argsort(key, stable=True)
        counts = torch.bincount(key, minlength=buckets)
        starts = torch.cumsum(counts, 0) - counts
        ranked = torch.arange(n) - starts[key[order]]
        want = torch.zeros_like(key).scatter(0, order, ranked)
        assert torch.equal(moe_ep._bucket_ranks(key, buckets), want)
        got = moe_ep._bucket_ranks(key.to(META), buckets)
        assert got.shape == want.shape and got.dtype == want.dtype


def test_sdpa_auto_takes_the_kernel_on_meta_and_plain_on_the_cpu():
    meta = _attention_inputs(META)
    with kernels.meta_costs() as recs:
        attention.sdpa(*meta)
    assert [r[0] for r in recs] == ["flash_attention"]
    cpu = _attention_inputs("cpu")
    with kernels.meta_costs() as recs:
        out = attention.sdpa(*cpu)
    assert recs == [] and out.device.type == "cpu"
