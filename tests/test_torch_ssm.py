"""repro_torch's selective scan and Mamba mixer against the reference on
the same numpy inputs: the kernel's plain version (``ref.ssm_scan_ref``,
which ``ops.ssm_scan`` runs on CPU tensors) against the reference's
Pallas kernel in interpret mode and its oracle on the reference's sweep
shapes; its fused form (dt's bias and softplus, the gate by z) against
the unfused ops and the reference's composition of them; the carried-in
state against the reference model's ``_scan_full(h0=...)``; ``mamba_forward`` — fresh prefill, continuation,
prefill then decode — against the reference's on the Falcon-Mamba SMOKE
mixer carried across by the bridge."""
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_get_config
from repro.kernels.ssm_scan import ops as ref_ss_ops
from repro.kernels.ssm_scan import ref as ref_ss_ref
from repro.models import ssm as ref_ssm
from repro.models import transformer as ref_tf
from repro_torch import bridge
from repro_torch.configs.base import get_config
from repro_torch.kernels.ssm_scan import ops as ss_ops
from repro_torch.kernels.ssm_scan import ref as ss_ref
from repro_torch.models import ssm
from _torch_threads import one_intra_op_thread  # noqa: F401

ARCH = "falcon-mamba-7b"
# the reference's own kernel tolerances (tests/test_kernels.py): f32 sums
# in other orders over S steps; bf16 y rounded from f32 values that differ
# in their last bits
TOL = {"float32": 2e-4, "bfloat16": 4e-2}
H_TOL = 2e-4
# the reference's model tolerances (tests/test_models.py): associative
# scan against a sequential recurrence
MODEL_TOL = 3e-4
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SWEEP = [(2, 64, 128, 16), (1, 128, 256, 16), (2, 100, 96, 8), (1, 17, 64, 4)]


def _scan_inputs(seed, b, s, d_in, n, dtype="float32", with_h0=False):
    """u, dt, b, c, a, d_skip (and h0) as numpy f32, distributed as the
    reference's sweep draws them; u rounded to bf16 for a bf16 case."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((b, s, d_in), dtype=np.float32)
    if dtype == "bfloat16":
        u = u.astype(ml_dtypes.bfloat16).astype(np.float32)
    x = rng.standard_normal((b, s, d_in), dtype=np.float32)
    dt = (np.logaddexp(x, 0) * 0.1).astype(np.float32)
    bm = rng.standard_normal((b, s, n), dtype=np.float32)
    cm = rng.standard_normal((b, s, n), dtype=np.float32)
    a = -np.exp(rng.standard_normal((d_in, n), dtype=np.float32) * 0.3)
    dsk = np.ones(d_in, np.float32)
    out = [u, dt, bm, cm, a.astype(np.float32), dsk]
    if with_h0:
        out.append(rng.standard_normal((b, d_in, n), dtype=np.float32))
    return out


def _torch(arrays, dtype="float32"):
    u, *rest = [torch.from_numpy(x) for x in arrays]
    return [u.to(DTYPES[dtype][1])] + rest


def _jax(arrays, dtype="float32"):
    u, *rest = [jnp.asarray(x) for x in arrays]
    return [u.astype(DTYPES[dtype][0])] + rest


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("b,s,d_in,n", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scan_matches_reference_kernel_and_oracle(b, s, d_in, n, dtype):
    arrays = _scan_inputs(0, b, s, d_in, n, dtype)
    before = ss_ops.ssm_scan.launches
    y, h = ss_ops.ssm_scan(*_torch(arrays, dtype))     # CPU: the plain version
    assert ss_ops.ssm_scan.launches == before
    assert y.dtype == DTYPES[dtype][1] and y.shape == (b, s, d_in)
    assert h.dtype == torch.float32 and h.shape == (b, d_in, n)
    want = [ref_ss_ops.ssm_scan(*_jax(arrays, dtype)),      # Pallas, interpret
            ref_ss_ref.ssm_scan_ref(*_jax(arrays, dtype))]  # the oracle
    for wy, wh in want:
        np.testing.assert_allclose(_f32(y), _f32(wy), rtol=TOL[dtype],
                                   atol=TOL[dtype])
        np.testing.assert_allclose(h.numpy(), _f32(wh), rtol=H_TOL,
                                   atol=H_TOL)


def _fused_inputs(seed, b, s, d_in, dtype="float32"):
    """x_proj's raw dt rows times W_dt (centred where dt_proj's -4.6 bias
    puts softplus's bend), dt's bias and the gate's z, as numpy f32 (z
    rounded to bf16 for a bf16 case)."""
    rng = np.random.default_rng(seed)
    raw = (rng.standard_normal((b, s, d_in), dtype=np.float32) * 2
           + 4.0).astype(np.float32)
    bias = np.full(d_in, -4.6, np.float32) + rng.standard_normal(
        d_in, dtype=np.float32) * 0.5
    z = rng.standard_normal((b, s, d_in), dtype=np.float32) * 2
    if dtype == "bfloat16":
        z = z.astype(ml_dtypes.bfloat16).astype(np.float32)
    return raw, bias.astype(np.float32), z


# ragged S and D_in, N below a power of two
FUSED = [(2, 64, 128, 16), (1, 17, 37, 5), (3, 9, 96, 8), (2, 1, 64, 16)]


@pytest.mark.parametrize("b,s,d_in,n", FUSED)
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_plain_version_equals_unfused_ops(b, s, d_in, n, with_h0,
                                                dtype):
    """dt_bias, dt_softplus and z in the plain version are the mixer's own
    eager ops around the unfused scan: softplus(raw + bias) before it,
    y * silu(z) after it — bit for bit, y and h, through the wrapper (CPU:
    the plain version, no launch)."""
    u, _, bm, cm, a, dsk, *h0 = _torch(
        _scan_inputs(7, b, s, d_in, n, dtype, with_h0), dtype)
    h0 = h0[0] if h0 else None
    raw, bias, z = (torch.from_numpy(x) for x in _fused_inputs(8, b, s,
                                                                d_in, dtype))
    z = z.to(DTYPES[dtype][1])
    before = ss_ops.ssm_scan.launches
    got_y, got_h = ss_ops.ssm_scan(u, raw, bm, cm, a, dsk, h0, dt_bias=bias,
                                   dt_softplus=True, z=z)
    assert ss_ops.ssm_scan.launches == before
    dt = torch.clamp(raw + bias, min=0) + torch.log1p(
        torch.exp(-(raw + bias).abs()))
    y, h = ss_ref.ssm_scan_ref(u, dt, bm, cm, a, dsk, h0)
    want_y = y * torch.nn.functional.silu(z)
    assert got_y.dtype == DTYPES[dtype][1] and got_y.shape == (b, s, d_in)
    assert torch.equal(got_y, want_y) and torch.equal(got_h, h)
    # softplus without a bias is the same op on dt as handed in
    y_s, h_s = ss_ref.ssm_scan_ref(u, raw + bias, bm, cm, a, dsk, h0,
                                   dt_softplus=True)
    assert torch.equal(y_s, y) and torch.equal(h_s, h)


@pytest.mark.parametrize("b,s,d_in,n", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_scan_matches_jax_composition(b, s, d_in, n, dtype):
    """The fused plain version against the same numpy inputs through
    jax.nn.softplus(raw + bias) -> the reference's Pallas kernel
    (interpret) -> y * jax.nn.silu(z), and through its oracle."""
    arrays = _scan_inputs(9, b, s, d_in, n, dtype)
    raw, bias, z = _fused_inputs(10, b, s, d_in, dtype)
    u, _, bm, cm, a, dsk = _torch(arrays, dtype)
    zt = torch.from_numpy(z).to(DTYPES[dtype][1])
    y, h = ss_ops.ssm_scan(u, torch.from_numpy(raw), bm, cm, a, dsk,
                           dt_bias=torch.from_numpy(bias), dt_softplus=True,
                           z=zt)
    ju, _, jb, jc, ja, jd = _jax(arrays, dtype)
    jdt = jax.nn.softplus(jnp.asarray(raw) + jnp.asarray(bias))
    jz = jnp.asarray(z).astype(DTYPES[dtype][0])
    for fn in (ref_ss_ops.ssm_scan, ref_ss_ref.ssm_scan_ref):
        wy, wh = fn(ju, jdt, jb, jc, ja, jd)
        want = wy * jax.nn.silu(jz)
        assert want.dtype == DTYPES[dtype][0]
        np.testing.assert_allclose(_f32(y), _f32(want), rtol=TOL[dtype],
                                   atol=TOL[dtype])
        np.testing.assert_allclose(h.numpy(), _f32(wh), rtol=H_TOL,
                                   atol=H_TOL)


@functools.lru_cache(maxsize=None)
def _ref_mixer(dtype="float32"):
    """The reference's init_mamba on the Falcon-Mamba SMOKE config, as
    numpy leaves."""
    cfg = ref_get_config(ARCH, smoke=True)
    p = ref_ssm.init_mamba(jax.random.PRNGKey(0), cfg, DTYPES[dtype][0])
    return jax.tree.map(np.asarray, p)


def _mixer(dtype="float32"):
    return bridge.to_torch(_ref_mixer(dtype))


def test_h0_carry_in_matches_reference_scan_full():
    """The kernel's contract with h0 — the recurrence started from the
    carried state — against the reference model's associative scan that
    adds cum_decay * h0 afterwards: equal by linearity, up to rounding."""
    rcfg, cfg = ref_get_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    np_p = _ref_mixer()
    p = _mixer()
    rng = np.random.default_rng(1)
    b, s = 2, 12
    u = rng.standard_normal((b, s, cfg.ssm_d_inner), dtype=np.float32)
    h0 = rng.standard_normal((b, cfg.ssm_d_inner, cfg.ssm_state),
                             dtype=np.float32)
    want_y, want_h = ref_ssm._scan_full(rcfg, np_p, jnp.asarray(u),
                                        h0=jnp.asarray(h0))
    ut = torch.from_numpy(u)
    raw, bm, cm = ssm._ssm_params(cfg, p, ut)
    fused = {"dt_bias": p["dt_proj"]["b"].float(), "dt_softplus": True}
    got_y, got_h = ss_ops.ssm_scan(ut, raw, bm, cm, -torch.exp(p["a_log"]),
                                   p["d_skip"], torch.from_numpy(h0),
                                   **fused)
    np.testing.assert_allclose(got_y.numpy(), _f32(want_y), rtol=H_TOL,
                               atol=H_TOL)
    np.testing.assert_allclose(got_h.numpy(), _f32(want_h), rtol=H_TOL,
                               atol=H_TOL)
    # and a split scan carrying h equals the whole one
    y1, h1 = ss_ref.ssm_scan_ref(ut[:, :5], raw[:, :5], bm[:, :5],
                                 cm[:, :5], -torch.exp(p["a_log"]),
                                 p["d_skip"], torch.from_numpy(h0), **fused)
    y2, h2 = ss_ref.ssm_scan_ref(ut[:, 5:], raw[:, 5:], bm[:, 5:],
                                 cm[:, 5:], -torch.exp(p["a_log"]),
                                 p["d_skip"], h1, **fused)
    torch.testing.assert_close(torch.cat([y1, y2], 1), got_y, rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(h2, got_h, rtol=1e-6, atol=1e-6)


def test_ssm_params_and_softplus_match_reference():
    """dt in f32 through jax.nn.softplus's exact form (torch's softplus
    returns x above 20) of the raw dt plus its bias, as the scan forms it;
    B and C as f32 slices of the projection."""
    x = np.linspace(-60, 60, 2001, dtype=np.float32)
    np.testing.assert_allclose(ss_ref.softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(x)), rtol=1e-6,
                               atol=1e-7)
    rcfg, cfg = ref_get_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    u = np.random.default_rng(2).standard_normal((2, 5, cfg.ssm_d_inner),
                                                 dtype=np.float32)
    want = ref_ssm._ssm_params(rcfg, _ref_mixer(), jnp.asarray(u))
    p = _mixer()
    raw, bm, cm = ssm._ssm_params(cfg, p, torch.from_numpy(u))
    got = (ss_ref.softplus(raw + p["dt_proj"]["b"].float()), bm, cm)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), _f32(w), rtol=1e-5, atol=1e-5)


def _assert_state(got, want, tol=MODEL_TOL):
    np.testing.assert_allclose(_f32(got["conv"]), _f32(want["conv"]),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(_f32(got["h"]), _f32(want["h"]), rtol=tol,
                               atol=tol)
    assert got["h"].dtype == torch.float32


@pytest.mark.parametrize("impl", ["auto", "reference"])
def test_mamba_forward_matches_reference(impl):
    """Fresh prefill; a continuation split at 7 of 16 (conv window and h
    carried in); prefill then one-token decode — outputs and states."""
    rcfg, cfg = ref_get_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    np_p, p = _ref_mixer(), _mixer()
    x = np.random.default_rng(3).standard_normal((2, 16, cfg.d_model),
                                                 dtype=np.float32)
    xt = torch.from_numpy(x)
    fwd = functools.partial(ssm.mamba_forward, cfg, p, impl=impl)

    want_y, want_st = ref_ssm.mamba_forward(rcfg, np_p, jnp.asarray(x))
    got_y, got_st = fwd(xt)
    np.testing.assert_allclose(got_y.numpy(), _f32(want_y), rtol=MODEL_TOL,
                               atol=MODEL_TOL)
    _assert_state(got_st, want_st)

    _, rst1 = ref_ssm.mamba_forward(rcfg, np_p, jnp.asarray(x[:, :7]))
    want_y2, want_st2 = ref_ssm.mamba_forward(rcfg, np_p,
                                              jnp.asarray(x[:, 7:]),
                                              state=rst1)
    _, st1 = fwd(xt[:, :7])
    got_y2, got_st2 = fwd(xt[:, 7:], state=st1)
    np.testing.assert_allclose(got_y2.numpy(), _f32(want_y2), rtol=MODEL_TOL,
                               atol=MODEL_TOL)
    np.testing.assert_allclose(got_y2.numpy(), got_y[:, 7:].numpy(),
                               rtol=MODEL_TOL, atol=MODEL_TOL)
    _assert_state(got_st2, want_st2)
    _assert_state(got_st2, got_st)

    _, rst = ref_ssm.mamba_forward(rcfg, np_p, jnp.asarray(x[:, :15]))
    want_dec, want_st3 = ref_ssm.mamba_forward(rcfg, np_p,
                                               jnp.asarray(x[:, 15:]),
                                               state=rst)
    _, st = fwd(xt[:, :15])
    got_dec, got_st3 = fwd(xt[:, 15:], state=st)
    assert got_dec.shape == (2, 1, cfg.d_model)
    np.testing.assert_allclose(got_dec.numpy(), _f32(want_dec),
                               rtol=MODEL_TOL, atol=MODEL_TOL)
    np.testing.assert_allclose(got_dec[:, 0].numpy(), got_y[:, -1].numpy(),
                               rtol=MODEL_TOL, atol=MODEL_TOL)
    _assert_state(got_st3, want_st3)


def test_mamba_forward_bf16_keeps_f32_state():
    """A bf16 mixer (the reference's bf16 init carried across): the conv
    window in bf16, h in f32, y in bf16, close to the reference's."""
    rcfg, cfg = ref_get_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    np_p, p = _ref_mixer("bfloat16"), _mixer("bfloat16")
    x = np.random.default_rng(4).standard_normal((2, 9, cfg.d_model),
                                                 dtype=np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    want_y, rst = ref_ssm.mamba_forward(rcfg, np_p, xj[:, :8])
    got_y, st = ssm.mamba_forward(cfg, p, xt[:, :8])
    want_d, rst = ref_ssm.mamba_forward(rcfg, np_p, xj[:, 8:], state=rst)
    got_d, st = ssm.mamba_forward(cfg, p, xt[:, 8:], state=st)
    assert got_y.dtype == got_d.dtype == st["conv"].dtype == torch.bfloat16
    assert st["h"].dtype == torch.float32
    # bf16 activations rounded at other points (silu, the conv sum)
    for g, w in ((got_y, want_y), (got_d, want_d), (st["h"], rst["h"])):
        np.testing.assert_allclose(_f32(g), _f32(w), rtol=5e-2, atol=5e-2)


def test_bridge_keeps_a_log_and_d_skip_f32_in_a_bf16_model():
    """The reference's bf16 init carried across leaf for leaf: bf16 leaves
    bit for bit (ml_dtypes' bfloat16 through uint16), a_log and d_skip
    f32; the port's own bf16 init has the same dtypes."""
    cfg = get_config(ARCH, smoke=True)
    np_p = _ref_mixer("bfloat16")
    got = bridge.to_torch(np_p)
    own = ssm.init_mamba(torch.Generator().manual_seed(0), cfg,
                         torch.bfloat16)
    for (path, g), (_, w), (_, o) in zip(
            bridge.tree_leaves_with_path(got),
            bridge.tree_leaves_with_path(np_p),
            bridge.tree_leaves_with_path(own), strict=True):
        f32 = path[-1] in ("a_log", "d_skip")
        assert g.dtype == o.dtype == (torch.float32 if f32
                                      else torch.bfloat16), path
        assert np.array_equal(_f32(g), w.astype(np.float32)), path


def test_init_mamba_distributions():
    cfg = get_config(ARCH, smoke=True)
    p = ssm.init_mamba(torch.Generator().manual_seed(0), cfg, torch.float32)
    want = _ref_mixer()
    for (gp, g), (wp, w) in zip(bridge.tree_leaves_with_path(p),
                                bridge.tree_leaves_with_path(want),
                                strict=True):
        assert gp == wp and tuple(g.shape) == w.shape
    assert abs(float(p["conv_w"].std()) * cfg.ssm_conv ** 0.5 - 1) < 0.1
    assert abs(float(p["dt_proj"]["w"].std())
               * cfg.resolved_dt_rank ** 0.5 - 1) < 0.1
    assert bool((p["dt_proj"]["b"] == -4.6).all())
    # log(1..N): XLA's vectorized log and torch's differ by an ulp
    np.testing.assert_allclose(p["a_log"].numpy(), want["a_log"], rtol=1e-6)
    assert bool((p["d_skip"] == 1).all()) and bool((p["conv_b"] == 0).all())


def test_scan_wrapper_rejects_bad_inputs():
    u, dt, b, c, a, dsk, h0 = _torch(_scan_inputs(5, 1, 4, 8, 4,
                                                  with_h0=True))
    before = ss_ops.ssm_scan.launches
    with pytest.raises(ValueError, match="dt must be"):
        ss_ops.ssm_scan(u, dt[:, :3], b, c, a, dsk)
    with pytest.raises(ValueError, match="a must be"):
        ss_ops.ssm_scan(u, dt, b, c, a[:, :3], dsk)
    with pytest.raises(ValueError, match="h0 must be"):
        ss_ops.ssm_scan(u, dt, b, c, a, dsk, h0[:, :4])
    with pytest.raises(ValueError, match="u must be"):
        ss_ops.ssm_scan(u[0], dt, b, c, a, dsk)
    with pytest.raises(TypeError, match="u must be"):
        ss_ops.ssm_scan(u.double(), dt, b, c, a, dsk)
    with pytest.raises(TypeError, match="dt must be float32"):
        ss_ops.ssm_scan(u, dt.to(torch.bfloat16), b, c, a, dsk)
    with pytest.raises(TypeError, match="h0 must be float32"):
        ss_ops.ssm_scan(u, dt, b, c, a, dsk, h0.double())
    with pytest.raises(ValueError, match="empty"):
        ss_ops.ssm_scan(u[:, :0], dt[:, :0], b[:, :0], c[:, :0], a, dsk)
    with pytest.raises(ValueError, match="impl"):
        ssm.mamba_forward(get_config(ARCH, smoke=True), {}, u,
                          impl="kernel")
    with pytest.raises(ValueError, match="dt_bias must be"):
        ss_ops.ssm_scan(u, dt, b, c, a, dsk, dt_bias=dsk[:7])
    with pytest.raises(TypeError, match="dt_bias must be float32"):
        ss_ops.ssm_scan(u, dt, b, c, a, dsk, dt_bias=dsk.double())
    with pytest.raises(ValueError, match="z must be"):
        ss_ops.ssm_scan(u, dt, b, c, a, dsk, z=u[:, :2])
    with pytest.raises(TypeError, match="z must be u's dtype"):
        ss_ops.ssm_scan(u, dt, b, c, a, dsk, z=u.to(torch.bfloat16))
    assert ss_ops.ssm_scan.launches == before


def test_ssm_states_bridge_from_reference():
    """lm_states_from_reference on an SSM stack: {conv, h} per layer, no
    idx, in the reference's dtypes."""
    rcfg, cfg = ref_get_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    rst = jax.tree.map(np.asarray,
                       ref_tf.init_states(rcfg, 2, 5, jnp.bfloat16))
    got = bridge.lm_states_from_reference(rst, cfg)
    assert len(got) == cfg.num_layers
    for st in got:
        assert set(st) == {"conv", "h"}
        assert st["conv"].dtype == torch.bfloat16
        assert tuple(st["conv"].shape) == (2, cfg.ssm_conv - 1,
                                           cfg.ssm_d_inner)
        assert st["h"].dtype == torch.float32
        assert tuple(st["h"].shape) == (2, cfg.ssm_d_inner, cfg.ssm_state)


def test_prefill_state_holds_no_view_of_the_sequence():
    """The carried conv window is its own (B, cw - 1, d_in) tensor: a view
    of the prefill's (B, S + cw - 1, d_in) buffer would keep that alive in
    every layer's state (16 GiB at Falcon-Mamba-7B's width, B 8, S 1024,
    f32)."""
    cfg = get_config(ARCH, smoke=True)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 40, cfg.d_model), dtype=np.float32))
    _, st = ssm.mamba_forward(cfg, _mixer(), x)
    for key in ("conv", "h"):
        t = st[key]
        assert t.untyped_storage().nbytes() == t.numel() * t.element_size()
    _, st = ssm.mamba_forward(cfg, _mixer(), x[:, :1], state=st)   # decode
    assert st["conv"].shape == (2, cfg.ssm_conv - 1, cfg.ssm_d_inner)
