"""Port parity, the Mamba-2 SSD mixer (``repro_torch.models.ssd``)
against the JAX package's ``repro.models.ssd``: the causal conv and its
decode step, the chunked scan, the one-token recurrence step, softplus
and the gated norm. Same numpy inputs from a seed, f32 throughout.

Tolerances: within 1e-4 of max |out| (the plain einsums and sums run in
other orders than XLA's). The port's chunked form equals its own
stepwise recurrence (the reference's contract) within 1e-4 of max |y|
and is pad-invariant; at L = 128 with one chunk of 128, where the
reference's chunked form overflows to NaN, the port's is finite and
within 1e-4 of the reference's stepwise loop.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssd as jssd
from repro_torch.models import ssd as tssd

TOL = 1e-4      # of max |out|


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    """max |got - want| <= tol * max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.isfinite(got).all() and np.isfinite(want).all()
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * scale, (err, scale)


def _softplus(a):
    return np.logaddexp(a, 0).astype(np.float32)


def scan_inputs(seed, b, length, g, hg, p, n, a_scale=0.1):
    """x, dt (softplus of a normal), a_log, B, C, D for the scan."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return (normal(b, length, g, hg, p),
            _softplus(normal(b, length, g, hg)),
            normal(g, hg) * np.float32(a_scale),
            normal(b, length, g, n), normal(b, length, g, n),
            (normal(g, hg) * 0.5 + 1).astype(np.float32))


def stepwise(mod, x, dt, a_log, b_in, c_in, d_skip, h0=None):
    """``mod``'s decode step applied token by token: (y (B, L, ...),
    final state). ``mod`` is either package's ssd module, the inputs its
    arrays."""
    stack = jnp.stack if mod is jssd else torch.stack
    b, length, g, hg, p = x.shape
    n = b_in.shape[-1]
    h = h0
    if h is None:
        h = (jnp.zeros((b, g, hg, p, n), jnp.float32) if mod is jssd else
             torch.zeros((b, g, hg, p, n)))
    ys = []
    for t in range(length):
        y, h = mod.ssd_decode_step(h, x[:, t], dt[:, t], a_log, b_in[:, t],
                                   c_in[:, t], d_skip)
        ys.append(y)
    return stack(ys, 1), h


# ---------------------------------------------------------------------------
# the conv, softplus, the gated norm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv1d_matches_jax(dtype):
    """The W = 4 depthwise causal conv over (B, L, CH), with its bias:
    f32 within 1e-4 of max |out|; at bf16 (f32 sums, one cast) equal but
    for a bf16 rounding of the last bit."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 11, 24)).astype(np.float32)
    w = (rng.standard_normal((4, 24)) / 2).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    want = np.asarray(jssd.causal_conv1d(jx, jnp.asarray(w), jnp.asarray(b))
                      .astype(jnp.float32))
    tx = _t(x).to(getattr(torch, dtype))
    got = tssd.causal_conv1d(tx, _t(w), _t(b))
    assert got.dtype == tx.dtype
    _close(got.float().numpy(), want, TOL if dtype == "float32" else 1e-2)


def test_conv1d_step_matches_jax_and_conv():
    """One decode step of the conv against JAX's (state and output), and
    the steps chained over a sequence equal the whole-sequence conv."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 9, 16)).astype(np.float32)
    w = rng.standard_normal((4, 16)).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    state = np.zeros((3, 3, 16), np.float32)
    jstate, tstate, outs = jnp.asarray(state), _t(state), []
    for t in range(9):
        jstate, jout = jssd.conv1d_step(jstate, jnp.asarray(x[:, t]),
                                        jnp.asarray(w), jnp.asarray(b))
        tstate, tout = tssd.conv1d_step(tstate, _t(x[:, t]), _t(w), _t(b))
        _close(tout.numpy(), jout)
        np.testing.assert_array_equal(tstate.numpy(), np.asarray(jstate))
        outs.append(tout)
    _close(torch.stack(outs, 1).numpy(),
           tssd.causal_conv1d(_t(x), _t(w), _t(b)).numpy())


def test_softplus_matches_jax():
    x = np.concatenate([np.linspace(-30, 30, 301),
                        np.random.default_rng(2).standard_normal(200) * 3]
                       ).astype(np.float32)
    np.testing.assert_allclose(tssd.softplus(_t(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=2e-7, atol=1e-30)


def test_gated_rms_norm_matches_jax():
    rng = np.random.default_rng(3)
    y = rng.standard_normal((2, 5, 32)).astype(np.float32)
    z = rng.standard_normal((2, 5, 32)).astype(np.float32)
    g = (rng.standard_normal(32) * 0.5).astype(np.float32)
    want = jssd.gated_rms_norm(jnp.asarray(y), jnp.asarray(z),
                               jnp.asarray(g), 1e-5)
    _close(tssd.gated_rms_norm(_t(y), _t(z), _t(g), 1e-5).numpy(), want)


# ---------------------------------------------------------------------------
# the scan and the recurrence step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("length,chunk", [(16, 4), (16, 16), (21, 4),
                                          (21, 16), (7, 16)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_jax(length, chunk, with_h0):
    """``ssd_chunked`` against JAX's, output and final state: several
    chunks, one chunk, ragged lengths (tail-padded), a chunk longer than
    the sequence, from a zero or a carried state; 2 groups."""
    b, g, hg, p, n = 2, 2, 3, 4, 8
    args = scan_inputs(length * 10 + chunk, b, length, g, hg, p, n)
    h0 = (np.random.default_rng(5).standard_normal((b, g, hg, p, n))
          .astype(np.float32) if with_h0 else None)
    jy, jh = jssd.ssd_chunked(*map(jnp.asarray, args), chunk=chunk,
                              h0=None if h0 is None else jnp.asarray(h0))
    ty, th = tssd.ssd_chunked(*map(_t, args), chunk=chunk,
                              h0=None if h0 is None else _t(h0))
    assert ty.dtype == torch.float32 and th.dtype == torch.float32
    _close(ty.numpy(), jy)
    _close(th.numpy(), jh)


def test_ssd_decode_step_matches_jax():
    b, g, hg, p, n = 3, 2, 4, 8, 16
    rng = np.random.default_rng(6)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    args = (normal(b, g, hg, p, n), normal(b, g, hg, p),
            _softplus(normal(b, g, hg)), normal(g, hg) * 0.1,
            normal(b, g, n), normal(b, g, n), normal(g, hg))
    jy, jh = jssd.ssd_decode_step(*map(jnp.asarray, args))
    ty, th = tssd.ssd_decode_step(*map(_t, args))
    _close(ty.numpy(), jy)
    _close(th.numpy(), jh)


@pytest.mark.parametrize("length,chunk", [(12, 4), (40, 16), (33, 8)])
def test_ssd_chunked_equals_stepwise(length, chunk):
    """The reference's contract on the port: the chunked scan equals the
    token-by-token recurrence, output and final state."""
    args = list(map(_t, scan_inputs(length + chunk, 2, length, 1, 3, 4, 8)))
    y, h = tssd.ssd_chunked(*args, chunk=chunk)
    y_step, h_step = stepwise(tssd, *args)
    _close(y.numpy(), y_step.numpy())
    _close(h.numpy(), h_step.numpy())


def test_ssd_chunked_pad_invariance():
    """A length the chunk does not divide (10 over chunks of 4, padded to
    12) gives the output of one chunk of 10."""
    args = list(map(_t, scan_inputs(9, 1, 10, 1, 2, 4, 4)))
    y4, h4 = tssd.ssd_chunked(*args, chunk=4)
    y10, h10 = tssd.ssd_chunked(*args, chunk=10)
    _close(y4.numpy(), y10.numpy())
    _close(h4.numpy(), h10.numpy())


def test_ssd_chunked_finite_where_reference_overflows():
    """The repair. One chunk of 128 positions, 4 heads, a_log = 0 (A =
    -1) and dt = softplus(normal): above the diagonal the decay's
    exponent (a sum of dt over up to 127 steps, ~100) overflows f32
    ``exp``, and the reference's ``inf * 0`` leaves NaN in its chunked
    output, though its own stepwise loop is finite. The port's chunked
    form is finite and within 1e-4 of the reference's stepwise loop
    (output and state); at a chunk of 16, where the reference is finite,
    the two chunked forms agree."""
    b, length, g, hg, p, n = 1, 128, 1, 4, 8, 8
    args = list(scan_inputs(0, b, length, g, hg, p, n, a_scale=0.0))
    sums = args[1].sum(1)[0, 0]
    assert sums.min() > 89, sums      # every head's exponent overflows
    jargs = list(map(jnp.asarray, args))
    jy, _ = jssd.ssd_chunked(*jargs, chunk=128)
    assert np.isnan(np.asarray(jy)).any()
    y_step, h_step = stepwise(jssd, *jargs)
    ty, th = tssd.ssd_chunked(*map(_t, args), chunk=128)
    assert torch.isfinite(ty).all() and torch.isfinite(th).all()
    _close(ty.numpy(), y_step)
    _close(th.numpy(), h_step)
    jy16, jh16 = jssd.ssd_chunked(*jargs, chunk=16)
    ty16, th16 = tssd.ssd_chunked(*map(_t, args), chunk=16)
    _close(ty16.numpy(), jy16)
    _close(th16.numpy(), jh16)
