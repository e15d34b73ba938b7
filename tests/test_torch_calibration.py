"""Port parity, the core's calibration half and the rest of the codec:
the same numpy inputs, made from a seed, through the JAX package's
functions and the port's. Integer work and the f32 formulas are
bit-equal: ``compression_percent``, ``ops_reduction_percent``,
``encoded_bytes``, ``tile_sparsity``, ``quantize_kv``, ``dequantize``,
``fake_quantize``, ``importance_mask``, ``clip_fraction`` and
``enhanced_sparsity``. ``soft_clipping`` values and gradients agree
within 1e-6; ``global_calibrate`` picks JAX's (l, h) from the same
sweep; Algorithm 1 (``learn_clipping_constants``) on the data of
``tests/test_clipping.py``'s test learns JAX's l and h, and its loss
history, within 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clipping as JC
from repro.core import quantize as JQ
from repro.core import sparqle as JS
from repro_torch.core import clipping as TC
from repro_torch.core import quantize as TQ
from repro_torch.core import sparqle as TS


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def _int8(rng, shape, lo=-128, hi=128):
    return rng.integers(lo, hi, shape).astype(np.int8)


def test_compression_and_ops_reduction_bit_equal():
    s = np.random.default_rng(0).random(257).astype(np.float32)
    s[:4] = [0.0, 0.25, 0.444, 1.0]
    for p in (8, 4):
        np.testing.assert_array_equal(_np(TS.compression_percent(s, p)),
                                      _np(JS.compression_percent(s, p)))
    np.testing.assert_array_equal(_np(TS.ops_reduction_percent(s)),
                                  _np(JS.ops_reduction_percent(s)))
    assert float(TS.compression_percent(0.618)) == \
        float(JS.compression_percent(0.618))


@pytest.mark.parametrize("shape", [(4096,), (8, 4096), (3, 5, 7)])
def test_encoded_bytes_equal(shape):
    for s in (0.0, 0.3, 0.444, 1.0):
        for p in (8, 4):
            assert TS.encoded_bytes(shape, s, p) == \
                JS.encoded_bytes(shape, s, p)


@pytest.mark.parametrize("seed,m,k,tm,tk", [(0, 32, 256, 16, 128),
                                            (1, 48, 64, 8, 16),
                                            (2, 16, 128, 16, 128)])
def test_tile_sparsity_bit_equal(seed, m, k, tm, tk):
    rng = np.random.default_rng(seed)
    pbm = rng.random((m, k)) < 0.002
    pbm[:tm, :tk] = False
    got = TS.tile_sparsity(torch.from_numpy(pbm), tm, tk)
    want = JS.tile_sparsity(jnp.asarray(pbm), tm, tk)
    assert _np(got).tobytes() == np.asarray(want).tobytes()
    assert 0.0 < float(got) < 1.0 or seed


@pytest.mark.parametrize("bits", [4, 2])
@pytest.mark.parametrize("dtype", [np.float32])
def test_quantize_kv_dequantize_fake_quantize_bit_equal(bits, dtype):
    rng = np.random.default_rng(bits)
    kv = (rng.standard_normal((3, 5, 2, 16)) * 3).astype(dtype)
    kv[0, 0, 0] = 0.0
    jt, tt = JQ.quantize_kv(jnp.asarray(kv), bits), TQ.quantize_kv(
        torch.from_numpy(kv), bits)
    for a, b in ((tt.q, jt.q), (tt.scale, jt.scale), (tt.zero, jt.zero)):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    assert tt.bits == jt.bits == bits
    np.testing.assert_array_equal(_np(TQ.dequantize(tt)),
                                  np.asarray(JQ.dequantize(jt)))
    x = (rng.standard_normal((6, 64)) * 5).astype(np.float32)
    for per_token in (True, False):
        np.testing.assert_array_equal(
            _np(TQ.fake_quantize(torch.from_numpy(x), 8, per_token)),
            np.asarray(JQ.fake_quantize(jnp.asarray(x), 8, per_token)))


@pytest.mark.parametrize("k_percent", [0.0, 10.0, 50.0, 75.0, 100.0])
def test_importance_mask_bit_equal(k_percent):
    rng = np.random.default_rng(int(k_percent))
    w = rng.standard_normal((96, 24)).astype(np.float32)
    w[10] = w[11]                         # a tie at the threshold's side
    got = TC.importance_mask(torch.from_numpy(w), k_percent)
    want = JC.importance_mask(jnp.asarray(w), k_percent)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("l,h", [(-8, 23), (-1, 16), (-64, 90), (-128, 127)])
def test_clip_fraction_and_enhanced_sparsity_bit_equal(l, h):
    rng = np.random.default_rng(-l + h)
    x = _int8(rng, (64, 48))
    mask = rng.random(48) < 0.5
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    xj, mj = jnp.asarray(x), jnp.asarray(mask)
    assert _np(TC.clip_fraction(xt, mt, l, h)).tobytes() == \
        np.asarray(JC.clip_fraction(xj, mj, l, h)).tobytes()
    for a, b in zip(TC.enhanced_sparsity(xt, mt, l, h),
                    JC.enhanced_sparsity(xj, mj, l, h)):
        assert _np(a).tobytes() == np.asarray(b).tobytes()
    np.testing.assert_array_equal(_np(TC.apply_clipping(xt, mt, l, h)),
                                  np.asarray(JC.apply_clipping(xj, mj, l, h)))


@pytest.mark.parametrize("tau", [0.01, 1.0, 2.0, 4.0])
def test_soft_clipping_values_and_gradients(tau):
    rng = np.random.default_rng(int(tau * 100))
    x = _int8(rng, (64, 16))
    mask = (rng.random(16) < 0.7).astype(np.float32)
    lh = np.array([-8.0, 23.0], np.float32)

    def jf(v):
        y, m = JC.soft_clipping(jnp.asarray(x), jnp.asarray(mask), v[0],
                                v[1], tau=tau)
        return jnp.sum(y ** 2) * 1e-4 - jnp.mean(m), (y, m)

    (jloss, (jy, jm)), jg = jax.value_and_grad(jf, has_aux=True)(
        jnp.asarray(lh))
    v = torch.tensor(lh, requires_grad=True)
    ty, tm = TC.soft_clipping(torch.from_numpy(x), torch.from_numpy(mask),
                              v[0], v[1], tau=tau)
    tloss = torch.sum(ty ** 2) * 1e-4 - torch.mean(tm)
    tloss.backward()
    np.testing.assert_allclose(_np(ty), np.asarray(jy), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(_np(tm), np.asarray(jm), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(_np(v.grad), np.asarray(jg), rtol=1e-6,
                               atol=1e-6)


def test_global_calibrate_picks_jax_lh():
    """A real sweep: per-token int8 activations of a seeded batch clipped
    on the least important half of a weight's columns, error the MSE of
    the product against the unclipped one, sparsity the clipped tensor's."""
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((64, 128)) * 2).astype(np.float32)
    w = rng.standard_normal((128, 32)).astype(np.float32)

    def jeval(l, h):
        q = JQ.quantize_activations(jnp.asarray(x)).q
        m = JC.importance_mask(jnp.asarray(w), 50.0)
        c = JC.apply_clipping(q, m, l, h)
        y0 = q.astype(jnp.float32) @ jnp.asarray(w)
        y1 = c.astype(jnp.float32) @ jnp.asarray(w)
        return float(jnp.mean((y1 - y0) ** 2)), float(
            JS.subprecision_sparsity(c))

    def teval(l, h):
        q = TQ.quantize_activations(torch.from_numpy(x)).q
        m = TC.importance_mask(torch.from_numpy(w), 50.0)
        c = TC.apply_clipping(q, m, l, h)
        y0 = q.float() @ torch.from_numpy(w)
        y1 = c.float() @ torch.from_numpy(w)
        return float(torch.mean((y1 - y0) ** 2)), float(
            TS.subprecision_sparsity(c))

    got, want = TC.global_calibrate(teval), JC.global_calibrate(jeval)
    assert (got.l, got.h) == (want.l, want.h)
    assert got.sparsity == want.sparsity
    np.testing.assert_allclose(got.error, want.error, rtol=1e-6)
    np.testing.assert_allclose(got.score, want.score, rtol=1e-6)
    # the tradeoff test's synthetic sweep too
    def fake(l, h):
        width = (-l) + (h - 15)
        return float(width ** 2) * 1e-4, min(1.0, 0.3 + width * 0.01)
    kw = dict(l_candidates=(-4, -16, -64), h_candidates=(19, 31, 79))
    got, want = TC.global_calibrate(fake, **kw), JC.global_calibrate(fake,
                                                                     **kw)
    assert (got.l, got.h, got.error, got.sparsity) == \
        (want.l, want.h, want.error, want.sparsity)


def algorithm1_setup():
    """``tests/test_clipping.py::test_algorithm1_learns_wider_bounds``'s
    data (numpy, from JAX's PRNG) and the port's callables over it."""
    data = np.asarray(jax.random.randint(jax.random.PRNGKey(0),
                                         (4, 32, 16), -40, 56,
                                         dtype=jnp.int8))
    return data


def _torch_callables(device):
    mask = torch.ones((16,), dtype=torch.float32, device=device)

    def apply_clip(cp, batch):
        y, m = TC.soft_clipping(batch, mask, cp["l"][0], cp["h"][0], tau=4.0)
        return y * 0.01, torch.mean(m)

    def apply_base(batch):
        return batch.float() * 0.01

    return apply_clip, apply_base


def test_learn_clipping_constants_matches_jax():
    data = algorithm1_setup()
    mask = jnp.ones((16,), jnp.float32)

    def japply_clip(cp, batch):
        y, m = JC.soft_clipping(batch, mask, cp["l"][0], cp["h"][0], tau=4.0)
        return y * 0.01, jnp.mean(m)

    def japply_base(batch):
        return batch.astype(jnp.float32) * 0.01

    jcp, jhist = JC.learn_clipping_constants(
        japply_clip, japply_base, jnp.asarray(data),
        JC.init_clip_params(1, l0=-1.0, h0=16.0), epochs=23, lr=1.0,
        alpha=0.5)
    apply_clip, apply_base = _torch_callables("cpu")
    tcp, thist = TC.learn_clipping_constants(
        apply_clip, apply_base, torch.from_numpy(data.copy()),
        TC.init_clip_params(1, l0=-1.0, h0=16.0), epochs=23, lr=1.0,
        alpha=0.5)
    for k in ("l", "h"):
        np.testing.assert_allclose(_np(tcp[k]), np.asarray(jcp[k]),
                                   atol=1e-4, rtol=0)
    assert len(thist) == len(jhist) == 23 * 4
    for a, b in zip(thist, jhist):
        for key in ("loss", "mse", "mask"):
            assert abs(a[key] - b[key]) <= 1e-4, (key, a, b)
    assert float(tcp["l"][0]) < -1.0 and float(tcp["h"][0]) > 16.0
    assert not tcp["l"].requires_grad


def test_init_clip_params_matches_jax():
    t, j = TC.init_clip_params(3, -4.0, 19.0), JC.init_clip_params(3, -4.0,
                                                                   19.0)
    for k in ("l", "h"):
        np.testing.assert_array_equal(_np(t[k]), np.asarray(j[k]))
        assert t[k].dtype == torch.float32
