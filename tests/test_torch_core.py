"""Port parity, core: the torch codec against the JAX package on the same
numpy inputs. Everything here is integer work or exact rescaling, so
every comparison is bit-exact."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import granite_8b as jgranite
from repro.core import clipping as jclip
from repro.core import packing as jpack
from repro.core import qlinear as jql
from repro.core import quantize as jq
from repro.core import sparqle as jsp
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import clipping as tclip
from repro_torch.core import packing as tpack
from repro_torch.core import qlinear as tql
from repro_torch.core import quantize as tq
from repro_torch.core import sparqle as tsp


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16_pair(x: np.ndarray):
    """The same bf16 values as a jnp array and a torch tensor."""
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = _t(np.asarray(xj.astype(jnp.float32))).to(torch.bfloat16)
    return xj, xt


@pytest.mark.parametrize("smoke", [False, True])
def test_config_fields_match_jax(smoke):
    jc = jgranite.SMOKE if smoke else jgranite.CONFIG
    tc = get_config("granite-8b", smoke=smoke)
    assert [f.name for f in dataclasses.fields(ModelConfig)] == \
        [f.name for f in dataclasses.fields(type(jc))]
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.hd == jc.hd and tc.d_inner == jc.d_inner
    assert tc.cdtype == torch.bfloat16
    assert tc.replace(dtype="float32").cdtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_activations_bit_exact(dtype, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((24, 200)) * rng.uniform(0.01, 5, (24, 1))
         ).astype(np.float32)
    x[3] = 0.0                                       # all-zero token
    if dtype == "bfloat16":
        xj, xt = _bf16_pair(x)
    else:
        xj, xt = jnp.asarray(x), _t(x)
    qa = jq.quantize_activations(xj)
    qt = tq.quantize_activations(xt)
    np.testing.assert_array_equal(qt.q.numpy(), np.asarray(qa.q))
    np.testing.assert_array_equal(qt.scale.numpy(), np.asarray(qa.scale))
    np.testing.assert_array_equal(
        tq.activation_scale(xt).float().numpy(), np.asarray(qa.scale))
    zj = jq.quantize_activations(xj, zero_point=True)
    zt = tq.quantize_activations(xt, zero_point=True)
    np.testing.assert_array_equal(zt.q.numpy(), np.asarray(zj.q))
    np.testing.assert_array_equal(zt.zero.numpy(), np.asarray(zj.zero))


@pytest.mark.parametrize("axis", [0, -1])
def test_quantize_weights_bit_exact(axis):
    w = np.random.default_rng(2).standard_normal((64, 48)).astype(np.float32)
    a = jq.quantize_weights(jnp.asarray(w), bits=4, axis=axis)
    b = tq.quantize_weights(_t(w), bits=4, axis=axis)
    np.testing.assert_array_equal(b.q.numpy(), np.asarray(a.q))
    np.testing.assert_array_equal(b.scale.numpy(), np.asarray(a.scale))


def test_encode_decode_exhaustive_int8():
    x = np.arange(-128, 128, dtype=np.int8).reshape(16, 16)
    ja = jsp.encode(jnp.asarray(x))
    ta = tsp.encode(_t(x))
    np.testing.assert_array_equal(ta.lsb4.numpy(), np.asarray(ja.lsb4))
    np.testing.assert_array_equal(ta.msb4.numpy(), np.asarray(ja.msb4))
    np.testing.assert_array_equal(ta.pbm.numpy(), np.asarray(ja.pbm))
    np.testing.assert_array_equal(tsp.decode(ta).numpy(), x)
    assert tsp.LP_LOW == jsp.LP_LOW and tsp.LP_HIGH == jsp.LP_HIGH
    np.testing.assert_array_equal(
        tsp.subprecision_sparsity(_t(x), axis=-1).numpy(),
        np.asarray(jsp.subprecision_sparsity(jnp.asarray(x), axis=-1)))
    assert float(tsp.subprecision_sparsity(_t(x))) == \
        float(jsp.subprecision_sparsity(jnp.asarray(x)))


def test_tile_population_pop0_and_nonzero():
    rng = np.random.default_rng(3)
    pbm = rng.random((32, 256)) < 0.05
    pbm[:16, :128] = False                            # a pop-0 tile
    got = tsp.tile_population(_t(pbm), 16, 128).numpy()
    want = np.asarray(jsp.tile_population(jnp.asarray(pbm), 16, 128))
    np.testing.assert_array_equal(got, want)
    assert (want == 0).any() and (want > 0).any()


@pytest.mark.parametrize("l,h", [(-8, 23), (-16, 47), (-8.0, 23.0)])
def test_apply_clipping_bit_exact(l, h):
    rng = np.random.default_rng(4)
    x = rng.integers(-128, 128, (20, 64)).astype(np.int8)
    mask = rng.random(64) < 0.5
    got = tclip.apply_clipping(_t(x), _t(mask), l, h).numpy()
    want = np.asarray(jclip.apply_clipping(jnp.asarray(x), jnp.asarray(mask),
                                           l, h))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k_percent,tile_k", [(50.0, 16), (30.0, 8)])
def test_importance_mask_tile_aligned(seed, k_percent, tile_k):
    w = np.random.default_rng(seed).standard_normal((72, 40)).astype(
        np.float32)
    got = tclip.importance_mask_tile_aligned(_t(w), k_percent, tile_k)
    want = jclip.importance_mask_tile_aligned(jnp.asarray(w), k_percent,
                                              tile_k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # f32 row sums: torch and XLA add in different orders (1 ulp apart);
    # the masks above agree on these seeds all the same
    np.testing.assert_allclose(
        tclip.column_importance(_t(w)).numpy(),
        np.asarray(jclip.column_importance(jnp.asarray(w))), rtol=1e-6)


def test_pack_unpack_int4_exhaustive():
    lo, hi = np.meshgrid(np.arange(-8, 8), np.arange(-8, 8), indexing="ij")
    q = np.stack([lo.ravel(), hi.ravel()], 0).astype(np.int8)  # (2, 256)
    q = np.repeat(q.T.reshape(-1, 1), 3, axis=1)             # (512, 3)
    got = tql.pack_int4(_t(q)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jql.pack_int4(
        jnp.asarray(q))))
    assert len(np.unique(got)) == 256                 # every byte value
    np.testing.assert_array_equal(tql.unpack_int4(_t(got)).numpy(), q)
    every = np.arange(-128, 128, dtype=np.int8).reshape(16, 16)
    np.testing.assert_array_equal(
        tql.unpack_int4(_t(every)).numpy(),
        np.asarray(jql.unpack_int4(jnp.asarray(every))))


def test_measured_wire_bytes_rows():
    rng = np.random.default_rng(5)
    for k in (32, 50, 4096):
        q = rng.integers(-128, 128, (6, k)).astype(np.int8)
        q[0] = rng.integers(0, 16, k)                 # all MSB4 zero
        np.testing.assert_array_equal(
            tpack.measured_wire_bytes_rows(_t(q)).numpy(),
            np.asarray(jpack.measured_wire_bytes_rows(jnp.asarray(q))))
        assert tpack.dense_bytes_rows(_t(q)) == k
        assert tpack.pad_k(k) == jpack.pad_k(k)
    assert tpack.PBM_WORD_BITS == jpack.PBM_WORD_BITS
