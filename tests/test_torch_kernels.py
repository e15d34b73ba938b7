"""Port parity, kernels: each plain PyTorch version against its Pallas
kernel (interpret mode, as the JAX tests run it) and the JAX serving
functions on the same numpy inputs. The kernel-vs-plain checks that need
a CUDA card are in ``test_torch_kernels_cuda.py``.

Tolerances: encoder and matmul bit-exact; attention within 1e-5 in f32
(the plain version's dense softmax sums in another order than the
Pallas kernel's page-by-page online softmax)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qlinear as jql
from repro.core.clipping import apply_clipping as japply_clipping
from repro.core.quantize import quantize_activations as jquant_act
from repro.core.sparqle import encode as jencode
from repro.kernels.kv_attention import kv4_paged_decode_attention as jattn
from repro.kernels.sparqle_encode import sparqle_encode as jsparqle_encode
from repro.kernels.sparqle_matmul import sparqle_matmul as jsparqle_matmul
from repro_torch.convert import convert_tree
from repro_torch.core import qlinear as tql
from repro_torch.core.quantize import activation_scale
from repro_torch.kernels import ref
from repro_torch.kernels.ref import TILE_K, TILE_M
from repro_torch.kernels.sparqle_encode import sparqle_encode


def _t(a):
    return torch.from_numpy(np.array(a))


def _pop_np(pbm: np.ndarray) -> np.ndarray:
    m, k = pbm.shape
    mp, kp = -(-m // TILE_M) * TILE_M, -(-k // TILE_K) * TILE_K
    p = np.zeros((mp, kp), np.int32)
    p[:m, :k] = pbm
    return p.reshape(mp // TILE_M, TILE_M, kp // TILE_K, TILE_K).sum((1, 3))


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def test_encode_plain_matches_pallas_f32():
    rng = np.random.default_rng(0)
    m, k = 32, 256
    x = (rng.standard_normal((m, k)) * 40).astype(np.float32)
    scale = rng.uniform(0.1, 2.0, (m, 1)).astype(np.float32)
    x[1] = 0.0
    scale[1] = 0.0                                 # degenerate row: / 1
    scale[2] = 0.25                                # exact .5 quotients
    x[2] = (rng.integers(-100, 100, k) + 0.5).astype(np.float32) * 0.25
    got = ref.sparqle_encode_ref(_t(x), _t(scale))
    want = jsparqle_encode(jnp.asarray(x), jnp.asarray(scale), bm=TILE_M,
                           bk=TILE_K, interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (np.asarray(want[0])[2] % 2 == 0).all()  # ties went to even


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k", [(5, 300), (32, 256), (1, 128)])
def test_encode_plain_matches_serving_path(dtype, m, k):
    """quantize_activations -> apply_clipping -> encode (JAX) == the fused
    plain encoder, with the per-token scale formed in x's dtype."""
    rng = np.random.default_rng(m * k)
    x = (rng.standard_normal((m, k)) * rng.uniform(0.1, 8, (m, 1))).astype(
        np.float32)
    if m > 1:
        x[0] = 0.0
    mask = rng.random(k) < 0.5
    xj = jnp.asarray(x)
    if dtype == "bfloat16":
        xj = xj.astype(jnp.bfloat16)
    xt = _t(np.asarray(xj.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    q = japply_clipping(jquant_act(xj).q, jnp.asarray(mask), -8, 23)
    planes = jencode(q)
    lsb, msb, pbm, pop = ref.sparqle_encode_ref(
        xt, activation_scale(xt).float(), _t(mask), -8, 23)
    np.testing.assert_array_equal(lsb.numpy(), np.asarray(planes.lsb4))
    np.testing.assert_array_equal(msb.numpy(), np.asarray(planes.msb4))
    np.testing.assert_array_equal(pbm.numpy(), np.asarray(planes.pbm))
    np.testing.assert_array_equal(pop.numpy(),
                                  _pop_np(np.asarray(planes.pbm)))


# ---------------------------------------------------------------------------
# dual-pass matmul
# ---------------------------------------------------------------------------

def _planes(rng, m, k):
    """Random planes with the MSB plane zero on every other K tile."""
    q = rng.integers(-128, 128, (m, k)).astype(np.int8)
    msb, lsb = q >> 4, q & 0xF
    tiles = np.arange(k) // TILE_K
    msb = np.where(tiles % 2 == 0, msb, 0).astype(np.int8)
    return lsb.astype(np.int8), msb.astype(np.int8)


def test_matmul_plain_matches_pallas():
    rng = np.random.default_rng(1)
    m, k, n = 32, 512, 128
    lsb, msb = _planes(rng, m, k)
    w = rng.integers(-8, 8, (k, n)).astype(np.int8)
    asc = rng.uniform(0.01, 0.1, (m, 1)).astype(np.float32)
    wsc = rng.uniform(0.01, 0.1, (1, n)).astype(np.float32)
    pop = _pop_np(msb != 0)
    assert (pop == 0).any() and (pop > 0).any()
    wp = tql.pack_int4(_t(w))
    for acc_out in (False, True):
        got = ref.sparqle_matmul_ref(_t(lsb), _t(msb), _t(pop), wp, _t(asc),
                                     _t(wsc), acc_out=acc_out)
        want = jsparqle_matmul(
            jnp.asarray(lsb), jnp.asarray(msb), jnp.asarray(pop),
            jnp.asarray(w), jnp.asarray(asc), jnp.asarray(wsc), bm=TILE_M,
            bn=128, bk=TILE_K, interpret=True, acc_out=acc_out)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("m,k,n", [(5, 96, 40), (3, 256, 24), (33, 130, 8)])
def test_matmul_plain_matches_dual_pass_ragged(m, k, n):
    rng = np.random.default_rng(m + k + n)
    q = rng.integers(-128, 128, (m, k)).astype(np.int8)
    w = rng.integers(-8, 8, (k, n)).astype(np.int8)
    want = np.asarray(jql._dual_pass_matmul(jnp.asarray(q), jnp.asarray(w),
                                            False))
    lsb, msb = q & 0xF, q >> 4
    got = ref.sparqle_matmul_ref(
        _t(lsb), _t(msb), _t(_pop_np(msb != 0)), tql.pack_int4(_t(w)),
        torch.ones((m, 1)), torch.ones((1, n)), acc_out=True)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_matches_quantized_apply(dtype):
    """The port's whole serving linear (scale, encode, clip, dual pass,
    drain) against the JAX ``linear`` on a converted SparqleLinear."""
    rng = np.random.default_rng(7)
    w = rng.standard_normal((256, 48)).astype(np.float32)
    x = rng.standard_normal((2, 5, 256)).astype(np.float32) * 3
    sl = jql.quantize_leaf(jnp.asarray(w), tile_k=16)
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    want = np.asarray(jql.linear(xj, sl).astype(jnp.float32))
    xt = _t(np.asarray(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    got = tql.linear(xt, convert_tree(sl)).float().numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("w_bits,k", [(8, 256), (4, 255)])
def test_linear_rejects_unpacked_weight(w_bits, k):
    """A weight left unpacked (w_bits > 4, or odd K) has no kernel: the
    serving linear raises instead of reading int8 values as nibbles."""
    rng = np.random.default_rng(k)
    w = _t(rng.standard_normal((k, 16)).astype(np.float32))
    sl = tql.quantize_leaf(w, w_bits=w_bits, tile_k=1)
    assert not sl.packed
    with pytest.raises(NotImplementedError, match="unpacked"):
        tql.linear(_t(rng.standard_normal((3, k)).astype(np.float32)), sl)


def test_encode_wrapper_without_pbm_on_cpu():
    rng = np.random.default_rng(11)
    x = _t(rng.standard_normal((5, 256)).astype(np.float32) * 4)
    scale = x.abs().amax(-1, keepdim=True) / 127
    full = sparqle_encode(x, scale)
    lean = sparqle_encode(x, scale, with_pbm=False)
    assert full[2] is not None and lean[2] is None
    for i in (0, 1, 3):
        assert torch.equal(full[i], lean[i])


# ---------------------------------------------------------------------------
# paged KV4 decode attention
# ---------------------------------------------------------------------------

def _attn_inputs(seed=3, b=4, kvh=2, g=2, hd=16, ps=4, n_pages=20, n_s=4):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, kvh, g, hd)).astype(np.float32)
    kp = rng.integers(-128, 128, (n_pages, ps, kvh, hd // 2)).astype(np.int8)
    vp = rng.integers(-128, 128, (n_pages, ps, kvh, hd // 2)).astype(np.int8)
    ks = rng.uniform(0.01, 0.3, (n_pages, ps, kvh)).astype(np.float32)
    vs = rng.uniform(0.01, 0.3, (n_pages, ps, kvh)).astype(np.float32)
    tables = (rng.permutation(n_pages - 1)[:b * n_s] + 1).reshape(
        b, n_s).astype(np.int32)
    tables[-1] = 0                                  # inactive: null page
    pos = np.array([ps - 1, ps, n_s * ps - 1, 0][:b], np.int32)  # edges
    return q, kp, ks, vp, vs, tables, pos


def test_attention_plain_matches_pallas():
    args = _attn_inputs()
    got = ref.kv4_paged_decode_attention_ref(*map(_t, args)).numpy()
    want = np.asarray(jattn(*map(jnp.asarray, args), interpret=True))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.isfinite(got).all()


def test_attention_null_slot_is_finite_and_ignored():
    q, kp, ks, vp, vs, tables, pos = _attn_inputs(seed=4)
    base = ref.kv4_paged_decode_attention_ref(
        *map(_t, (q, kp, ks, vp, vs, tables, pos)))
    kp2 = kp.copy()
    kp2[tables[0, 1]] = 0        # a page past pos[0]'s page: masked out
    again = ref.kv4_paged_decode_attention_ref(
        *map(_t, (q, kp2, ks, vp, vs, tables, pos)))
    torch.testing.assert_close(again[0], base[0], rtol=0, atol=0)
