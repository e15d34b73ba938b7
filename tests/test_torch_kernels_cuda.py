"""On the card: each CUDA kernel against its plain PyTorch version.

Marked ``cuda`` and skipped without a card. This file imports neither
JAX nor the JAX package, so it also runs on a GPU machine without them:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest \
        tests/test_torch_kernels_cuda.py

Tolerances: encoder and matmul bit-exact; attention within 1e-4 in f32
(sums in another order than the plain einsum/softmax).
"""
import pytest
import torch

from repro_torch.core.qlinear import pack_int4
from repro_torch.core.quantize import activation_scale
from repro_torch.kernels import kv_attention, ref, sparqle_encode, sparqle_matmul
from repro_torch.kernels.ref import TILE_K, TILE_M


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode; the "
                    "plain versions are tested against JAX elsewhere)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k", [(33, 4100), (1, 128), (8, 14336)])
def test_encode_kernel_matches_plain(cuda, dtype, m, k):
    g = torch.Generator(device=cuda).manual_seed(m + k)
    x = (torch.randn((m, k), generator=g, device=cuda) * 6).to(dtype)
    x[0] = 0
    scale = activation_scale(x).float()
    mask = torch.rand((k,), generator=g, device=cuda) < 0.5
    want = ref.sparqle_encode_ref(x, scale, mask, -8, 23)
    got = sparqle_encode.sparqle_encode(x, scale, mask, -8, 23)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # the serving linear's call: no PBM plane stored, the rest unchanged
    lean = sparqle_encode.sparqle_encode(x, scale, mask, -8, 23,
                                         with_pbm=False)
    assert lean[2] is None
    for i in (0, 1, 3):
        assert torch.equal(lean[i], want[i])


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 4096, 1024), (8, 14336, 4096),
                                   (33, 200, 70), (32, 4096, 14336)])
def test_matmul_kernel_matches_plain(cuda, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    q = torch.randint(-128, 128, (m, k), generator=g, device=cuda,
                      dtype=torch.int8)
    lsb, msb = q & 0xF, q >> 4
    tiles = torch.arange(k, device=cuda) // TILE_K      # pop-0 tiles too
    msb = torch.where((tiles % 2 == 0)[None, :], msb, torch.zeros_like(msb))
    pop = ref.tile_population_padded(msb != 0, TILE_M, TILE_K)
    assert (pop == 0).any() and (pop > 0).any()
    wp = pack_int4(torch.randint(-8, 8, (k, n), generator=g, device=cuda,
                                 dtype=torch.int8))
    asc = torch.rand((m, 1), generator=g, device=cuda)
    wsc = torch.rand((1, n), generator=g, device=cuda)
    for acc_out in (False, True):
        assert torch.equal(
            sparqle_matmul.sparqle_matmul(lsb, msb, pop, wp, asc, wsc,
                                          acc_out=acc_out),
            ref.sparqle_matmul_ref(lsb, msb, pop, wp, asc, wsc,
                                   acc_out=acc_out))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_matches_plain(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(3)
    b, kvh, gq, hd, ps, n_s, n_pages = 6, 8, 4, 128, 16, 8, 64
    q = torch.randn((b, kvh, gq, hd), generator=g, device=cuda).to(dtype)
    kp, vp = (torch.randint(-128, 128, (n_pages, ps, kvh, hd // 2),
                            generator=g, device=cuda, dtype=torch.int8)
              for _ in range(2))
    ks, vs = (torch.rand((n_pages, ps, kvh), generator=g, device=cuda) * 0.2
              for _ in range(2))
    perm = torch.randperm(n_pages - 1, generator=g, device=cuda) + 1
    tables = perm[:b * n_s].reshape(b, n_s).to(torch.int32).contiguous()
    tables[-1] = 0                               # inactive slot: null page
    pos = torch.tensor([ps - 1, ps, 2 * ps + 3, n_s * ps - 1, 40, 0],
                       dtype=torch.int32, device=cuda)
    args = (q, kp, ks, vp, vs, tables, pos)
    got = kv_attention.kv4_paged_decode_attention(*args)
    want = ref.kv4_paged_decode_attention_ref(*args)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    else:   # both round the same f32 result to bf16: at most one bf16 ulp
        torch.testing.assert_close(got.float(), want.float(), atol=0,
                                   rtol=2 ** -7)
