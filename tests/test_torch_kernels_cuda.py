"""On the card: each CUDA kernel against its plain PyTorch version.

Marked ``cuda`` and skipped without a card. This file imports neither
JAX nor the JAX package, so it also runs on a GPU machine without them:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest \
        tests/test_torch_kernels_cuda.py

Tolerances: encoder (and its quantize-only and packed forms), matmul,
draft matmul, their packed forms and dense matmul bit-exact (the packed
ones with the unpacked ones too, the dense one with the dual pass; the
five entries of the matmul body over chip_smoke's sweep of M, (K, N)
and population patterns, and on q = -128, w = -8 everywhere; the dense
wrapper raises above MAX_K);
attention within 1e-4 in f32 (sums in another order than the plain
einsum/softmax), in bf16 within one bf16 step (of the output, or for the
contiguous kernel of the outputs' scale); the verify attention bit-exact with T calls of the
decode kernel, the tiered attention with one decode call (over the
clamped pages where demoted), and the contiguous attention with the
paged one on pages that tile the same cache; greedy speculative streams
identical to the base engine's. The fused-scale encoders: the scale
bit-equal to ``activation_scale(x).float()``, scale, planes and
populations to their plain versions and to the entries fed the scale. The split-KV attention at a long context
(256-page tables): within 1e-4 of its plain version, verify bit-exact
with decode calls; the contiguous kernel's ``round_kv`` at bf16 unlike
``round_kv=False`` and within one bf16 ulp of each element of its plain
form (``chip_smoke.check_round_kv``), the ``round_kv=False`` bits at
f32. The attention instances off the main path (head dims 16-64 and
256, pages of 1, 5, 8, 16 and 40 tokens, G of 1, 2, 3, 6 and 8) as
``chip_smoke.check_attention_shapes`` holds them. The contiguous
kernel's sliding window at gemma3-27b's shape and its hd-256 instance at
paligemma-3b's (``chip_smoke.check_window_case``: within 1e-4 of the
plain version, round_kv within one bf16 ulp, a window that does not bind
giving window 0's bits), and both archs' smoke configs through
``--legacy`` on the card and on the CPU: the same greedy streams. The expert-batched
encoders and matmuls (a routed MoE projection): bit-exact with their
plain versions (the 2-D ones expert by expert) at E = 8 and 64 experts,
one launch a call; decode attention at the zoo's head shapes (G = 1, 12,
8) within 1e-4; the deepseek-moe-16b smoke config served on the card.
deepseek-v3-671b's shapes: the five matmul entries at its (K, N) pairs
(wkv_a's N = 576 among them), bit-exact, and the batched matmul entries
and encoders at E = 256 with one launch a call; its smoke config through
``--legacy`` on the card and on the CPU: the same greedy streams. The SSD
family's shapes: the five matmul entries at mamba2-2.7b's and
jamba-v0.1-52b's projections (N = 10,576 and 16,544: a ragged last
column block), the fused encoders at their K, the batched entries at
jamba's E = 16; both smoke configs through ``--legacy`` on the card and
on the CPU: the same greedy streams. Training: granite-8b's and
hubert-xlarge's smoke configs train two steps on the card, twice from
one seed in a child process under ``torch.use_deterministic_algorithms``
(cuBLAS's workspace set before CUDA starts): every loss finite, no
blow-up, the two runs' states bit-equal. Row 7p (the partial decode
over a slice of the cache): each slice within 1e-4 of its plain version
(out and log-sum-exp; a slice wholly past pos -inf and 0), the slices
merged within 1e-4 of one row-7 call, at hd 16, 128 and 256, with and
without a window.
"""
import math
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from repro_torch.core import packing
from repro_torch.core.qlinear import pack_int4
from repro_torch.core.quantize import activation_scale
from repro_torch.kernels import (kv_attention, quant_matmul, ref,
                                 sparqle_encode, sparqle_matmul)
from repro_torch.kernels.ref import TILE_K, TILE_M

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import (BATCHED_KN, GEMMA3_ATTN,  # noqa: E402
                        HD256_POS, MATMUL_KN, MATMUL_M, PALIGEMMA_ATTN,
                        POP_PATTERNS, ROWS_PATTERNS, SSD_BATCHED,
                        SSD_ENCODE_K, SSD_KN,
                        SSD_M, V3_BATCHED, V3_KN, WINDOW_POS,
                        WINDOWS, batched_case,
                        batched_instances, check_attention_shapes,
                        check_attention_zoo, check_batched_matmul_case,
                        check_rows_encoder_case, check_rows_matmul_case,
                        check_fused_case, check_matmul_case,
                        check_one_launch, check_round_kv, check_window_case,
                        contiguous_cache, demoted_pool, encoder_input,
                        long_context, matmul_case, paged_tiling,
                        rows_pattern, smoke_config_on_card, with_garbage)


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


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(8, 4096, 1024), (24, 4096, 14336),
                                   (24, 14336, 4096), (33, 200, 70)])
def test_draft_matmul_kernel_matches_plain(cuda, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(m * k + n)
    lsb = torch.randint(0, 16, (m, k), generator=g, device=cuda,
                        dtype=torch.int8)
    wp = pack_int4(torch.randint(-8, 8, (k, n), generator=g, device=cuda,
                                 dtype=torch.int8))
    asc = torch.rand((m, 1), generator=g, device=cuda)
    wsc = torch.rand((1, n), generator=g, device=cuda)
    for acc_out in (False, True):
        got = sparqle_matmul.sparqle_matmul(lsb, None, None, wp, asc, wsc,
                                            acc_out=acc_out, msb_skip=True)
        want = ref.sparqle_matmul_ref(lsb, None, None, wp, asc, wsc,
                                      acc_out=acc_out, msb_skip=True)
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_verify_attention_kernel_matches_decode_kernel(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(5)
    b, t, kvh, gq, hd, ps, n_s, n_pages = 6, 3, 8, 4, 128, 16, 8, 64
    q = torch.randn((b, t, kvh, gq, hd), generator=g, device=cuda).to(dtype)
    kp, vp = (torch.randint(-128, 128, (n_pages, ps, kvh, hd // 2),
                            generator=g, device=cuda, dtype=torch.int8)
              for _ in range(2))
    ks, vs = (torch.rand((n_pages, ps, kvh), generator=g, device=cuda) * 0.2
              for _ in range(2))
    perm = torch.randperm(n_pages - 1, generator=g, device=cuda) + 1
    tables = perm[:b * n_s].reshape(b, n_s).to(torch.int32).contiguous()
    tables[-1] = 0                               # inactive slot: null page
    # windows crossing page boundaries, and one ending on the last page
    pos = torch.tensor([ps - 1, ps - 2, 2 * ps + 3, n_s * ps - t, 40, 0],
                       dtype=torch.int32, device=cuda)
    args = (kp, ks, vp, vs, tables)
    got = kv_attention.kv4_paged_verify_attention(q, *args, pos)
    for i in range(t):
        single = kv_attention.kv4_paged_decode_attention(
            q[:, i].contiguous(), *args, pos + i)
        assert torch.equal(got[:, i], single), i
    want = ref.kv4_paged_verify_attention_ref(q, *args, pos)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    else:
        torch.testing.assert_close(got.float(), want.float(), atol=0,
                                   rtol=2 ** -7)


@pytest.mark.cuda
def test_spec_engine_greedy_matches_base_engine_on_card(cuda):
    """The verify window runs B*(γ+1) rows where a decode step runs B;
    on the card its greedy stream must still equal the base engine's."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import (build_served_params, make_engine,
                                          make_prompts, run_requests)
    cfg = get_config("granite-8b", smoke=True)
    params = build_served_params(cfg, 0, cuda, tile_k=16)
    prompts = make_prompts(cfg, 1, 4, 21)
    runs = [run_requests(make_engine(cfg, params, batch=4, prompt_len=21,
                                     gen=9, spec_gamma=gamma, device=cuda),
                         prompts, 9) for gamma in (0, 2)]
    assert runs[0]["streams"] == runs[1]["streams"]
    assert all(len(s) == 9 for s in runs[1]["streams"])
    assert runs[1]["aggregate"]["spec_tokens_per_step"] >= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k", [(33, 4100), (1, 128), (8, 14336)])
def test_quantize_kernel_matches_plain(cuda, dtype, m, k):
    g = torch.Generator(device=cuda).manual_seed(m * k)
    x = (torch.randn((m, k), generator=g, device=cuda) * 6).to(dtype)
    x[0] = 0
    scale = activation_scale(x).float()
    mask = torch.rand((k,), generator=g, device=cuda) < 0.5
    got = sparqle_encode.sparqle_quantize(x, scale, mask, -8, 23)
    assert torch.equal(got, ref.sparqle_quantize_ref(x, scale, mask, -8, 23))
    lsb, msb, _, _ = sparqle_encode.sparqle_encode(x, scale, mask, -8, 23)
    assert torch.equal(msb * 16 + lsb, got)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 4096, 1024), (8, 4096, 14336),
                                   (24, 14336, 4096), (33, 200, 70),
                                   (17, 4100, 1024), (64, 200, 70),
                                   (1024, 4096, 1024)])
def test_quant_matmul_kernel_matches_plain_and_dual_pass(cuda, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    q = torch.randint(-128, 128, (m, k), generator=g, device=cuda,
                      dtype=torch.int8)
    lsb, msb = q & 0xF, q >> 4
    pop = ref.tile_population_padded(msb != 0, TILE_M, TILE_K)
    wp = pack_int4(torch.randint(-8, 8, (k, n), generator=g, device=cuda,
                                 dtype=torch.int8))
    asc = torch.rand((m, 1), generator=g, device=cuda)
    wsc = torch.rand((1, n), generator=g, device=cuda)
    for acc_out in (False, True):
        got = quant_matmul.quant_matmul(q, wp, asc, wsc, acc_out=acc_out)
        assert torch.equal(got, ref.quant_matmul_ref(q, wp, asc, wsc,
                                                     acc_out=acc_out))
        assert torch.equal(got, sparqle_matmul.sparqle_matmul(
            lsb, msb, pop, wp, asc, wsc, acc_out=acc_out))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(8, 4096, 14336), (33, 4100, 1024),
                                   (1024, 200, 70), (1, 65536, 64)])
def test_quant_matmul_kernel_extreme_operands(cuda, m, k, n):
    # q = -128, w = -8: every product +1024 (the largest), through the
    # cp.async path (K = 4100), ragged edges and K = MAX_K
    q = torch.full((m, k), -128, dtype=torch.int8, device=cuda)
    wp = pack_int4(torch.full((k, n), -8, dtype=torch.int8, device=cuda))
    asc = torch.full((m, 1), 0.03, device=cuda)
    wsc = torch.full((1, n), 0.002, device=cuda)
    acc = quant_matmul.quant_matmul(q, wp, asc, wsc, acc_out=True)
    assert (acc == 1024 * k).all()
    assert torch.equal(quant_matmul.quant_matmul(q, wp, asc, wsc),
                       ref.quant_matmul_ref(q, wp, asc, wsc))


@pytest.mark.cuda
def test_quant_matmul_kernel_raises_above_max_k(cuda):
    k = sparqle_matmul.MAX_K + 2
    q = torch.zeros((1, k), dtype=torch.int8, device=cuda)
    wp = torch.zeros((k // 2, 8), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="int32 accumulator"):
        quant_matmul.quant_matmul(q, wp, torch.ones((1, 1), device=cuda),
                                  torch.ones((1, 8), device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiered_attention_kernel_matches_decode_kernel(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(7)
    b, kvh, gq, hd, ps, n_s = 6, 8, 4, 128, 16, 8
    kv4, tiered, clamped = demoted_pool(cuda, g, b, kvh, hd, ps, n_s, 64)
    q = torch.randn((b, kvh, gq, hd), generator=g, device=cuda).to(dtype)
    pos = torch.tensor([ps - 1, ps, 2 * ps + 3, n_s * ps - 1, 90, 0],
                       dtype=torch.int32, device=cuda)
    # every page tier 0: the decode kernel's bits
    got = kv_attention.kv_tiered_paged_decode_attention(
        q, *kv4[:4], *tiered[4:8], kv4[-1], torch.zeros_like(kv4[-1]), pos)
    assert torch.equal(got, kv_attention.kv4_paged_decode_attention(
        q, *kv4, pos))
    # half the pages demoted: the decode kernel's bits on the clamped pages
    got = kv_attention.kv_tiered_paged_decode_attention(q, *tiered, pos)
    assert torch.equal(got, kv_attention.kv4_paged_decode_attention(
        q, *clamped, pos))
    want = ref.kv_tiered_paged_decode_attention_ref(q, *tiered, pos)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    else:
        torch.testing.assert_close(got.float(), want.float(), atol=0,
                                   rtol=2 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k", [(33, 4100), (1, 128), (8, 14336), (5, 37)])
def test_encode_packed_kernel_matches_plain_and_codec(cuda, dtype, m, k):
    g = torch.Generator(device=cuda).manual_seed(m + k + 1)
    x = (torch.randn((m, k), generator=g, device=cuda) * 6).to(dtype)
    x[0] = 0
    scale = activation_scale(x).float()
    mask = torch.rand((k,), generator=g, device=cuda) < 0.5
    got = sparqle_encode.sparqle_encode_packed(x, scale, mask, -8, 23)
    want = ref.sparqle_encode_packed_ref(x, scale, mask, -8, 23)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    lsb, msb, pbm, pop = sparqle_encode.sparqle_encode(x, scale, mask, -8, 23)
    pad = packing.pad_k(k) - k
    assert torch.equal(got[0], packing.pack_nibbles(F.pad(lsb, (0, pad))))
    assert torch.equal(got[1], packing.pack_nibbles(F.pad(msb, (0, pad))))
    assert torch.equal(got[2], packing.pack_pbm(F.pad(pbm, (0, pad))))
    assert torch.equal(got[3], pop)


@pytest.mark.cuda
@pytest.mark.parametrize("msb_skip", [False, True])
@pytest.mark.parametrize("m,k,n", [(1, 4096, 1024), (8, 14336, 4096),
                                   (33, 200, 70), (24, 4096, 14336)])
def test_matmul_packed_kernel_matches_plain_and_unpacked(cuda, m, k, n,
                                                         msb_skip):
    g = torch.Generator(device=cuda).manual_seed(m + k + n + 2)
    q = torch.randint(-128, 128, (m, k), generator=g, device=cuda,
                      dtype=torch.int8)
    tiles = torch.arange(k, device=cuda) // TILE_K      # pop-0 tiles too
    q = torch.where((tiles % 2 == 0)[None, :], q, q & 0xF)
    lsb, msb = q & 0xF, q >> 4
    pop = ref.tile_population_padded(msb != 0, TILE_M, TILE_K)
    lp, mp = packing.planes_packed(packing.encode_packed(q))
    wp = pack_int4(torch.randint(-8, 8, (k, n), generator=g, device=cuda,
                                 dtype=torch.int8))
    asc = torch.rand((m, 1), generator=g, device=cuda)
    wsc = torch.rand((1, n), generator=g, device=cuda)
    for acc_out in (False, True):
        kw = dict(acc_out=acc_out, msb_skip=msb_skip)
        got = sparqle_matmul.sparqle_matmul_packed(lp, mp, pop, wp, asc, wsc,
                                                   **kw)
        assert torch.equal(got, ref.sparqle_matmul_packed_ref(
            lp, mp, pop, wp, asc, wsc, **kw))
        assert torch.equal(got, sparqle_matmul.sparqle_matmul(
            lsb, msb, pop, wp, asc, wsc, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_contiguous_attention_kernel_matches_plain_and_paged(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(9)
    b, s, kvh, gq, hd, bs = 6, 144, 8, 4, 128, 16
    q = torch.randn((b, kvh, gq, hd), generator=g, device=cuda).to(dtype)
    kq, vq = (torch.randint(-128, 128, (b, s, kvh, hd // 2), generator=g,
                            device=cuda, dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand((b, s, kvh), generator=g, device=cuda) * 0.2
              for _ in range(2))
    pos = torch.tensor([0, bs - 1, bs, 77, s - 1, 128], dtype=torch.int32,
                       device=cuda)
    cache = (kq, ks, vq, vs)
    got = kv_attention.kv4_decode_attention(q, *cache, pos, bs=bs)
    paged = kv_attention.kv4_paged_decode_attention(
        q, *paged_tiling(cache, bs, g), pos)
    assert torch.equal(got, paged)
    want = ref.kv4_decode_attention_ref(q, *cache, pos)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    else:   # one bf16 step at the outputs' scale (chip_smoke.py's limit):
        # near-zero outputs carry the f32 sums' absolute differences
        torch.testing.assert_close(
            got.float(), want.float(), rtol=0,
            atol=2 ** -7 * max(1.0, want.float().abs().max().item()))
    with pytest.raises(ValueError, match="multiple"):
        kv_attention.kv4_decode_attention(q, *cache, pos, bs=32)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", MATMUL_KN)
@pytest.mark.parametrize("m", MATMUL_M)
def test_matmul_family_matches_plain_and_each_other(cuda, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(m * 7 + k + n)
    for pattern in POP_PATTERNS:
        c = matmul_case(cuda, g, m, k, n, pattern)
        if pattern == "zero":
            assert (c["pop"] == 0).all()
        elif pattern == "live":
            assert (c["pop"] > 0).all()
        check_matmul_case(c, f"at M={m} K={k} N={n} pop={pattern}")


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", MATMUL_KN)
def test_matmul_family_extreme_operands(cuda, k, n):
    # q = -128 (LSB 0, MSB -8) and w = -8 everywhere: a sign-extension
    # slip in either operand changes every output
    for m in (8, 33, 1024):
        check_matmul_case(matmul_case(cuda, None, m, k, n, "", True),
                          f"at M={m} K={k} N={n} q=-128 w=-8")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k", [(1, 4096), (8, 14336), (33, 200),
                                 (1024, 4096), (5, 21504)])
def test_fused_encoders_match_activation_scale_and_unfused(cuda, dtype, m,
                                                           k):
    """Scale bit-equal to activation_scale(x).float() (zero and tiny rows
    included), scale, planes and populations to the plain versions, and
    to the entries that take the scale."""
    g = torch.Generator(device=cuda).manual_seed(m + k + 11)
    x, mask = encoder_input(cuda, g, m, k, dtype)
    check_fused_case(x, mask, f"M={m} K={k} {dtype}")


@pytest.mark.cuda
def test_attention_long_context_matches_plain_and_splits_alike(cuda):
    """256-page tables (a cluster of 8 blocks, 8 pages a warp): decode
    within 1e-4 of the plain version, the verify window bit-exact with
    decode calls."""
    g = torch.Generator(device=cuda).manual_seed(13)
    lc = long_context(cuda, g)
    pool, tables, pos = lc["pools"][0], lc["tables"], lc["pos"]
    q = torch.randn((8, 8, 4, 128), generator=g, device=cuda)
    got = kv_attention.kv4_paged_decode_attention(q, *pool, tables, pos)
    want = ref.kv4_paged_decode_attention_ref(q, *pool, tables, pos)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    qw = torch.randn((8, 3, 8, 4, 128), generator=g, device=cuda)
    win = kv_attention.kv4_paged_verify_attention(qw, *pool, tables, pos - 2)
    for i in range(3):
        assert torch.equal(win[:, i], kv_attention.kv4_paged_decode_attention(
            qw[:, i].contiguous(), *pool, tables, pos - 2 + i))


@pytest.mark.cuda
def test_contiguous_attention_round_kv(cuda):
    """round_kv=True: at bf16 unlike round_kv=False, within one bf16 ulp
    of each element of the plain version's round_kv form and nearer it
    than the f32-dequant form; the round_kv=False bits at f32."""
    g = torch.Generator(device=cuda).manual_seed(17)
    b, s, kvh, gq, hd = 4, 96, 8, 4, 128
    kq, vq = (torch.randint(-128, 128, (b, s, kvh, hd // 2), generator=g,
                            device=cuda, dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand((b, s, kvh), generator=g, device=cuda) * 0.2
              for _ in range(2))
    pos = torch.tensor([0, 17, 64, s - 1], dtype=torch.int32, device=cuda)
    cache = (kq, ks, vq, vs)
    q = torch.randn((b, kvh, gq, hd), generator=g, device=cuda)
    assert torch.equal(
        kv_attention.kv4_decode_attention(q, *cache, pos, round_kv=True),
        kv_attention.kv4_decode_attention(q, *cache, pos))
    qb = q.to(torch.bfloat16)
    check_round_kv(
        kv_attention.kv4_decode_attention(qb, *cache, pos, round_kv=True),
        kv_attention.kv4_decode_attention(qb, *cache, pos), qb, cache, pos)


@pytest.mark.cuda
def test_attention_instances_off_the_main_path(cuda):
    """Every head dim, pages of a run-time size and groups of G that are
    no multiple of 4: plain, verify, tiered, contiguous and round_kv."""
    check_attention_shapes(cuda, torch.Generator(device=cuda).manual_seed(19))


@pytest.mark.cuda
def test_smoke_config_serves_on_card(cuda):
    """The smoke config (hd 16, G 2) with pages of 8 and a fixed-batch
    cache of 30 positions, through the attention kernels."""
    smoke_config_on_card(cuda, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", BATCHED_KN)
@pytest.mark.parametrize("e,c", [(8, 1), (8, 17), (64, 3)])
def test_batched_matmul_family_matches_plain(cuda, e, c, k, n):
    g = torch.Generator(device=cuda).manual_seed(e + c + k)
    for pattern in POP_PATTERNS:
        check_batched_matmul_case(batched_case(cuda, g, e, c, k, n, pattern),
                                  f"at E={e} C={c} K={k} N={n} {pattern}")
    cs = batched_case(cuda, g, e, c, k, n, "live")
    for name, (fn, _, planes, skip) in batched_instances().items():
        check_one_launch(name, lambda: fn(
            cs[planes[0]], cs[planes[1]], cs["pop"], cs["wp"], cs["asc"],
            cs["wsc"], msb_skip=skip))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,c,k", [(8, 1, 2048), (64, 3, 1408),
                                   (8, 17, 10944), (3, 33, 200)])
def test_batched_encoders_match_plain(cuda, dtype, e, c, k):
    """Each expert's slab, mask row, scale rows and populations: the
    batched launch's outputs = the 2-D plain version's expert by expert
    (zero and tiny rows included), one launch a call."""
    g = torch.Generator(device=cuda).manual_seed(e * c + k)
    x, mask = zip(*[encoder_input(cuda, g, c, k, dtype) for _ in range(e)])
    x, mask = torch.stack(x).contiguous(), torch.stack(mask).contiguous()
    for fn, plain in (
            (sparqle_encode.sparqle_encode_fused,
             ref.sparqle_encode_fused_ref),
            (sparqle_encode.sparqle_quantize_fused,
             ref.sparqle_quantize_fused_ref),
            (sparqle_encode.sparqle_encode_packed_fused,
             ref.sparqle_encode_packed_fused_ref)):
        got = fn(x, mask, -8, 23)
        want = ref.batched(plain)(x, mask, -8, 23)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        check_one_launch(fn.__name__ + "_batched",
                         lambda: fn(x, mask, -8, 23))


@pytest.mark.cuda
@pytest.mark.parametrize("e,c,k,n", [(64, 1, 2048, 1408), (8, 17, 1408, 2048),
                                     (8, 3, 2048, 1408), (3, 33, 200, 70),
                                     (4, 128, 1024, 448), (5, 80, 200, 70)])
def test_batched_rows_match_plain(cuda, e, c, k, n):
    """The live rows (``rows``): the five batched matmul entries and the
    six batched encoders on operands with garbage past each expert's
    count, every rows pattern, bit-exact with the plain versions (which
    zero those rows first), the arrival counters 0 after every launch
    (E = 8, C = 3, 2048 -> 1408 splits K; C = 128 and 80: a count that
    cuts or empties an expert's second 64-row block)."""
    g = torch.Generator(device=cuda).manual_seed(e * c + k)
    case = batched_case(cuda, g, e, c, k, n, "alternating")
    x = (torch.randn((e, c, k), generator=g, device=cuda) * 3).to(
        torch.bfloat16)
    mask = torch.rand((e, k), generator=g, device=cuda) < 0.5
    for pattern in ROWS_PATTERNS:
        rows = rows_pattern(cuda, g, e, c, pattern)
        dirty = dict(case)
        for key in ("q", "lsb", "msb", "lp", "mp"):
            dirty[key] = with_garbage(case[key], rows, g)
        check_rows_matmul_case(dirty, rows, f"E={e} C={c} {pattern}")
        check_rows_encoder_case(x, mask, rows, g, f"E={e} C={c} {pattern}")


@pytest.mark.cuda
def test_attention_at_the_zoo_head_shapes(cuda):
    check_attention_zoo(cuda, torch.Generator(device=cuda).manual_seed(23),
                        (3.35e12, 1979e12, 67e12))


@pytest.mark.cuda
def test_moe_smoke_config_serves_on_card(cuda):
    """deepseek-moe-16b's smoke config (8 experts, hd 16, MHA): engine and
    speculative engine on the card, equal greedy streams, the routed
    projections through the batched kernels."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import (build_served_params, make_engine,
                                          make_prompts, run_requests)
    cfg = get_config("deepseek-moe-16b", smoke=True)
    params = build_served_params(cfg, 0, cuda, tile_k=16)
    prompts = make_prompts(cfg, 5, 4, 21)
    streams = []
    for gamma in (0, 2):
        kernels.reset_launch_counts()
        streams.append(run_requests(make_engine(
            cfg, params, batch=4, prompt_len=21, gen=9, page_size=8,
            spec_gamma=gamma, device=cuda), prompts, 9)["streams"])
        counts = kernels.launch_counts()
        assert counts["sparqle_matmul_batched"] > 0
        assert counts["sparqle_encode_fused_batched"] > 0
    assert streams[0] == streams[1]


@pytest.mark.cuda
@pytest.mark.parametrize("pos", WINDOW_POS)
def test_contiguous_window_at_gemma3_shape(cuda, pos):
    a = GEMMA3_ATTN
    g = torch.Generator(device=cuda).manual_seed(sum(pos))
    cache = contiguous_cache(cuda, g, a["b"], a["s"], a["kvh"], a["hd"])
    p = torch.tensor(pos, dtype=torch.int32, device=cuda)
    q = torch.randn((a["b"], a["kvh"], a["g"], a["hd"]), generator=g,
                    device=cuda)
    for w in WINDOWS + (max(pos) + 1,):
        check_window_case(q, cache, p, w, f"pos={pos}")


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 1, 17, 100, 528])
def test_contiguous_hd256_at_paligemma_shape(cuda, window):
    a = PALIGEMMA_ATTN
    g = torch.Generator(device=cuda).manual_seed(window + 3)
    cache = contiguous_cache(cuda, g, a["b"], a["s"], a["kvh"], a["hd"])
    p = torch.tensor(HD256_POS, dtype=torch.int32, device=cuda)
    q = torch.randn((a["b"], a["kvh"], a["g"], a["hd"]), generator=g,
                    device=cuda)
    check_window_case(q, cache, p, window, "hd 256")
    got = kv_attention.kv4_decode_attention(q, *cache, p)
    assert torch.equal(got, kv_attention.kv4_paged_decode_attention(
        q, *paged_tiling(cache, 16, g), p))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma3-27b", "paligemma-3b"])
def test_gemma_smoke_legacy_on_card_matches_cpu(cuda, arch):
    """The smoke config at f32 through ``--legacy`` on the card (the
    windowed contiguous kernel for gemma3's local layers) and on the CPU:
    the same greedy streams, the window binding (prompt 20 past 16)."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.qlinear import tree_to
    from repro_torch.launch.serve import (build_served_params, legacy_serve,
                                          make_prompts, vlm_patches)
    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    params = build_served_params(cfg, 0, "cpu", tile_k=16)
    prompts = make_prompts(cfg, 4, 3, 20)
    patches = (vlm_patches(cfg, 4, 3, "cpu") if cfg.family == "vlm"
               else None)
    cpu = legacy_serve(cfg, params, prompts, 6, torch.device("cpu"),
                       patches)
    kernels.reset_launch_counts()
    card = legacy_serve(cfg, tree_to(params, cuda), prompts, 6, cuda,
                        None if patches is None else patches.to(cuda))
    assert card["streams"] == cpu["streams"]
    counts = kernels.launch_counts()
    assert counts["kv_attention_contiguous"] > 0
    assert (counts["kv_attention_contiguous_window"] > 0) == (
        arch == "gemma3-27b")


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", V3_KN)
def test_matmul_family_at_deepseek_v3_shapes(cuda, k, n):
    """The five entries bit-exact at deepseek-v3-671b's projections (N =
    576 for wkv_a: 9 column blocks of 64), decode and prefill rows."""
    g = torch.Generator(device=cuda).manual_seed(k + n)
    for m in (8, 17, 1024):
        for pattern in POP_PATTERNS:
            check_matmul_case(matmul_case(cuda, g, m, k, n, pattern),
                              f"at M={m} K={k} N={n} pop={pattern}")


@pytest.mark.cuda
@pytest.mark.parametrize("c", V3_BATCHED["c"])
@pytest.mark.parametrize("k,n", V3_BATCHED["kn"])
def test_batched_family_at_256_experts(cuda, c, k, n):
    """deepseek-v3-671b's routed projections: 256 experts, C = 1 (decode)
    and 32 (the legacy prefill), the five batched matmul entries and the
    three batched encoders bit-exact with their plain versions, one
    launch a call."""
    check_batched_family(cuda, V3_BATCHED["e"], c, k, n)


def check_batched_family(cuda, e, c, k, n):
    """The five batched matmul entries and the two batched encoders that
    take no scale at E experts, bit-exact with their plain versions, one
    launch a call."""
    g = torch.Generator(device=cuda).manual_seed(e + c + k)
    check_batched_matmul_case(batched_case(cuda, g, e, c, k, n, "alternating"),
                              f"at E={e} C={c} K={k} N={n}")
    cs = batched_case(cuda, g, e, c, k, n, "live")
    for name, (fn, _, planes, skip) in batched_instances().items():
        check_one_launch(name, lambda: fn(
            cs[planes[0]], cs[planes[1]], cs["pop"], cs["wp"], cs["asc"],
            cs["wsc"], msb_skip=skip))
    x = (torch.randn((e, c, k), generator=g, device=cuda) * 2).to(
        torch.bfloat16)
    mask = torch.rand((e, k), generator=g, device=cuda) < 0.5
    for fn, plain in ((sparqle_encode.sparqle_encode_fused,
                       ref.sparqle_encode_fused_ref),
                      (sparqle_encode.sparqle_encode_packed_fused,
                       ref.sparqle_encode_packed_fused_ref)):
        got = fn(x, mask, -8, 23)
        assert all(torch.equal(a, b) for a, b in zip(
            got, ref.batched(plain)(x, mask, -8, 23)))
        check_one_launch(fn.__name__ + "_batched",
                         lambda: fn(x, mask, -8, 23))


@pytest.mark.cuda
def test_deepseek_v3_smoke_legacy_on_card_matches_cpu(cuda):
    """deepseek-v3-671b's smoke config at f32 through ``--legacy`` on the
    card and on the CPU: the same greedy streams, the routed projections
    through the batched kernels and no attention kernel."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.qlinear import tree_to
    from repro_torch.launch.serve import (build_served_params, legacy_serve,
                                          make_prompts)
    cfg = get_config("deepseek-v3-671b", smoke=True).replace(dtype="float32")
    params = build_served_params(cfg, 0, "cpu", tile_k=16)
    prompts = make_prompts(cfg, 4, 3, 20)
    cpu = legacy_serve(cfg, params, prompts, 6, torch.device("cpu"))
    kernels.reset_launch_counts()
    card = legacy_serve(cfg, tree_to(params, cuda), prompts, 6, cuda)
    assert card["streams"] == cpu["streams"]
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    assert set(counts) == {"sparqle_encode_fused", "sparqle_matmul",
                           "sparqle_encode_fused_batched",
                           "sparqle_matmul_batched"}


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", SSD_KN)
def test_matmul_family_at_ssd_shapes(cuda, k, n):
    """The five entries bit-exact at the SSD family's projections: the
    input projections' N = 10,576 and 16,544 (a ragged last block of 64
    columns) and the output projections, decode and prefill rows."""
    g = torch.Generator(device=cuda).manual_seed(k + n)
    for m in SSD_M:
        for pattern in POP_PATTERNS:
            check_matmul_case(matmul_case(cuda, g, m, k, n, pattern),
                              f"at M={m} K={k} N={n} pop={pattern}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", SSD_ENCODE_K)
def test_fused_encoders_at_ssd_k(cuda, dtype, k):
    """The fused-scale encoders at the SSD family's K (d_model 2,560,
    mamba2's d_inner 5,120, jamba's 8,192) against their plain versions."""
    g = torch.Generator(device=cuda).manual_seed(k)
    for m in SSD_M:
        check_fused_case(*encoder_input(cuda, g, m, k, dtype),
                         f"at M={m} K={k} {dtype}")


@pytest.mark.cuda
@pytest.mark.parametrize("c", SSD_BATCHED["c"])
@pytest.mark.parametrize("k,n", SSD_BATCHED["kn"])
def test_batched_family_at_16_experts(cuda, c, k, n):
    """jamba-v0.1-52b's routed projections: 16 experts, C = 1 (decode)
    and 128 (the legacy prefill), as the 256-expert case."""
    check_batched_family(cuda, SSD_BATCHED["e"], c, k, n)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "jamba-v0.1-52b"])
def test_ssd_smoke_legacy_on_card_matches_cpu(cuda, arch):
    """The SSD family's smoke configs at f32 through ``--legacy`` on the
    card and on the CPU: the same greedy streams; mamba2 through the
    plain projections' kernels only, jamba's routed projections through
    the batched kernels and its attention layer through the contiguous
    one."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.qlinear import tree_to
    from repro_torch.launch.serve import (build_served_params, legacy_serve,
                                          make_prompts)
    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    params = build_served_params(cfg, 0, "cpu", tile_k=16)
    prompts = make_prompts(cfg, 4, 3, 20)
    cpu = legacy_serve(cfg, params, prompts, 6, torch.device("cpu"))
    kernels.reset_launch_counts()
    card = legacy_serve(cfg, tree_to(params, cuda), prompts, 6, cuda)
    assert card["streams"] == cpu["streams"]
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    want = {"sparqle_encode_fused", "sparqle_matmul"}
    if arch == "jamba-v0.1-52b":
        want |= {"sparqle_encode_fused_batched", "sparqle_matmul_batched",
                 "kv_attention_contiguous"}
    assert set(counts) == want


# a two-step smoke train, run twice from one seed in a child process whose
# environment sets cuBLAS's workspace before CUDA starts, as
# use_deterministic_algorithms needs
_TRAIN_TWICE = r"""
import json, sys, torch
from repro_torch.configs import get_config
from repro_torch.checkpoint import store
from repro_torch.launch import steps as S
from repro_torch.launch.train import build_state
from repro_torch.optim.adamw import OptConfig
torch.use_deterministic_algorithms(True)
dev = torch.device("cuda")
cfg = get_config(sys.argv[1], smoke=True)
ocfg = OptConfig(warmup_steps=1, total_steps=4)
g = torch.Generator(device=dev).manual_seed(3)
if cfg.family == "encoder":
    batch = {"frames": torch.randn((4, 24, cfg.d_model), generator=g,
                                   device=dev)}
else:
    batch = {"tokens": torch.randint(0, cfg.vocab, (4, 24), generator=g,
                                     device=dev, dtype=torch.int32)}
batch["targets"] = torch.randint(0, cfg.vocab, (4, 24), generator=g,
                                 device=dev, dtype=torch.int32)
runs = []
for _ in range(2):
    state = build_state(cfg, ocfg, 0, dev)
    step = S.make_train_step(cfg, ocfg, S.TrainKnobs(microbatch=2, ce_chunk=8))
    losses = []
    for _ in range(2):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    runs.append((losses, [t.cpu() for t in store.flatten(state)]))
print(json.dumps({"losses": [r[0] for r in runs], "bit_equal": all(
    torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))}))
"""


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-8b", "hubert-xlarge"])
def test_smoke_train_on_card_finite_and_deterministic(cuda, arch):
    """Two train steps of the smoke config (bf16, two microbatches, remat,
    chunked CE) on the card, twice from one seed under
    ``torch.use_deterministic_algorithms``: every loss finite, the second
    step's below the first's + 1.0 (the reference's smoke check), and
    the two runs' states (params, moments, step) bit-equal."""
    import json
    import os
    import subprocess
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8",
               PYTHONPATH=str(root / "src"))
    out = subprocess.run([sys.executable, "-c", _TRAIN_TWICE, arch],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    for losses in r["losses"]:
        assert all(map(math.isfinite, losses)), r
        assert losses[1] < losses[0] + 1.0, r
    assert r["bit_equal"], r


@pytest.mark.cuda
@pytest.mark.parametrize("hd,kvh,g", [(128, 8, 4), (256, 1, 8), (16, 2, 2)])
@pytest.mark.parametrize("window", [0, 100])
def test_partial_attention_slices_merge_to_row_7(cuda, hd, kvh, g, window):
    """Row 7p on the card: each slice of 1, 2 and 16 against its plain
    version (out and lse within 1e-4, the slices wholly past pos -inf and
    0), the slices merged against one row-7 call within 1e-4 (f32 q)."""
    gen = torch.Generator(device=cuda).manual_seed(hd + window)
    b, s = 8, 512
    cache = contiguous_cache(cuda, gen, b, s, kvh, hd)
    pos = torch.tensor([511, 0, 5, 200, 300, 301, 400, 100],
                       dtype=torch.int32, device=cuda)
    q = torch.randn((b, kvh, g, hd), generator=gen, device=cuda)
    whole = kv_attention.kv4_decode_attention(q, *cache, pos, window=window)
    for n in (1, 2, 16):
        n_loc = s // n
        outs, lses = [], []
        for r in range(n):
            part = tuple(t[:, r * n_loc:(r + 1) * n_loc].contiguous()
                         for t in cache)
            o, lse = kv_attention.kv4_decode_attention_partial(
                q, *part, pos, start=r * n_loc, window=window)
            wo, wl = ref.kv4_decode_attention_partial_ref(
                q, *part, pos, start=r * n_loc, window=window)
            assert torch.equal(torch.isinf(lse), torch.isinf(wl))
            assert (o[torch.isinf(lse)] == 0).all()
            live = torch.isfinite(wl)
            assert (o - wo).abs().max().item() <= 1e-4
            if live.any():
                assert (lse - wl)[live].abs().max().item() <= 1e-4
            outs.append(o)
            lses.append(lse)
        assert (ref.merge_partials(outs, lses) - whole).abs().max().item() \
            <= 1e-4
