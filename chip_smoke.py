"""On-card smoke of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py                 # every phase, one GPU
    python3 chip_smoke.py --kernels-only  # build + kernel checks only

Phases, each printing one line, phase 11 one more per seed (details go
to chiprun_out/):
  1. the card: ``nvidia-smi --query-gpu=name,power.limit``;
  2. build every CUDA kernel from ``src/repro_torch/csrc`` (parallel nvcc);
  3. hold each kernel against its plain PyTorch version on the card at
     the serving shapes (the fused-scale encoder, its quantize-only and
     packed forms: scale bit-equal to activation_scale(x).float(),
     scale, planes, PBM and populations bit-equal to their plain
     versions and to the entries fed that scale, over ENCODE_M x
     ENCODE_K x bf16, f32 with zero and tiny rows; attention, verify, tiered
     and contiguous attention within ATTN_TOL; verify attention
     bit-exact with T calls of the decode kernel, tiered attention with
     one, over the clamped pages where demoted, contiguous attention with
     the decode kernel on pages that tile the same cache, all four also
     at a long context of ~4,096 tokens and, untimed, at the other head
     dims, page sizes and G of ATTN_SHAPES, with the granite-8b smoke
     config served on the card; decode attention also at the zoo's head
     shapes, G = 1, 12 and 8; the contiguous attention's sliding window
     at gemma3-27b's shape and its hd-256 instance at paligemma-3b's,
     within ATTN_TOL, round_kv within a bf16 ulp, a window that does not
     bind bit-equal to none, hd 256 bit-equal to the paged kernel) and
     time kernel, plain version and library call; the expert-batched encoders (three modes) and matmuls
     (five entries) bit-exact with their plain versions over BATCHED_E x
     BATCHED_C x BATCHED_KN (x POP_PATTERNS), one launch a call, timed at
     E = 64, C = 1 and 3 beside the loop of 64 2-D calls; the five entries of the W4A8 matmul body (full, draft,
     packed, packed draft and dense) are timed at M = 8, 32 and 1024 and
     swept for bit-exactness over MATMUL_M x MATMUL_KN x POP_PATTERNS
     (and q = -128, w = -8), f32 and int32 outputs, each against its
     plain version, packed against unpacked and dense against the dual
     pass on the planes of the same q; at M = 8 and 32 the dense entry,
     the dual pass and the draft are timed on the same q under each
     population pattern; untimed, deepseek-v3-671b's shapes (V3_KN,
     V3_ENCODE_K at V3_M; the batched entries at E = 256, V3_BATCHED) and
     the SSD family's (SSD_KN, SSD_ENCODE_K at SSD_M; jamba's batched
     entries at E = 16, SSD_BATCHED); the batched entries with each
     expert's live rows (``rows``; ``check_expert_rows``): the five
     matmul entries over ROWS_SWEEP and the six encoders over
     ROWS_ENCODE, and both at V3_BATCHED and SSD_BATCHED (C = 128: a
     count that cuts or empties an expert's second 64-row block), every
     ROWS_PATTERNS, garbage past the count, bit-exact with their plain
     versions, the arrival counters 0 after every launch; timed at the serve's routing (ROWS_LIVE: 35 of 64 experts
     live, and 57 of 256 at deepseek-v3's routed shapes) with the rows
     and with rows=None, beside the live and the all-experts bound: the
     batched rows' times and bounds in the kernels line are these;
  4. serve granite-8b at full width and depth through the port's Engine
     (8 requests x 128 prompt tokens x 16 new, 8 decode slots), with the
     launch counters zeroed just before and read just after; from here
     on every serve runs its steps as CUDA graphs (``launch/graphs.py``),
     as the engines and the fixed-batch decode do by default on a card;
 4b. the compiled steps against eager ones: an engine serves the same
     weights and prompts under ``disable_graphs()`` and another with
     graphs, alternated, a warm serve each and then GRAPH_ROUNDS rounds:
     streams equal to phase 4's, per-kernel launch counts equal, TTFT,
     TPOT and tokens/s of both; then every step kind captured at full
     depth (``graph_cases``: the prefill chunk at valid = 32 and < 32,
     decode, draft, verify, KV2 decode, the fixed-batch prefill into
     used caches and decode, the KV2 page re-codecs at other pages each
     call) replayed against its eager calls, logits, telemetry, pages and
     caches bit-equal; and three ``--legacy`` serves of the prompts
     through one ``LegacySteps`` (the prefill's warm-up, capture and
     replay: their times, the capture's added reserved bytes; streams and
     launch counts equal);
  5. serve the same weights and prompts through the SpeculativeEngine
     (gamma = SPEC_GAMMA: LSB4-only drafts + one verify window per
     cycle), counters zeroed just before and read just after; every
     greedy stream must equal phase 4's;
  6. serve them with the KV2 precision ladder armed, twice: idle (no
     demotion; streams equal to phase 4's) and an aggressive cold sweep
     (demotions > 0, reclaimed bytes = demotions x the page saving;
     attributed, its decode counted at the KV2 share of the tables its
     decodes read, which must lie in (0, 1)); every decode step runs the
     tiered attention kernel, never the KV4 one;
  7. serve them through the dense W4A8 tree of the same int4 weights:
     streams equal to phase 4's, one prefill chunk and one decode step
     at full depth give logits bit-equal to the SPARQLe tree's, and only
     the quantize-only encoder and the dense matmul run the linears;
  8. serve them through the packed-wire-format tree of the same weights,
     base engine and gamma = SPEC_GAMMA: streams equal to phase 4's, only
     the packed encoder and the packed (and packed draft) matmuls run the
     linears, and one prefill chunk and one decode step give logits
     bit-equal to the unpacked tree's;
  9. serve the prompts through the fixed-batch ``--legacy`` path (one
     whole-prompt prefill into contiguous caches, lockstep decode): the
     contiguous attention kernel runs once a layer a decode step and the
     paged one never; how many streams equal phase 4's is reported (a
     128-token prompt is prefilled in chunks by the engine, so they may
     differ), and they must equal phase 4b's three legacy serves'; then
     granite width, 2 layers, f32: legacy streams equal to the engine's
     with the prefill unchunked;
 10. profile a shorter run of phase 4's, phase 5's and phase 7's
     engine shapes on an engine whose graphs a first run captured
     (device busy share under graphs, device time by kernel, bf16
     reduce_kernel launches beside the encoder's; the dense run's matmul
     is one kernel row whose launches equal the quant_matmul counter's,
     with no drain and no more fill launches than the base run), then
     serve phase 4 once more to read what the profilers left behind on
     the host;
 11. cross-check, for XC_SEEDS seeds: granite width, 2 layers, f32 — the
     same weights and prompts through the Engine on the card (kernels)
     and on the CPU (plain versions), logits within LOGIT_TOL and the
     greedy token streams identical;
 12. the rest of the zoo the engine serves, each at full width and depth
     (deepseek-moe-16b at ZOO_LAYERS' 14 of 28) with phase 4's serve
     under CUDA graphs: yi-6b, starcoder2-3b and deepseek-moe-16b (and
     for it gamma = SPEC_GAMMA, dense with logits
     bit-equal to SPARQLe, packed base and gamma: streams equal to its
     base serve's, every routed projection one batched encoder and one
     batched matmul launch; the base serve again with rows=None, the A
     of the live rows' A/B: streams and launches equal), TTFT, TPOT,
     tokens/s and launch counts; each
     arch's 2-layer f32 cross-check as phase 11's; ``serve --ckpt`` of a
     checkpoint the port's ``save`` wrote, streams equal to serving the
     tree directly;
 13. tensor-parallel serving, the ranks of a ("data", "model") mesh
     sharing the card over gloo (one process a rank, steps eager): the
     expert-batched encoders that take a scale bit-equal to their plain
     versions and to their fused twins fed the same scale; granite-8b at
     full width and depth rebuilt from the seed (checksum equal to phase
     4's tree), one decode step at meshes 1x2 and 2x2 with logits
     bit-equal to the single-device step's, and how many logits a 4-row
     decode step changes against the same rows of the 8-row one; gloo's
     all-reduce MAX and SUM and all-gather on CUDA int32 and f32 tensors;
     granite-8b cut to TP_GRANITE_LAYERS layers served at 1x2 (base,
     gamma = SPEC_GAMMA, dense) and 2x2 (base), streams equal to the
     single-device serves of the same cut tree, deepseek-moe-16b at
     full width and MOE_TP_LAYERS layers at 2x2 (base, dense, packed:
     streams equal to its single-device serve's), every rank's streams
     equal and its weight shard's checksum the parent's cut, rank 0's
     launch counts through the row-parallel path; TTFT, TPOT and tokens/s
     as information; NCCL with CUDA graphs only with two cards or more;
 14. the serve's surface and the core's calibration on the card, run
     between phases 9 and 10 (before any profiler) on phase 4's tree and
     prompts: phase 4's and 5's serves again through engines armed with
     SLO_SPECS and attributed (``Engine.attribute_steps``): streams equal
     to phases 4 and 5, ``validate_attribution(require=True)`` empty,
     the loose SLO silent and the tight one violated, and per phase the
     attributed FLOPs and bytes, the measured mean step, the byte floor
     and the memory and compute utilisation, each in (0, UTIL_MAX] (not
     the speculative engine's decode row: it times the whole draft +
     verify cycle); the decode's attributed bytes at least the bytes of
     the tensors it must read (``resident_decode_bytes``) and at most
     DECODE_BYTES_MARGIN above;
     ``Engine.stream`` of one prompt equal to its phase 4 stream;
     ``serve.main --slo --attribute --metrics-out`` on the smoke config
     (snapshot valid, the closing report's sparsity and cost-model
     prediction); ``global_calibrate`` over the int8 inputs of layer 0's
     four linear sites on the card and on the CPU (every candidate's
     sparsity equal, MSE within 1e-6 relative, the same (l, h)) and
     ``learn_clipping_constants`` on the card against the CPU (l and h
     within 1e-4);
 15. the gemma family through ``--legacy``, after phase 13 (its trees
     freed): gemma3-27b (62 layers, 2 requests x 2,048 prompt tokens x
     16 new: the sliding window binds in the prefill and in every decode
     step) and paligemma-3b (18 layers, 8 x (256 patches + 256 tokens) x
     16) at full width, bf16, weights from the seed, decode as CUDA
     graphs: prefill time, decode step time and launch counts (the
     windowed contiguous attention once a local layer and step, the
     global layers' instance, seven matmuls a layer and forward, no paged
     attention), the decode step replayed against its eager calls at full
     depth (bit-equal), the prefill too (``prefill_replay``: token and
     caches bit-equal, launch counts equal, its times; gemma3-27b at 12
     of its 62 layers, PREFILL_REPLAY_LAYERS), each arch's
     2-layer f32 card vs CPU cross-check
     of the fixed-batch path (LEGACY_XC; logits within LOGIT_TOL, greedy
     streams identical), ``serve.main --legacy --smoke`` of both and
     their exit without ``--legacy``;
 16. deepseek-v3-671b through ``--legacy``, after phase 15 (its trees
     freed): full width (d 7,168, 128 MLA heads on the 512-wide packed
     compressed cache, 256 experts top-8 sigmoid, the 129,280-word untied
     head) at 3 dense + 4 MoE layers and the MTP block, bf16, weights
     from the seed (an expert layer drawn a chunk of experts at a time):
     build time and peak, V3_SERVE's serve (8 x 128 x 16, decode as CUDA
     graphs): prefill time, decode step time, launch counts (the fused
     encoder and dual-pass matmul for each plain projection, the batched
     pair at E = 256 for each routed one, no attention kernel), the
     decode replay with the live rows against rows=None (serves A B B A:
     streams and launches equal, ``legacy_rows_ab``), the
     decode step's logits and caches replayed against its eager calls at
     full depth (bit-equal), the prefill too (``prefill_replay``), the
     MTP logits once; the 2-layer f32 card vs
     CPU cross-check (V3_XC: 16 experts) of the fixed-batch path, the
     card fed the CPU's greedy tokens, and of the MTP logits (within the
     arch's LOGIT_TOL_ARCH; greedy tokens equal at every step but at
     most V3_XC_PARTED near-ties, top-2 gap <= V3_XC_TIE, reported);
     ``serve.main --legacy --smoke`` and its exit without ``--legacy``,
     naming the mla mixer;
 17. the SSD family through ``--legacy``, after phase 16 (its trees
     freed): mamba2-2.7b (64 SSD layers, no FFN, tied head) and
     jamba-v0.1-52b (32 layers: 4 periods of 7 SSD + 1 attention, MoE of
     16 experts top-2 on every second layer) at full width and depth,
     bf16, weights from the seed: build time and peak, SSD_SERVE's serve
     (8 x 128 x 16, decode as CUDA graphs): prefill time, decode step
     time with the warm-up and capture timed apart, launch counts (the
     fused encoder and dual-pass matmul for each plain projection, the
     batched pair at E = 16 for each routed one, the contiguous attention
     once an attention layer and step, no other kernel), the prefill's
     logits and SSD states finite (the reference's chunked scan
     overflows to NaN at the serve's chunk of 128), the decode step's
     byte floor and the replay's share of it, jamba's decode replay with
     the live rows against rows=None (``legacy_rows_ab``), the decode
     step's logits
     and SSD states replayed against its eager calls at full depth
     (bit-equal), the prefill too (``prefill_replay``); each arch's
     2-layer f32 card vs CPU cross-check
     (LEGACY_XC; logits within LOGIT_TOL, greedy streams identical);
     ``serve.main --legacy --smoke`` of both and their exit without
     ``--legacy``, naming the ssd mixer;
 18. training, after phase 17 (its trees freed): starcoder2-3b at
     full width and depth, bf16 compute on f32 masters, 3 steps of
     ``launch/steps.make_train_step`` (microbatches of 4, CE chunks of
     128, remat) on one 8 x 128 ``SyntheticLM`` batch, losses finite and
     falling, step times and peak memory; its trained tree quantized and
     served by the Engine (rows 1, 3 and 8 launched, every step's logits
     finite); hubert-xlarge (48 L, bidirectional) at full width and
     depth, 2 steps on frames drawn from the seed; ``launch/train.main``
     on the granite-8b smoke config in a child process under
     ``torch.use_deterministic_algorithms``: a run with an injected
     failure and async checkpoints ends bit-equal to a clean run, and
     ``--resume auto`` continues from the clean run's last checkpoint;
 19. training on a (data, model) mesh, after phase 18: deepseek-moe-16b
     at full width, its first MESH_TRAIN_LAYERS of 28 layers, on a 2x2 mesh
     of ranks sharing the card over gloo (master params and moments
     sharded over data, Megatron over model, the routed experts on the
     expert axis; capacity factor ceil(E / top_k), so nothing drops),
     MESH_TRAIN["steps"] steps of two microbatches of 4 on one 8 x 128
     batch, then the same tree and batch at 1x1: step 1's loss within
     MESH_LOSS_RTOL and grad norm within MESH_GNORM_RTOL of 1x1's, the
     leaves whole over model bit-equal across the ranks, the ranks'
     peaks summed within MESH_PEAK_SUM_GB (19a); the trained params
     gathered onto rank 0, which quantizes and serves them as phase 18
     serves its tree (rows 1, 3, 1e, 3e and 8 launched, logits finite;
     the kernel line's launches of those rows, 19b); phase 18c's clean
     and faulted CLI runs at ``--data-axis 2 --dist-backend gloo``: the
     faulted run bit-equal to the clean one with one restart (19c);
 20. MLA and SSD layers trained on a model axis, after phase 19: in one
     1x2 world of ranks sharing the card over gloo, deepseek-v3-671b at
     full width cut to its layer 0 (absorbed MLA, the dense FFN of
     18,432) with its MTP block and 129,280-word untied head (20a), then
     mamba2-2.7b at full width, MLA_SSD_TRAIN's 8 of 64 layers (20b),
     each one step of two microbatches of 4 on one 8 x 128 batch; then
     both at 1x1 on the same trees and batches in a child process of
     its own (deepseek-v3's 1x1 state alone is ~44 GB, so never beside
     the world): step 1's loss within MESH_LOSS_RTOL and grad norm within
     MESH_GNORM_RTOL of 1x1's, the leaves whole over model and the SSD
     mixer's B/C runs held whole bit-equal across the ranks, the ranks'
     peaks summed within MESH_PEAK_SUM_GB; each trained tree gathered
     onto rank 0, quantized and served there through ``--legacy``
     (MLA_SSD_SERVE; the prefill's and a decode step's logits finite,
     rows 1 and 3 launched: the kernel line's launches of those rows,
     20c);
 21. the examples and the static checks, after phase 20: the port's
     ``examples/*_torch.py`` driven through their ``main`` on the card —
     the quickstart at the cost model's own linear (2048 x 4096 ->
     11008: rows 3 and 6 launched once each, dual pass = dense bit for
     bit, 21a), calibrate-and-serve on granite-8b at full width cut to
     2 layers (the global sweep's (l, h) and every candidate's sparsity
     equal to a CPU run of the sweep on the card's calibration stream,
     Algorithm 1 within ALG1_TOL of the CPU's, served tokens in the
     vocab, rows 1, 3 and 7 launched, 21b), train-with-failover at its
     full config (d 512, 60 steps: one restart, the restored params
     bit-equal, the last loss below the first, 21c) — and ``python -m
     repro_torch.analysis --check --no-mesh`` in a child process,
     started with the phase and run on the CPU beside it (exit 0, 21d);
 22. the dry-run and the ``--legacy`` steps on a mesh, after phase 21:
     ``python -m repro_torch.launch.dryrun --list`` (32 cells, 8 skips)
     and DRYRUN_CELLS planned on the host in child processes started
     before phase 16 (no card visible: meta tensors, rank 0 of a fake
     16x16 world, 22a; the prefill_32k and train_4k cells at
     DRYRUN_CARD_LAYERS' cut, planned and run alike); each of those
     cells as rank 0 of a fake world on
     the card, one call of its whole step on random data with the
     collectives elided: ``max_memory_allocated`` within max(PEAK_REL,
     PEAK_ABS_B) of the plan's peak, each kernel's launches = its op's
     count in the plan's trace, the step timed (22b); beside 22b, a world
     of two gloo ranks sharing the card runs granite-8b at
     MESH_LEGACY_LAYERS layers, full width, f32 through the ``--legacy``
     steps at 1x2 (batch 8) and 2x1 (batch 1): every rank's greedy tokens
     equal one device's, logits within LOGIT_TOL (22c). Phase 3 also
     holds row 7p (the partial decode) against its plain version and its
     merge against row 7 (``check_partial_attention``);
 23. the ``kernels`` JSON line, the card line, then the ``ok`` line.
Any failed check raises, so the script exits non-zero without the last
line. It needs a CUDA card and the rest of the repository beside it.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import gc
import importlib.util
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
OUT = ROOT / "chiprun_out"

# The card's published dense peaks (bytes/s, int8 op/s, f32 flop/s,
# NVLink bytes/s) by the part's name: one table, which the live
# attribution's roofline divides by too.
from repro_torch.core.costmodel import peaks_for  # noqa: E402
# ... and count each kernel's bytes and operations by the rules the live
# attribution counts a serving step's by (launch/step_cost.py).
from repro_torch.launch.step_cost import (attention_work,  # noqa: E402
                                          encoder_bytes, matmul_work)

# Stated tolerances. Encoder and matmul are integer work (and the same
# f32 drain multiplies): bit-exact. Attention sums in another order than
# the plain einsum/softmax: |err| <= ATTN_TOL in f32.
ATTN_TOL = 1e-4
# Cross-check: identical integer linears, but f32 attention/rope/matmul
# orders differ between card and CPU, which can move an int8 rounding
# by one step downstream: max |dlogit| <= LOGIT_TOL * max |logit|. The
# limit is about twice the worst reading on seeds 0-2 (0.0203, 0.0184,
# 4e-7 of max |logit| on an H100); the greedy streams must agree.
LOGIT_TOL = 0.04
# deepseek-moe-16b (phase 12): readings 0.0435, 0.0386, 0.0474 on seeds
# 0-2 (H100), absolute differences 0.19-0.22 as granite's 0.14-0.19, over
# a smaller max |logit| (4.6-4.9 against 7.3-7.8); a router top-6
# near-tie that the f32 sum order flips also moves a token's FFN output.
# Its limit is about twice the worst reading; the greedy streams must
# agree as for every arch.
LOGIT_TOL_ARCH = {"deepseek-moe-16b": 0.1, "deepseek-v3-671b": 0.13}
# deepseek-v3-671b (phase 16, 2 layers f32, 16 experts): readings 0.0658,
# 0.0548, 0.0547 of max |logit| on seeds 0-2 (MTP logits 0.0620, 0.0574,
# 0.0619; NVIDIA H100 80GB HBM3, 700.00 W), traced to int8 roundings that ulp-level f32 differences
# flip (the attention output's quantization before wo, 2e-4 of the layer
# out; the dense FFN's 18,432-wide down projection, 2%) and to the MoE
# layer's top-8-of-16 routing, which the moved input reroutes (8%). Its
# limit is about twice the worst reading.
XC_SEEDS = 3
SPEC_GAMMA = 2
# The encoder entries that take a scale: no serve launches them, since
# the serving linear calls the fused-scale entries.
UNFUSED = ("sparqle_encode", "sparqle_quantize", "sparqle_encode_packed")
# The granite-8b serve of phases 4 and 5.
SERVE = dict(batch=8, prompt_len=128, gen=16)
# Phase 4b: timed serves of each path (eager, graphs) after a warm one
# (one round since phase 16 came in: the smoke's wall passed 700 s).
GRAPH_ROUNDS = 1


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, args_list, iters: int = 20) -> float:
    """Mean device ms per call, cycling over ``args_list`` (so that weight
    sets larger than L2 arrive cold, as in a decode step). The calls are
    captured once into a CUDA graph and the replay is timed with CUDA
    events, so host-side wrapper overhead is not counted."""
    for a in args_list[:3]:
        fn(*a)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*args_list[i % len(args_list)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

# The fused encoder family (rows 1, 1q, 2): M and K of the check; 1024
# is the --legacy prefill, 200 a ragged width.
ENCODE_M = (1, 4, 8, 24, 32, 1024)
ENCODE_K = (4096, 14336, 200)


def encoder_input(dev, gen, m, k, dt):
    """x (M, K) in dt with an all-zero row 0 and, from M = 4, a row 1
    whose amax / 127 falls below 1e-8 (the scale's clamp), and a random
    column mask (the serve-time clip)."""
    x = (torch.randn((m, k), generator=gen, device=dev)
         * torch.rand((m, 1), generator=gen, device=dev) * 4).to(dt)
    if m > 1:
        x[0] = 0
    if m > 3:
        x[1] = (torch.randn((k,), generator=gen, device=dev) * 3e-7).to(dt)
    mask = torch.rand((k,), generator=gen, device=dev) < 0.5
    return x, mask


def check_fused_case(x, mask, where=""):
    """The three fused-scale entries on one input, each held against its
    plain version (``kernels.ref`` ``*_fused_ref``): scale, planes, PBM
    and populations bit-equal on every row up to M = 32 and, above, on
    the 32 rows from a tile boundary at M/2; the scale bit-equal to
    activation_scale(x).float() on every row, q = 16 * msb + lsb, and
    the entries that take a scale equal to the fused ones fed it."""
    from repro_torch.core.quantize import activation_scale
    from repro_torch.kernels import ref
    from repro_torch.kernels import sparqle_encode as E
    m = x.shape[0]
    r0 = 0 if m <= 32 else m // 2 // ref.TILE_M * ref.TILE_M
    rows = slice(r0, r0 + min(m, 32))
    tiles = slice(r0 // ref.TILE_M, -(-rows.stop // ref.TILE_M))
    cut = (rows, rows, rows, tiles, rows)       # planes, pop, scale

    def same(got, want, what):
        for i, (a, b) in enumerate(zip(got, want)):
            if not torch.equal(a[cut[i]], b):
                raise AssertionError(f"{what} differs from its plain version "
                                     f"(output {i}) {where}")

    xs = x[rows]
    scale = activation_scale(x).float()
    enc = E.sparqle_encode_fused(x, mask, -8, 23)
    *nopbm, s1b = E.sparqle_encode_fused(x, mask, -8, 23, with_pbm=False)
    q, s2 = E.sparqle_quantize_fused(x, mask, -8, 23)
    packed = E.sparqle_encode_packed_fused(x, mask, -8, 23)
    for s in (enc[-1], s1b, s2, packed[-1]):
        if not torch.equal(s, scale):
            raise AssertionError(f"fused scale differs {where}")
    same(enc, ref.sparqle_encode_fused_ref(xs, mask, -8, 23), "fused encoder")
    qw, sw = ref.sparqle_quantize_fused_ref(xs, mask, -8, 23)
    if not (torch.equal(q[rows], qw) and torch.equal(s2[rows], sw)):
        raise AssertionError(f"fused quantize differs from its plain version "
                             f"{where}")
    same(packed, ref.sparqle_encode_packed_fused_ref(xs, mask, -8, 23),
         "fused packed encoder")
    if not torch.equal(q.int(), enc[1].int() * 16 + enc[0].int()):
        raise AssertionError(f"fused quantize q != 16 * msb + lsb {where}")
    if nopbm[2] is not None or not all(torch.equal(nopbm[i], enc[i])
                                       for i in (0, 1, 3)):
        raise AssertionError(f"fused encoder without PBM differs {where}")
    # the entries that take a scale: the same body without the amax pass
    if not all(torch.equal(a, b) for a, b in zip(
            enc[:4], E.sparqle_encode(x, scale, mask, -8, 23))):
        raise AssertionError(f"encoder fed the scale differs {where}")
    if not torch.equal(q, E.sparqle_quantize(x, scale, mask, -8, 23)):
        raise AssertionError(f"quantize fed the scale differs {where}")
    if not all(torch.equal(a, b) for a, b in zip(
            packed[:4], E.sparqle_encode_packed(x, scale, mask, -8, 23))):
        raise AssertionError(f"packed encoder fed the scale differs {where}")


def check_fused_family(dev, gen):
    """check_fused_case over ENCODE_M x ENCODE_K x bf16, f32; returns the
    number of input sets."""
    cases = 0
    for m in ENCODE_M:
        for k in ENCODE_K:
            for dt in (torch.bfloat16, torch.float32):
                x, mask = encoder_input(dev, gen, m, k, dt)
                check_fused_case(x, mask, f"at M={m} K={k} {dt}")
                cases += 1
    return cases


def time_encoder(dev, gen, peaks, fused, unfused, plain, out_bytes):
    """One fused encoder entry timed as the serving linear calls it (M=8,
    K=4096, bf16, masked columns), beside the entry that takes a scale
    (the same body without the amax pass) alone and after the scale
    chain the fused entry replaces (activation_scale + cast + encoder);
    bound by bytes: x read once, scale and ``out_bytes(m, k)`` written."""
    from repro_torch.core.quantize import activation_scale
    m, k = 8, 4096
    x, mask = encoder_input(dev, gen, m, k, torch.bfloat16)
    args = [(x, mask, -8, 23)]

    def chain(x, mask, lo, hi):
        return unfused(x, activation_scale(x).float(), mask, lo, hi)

    kms = time_ms(fused, args, 200)
    cms = time_ms(chain, args, 200)
    sms = time_ms(unfused, [(x, activation_scale(x).float(), mask, -8, 23)],
                  200)
    pms = time_ms(plain, args, 50)
    nbytes = encoder_bytes(m, k, xb=2, mask=k, planes=out_bytes(m, k))
    return {"max_abs_err": 0.0, "ms": kms, "plain_ms": pms,
            "bound_ms": nbytes / peaks[0] * 1e3, "bound_by": "bytes",
            "library_ms": None, "chain_ms": cms,
            "detail": [{"key": "scale_in", "ms": sms}]}


def check_encoder(dev, gen, peaks):
    """Row 1: the fused encoder (scale + encode in one launch), checked
    with the two other fused entries by check_fused_family."""
    from repro_torch.kernels import sparqle_encode as E
    from repro_torch.kernels.ref import (TILE_K, TILE_M,
                                         sparqle_encode_fused_ref)

    def fused(*a):
        return E.sparqle_encode_fused(*a, with_pbm=False)

    def unfused(*a):
        return E.sparqle_encode(*a, with_pbm=False)

    def out_bytes(m, k):
        return 2 * m * k + -(-m // TILE_M) * -(-k // TILE_K) * 4

    t0 = time.perf_counter()
    n = check_fused_family(dev, gen)
    r = time_encoder(dev, gen, peaks, fused, unfused, sparqle_encode_fused_ref,
                     out_bytes)
    plan = E.fused_plan(4096)
    return {"name": "sparqle_encode_fused", "route": "cuda",
            "source": "src/repro_torch/csrc/sparqle_encode.cu",
            "replaces": "src/repro/kernels/sparqle_encode.py:69", **r,
            "shape": f"M=8 K=4096 bf16 no PBM plane, scale included "
                     f"({plan.blocks} blocks x {plan.tiles} tiles a row group; "
                     f"unfused encoder after abs/amax/div/clamp_min/cast "
                     f"{r['chain_ms'] * 1e3:.1f} us, alone "
                     f"{r['detail'][0]['ms'] * 1e3:.1f} us); fused family "
                     f"checked "
                     f"on {n} input sets (M in {ENCODE_M} x K in {ENCODE_K} "
                     f"x bf16,f32, zero and tiny rows) in "
                     f"{time.perf_counter() - t0:.1f} s"}


# The W4A8 matmul family (rows 3, 4, 5a, 5b and the dense row 6: one CUDA
# body, five entries) at the shapes the port runs: M = 8 decode, 24 the
# verify window, 32 a prefill chunk, 1024 the --legacy prefill.
MATMUL_M = (1, 8, 16, 17, 24, 32, 33, 64, 1024)
MATMUL_KN = ((4096, 14336), (4096, 4096), (4096, 1024), (14336, 4096),
             (200, 70), (4100, 1024))
POP_PATTERNS = ("zero", "live", "alternating")
# timed: M=8 at the four granite shapes, M=32 and M=1024 at w_gate/w_up
MATMUL_TIMED = [(8, k, n) for k, n in MATMUL_KN[:4]] + [
    (32, 4096, 14336), (1024, 4096, 14336)]


def matmul_case(dev, gen, m, k, n, pattern, extreme=False):
    """One input set for the five entries: a random int8 q (the dense
    entry's operand), its unpacked planes, their wire-layout planes, the
    tile populations (``pattern``: MSB plane zero everywhere, live in
    every tile, or zero on every other K tile), the packed int4 weight
    and the scales.
    ``extreme``: q = -128 and w = -8 everywhere."""
    from repro_torch.core.packing import pack_nibbles, pad_k
    from repro_torch.core.qlinear import pack_int4
    from repro_torch.kernels.ref import (TILE_K, TILE_M,
                                         tile_population_padded)
    if extreme:
        q = torch.full((m, k), -128, dtype=torch.int8, device=dev)
        w = torch.full((k, n), -8, dtype=torch.int8, device=dev)
    else:
        q = torch.randint(-128, 128, (m, k), generator=gen, device=dev,
                          dtype=torch.int8)
        w = torch.randint(-8, 8, (k, n), generator=gen, device=dev,
                          dtype=torch.int8)
        tiles = torch.arange(k, device=dev) // TILE_K
        if pattern == "zero":
            q = q & 0xF
        elif pattern == "live":      # an MSB in every (row, K tile)
            q[:, ::TILE_K] = q[:, ::TILE_K] | 0x40
        else:
            q = torch.where((tiles % 2 == 0)[None, :], q, q & 0xF)
    lsb, msb = q & 0xF, q >> 4
    pop = tile_population_padded(msb != 0, TILE_M, TILE_K)
    pad = (0, pad_k(k) - k)
    lp = pack_nibbles(torch.nn.functional.pad(lsb, pad))
    mp = pack_nibbles(torch.nn.functional.pad(msb, pad))
    asc = torch.rand((m, 1), generator=gen, device=dev) * 0.1
    wsc = torch.rand((1, n), generator=gen, device=dev) * 0.01 + 1e-3
    return dict(q=q, w=w, wp=pack_int4(w), lsb=lsb, msb=msb, pop=pop, lp=lp,
                mp=mp, asc=asc, wsc=wsc)


def _dense(fn):
    """The dense wrapper ``fn`` in the dual-pass call form: (q, unused,
    unused, w_packed, act_scale, w_scale)."""
    def call(q, _msb, _pop, wp, asc, wsc, acc_out=False, msb_skip=True,
             **kw):
        return fn(q, wp, asc, wsc, acc_out=acc_out, **kw)
    return call


# entry name -> (wrapper, plain version, operands, msb_skip, the q that
# torch._int_mm multiplies: the LSB plane for a draft, else q)
def matmul_instances():
    from repro_torch.kernels import ref
    from repro_torch.kernels import sparqle_matmul as sm
    from repro_torch.kernels.quant_matmul import quant_matmul
    return {"sparqle_matmul": (sm.sparqle_matmul, ref.sparqle_matmul_ref,
                               ("lsb", "msb"), False, "q"),
            "sparqle_matmul_packed": (sm.sparqle_matmul_packed,
                                      ref.sparqle_matmul_packed_ref,
                                      ("lp", "mp"), False, "q"),
            "sparqle_matmul_draft": (sm.sparqle_matmul,
                                     ref.sparqle_matmul_ref, ("lsb", "msb"),
                                     True, "lsb"),
            "sparqle_matmul_packed_draft": (sm.sparqle_matmul_packed,
                                            ref.sparqle_matmul_packed_ref,
                                            ("lp", "mp"), True, "lsb"),
            "quant_matmul": (_dense(quant_matmul),
                             _dense(ref.quant_matmul_ref), ("q", "msb"),
                             True, "q")}


def check_matmul_case(c, where=""):
    """All five entries, f32 and int32 outputs: each torch.equal to its
    plain version, packed = unpacked, full and draft alike, and dense on
    q = the dual pass on its planes."""
    got = {}
    for name, (fn, plain, planes, skip, _) in matmul_instances().items():
        args = (c[planes[0]], c[planes[1]], c["pop"], c["wp"], c["asc"],
                c["wsc"])
        for acc_out in (False, True):
            kw = dict(acc_out=acc_out, msb_skip=skip)
            out = fn(*args, **kw)
            if not torch.equal(out, plain(*args, **kw)):
                raise AssertionError(f"{name} differs from its plain version "
                                     f"{where} acc_out={acc_out}")
            got[name, acc_out] = out
    for acc_out in (False, True):
        for a, b in (("sparqle_matmul", "sparqle_matmul_packed"),
                     ("sparqle_matmul_draft", "sparqle_matmul_packed_draft"),
                     ("sparqle_matmul", "quant_matmul")):
            if not torch.equal(got[a, acc_out], got[b, acc_out]):
                raise AssertionError(f"{b} differs from {a} {where} "
                                     f"acc_out={acc_out}")


def check_matmul_family(dev, gen) -> int:
    """The five entries over MATMUL_M x MATMUL_KN x POP_PATTERNS, plus
    q = -128, w = -8 everywhere; returns the number of
    input sets checked (one split and several both occur)."""
    from repro_torch.kernels.sparqle_matmul import launch_plan
    cases, splits = 0, set()
    for k, n in MATMUL_KN:
        for m in MATMUL_M:
            for pattern in POP_PATTERNS:
                check_matmul_case(matmul_case(dev, gen, m, k, n, pattern),
                                  f"at M={m} K={k} N={n} pop={pattern}")
                cases += 1
            splits.add(launch_plan(m, n, k).splits > 1)
        for m in (8, 33, 1024):
            check_matmul_case(matmul_case(dev, gen, m, k, n, "", True),
                              f"at M={m} K={k} N={n} q=-128 w=-8")
            cases += 1
    if splits != {False, True}:
        raise AssertionError("the sweep must run one split and several")
    return cases


def time_matmul_family(dev, gen, peaks, names):
    """Device time of the instances ``names`` at MATMUL_TIMED (MSB zero
    on every other K tile), each beside its plain version, its bound and
    torch._int_mm on the same q (LSB plane for a draft) and weight (the
    dense entry: one pass over q, counted as a draft is); at
    M <= 16 torch._int_mm needs more than 16 rows, so it runs at M = 32.
    Returns {name: [detail, ...]}."""
    inst = matmul_instances()
    detail = {name: [] for name in names}
    for m, k, n in MATMUL_TIMED:
        c = matmul_case(dev, gen, m, k, n, "alternating")
        # weight copies beyond L2, so that each call finds its weight cold
        copies = max(1, math.ceil(150e6 / c["wp"].numel()))
        wps = [c["wp"].clone() for _ in range(copies)]
        live = (c["pop"] > 0).sum().item() / c["pop"].numel()
        ml = max(m, 32)
        qa = torch.zeros((ml, k), dtype=torch.int8, device=dev)
        for name in names:
            fn, plain, planes, skip, lib_q = inst[name]
            a0, a1 = c[planes[0]], c[planes[1]]

            def call(*a, _fn=fn, _skip=skip):
                return _fn(*a, msb_skip=_skip)

            def ref(*a, _fn=plain, _skip=skip):
                return _fn(*a, msb_skip=_skip)

            args = [(a0, a1, c["pop"], w, c["asc"], c["wsc"]) for w in wps]
            kms = time_ms(call, args, 50)
            pms = time_ms(ref, args[:1], 5)
            qa[:m] = c[lib_q]
            lib = time_ms(torch._int_mm, [(qa, c["w"])], 50)
            nbytes, ops = matmul_work(m, k, n, plane_row=a0.numel() / m,
                                      passes=1 if skip else 1 + live)
            detail[name].append({
                "M": m, "K": k, "N": n, "ms": kms, "plain_ms": pms,
                "library_ms": lib, "library": f"torch._int_mm at M={ml}",
                "bound_ms": max(nbytes / peaks[0], ops / peaks[1]) * 1e3,
                "bound_by": "bytes" if nbytes / peaks[0] >= ops / peaks[1]
                else "operations"})
    return detail


def matmul_row(name, replaces, detail, note=""):
    """The kernels-line row of one entry (``replaces``: file:line under
    src/repro/kernels): its time at M=8, 4096 -> 14336 (w_gate/w_up at
    decode); every timed shape in ``detail``."""
    timed = detail[0]
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/sparqle_matmul.cu",
            "replaces": f"src/repro/kernels/{replaces}",
            "max_abs_err": 0.0, "ms": timed["ms"],
            "plain_ms": timed["plain_ms"], "bound_ms": timed["bound_ms"],
            "bound_by": timed["bound_by"],
            "library_ms": timed["library_ms"],
            "shape": f"M=8 K=4096 N=14336{note}; also timed at "
                     + ", ".join(f"M={d['M']} {d['K']}->{d['N']} "
                                 f"{d['ms'] * 1e3:.1f} us"
                                 for d in detail[1:])
                     + "; library: torch._int_mm at M=max(M, 32)",
            "detail": detail}


def check_matmul(dev, gen, peaks):
    """Row 3 timed (the five entries are held bit-exact by
    check_matmul_family)."""
    d = time_matmul_family(dev, gen, peaks, ["sparqle_matmul"])
    return matmul_row("sparqle_matmul", "sparqle_matmul.py:209",
                      d["sparqle_matmul"])


# The attention rows (7-10) at a long context too: 8 sequences of about
# 4,096 tokens through tables of 256 pages of 16 (about 17 MB of pool for
# K and again for V), LONG_COPIES copies of every cache so that each
# timed call reads its pages cold (beyond the 50 MB L2).
LONG_POS = (4095, 4031, 4064, 4095, 3999, 4095, 4050, 4090)
LONG_NS = 256
LONG_COPIES = 3
_LONG = {}


def kv_pool(dev, gen, n_pages, ps=16, kvh=8, hd=128):
    """Random KV4 pages and scales: (k_pages, k_scale, v_pages, v_scale)."""
    kp, vp = (torch.randint(-128, 128, (n_pages, ps, kvh, hd // 2),
                            generator=gen, device=dev, dtype=torch.int8)
              for _ in range(2))
    ks, vs = (torch.rand((n_pages, ps, kvh), generator=gen, device=dev) * 0.2
              for _ in range(2))
    return kp, ks, vp, vs


def long_context(dev, gen):
    """The long-context pools (LONG_COPIES of them, one table), made once
    a process."""
    if not _LONG:
        b = len(LONG_POS)
        pools = [kv_pool(dev, gen, 1 + b * LONG_NS)
                 for _ in range(LONG_COPIES)]
        perm = torch.randperm(b * LONG_NS, generator=gen, device=dev) + 1
        _LONG.update(pools=pools, tables=perm.reshape(b, LONG_NS).to(
            torch.int32).contiguous(), pos=torch.tensor(
                LONG_POS, dtype=torch.int32, device=dev))
    return _LONG


def attn_bound(peaks, n_q, toks, work, kv2_toks=0, extra=0, kvh=8, g=4,
               hd=128, qb=4, qk_bf16=False):
    """(bound ms, what bounds it) of an attention call: q and out of n_q
    query groups at ``qb`` bytes (f32: 4), ``toks`` KV4 (and ``kv2_toks``
    KV2) tokens read once a kv head, ``extra`` bytes of tables and
    positions; 4 G hd flops a kv head for each of ``work`` (query, token)
    pairs, half of them q.k and half p.v. The p.v half is f32 (p is), at
    the f32 rate; so is q.k, unless ``qk_bf16`` (a bf16 q with
    ``round_kv``: both operands bf16), at the bf16 tensor-core rate, half
    the int8 rate on every H100 part. The two halves run on separate
    units, so the operations take the longer of the two."""
    nbytes, flops = attention_work(n_q, kvh * g, hd, kvh, kv4_tokens=toks,
                                   kv2_tokens=kv2_toks, pairs=work, qb=qb)
    nbytes += extra
    t_ops = (max(flops / peaks[1], flops / 2 / peaks[2]) if qk_bf16
             else flops / peaks[2])
    by = "bytes" if nbytes / peaks[0] >= t_ops else "operations"
    return max(nbytes / peaks[0], t_ops) * 1e3, by


def page_tokens(pos, ps, n_s, t=1):
    """Tokens of the pages a window of t tokens at each pos reads."""
    return sum((min((int(p) + t - 1) // ps, n_s - 1) + 1) * ps for p in pos)


def split_note():
    from repro_torch.kernels.kv_attention import WARPS, split_plan
    return "; ".join(
        f"NS={n}: cluster {p.cluster} x {WARPS} warps x "
        f"{p.pages_per_warp} page(s)"
        for n, p in ((n, split_plan(n)) for n in (9, 16, LONG_NS)))


def check_attention(dev, gen, peaks):
    """Row 8 at the smoke shape (B=8, KVH=8, G=4, hd=128, ps=16, Pmax=16)
    and at the long context: within ATTN_TOL of the plain version (f32;
    bf16 within one bf16 step), a table widened past pos (more cluster
    ranks launched, all past pos) giving the same bits; timed at both
    shapes."""
    from repro_torch.kernels.kv_attention import kv4_paged_decode_attention
    from repro_torch.kernels.ref import kv4_paged_decode_attention_ref
    b, kvh, g, hd, ps, n_s, n_pages = 8, 8, 4, 128, 16, 16, 160
    kp, ks, vp, vs = kv_pool(dev, gen, n_pages)
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    tables = perm[:b * n_s].reshape(b, n_s).to(torch.int32).contiguous()
    pos = torch.tensor([0, 15, 16, 17, 100, 143, 255, 0], dtype=torch.int32,
                       device=dev)
    tables[-1] = 0                 # inactive slot: null page, pos 0
    wide = torch.cat([tables, perm[-b * n_s:].reshape(b, n_s).to(
        torch.int32)], 1).contiguous()
    err = 0.0
    for dt in (torch.float32, torch.bfloat16):
        q = torch.randn((b, kvh, g, hd), generator=gen, device=dev).to(dt)
        args = (q, kp, ks, vp, vs, tables, pos)
        got = kv4_paged_decode_attention(*args)
        want = kv4_paged_decode_attention_ref(*args).float()
        e = (got.float() - want).abs().max().item()
        tol = ATTN_TOL if dt == torch.float32 else 2 ** -7 * max(
            1.0, want.abs().max().item())
        if not e <= tol:
            raise AssertionError(f"attention {dt}: max err {e} > {tol}")
        if not torch.equal(got, kv4_paged_decode_attention(
                q, kp, ks, vp, vs, wide, pos)):
            raise AssertionError(f"attention {dt}: ranks launched past pos "
                                 f"changed the bits")
        if dt == torch.float32:
            err, f32_args = e, args
    kms = time_ms(kv4_paged_decode_attention, [f32_args], 200)
    pms = time_ms(kv4_paged_decode_attention_ref, [f32_args], 20)
    toks = page_tokens(pos.tolist(), ps, n_s)
    bound, by = attn_bound(peaks, b, toks, toks, extra=b * n_s * 4 + b * 4)
    # the long context
    lc = long_context(dev, gen)
    q = torch.randn((b, kvh, g, hd), generator=gen, device=dev)
    largs = [(q, *pool, lc["tables"], lc["pos"]) for pool in lc["pools"]]
    le = (kv4_paged_decode_attention(*largs[0])
          - kv4_paged_decode_attention_ref(*largs[0])).abs().max().item()
    if not le <= ATTN_TOL:
        raise AssertionError(f"attention, long context: max err {le}")
    lms = time_ms(kv4_paged_decode_attention, largs, 60)
    ltoks = page_tokens(LONG_POS, ps, LONG_NS)
    lbound, lby = attn_bound(peaks, b, ltoks, ltoks,
                             extra=b * LONG_NS * 4 + b * 4)
    return {"name": "kv4_paged_decode_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/kv_attention.cu",
            "replaces": "src/repro/kernels/kv_attention.py:206",
            "max_abs_err": max(err, le), "ms": kms, "plain_ms": pms,
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "shape": f"B=8 KVH=8 G=4 hd=128 ps=16 Pmax=16, f32 q; long "
                     f"context (B=8, ~4,096 tokens, Pmax=256, cold): "
                     f"{lms * 1e3:.1f} us against a {lbound * 1e3:.2f} us "
                     f"{lby} bound ({lbound / lms * 100:.0f}%); split: "
                     f"{split_note()}",
            "detail": [{"key": "long", "ms": lms, "bound_ms": lbound,
                        "bound_by": lby, "max_abs_err": le}]}


def check_draft_matmul(dev, gen, peaks):
    """Row 5a timed, beside the full dual-pass kernel on the same planes."""
    d = time_matmul_family(dev, gen, peaks,
                           ["sparqle_matmul_draft", "sparqle_matmul"])
    for dd, full in zip(d["sparqle_matmul_draft"], d["sparqle_matmul"]):
        dd["full_ms"] = full["ms"]
    return matmul_row("sparqle_matmul_draft", "sparqle_matmul.py:142",
                      d["sparqle_matmul_draft"],
                      f" (full kernel "
                      f"{d['sparqle_matmul'][0]['ms'] * 1e3:.1f} us on the "
                      f"same planes)")


def check_verify_attention(dev, gen, peaks):
    """The verify window at B=8, KVH=8, G=4, hd=128, T=SPEC_GAMMA+1,
    contexts up to 16 pages of 16, windows crossing page boundaries:
    within ATTN_TOL of the plain version (f32) and bit-exact with T
    calls of the decode kernel (f32 and bf16)."""
    from repro_torch.kernels.kv_attention import (kv4_paged_decode_attention,
                                                  kv4_paged_verify_attention)
    from repro_torch.kernels.ref import kv4_paged_verify_attention_ref
    b, kvh, g, hd, ps, n_s, n_pages = 8, 8, 4, 128, 16, 16, 160
    t = SPEC_GAMMA + 1
    kp = torch.randint(-128, 128, (n_pages, ps, kvh, hd // 2),
                       generator=gen, device=dev, dtype=torch.int8)
    vp = torch.randint(-128, 128, (n_pages, ps, kvh, hd // 2),
                       generator=gen, device=dev, dtype=torch.int8)
    ks = torch.rand((n_pages, ps, kvh), generator=gen, device=dev) * 0.2
    vs = torch.rand((n_pages, ps, kvh), generator=gen, device=dev) * 0.2
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    tables = perm[:b * n_s].reshape(b, n_s).to(torch.int32).contiguous()
    # windows [pos, pos + t): 14-16, 15-17 and 142-144 cross a page
    pos = torch.tensor([0, 14, 15, 16, 100, 142, n_s * ps - t, 0],
                       dtype=torch.int32, device=dev)
    tables[-1] = 0                 # inactive slot: null page, pos 0
    err = 0.0
    for dt in (torch.float32, torch.bfloat16):
        q = torch.randn((b, t, kvh, g, hd), generator=gen, device=dev).to(dt)
        args = (q, kp, ks, vp, vs, tables, pos)
        got = kv4_paged_verify_attention(*args)
        for i in range(t):
            single = kv4_paged_decode_attention(q[:, i].contiguous(), kp, ks,
                                                vp, vs, tables, pos + i)
            if not torch.equal(got[:, i], single):
                raise AssertionError(f"verify attention {dt} window token "
                                     f"{i} differs from the decode kernel")
        want = kv4_paged_verify_attention_ref(*args).float()
        e = (got.float() - want).abs().max().item()
        tol = ATTN_TOL if dt == torch.float32 else 2 ** -7 * max(
            1.0, want.abs().max().item())
        if not e <= tol:
            raise AssertionError(f"verify attention {dt}: max err {e} > "
                                 f"{tol}")
        if dt == torch.float32:
            err, f32_args = e, args
    kms = time_ms(kv4_paged_verify_attention, [f32_args], 200)
    pms = time_ms(kv4_paged_verify_attention_ref, [f32_args], 20)
    q = f32_args[0]
    singles = [(q[:, i].contiguous(), kp, ks, vp, vs, tables, pos + i)
               for i in range(t)]
    loop_ms = time_ms(kv4_paged_decode_attention, singles, 201) * t
    last = [min((int(p) + t - 1) // ps, n_s - 1) for p in pos.tolist()]
    toks = sum((lp + 1) * ps for lp in last)          # pages read once
    work = sum((min((int(p) + i) // ps, n_s - 1) + 1) * ps
               for p in pos.tolist() for i in range(t))
    bound, by = attn_bound(peaks, b * t, toks, work,
                           extra=b * n_s * 4 + b * 4)
    # the long context: windows ending at LONG_POS
    lc = long_context(dev, gen)
    lpos = lc["pos"] - (t - 1)
    q = torch.randn((b, t, kvh, g, hd), generator=gen, device=dev)
    largs = [(q, *pool, lc["tables"], lpos) for pool in lc["pools"]]
    got = kv4_paged_verify_attention(*largs[0])
    for i in range(t):
        if not torch.equal(got[:, i], kv4_paged_decode_attention(
                q[:, i].contiguous(), *lc["pools"][0], lc["tables"],
                lpos + i)):
            raise AssertionError(f"verify attention, long context: window "
                                 f"token {i} differs from the decode kernel")
    lms = time_ms(kv4_paged_verify_attention, largs, 60)
    lloop = time_ms(kv4_paged_decode_attention, [
        (q[:, i].contiguous(), *pool, lc["tables"], lpos + i)
        for pool in lc["pools"] for i in range(t)], 60) * t
    ltoks = page_tokens(lpos.tolist(), ps, LONG_NS, t)
    lwork = sum(page_tokens([int(p) + i], ps, LONG_NS)
                for p in lpos.tolist() for i in range(t))
    lbound, lby = attn_bound(peaks, b * t, ltoks, lwork,
                             extra=b * LONG_NS * 4 + b * 4)
    return {"name": "kv4_paged_verify_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/kv_attention.cu",
            "replaces": "src/repro/kernels/kv_attention.py:280",
            "max_abs_err": err, "ms": kms, "plain_ms": pms,
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "shape": f"B=8 T={t} KVH=8 G=4 hd=128 ps=16 Pmax=16, f32 q "
                     f"({t} decode-kernel calls: {loop_ms * 1e3:.1f} us); "
                     f"long context: {lms * 1e3:.1f} us ({t} decode calls "
                     f"{lloop * 1e3:.1f} us) against a {lbound * 1e3:.2f} "
                     f"us {lby} bound",
            "detail": [{"key": "long", "ms": lms, "bound_ms": lbound,
                        "bound_by": lby, "decode_calls_ms": lloop}]}


def check_quantize(dev, gen, peaks):
    """Row 1q: the fused quantize-only entry (the dense linear's
    activation and its scale in one launch; checked by
    check_fused_family), timed as the dense linear calls it."""
    from repro_torch.kernels import sparqle_encode as E
    from repro_torch.kernels.ref import sparqle_quantize_fused_ref
    r = time_encoder(dev, gen, peaks, E.sparqle_quantize_fused,
                     E.sparqle_quantize, sparqle_quantize_fused_ref,
                     lambda m, k: m * k)
    return {"name": "sparqle_quantize_fused", "route": "cuda",
            "source": "src/repro_torch/csrc/sparqle_encode.cu",
            "replaces": "src/repro/kernels/sparqle_encode.py:69", **r,
            "shape": f"M=8 K=4096 bf16, scale included (the _quantize "
                     f"step of row 1 alone; unfused after the scale chain "
                     f"{r['chain_ms'] * 1e3:.1f} us, alone "
                     f"{r['detail'][0]['ms'] * 1e3:.1f} us)"}


def check_dense_matmul(dev, gen, peaks):
    """Row 6 timed at MATMUL_TIMED (the five entries are held bit-exact
    by check_matmul_family), then the kernel-level format comparison that
    phase 7 stands for: at M = 8 and 32, 4096 -> 14336, the dense entry,
    the dual pass and the draft on the same q (its planes), under each of
    POP_PATTERNS, every call on a cold weight."""
    d = time_matmul_family(dev, gen, peaks, ["quant_matmul"])
    inst = matmul_instances()
    formats = []
    for m in (8, 32):
        for pattern in POP_PATTERNS:
            c = matmul_case(dev, gen, m, 4096, 14336, pattern)
            copies = max(1, math.ceil(150e6 / c["wp"].numel()))
            wps = [c["wp"].clone() for _ in range(copies)]
            row = {"M": m, "pop": pattern,
                   "live": (c["pop"] > 0).sum().item() / c["pop"].numel()}
            for name in ("quant_matmul", "sparqle_matmul",
                         "sparqle_matmul_draft"):
                fn, _, planes, skip, _ = inst[name]
                row[name] = time_ms(
                    functools.partial(fn, msb_skip=skip),
                    [(c[planes[0]], c[planes[1]], c["pop"], w, c["asc"],
                      c["wsc"]) for w in wps], 50)
            formats.append(row)
    r = matmul_row("quant_matmul", "quant_matmul.py:45", d["quant_matmul"])
    r["formats"] = formats
    return r


def demoted_pool(dev, gen, b, kvh, hd, ps, n_s, n_pages):
    """A paged KV4 pool with distinct pages per slot (the last slot
    inactive), and the first half of every active slot's pages demoted
    to a KV2 slab by the port's ``tiering.demote_page``. Returns the KV4
    args, the tiered args and the KV4 args with those pages clamped to
    [-2, 1] in place (what a demoted page must read back as)."""
    from repro_torch.core.packing import pack_plane, unpack_plane
    from repro_torch.serving import tiering
    kp, vp = (torch.randint(-128, 128, (n_pages, ps, kvh, hd // 2),
                            generator=gen, device=dev, dtype=torch.int8)
              for _ in range(2))
    ks, vs = (torch.rand((n_pages, ps, kvh), generator=gen, device=dev)
              * 0.2 for _ in range(2))
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    tables = perm[:b * n_s].reshape(b, n_s).to(torch.int32).contiguous()
    tables[-1] = 0                 # inactive slot: null page, pos 0
    n2 = 1 + (b - 1) * (n_s // 2)
    state = {"k_q": kp[None], "k_s": ks[None], "v_q": vp[None],
             "v_s": vs[None]}
    for name in ("k2", "v2"):
        state[f"{name}_q"] = torch.zeros((1, n2, ps, kvh, hd // 4),
                                         dtype=torch.int8, device=dev)
        state[f"{name}_s"] = torch.ones((1, n2, ps, kvh), device=dev)
    tiers = torch.zeros_like(tables)
    tables2 = tables.clone()
    kpc, vpc = kp.clone(), vp.clone()
    dst = 1
    for i in range(b - 1):
        for j in range(n_s // 2):
            src = int(tables[i, j])
            tiering.demote_page(state, src, dst)
            tables2[i, j], tiers[i, j] = dst, 1
            for page, clamped in ((kp, kpc), (vp, vpc)):
                nib = unpack_plane(page[src], width=4, signed=True)
                clamped[src] = pack_plane(nib.clamp(-2, 1), width=4)
            dst += 1
    kv2 = tuple(state[k][0] for k in ("k2_q", "k2_s", "v2_q", "v2_s"))
    return ((kp, ks, vp, vs, tables), (kp, ks, vp, vs, *kv2, tables2, tiers),
            (kpc, ks, vpc, vs, tables))


def check_tiered_attention(dev, gen, peaks):
    """The mixed-tier decode at B=8, KVH=8, G=4, hd=128, ps=16, contexts
    up to 16 pages, half of each active slot's pages demoted: all tier 0
    bit-exact with the decode kernel, demoted bit-exact with the decode
    kernel on the clamped pages (f32 and bf16), within ATTN_TOL of the
    plain version (f32); timed beside the decode kernel on the clamped
    pages."""
    from repro_torch.kernels.kv_attention import (
        kv4_paged_decode_attention, kv_tiered_paged_decode_attention)
    from repro_torch.kernels.ref import kv_tiered_paged_decode_attention_ref
    b, kvh, g, hd, ps, n_s, n_pages = 8, 8, 4, 128, 16, 16, 160
    kv4, tiered, clamped = demoted_pool(dev, gen, b, kvh, hd, ps, n_s,
                                        n_pages)
    pos = torch.tensor([0, 15, 16, 17, 100, 143, 255, 0], dtype=torch.int32,
                       device=dev)
    err = 0.0
    for dt in (torch.float32, torch.bfloat16):
        q = torch.randn((b, kvh, g, hd), generator=gen, device=dev).to(dt)
        zeros = torch.zeros_like(kv4[-1])
        all_kv4 = kv_tiered_paged_decode_attention(q, *kv4[:4], *tiered[4:8],
                                                   kv4[-1], zeros, pos)
        if not torch.equal(all_kv4, kv4_paged_decode_attention(q, *kv4,
                                                               pos)):
            raise AssertionError(f"tiered attention {dt}, all tier 0: not "
                                 f"the decode kernel's bits")
        args = (q, *tiered, pos)
        got = kv_tiered_paged_decode_attention(*args)
        if not torch.equal(got, kv4_paged_decode_attention(q, *clamped,
                                                           pos)):
            raise AssertionError(f"tiered attention {dt}, demoted pages: not "
                                 f"the decode kernel's bits on the clamped "
                                 f"pages")
        if dt == torch.float32:
            err = (got - kv_tiered_paged_decode_attention_ref(*args)
                   ).abs().max().item()
            if not err <= ATTN_TOL:
                raise AssertionError(f"tiered attention: max err {err} > "
                                     f"{ATTN_TOL}")
            f32_args, dec_args = args, (q, *clamped, pos)
    kms = time_ms(kv_tiered_paged_decode_attention, [f32_args], 200)
    dec = time_ms(kv4_paged_decode_attention, [dec_args], 200)
    pms = time_ms(kv_tiered_paged_decode_attention_ref, [f32_args], 20)
    tiers = tiered[-1]
    tok4 = tok2 = 0
    for i, p in enumerate(pos.tolist()):
        for j in range(min(p // ps, n_s - 1) + 1):
            if tiers[i, j]:
                tok2 += ps
            else:
                tok4 += ps
    bound, by = attn_bound(peaks, b, tok4, tok4 + tok2, kv2_toks=tok2,
                           extra=2 * b * n_s * 4 + b * 4)
    # the long context, half of each active slot's pages demoted
    kv4, tiered, clamped = demoted_pool(dev, gen, b, kvh, hd, ps, LONG_NS,
                                        1 + b * LONG_NS)
    lpos = torch.tensor(LONG_POS[:-1] + (0,), dtype=torch.int32, device=dev)
    q = torch.randn((b, kvh, g, hd), generator=gen, device=dev)
    if not torch.equal(kv_tiered_paged_decode_attention(q, *tiered, lpos),
                       kv4_paged_decode_attention(q, *clamped, lpos)):
        raise AssertionError("tiered attention, long context: not the decode "
                             "kernel's bits on the clamped pages")
    largs = [(q, *(x.clone() for x in tiered), lpos)
             for _ in range(LONG_COPIES)]
    lms = time_ms(kv_tiered_paged_decode_attention, largs, 60)
    ltok2 = sum(ps for i, p in enumerate(lpos.tolist())
                for j in range(min(p // ps, LONG_NS - 1) + 1)
                if tiered[-1][i, j])
    ltok4 = page_tokens(lpos.tolist(), ps, LONG_NS) - ltok2
    lbound, lby = attn_bound(peaks, b, ltok4, ltok4 + ltok2, kv2_toks=ltok2,
                             extra=2 * b * LONG_NS * 4 + b * 4)
    return {"name": "kv_tiered_paged_decode_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/kv_attention.cu",
            "replaces": "src/repro/kernels/kv_attention.py:366",
            "max_abs_err": err, "ms": kms, "plain_ms": pms,
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "shape": f"B=8 KVH=8 G=4 hd=128 ps=16 Pmax=16, f32 q, "
                     f"{tok2 // ps} of {(tok4 + tok2) // ps} pages read "
                     f"from KV2 (decode kernel on the clamped pages: "
                     f"{dec * 1e3:.1f} us); long context (7 slots, "
                     f"{ltok2 // ps} of {(ltok4 + ltok2) // ps} pages from "
                     f"KV2): {lms * 1e3:.1f} us against a "
                     f"{lbound * 1e3:.2f} us {lby} bound",
            "detail": [{"key": "long", "ms": lms, "bound_ms": lbound,
                        "bound_by": lby}]}


def check_encoder_packed(dev, gen, peaks):
    """Row 2: the fused packed entry, checked by check_fused_family, and
    the packed entry that takes a scale held against its plain version
    and against the unpacked entry's planes packed by the codec at K =
    4096, 14336 and a ragged 4100; timed as the packed serving linear
    calls it."""
    import torch.nn.functional as F
    from repro_torch.core.packing import pack_nibbles, pack_pbm, pad_k
    from repro_torch.core.quantize import activation_scale
    from repro_torch.kernels import sparqle_encode as E
    from repro_torch.kernels.ref import (TILE_K, TILE_M,
                                         sparqle_encode_packed_fused_ref,
                                         sparqle_encode_packed_ref)
    for m in (1, 5, 8, 24, 33):
        for k in (4096, 14336, 4100):
            for dt in (torch.bfloat16, torch.float32):
                x, mask = encoder_input(dev, gen, m, k, dt)
                scale = activation_scale(x).float()
                got = E.sparqle_encode_packed(x, scale, mask, -8, 23)
                lsb, msb, pbm, pop = E.sparqle_encode(x, scale, mask, -8, 23)
                pad = (0, pad_k(k) - k)
                planes = (pack_nibbles(F.pad(lsb, pad)),
                          pack_nibbles(F.pad(msb, pad)),
                          pack_pbm(F.pad(pbm, pad)), pop)
                if not all(torch.equal(g, u) for g, u in zip(got, planes)):
                    raise AssertionError(f"packed encoder differs from the "
                                         f"codec at M={m} K={k} {dt}")
                if not all(torch.equal(g, u) for g, u in zip(
                        got, sparqle_encode_packed_ref(x, scale, mask, -8,
                                                       23))):
                    raise AssertionError(f"packed encoder differs from its "
                                         f"plain version at M={m} K={k} {dt}")

    def out_bytes(m, k):
        kp = pad_k(k)
        return m * kp + m * kp // 8 + -(-m // TILE_M) * -(-k // TILE_K) * 4

    r = time_encoder(dev, gen, peaks, E.sparqle_encode_packed_fused,
                     E.sparqle_encode_packed, sparqle_encode_packed_fused_ref,
                     out_bytes)
    return {"name": "sparqle_encode_packed_fused", "route": "cuda",
            "source": "src/repro_torch/csrc/sparqle_encode.cu",
            "replaces": "src/repro/kernels/sparqle_encode.py:105", **r,
            "shape": f"M=8 K=4096 bf16, scale included (unfused after the "
                     f"scale chain {r['chain_ms'] * 1e3:.1f} us, alone "
                     f"{r['detail'][0]['ms'] * 1e3:.1f} us); unfused "
                     f"packed = plain = codec of the unpacked planes at M "
                     f"in 1,5,8,24,33 x K in 4096,14336,4100"}


def check_matmul_packed(dev, gen, peaks):
    """Rows 4 and 5b timed, beside the unpacked kernels on the planes of
    the same q. Two rows: full and draft."""
    names = ["sparqle_matmul_packed", "sparqle_matmul_packed_draft",
             "sparqle_matmul", "sparqle_matmul_draft"]
    d = time_matmul_family(dev, gen, peaks, names)
    rows = []
    for name, unpacked, line in (
            ("sparqle_matmul_packed", "sparqle_matmul",
             "sparqle_matmul.py:250"),
            ("sparqle_matmul_packed_draft", "sparqle_matmul_draft",
             "sparqle_matmul.py:159")):
        for dd, u in zip(d[name], d[unpacked]):
            dd["unpacked_ms"] = u["ms"]
        rows.append(matmul_row(name, line, d[name],
                               f" (unpacked kernel "
                               f"{d[unpacked][0]['ms'] * 1e3:.1f} us on the "
                               f"planes of the same q)"))
    return rows


def paged_tiling(cache, bs, gen):
    """A contiguous KV4 cache (k_q, k_s, v_q, v_s), each (B, S, ...), cut
    into shuffled pages of ``bs`` tokens behind a null page 0: returns
    (k_pages, k_scale_pages, v_pages, v_scale_pages, block_tables)."""
    b, s = cache[0].shape[:2]
    n_s = s // bs
    dev = cache[0].device
    perm = torch.randperm(b * n_s, generator=gen, device=dev) + 1
    pages = []
    for t in cache:
        p = torch.zeros((1 + b * n_s, bs) + tuple(t.shape[2:]),
                        dtype=t.dtype, device=dev)
        p[perm] = t.reshape(b * n_s, bs, *t.shape[2:])
        pages.append(p)
    return (*pages, perm.reshape(b, n_s).to(torch.int32).contiguous())


def check_round_kv(rounded, unrounded, q, cache, pos, where="", window=0):
    """The contiguous kernel's round_kv=True at a bf16 q (``rounded``;
    ``unrounded`` its round_kv=False output; both with the sliding
    ``window``): it differs from round_kv=False, lies within one bf16 ulp
    of each element's own magnitude (plus 2^-20 for the f32 sums' order)
    of the plain version's round_kv form, and nearer that form than the
    plain f32-dequant one. At a window of 1 the output is one V row,
    which the bf16 output rounds alike either way: only the ulp bound
    holds there."""
    from repro_torch.kernels.ref import kv4_decode_attention_ref
    want = kv4_decode_attention_ref(q, *cache, pos, round_kv=True,
                                    window=window).float()
    plain = kv4_decode_attention_ref(q, *cache, pos, window=window).float()
    got = rounded.float()
    if window != 1 and torch.equal(rounded, unrounded):
        raise AssertionError(f"round_kv changed no bit at bf16 {where}")
    _, e = torch.frexp(torch.maximum(got.abs(), want.abs()))
    tol = torch.ldexp(torch.ones_like(got), e - 8) + 2 ** -20
    bad = int(((got - want).abs() > tol).sum())
    if bad:
        raise AssertionError(f"round_kv: {bad} elements beyond one bf16 ulp "
                             f"of the plain round_kv form {where}")
    near, far = ((got - w).abs().sum().item() for w in (want, plain))
    if window != 1 and not near < far:
        raise AssertionError(f"round_kv: no nearer the plain round_kv form "
                             f"({near}) than the f32-dequant one ({far}) "
                             f"{where}")


def check_contiguous_attention(dev, gen, peaks):
    """The contiguous KV4 decode at B=8, S=256, KVH=8, G=4, hd=128, in
    blocks of 16: within ATTN_TOL of the plain version (f32) and, with
    round_kv=False, bit-exact with the paged decode kernel on pages of 16
    that tile the same cache (f32 and bf16); with round_kv=True (the
    fixed-batch model's call) as check_round_kv says at bf16 and the same
    bits as round_kv=False at f32;
    timed beside that paged call, and at the long context (S = 4,096)."""
    from repro_torch.kernels.kv_attention import (CONTIGUOUS_BLOCK,
                                                  kv4_decode_attention,
                                                  kv4_paged_decode_attention)
    from repro_torch.kernels.ref import kv4_decode_attention_ref
    b, s, kvh, g, hd, bs = 8, 256, 8, 4, 128, CONTIGUOUS_BLOCK
    kq, vq = (torch.randint(-128, 128, (b, s, kvh, hd // 2), generator=gen,
                            device=dev, dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand((b, s, kvh), generator=gen, device=dev) * 0.2
              for _ in range(2))
    cache = (kq, ks, vq, vs)
    paged = paged_tiling(cache, bs, gen)
    pos = torch.tensor([0, 15, 16, 17, 100, 143, 255, 0], dtype=torch.int32,
                       device=dev)
    err = 0.0
    for dt in (torch.float32, torch.bfloat16):
        q = torch.randn((b, kvh, g, hd), generator=gen, device=dev).to(dt)
        got = kv4_decode_attention(q, *cache, pos)
        if not torch.equal(got, kv4_paged_decode_attention(q, *paged, pos)):
            raise AssertionError(f"contiguous attention {dt}: not the paged "
                                 f"kernel's bits on pages that tile the "
                                 f"same cache")
        want = kv4_decode_attention_ref(q, *cache, pos).float()
        e = (got.float() - want).abs().max().item()
        tol = ATTN_TOL if dt == torch.float32 else 2 ** -7 * max(
            1.0, want.abs().max().item())
        if not e <= tol:
            raise AssertionError(f"contiguous attention {dt}: max err {e} > "
                                 f"{tol}")
        rounded = kv4_decode_attention(q, *cache, pos, round_kv=True)
        if dt == torch.float32 and not torch.equal(rounded, got):
            raise AssertionError("contiguous attention f32: round_kv "
                                 "changed the bits")
        if dt == torch.bfloat16:
            check_round_kv(rounded, got, q, cache, pos, "S=256")
        if dt == torch.float32:
            err, f32_args, paged_args = e, (q, *cache, pos), (q, *paged, pos)
        else:
            bf16_args = (q, *cache, pos)
    kms = time_ms(kv4_decode_attention, [f32_args], 200)
    rms = time_ms(lambda *a: kv4_decode_attention(*a, round_kv=True),
                  [bf16_args], 200)
    dec = time_ms(kv4_paged_decode_attention, [paged_args], 200)
    pms = time_ms(kv4_decode_attention_ref, [f32_args], 20)
    toks = sum((int(p) // bs + 1) * bs for p in pos.tolist())
    bound, by = attn_bound(peaks, b, toks, toks, extra=b * 4)
    # the long context: S = LONG_NS * 16, the pages tiled as in the pool
    ls = LONG_NS * bs
    caches = [tuple(x.reshape(b, ls, *x.shape[2:]) for x in kv_pool(
        dev, gen, b * LONG_NS)) for _ in range(LONG_COPIES)]
    lpos = torch.tensor(LONG_POS, dtype=torch.int32, device=dev)
    q = torch.randn((b, kvh, g, hd), generator=gen, device=dev)
    if not torch.equal(kv4_decode_attention(q, *caches[0], lpos),
                       kv4_paged_decode_attention(
                           q, *paged_tiling(caches[0], bs, gen), lpos)):
        raise AssertionError("contiguous attention, long context: not the "
                             "paged kernel's bits")
    lms = time_ms(kv4_decode_attention, [(q, *c, lpos) for c in caches], 60)
    ltoks = page_tokens(LONG_POS, bs, LONG_NS)
    lbound, lby = attn_bound(peaks, b, ltoks, ltoks, extra=b * 4)
    return {"name": "kv4_decode_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/kv_attention.cu",
            "replaces": "src/repro/kernels/kv_attention.py:148",
            "max_abs_err": err, "ms": kms, "plain_ms": pms,
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "shape": f"B=8 S=256 KVH=8 G=4 hd=128 bs={bs}, f32 q (paged "
                     f"kernel on the same cache in pages of {bs}: "
                     f"{dec * 1e3:.1f} us; bf16 q with round_kv, the "
                     f"fixed-batch model's call: {rms * 1e3:.1f} us); long "
                     f"context S={ls}: {lms * 1e3:.1f} us against a "
                     f"{lbound * 1e3:.2f} us {lby} bound",
            "detail": [{"key": "long", "ms": lms, "bound_ms": lbound,
                        "bound_by": lby},
                       {"key": "round_kv_bf16", "ms": rms}]}


# Row 7p: the partial decode over a slice of the contiguous cache, the
# --legacy decode on a mesh whose cache is cut along its positions; timed
# at decode_32k's shard on 16x16 (granite-8b: B = 128 / 16 = 8 rows, the
# 32,768 positions over 16 model ranks = 2,048, KVH 8, G 4, hd 128).
PARTIAL_ATTN = dict(b=8, s=2048, kvh=8, g=4, hd=128)
# gemma3-27b long_500k's shard on 16x16 (B = 1, the 524,288 positions
# over all 256 ranks = 2,048, KVH 16, G 2, hd 128, bf16 q with round_kv),
# the query at the last position: (window, slice start) of a local layer
# (window 1,024) on rank 0 (wholly before the window), on a rank the
# window's start cuts and on the last rank, and of a global layer
# (window 0) on rank 0
PARTIAL_LONG = dict(b=1, s=2048, kvh=16, g=2, hd=128, pos=524287)
PARTIAL_LONG_CASES = ((1024, 0), (1024, 524288 - 2048 - 512),
                      (1024, 524288 - 2048), (0, 0))
PARTIAL_SLICES = (1, 2, 16)
PARTIAL_POS = (2047, 0, 5, 700, 1023, 1024, 1500, 2000)


def check_partial_attention(dev, gen, peaks):
    """Row 7p against its plain version (out and lse, f32 q, ATTN_TOL),
    each slice of 1, 2 and 16 (some wholly past pos: out 0, lse -inf),
    with and without a window, at hd 128 and 256; the slices merged
    (``kernels.ref.merge_partials``) against one row-7 call on the whole
    cache (ATTN_TOL; bf16 q with round_kv within a bf16 step); timed at
    decode_32k's shard (PARTIAL_ATTN, every position live), the timed
    inputs and long_500k's shard (PARTIAL_LONG) held against the plain
    version too (ATTN_TOL): ``max_abs_err`` is the worst of every f32
    and main-path case."""
    from repro_torch.kernels.kv_attention import (
        kv4_decode_attention, kv4_decode_attention_partial)
    from repro_torch.kernels.ref import (kv4_decode_attention_partial_ref,
                                         merge_partials)
    err, cases = 0.0, 0
    for kvh, g, hd in ((8, 4, 128), (1, 8, 256)):
        b, s = 8, 512
        cache = contiguous_cache(dev, gen, b, s, kvh, hd)
        pos = torch.tensor([p % s for p in PARTIAL_POS], dtype=torch.int32,
                           device=dev)
        for dt, window in ((torch.float32, 0), (torch.float32, 100),
                           (torch.bfloat16, 0)):
            q = torch.randn((b, kvh, g, hd), generator=gen,
                            device=dev).to(dt)
            rk = dt == torch.bfloat16
            whole = kv4_decode_attention(q, *cache, pos, round_kv=rk,
                                         window=window).float()
            for n in PARTIAL_SLICES:
                n_loc = s // n
                outs, lses = [], []
                for r in range(n):
                    part = tuple(t[:, r * n_loc:(r + 1) * n_loc].contiguous()
                                 for t in cache)
                    o, l_ = kv4_decode_attention_partial(
                        q, *part, pos, start=r * n_loc, round_kv=rk,
                        window=window)
                    wo, wl = kv4_decode_attention_partial_ref(
                        q, *part, pos, start=r * n_loc, round_kv=rk,
                        window=window)
                    if not torch.equal(torch.isinf(l_), torch.isinf(wl)):
                        raise AssertionError(f"7p hd={hd}: empty slices "
                                             f"differ from the plain ones")
                    live = torch.isfinite(wl)
                    e = max((o - wo).abs().max().item(),
                            (l_ - wl)[live].abs().max().item()
                            if live.any() else 0.0)
                    tol = ATTN_TOL if not rk else 2 ** -7
                    if not e <= tol:
                        raise AssertionError(f"7p hd={hd} {dt} window "
                                             f"{window} slice {r}/{n}: err "
                                             f"{e}")
                    outs.append(o)
                    lses.append(l_)
                    if not rk:
                        err = max(err, e)
                    cases += 1
                m = (merge_partials(outs, lses) - whole).abs().max().item()
                tol = ATTN_TOL if not rk else 2 ** -7 * max(
                    1.0, whole.abs().max().item())
                if not m <= tol:
                    raise AssertionError(f"7p hd={hd} {dt} window {window}: "
                                         f"merged {n} slices err {m} against "
                                         f"row 7")
                if not rk:
                    err = max(err, m)
    c = PARTIAL_ATTN
    caches = [contiguous_cache(dev, gen, c["b"], c["s"], c["kvh"], c["hd"])
              for _ in range(ATTN_COPIES)]
    q = torch.randn((c["b"], c["kvh"], c["g"], c["hd"]), generator=gen,
                    device=dev)
    pos = torch.full((c["b"],), 32767, dtype=torch.int32, device=dev)
    args = [(q, *cc, pos) for cc in caches]
    kms = time_ms(kv4_decode_attention_partial, args, 60)
    pms = time_ms(kv4_decode_attention_partial_ref, args[:1], 5)
    # the main path's shapes: the timed call's inputs, and long_500k's
    # shard, each against the plain version (out and lse, ATTN_TOL)
    main_err = partial_case_err(args[0], {}, "decode_32k's shard")
    lc = PARTIAL_LONG
    lcache = contiguous_cache(dev, gen, lc["b"], lc["s"], lc["kvh"],
                              lc["hd"])
    lq = torch.randn((lc["b"], lc["kvh"], lc["g"], lc["hd"]), generator=gen,
                     device=dev).to(torch.bfloat16)
    lpos = torch.full((lc["b"],), lc["pos"], dtype=torch.int32, device=dev)
    for window, start in PARTIAL_LONG_CASES:
        main_err = max(main_err, partial_case_err(
            (lq, *lcache, lpos), dict(start=start, round_kv=True,
                                      window=window),
            f"long_500k's shard, window {window}, start {start}"))
    err = max(err, main_err)
    toks = c["b"] * c["s"]
    bound, by = attn_bound(peaks, c["b"], toks, toks,
                           extra=c["b"] * 4 + c["b"] * c["kvh"] * c["g"] * 4,
                           kvh=c["kvh"], g=c["g"], hd=c["hd"])
    return {"name": "kv4_decode_attention_partial", "route": "cuda",
            "source": "src/repro_torch/csrc/kv_attention.cu",
            "replaces": "src/repro/kernels/kv_attention.py:148",
            "max_abs_err": err, "ms": kms, "plain_ms": pms,
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "shape": f"decode_32k's shard on 16x16: B={c['b']} "
                     f"S={c['s']} KVH={c['kvh']} G={c['g']} hd={c['hd']}, "
                     f"f32 q, every position live; {cases} slices checked "
                     f"(hd 128 and 256, {PARTIAL_SLICES} slices, window 0 "
                     f"and 100, bf16 round_kv); at the main path's shapes "
                     f"(the timed call, and long_500k's shard at "
                     f"{len(PARTIAL_LONG_CASES)} (window, start)): "
                     f"{main_err:.3g}",
            "detail": [{"key": "main_path_shapes", "max_abs_err": main_err}]}


def partial_case_err(args, kw, where) -> float:
    """Row 7p on ``args`` (q, the cache slice, pos) and keywords ``kw``
    against its plain version: the same empty queries (lse -inf, out 0),
    out and the live lse within ATTN_TOL. Returns the error."""
    from repro_torch.kernels.kv_attention import kv4_decode_attention_partial
    from repro_torch.kernels.ref import kv4_decode_attention_partial_ref
    o, lse = kv4_decode_attention_partial(*args, **kw)
    wo, wl = kv4_decode_attention_partial_ref(*args, **kw)
    empty = torch.isinf(wl)
    if not (torch.equal(torch.isinf(lse), empty)
            and (o[empty] == 0).all().item()):
        raise AssertionError(f"7p at {where}: empty queries differ from "
                             f"the plain version's")
    live = ~empty
    e = max((o - wo).abs().max().item(),
            (lse - wl)[live].abs().max().item() if live.any() else 0.0)
    if not e <= ATTN_TOL:
        raise AssertionError(f"7p at {where}: err {e}")
    return e


# Row 7's instances the gemma family's --legacy decode runs, at its
# shapes (contiguous caches of prompt + 16 positions, blocks of 16):
# gemma3-27b's local layers, a sliding window of 1,024 over 2,048 + 16
# positions at KVH 16, G 2, hd 128; paligemma-3b's hd 256 at KVH 1, G 8
# over 256 patches + 256 tokens + 16. WINDOW_POS are ranks at different
# positions (the window binding for some, not for others); WINDOWS are
# windows of 1, a block +- 1, one not a multiple of the block (its start
# mid-block) and gemma3's; a window >= pos + 1 must give window 0's bits.
GEMMA3_ATTN = dict(b=2, s=2064, kvh=16, g=2, hd=128, window=1024)
PALIGEMMA_ATTN = dict(b=8, s=528, kvh=1, g=8, hd=256)
WINDOW_POS = ((2063, 700), (1100, 2048), (16, 1023))
WINDOWS = (1, 15, 16, 17, 1000, 1024)
HD256_POS = (527, 512, 300, 0, 15, 16, 17, 400)
HD256_WINDOWS = (1, 17, 100)
ATTN_COPIES = 6


def contiguous_cache(dev, gen, b, s, kvh, hd):
    """A random contiguous KV4 cache (k_q, k_s, v_q, v_s), each (B, S, ...)."""
    return tuple(x.reshape(b, s, *x.shape[2:]).contiguous() for x in
                 kv_pool(dev, gen, b * s // 16, 16, kvh, hd))


def check_window_case(q, cache, pos, window, where=""):
    """The contiguous kernel with a sliding ``window`` against its plain
    version: f32 q within ATTN_TOL (round_kv both ways, the same bits),
    bf16 q with round_kv as check_round_kv says; a window that binds for
    no rank (window >= pos + 1) bit-equal to window 0 in every form.
    Returns the f32 error."""
    from repro_torch.kernels.kv_attention import kv4_decode_attention
    from repro_torch.kernels.ref import kv4_decode_attention_ref
    err = 0.0
    for qq in (q, q.to(torch.bfloat16)):
        got = kv4_decode_attention(qq, *cache, pos, window=window)
        rounded = kv4_decode_attention(qq, *cache, pos, window=window,
                                       round_kv=True)
        if qq.dtype == torch.float32:
            err = (got - kv4_decode_attention_ref(q, *cache, pos,
                                                  window=window)
                   ).abs().max().item()
            if not err <= ATTN_TOL:
                raise AssertionError(f"windowed attention {where} window="
                                     f"{window}: max err {err}")
            if not torch.equal(rounded, got):
                raise AssertionError(f"windowed attention f32 {where}: "
                                     f"round_kv changed the bits")
        else:
            check_round_kv(rounded, got, qq, cache, pos,
                           f"{where} window={window}", window)
        if window >= int(pos.max()) + 1:
            for a, rk in ((got, False), (rounded, True)):
                if not torch.equal(a, kv4_decode_attention(
                        qq, *cache, pos, round_kv=rk)):
                    raise AssertionError(
                        f"window {window} >= pos + 1 {where}: not window "
                        f"0's bits ({qq.dtype}, round_kv={rk})")
    return err


def check_gemma_attention(dev, gen, peaks):
    """Row 7's new instances at the gemma family's shapes (GEMMA3_ATTN,
    PALIGEMMA_ATTN): the sliding window over WINDOWS x WINDOW_POS and
    windows that do not bind (check_window_case); hd 256 within ATTN_TOL
    of its plain version (round_kv at bf16 as check_round_kv says), with
    HD256_WINDOWS, and bit-exact with the paged kernel on pages that tile
    its cache. Each timed at its main-path call (bf16 q, round_kv, the
    decode's positions) over ATTN_COPIES caches, beside the same call
    without the window (the cost of reading the whole cache). Bounds:
    ``step_cost.attention_work`` with min(pos + 1, window) tokens a
    sequence. Returns the two rows."""
    from repro_torch.kernels.kv_attention import (kv4_decode_attention,
                                                  kv4_paged_decode_attention)
    from repro_torch.kernels.ref import kv4_decode_attention_ref
    rows = []
    # gemma3-27b: the sliding window
    a = GEMMA3_ATTN
    b, s, kvh, g, hd, win = (a[k] for k in ("b", "s", "kvh", "g", "hd",
                                            "window"))
    cache = contiguous_cache(dev, gen, b, s, kvh, hd)
    err, n = 0.0, 0
    for p in WINDOW_POS:
        pos = torch.tensor(p, dtype=torch.int32, device=dev)
        q = torch.randn((b, kvh, g, hd), generator=gen, device=dev)
        for w in WINDOWS + (max(p) + 1, s + 100):
            err = max(err, check_window_case(q, cache, pos, w,
                                             f"gemma3 pos={p}"))
            n += 1
    caches = [cache] + [contiguous_cache(dev, gen, b, s, kvh, hd)
                        for _ in range(ATTN_COPIES - 1)]
    pos = torch.full((b,), s - 9, dtype=torch.int32, device=dev)
    q = torch.randn((b, kvh, g, hd), generator=gen, device=dev).to(
        torch.bfloat16)
    args = [(q, *c, pos) for c in caches]
    wms = time_ms(lambda *x: kv4_decode_attention(*x, round_kv=True,
                                                  window=win), args, 200)
    fms = time_ms(lambda *x: kv4_decode_attention(*x, round_kv=True), args,
                  200)
    pms = time_ms(lambda *x: kv4_decode_attention_ref(*x, round_kv=True,
                                                      window=win),
                  args[:1], 20)
    toks = sum(min(int(x) + 1, win) for x in pos.tolist())
    bound, by = attn_bound(peaks, b, toks, toks, extra=b * 4, kvh=kvh, g=g,
                           hd=hd, qb=2, qk_bf16=True)
    rows.append({
        "name": "kv4_decode_attention_window", "route": "cuda",
        "source": "src/repro_torch/csrc/kv_attention.cu",
        "replaces": "src/repro/kernels/kv_attention.py:148",
        "max_abs_err": err, "ms": wms, "plain_ms": pms, "bound_ms": bound,
        "bound_by": by, "library_ms": None,
        "shape": f"B={b} S={s} KVH={kvh} G={g} hd={hd} bs=16, window {win} "
                 f"at pos {s - 9}, bf16 q with round_kv (gemma3-27b's local "
                 f"layers); the same call without the window, reading the "
                 f"whole cache: {fms * 1e3:.1f} us; {n} (pos, window) cases "
                 f"checked",
        "detail": [{"key": "no_window", "ms": fms}]})
    # paligemma-3b: hd 256
    a = PALIGEMMA_ATTN
    b, s, kvh, g, hd = (a[k] for k in ("b", "s", "kvh", "g", "hd"))
    cache = contiguous_cache(dev, gen, b, s, kvh, hd)
    pos = torch.tensor(HD256_POS, dtype=torch.int32, device=dev)
    q = torch.randn((b, kvh, g, hd), generator=gen, device=dev)
    got = kv4_decode_attention(q, *cache, pos)
    err = (got - kv4_decode_attention_ref(q, *cache, pos)).abs().max().item()
    if not err <= ATTN_TOL:
        raise AssertionError(f"hd 256 attention: max err {err}")
    if not torch.equal(got, kv4_paged_decode_attention(
            q, *paged_tiling(cache, 16, gen), pos)):
        raise AssertionError("hd 256 contiguous attention: not the paged "
                             "kernel's bits on pages that tile its cache")
    qb16 = q.to(torch.bfloat16)
    check_round_kv(kv4_decode_attention(qb16, *cache, pos, round_kv=True),
                   kv4_decode_attention(qb16, *cache, pos), qb16, cache, pos,
                   "hd 256")
    for w in HD256_WINDOWS + (s,):
        err = max(err, check_window_case(q, cache, pos, w, "hd 256"))
    caches = [cache] + [contiguous_cache(dev, gen, b, s, kvh, hd)
                        for _ in range(ATTN_COPIES - 1)]
    pos = torch.full((b,), s - 9, dtype=torch.int32, device=dev)
    args = [(qb16, *c, pos) for c in caches]
    hms = time_ms(lambda *x: kv4_decode_attention(*x, round_kv=True), args,
                  200)
    pms = time_ms(lambda *x: kv4_decode_attention_ref(*x, round_kv=True),
                  args[:1], 20)
    toks = sum(int(x) + 1 for x in pos.tolist())
    bound, by = attn_bound(peaks, b, toks, toks, extra=b * 4, kvh=kvh, g=g,
                           hd=hd, qb=2, qk_bf16=True)
    rows.append({
        "name": "kv4_decode_attention_hd256", "route": "cuda",
        "source": "src/repro_torch/csrc/kv_attention.cu",
        "replaces": "src/repro/kernels/kv_attention.py:148",
        "max_abs_err": err, "ms": hms, "plain_ms": pms, "bound_ms": bound,
        "bound_by": by, "library_ms": None,
        "shape": f"B={b} S={s} KVH={kvh} G={g} hd={hd} bs=16 at pos {s - 9}, "
                 f"bf16 q with round_kv (paligemma-3b's decode); checked at "
                 f"pos {HD256_POS}, windows {HD256_WINDOWS} and against the "
                 f"paged kernel"})
    return rows


# The attention kernel's instances off the main path, (hd, G, ps): the
# smoke config's head shape (hd 16, G 2) with pages of 8, each head dim
# instantiated (256 with its rings in dynamic shared memory, at
# paligemma-3b's G 8 and at G 2), groups that are no multiple of 4, pages
# of a size read at run time (one token, 5, 40: three tiles, the last
# short) beside the compile-time 16.
ATTN_SHAPES = ((16, 2, 8), (32, 3, 16), (64, 6, 40), (128, 4, 5),
               (16, 1, 1), (256, 8, 16), (256, 2, 40))


def check_attention_shapes(dev, gen):
    """Rows 7-10 at ATTN_SHAPES (B=4, KVH=2, about 48 tokens a slot):
    decode within ATTN_TOL of the plain version (f32; bf16 within one
    bf16 step), the verify window bit-exact with T decode calls, the
    tiered decode over demoted pages with the decode on the clamped
    pages, the contiguous decode in blocks of ps bit-exact with the paged
    one on pages that tile its cache and within ATTN_TOL of its plain
    version, and at bf16 its round_kv form as check_round_kv says."""
    from repro_torch.kernels.kv_attention import (
        kv4_decode_attention, kv4_paged_decode_attention,
        kv4_paged_verify_attention, kv_tiered_paged_decode_attention)
    from repro_torch.kernels.ref import (kv4_decode_attention_ref,
                                         kv4_paged_decode_attention_ref)
    b, kvh, t = 4, 2, SPEC_GAMMA + 1
    for hd, g, ps in ATTN_SHAPES:
        where = f"at hd={hd} G={g} ps={ps}"
        n_s = max(4, 48 // ps)
        kv4, tiered, clamped = demoted_pool(dev, gen, b, kvh, hd, ps, n_s,
                                            1 + b * n_s)
        s = n_s * ps
        pos = torch.tensor([s - 1, s // 2, min(s - 1, ps + 1), 0],
                           dtype=torch.int32, device=dev)
        for dt in (torch.float32, torch.bfloat16):
            q = torch.randn((b, kvh, g, hd), generator=gen, device=dev).to(dt)
            got = kv4_paged_decode_attention(q, *kv4, pos)
            want = kv4_paged_decode_attention_ref(q, *kv4, pos).float()
            e = (got.float() - want).abs().max().item()
            tol = ATTN_TOL if dt == torch.float32 else 2 ** -7 * max(
                1.0, want.abs().max().item())
            if not e <= tol:
                raise AssertionError(f"attention {dt} {where}: max err {e}")
            if not torch.equal(kv_tiered_paged_decode_attention(
                    q, *tiered, pos), kv4_paged_decode_attention(
                        q, *clamped, pos)):
                raise AssertionError(f"tiered attention {dt} {where}: not "
                                     f"the decode kernel's bits on the "
                                     f"clamped pages")
            qw = torch.randn((b, t, kvh, g, hd), generator=gen,
                             device=dev).to(dt)
            wpos = (pos - t).clamp_min(0)
            win = kv4_paged_verify_attention(qw, *kv4, wpos)
            for i in range(t):
                if not torch.equal(win[:, i], kv4_paged_decode_attention(
                        qw[:, i].contiguous(), *kv4, wpos + i)):
                    raise AssertionError(f"verify attention {dt} {where}: "
                                         f"token {i} differs from decode")
            cache = tuple(x.reshape(b, s, *x.shape[2:]).contiguous()
                          for x in kv_pool(dev, gen, b * n_s, ps, kvh, hd))
            cont = kv4_decode_attention(q, *cache, pos, bs=ps)
            if not torch.equal(cont, kv4_paged_decode_attention(
                    q, *paged_tiling(cache, ps, gen), pos)):
                raise AssertionError(f"contiguous attention {dt} {where}: "
                                     f"not the paged kernel's bits")
            if dt == torch.float32:
                e = (cont - kv4_decode_attention_ref(q, *cache, pos)
                     ).abs().max().item()
                if not e <= ATTN_TOL:
                    raise AssertionError(f"contiguous attention {where}: "
                                         f"max err {e}")
            else:
                check_round_kv(kv4_decode_attention(q, *cache, pos, bs=ps,
                                                    round_kv=True),
                               cont, q, cache, pos, where)
    return len(ATTN_SHAPES)


# ---------------------------------------------------------------------------
# phase 3: the expert-batched entries (a routed MoE projection, one launch)
# ---------------------------------------------------------------------------

# The batched encoder and matmul entries at the expert counts and
# capacities the MoE serves give them: E = 64 routed experts
# (deepseek-moe-16b) and 8 (its smoke config); C = 1 (decode at B = 8:
# capacity max(1, 8 * 6 // 64)), 3 (a 32-token prefill chunk), 6, 17 and
# 32; (K, N) the routed gate/up (2048 -> 1408) and down (1408 -> 2048)
# projections and the dense first layer's down projection (10944 ->
# 2048, K mod 128 = 64). Timed at E = 64, C = 1 and 3.
BATCHED_E = (8, 64)
BATCHED_C = (1, 3, 6, 17, 32)
BATCHED_KN = ((2048, 1408), (1408, 2048), (10944, 2048))
BATCHED_TIMED = ((1, 2048, 1408), (3, 2048, 1408), (1, 1408, 2048),
                 (3, 1408, 2048))
# the reference's batched XLA path that the batched instances of the
# Pallas kernels carry
BATCHED_REF = "src/repro/core/qlinear.py:138 (batched=True)"


def batched_instances():
    """The five matmul entries in their batched call form: (wrapper,
    batched plain version, operands, msb_skip, Pallas kernel)."""
    from repro_torch.kernels import ref
    inst = matmul_instances()
    return {f"{name}_batched": (fn, ref.batched(plain), planes, skip)
            for name, (fn, plain, planes, skip, _) in inst.items()}


def batched_case(dev, gen, e, c, k, n, pattern):
    """matmul_case for E experts: every operand with a leading E axis."""
    parts = [matmul_case(dev, gen, c, k, n, pattern) for _ in range(e)]
    return {key: torch.stack([p[key] for p in parts]).contiguous()
            for key in parts[0]}


def check_batched_matmul_case(c, where=""):
    """The five batched entries, f32 and int32 outputs, each torch.equal
    to its plain version (the 2-D plain version expert by expert);
    packed = unpacked and dense = dual pass on the same q."""
    got = {}
    for name, (fn, plain, planes, skip) in batched_instances().items():
        args = (c[planes[0]], c[planes[1]], c["pop"], c["wp"], c["asc"],
                c["wsc"])
        for acc_out in (False, True):
            kw = dict(acc_out=acc_out, msb_skip=skip)
            out = fn(*args, **kw)
            if not torch.equal(out, plain(*args, **kw)):
                raise AssertionError(f"{name} differs from its plain version "
                                     f"{where} acc_out={acc_out}")
            got[name, acc_out] = out
    for acc_out in (False, True):
        for a, b in (("sparqle_matmul", "sparqle_matmul_packed"),
                     ("sparqle_matmul_draft", "sparqle_matmul_packed_draft"),
                     ("sparqle_matmul", "quant_matmul")):
            if not torch.equal(got[a + "_batched", acc_out],
                               got[b + "_batched", acc_out]):
                raise AssertionError(f"{b}_batched differs from {a}_batched "
                                     f"{where} acc_out={acc_out}")


def check_one_launch(name, call):
    """Raise unless ``call()`` launches the kernel ``name`` once and no
    other kernel (a routed projection is one launch, never a loop)."""
    from repro_torch import kernels
    kernels.reset_launch_counts()
    call()
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    if counts != {name: 1}:
        raise AssertionError(f"{name}: launches {counts}, not one")


def check_batched_matmul(dev, gen, peaks):
    """The five batched matmul entries: bit-exact over BATCHED_E x
    BATCHED_C x BATCHED_KN x POP_PATTERNS with one launch a call, then
    each timed at BATCHED_TIMED (E = 64, MSB zero on every other K tile)
    beside its plain version and the loop of E 2-D calls it replaces;
    bound by bytes: the E packed weights, the planes (the MSB plane
    only of live tiles), scales and output once. Returns the rows."""
    t0 = time.perf_counter()
    cases = 0
    for e in BATCHED_E:
        for c in BATCHED_C:
            for k, n in BATCHED_KN:
                for pattern in POP_PATTERNS:
                    check_batched_matmul_case(
                        batched_case(dev, gen, e, c, k, n, pattern),
                        f"at E={e} C={c} K={k} N={n} pop={pattern}")
                    cases += 1
    # one launch a call, never a loop over experts
    c = batched_case(dev, gen, 8, 3, 2048, 1408, "live")
    for name, (fn, _, planes, skip) in batched_instances().items():
        check_one_launch(name, lambda: fn(
            c[planes[0]], c[planes[1]], c["pop"], c["wp"], c["asc"],
            c["wsc"], msb_skip=skip))
    sweep_s = time.perf_counter() - t0
    inst = batched_instances()
    flat = matmul_instances()
    detail = {name: [] for name in inst}
    for cc, k, n in BATCHED_TIMED:
        c = batched_case(dev, gen, 64, cc, k, n, "alternating")
        live = (c["pop"] > 0).sum().item() / c["pop"].numel()
        copies = max(1, math.ceil(150e6 / c["wp"].numel()))
        wps = [c["wp"].clone() for _ in range(copies)]
        for name, (fn, plain, planes, skip) in inst.items():
            a0, a1 = c[planes[0]], c[planes[1]]
            f2 = flat[name[:-len("_batched")]][0]

            def call(*a, _fn=fn, _skip=skip):
                return _fn(*a, msb_skip=_skip)

            def loop(a0, a1, pop, wp, asc, wsc, _fn=f2, _skip=skip):
                return [_fn(a0[i], a1[i], pop[i], wp[i], asc[i], wsc[i],
                            msb_skip=_skip) for i in range(a0.shape[0])]

            def ref(*a, _fn=plain, _skip=skip):
                return _fn(*a, msb_skip=_skip)

            args = [(a0, a1, c["pop"], w, c["asc"], c["wsc"]) for w in wps]
            kms = time_ms(call, args, 50)
            lms = time_ms(loop, args, 5)
            pms = time_ms(ref, args[:1], 2)
            nbytes, ops = (64 * w for w in matmul_work(
                cc, k, n, plane_row=a0.numel() / (64 * cc),
                passes=1 if skip else 1 + live))
            detail[name].append({
                "E": 64, "C": cc, "K": k, "N": n, "ms": kms,
                "loop_ms": lms, "plain_ms": pms,
                "bound_ms": max(nbytes / peaks[0], ops / peaks[1]) * 1e3,
                "bound_by": "bytes" if nbytes / peaks[0] >= ops / peaks[1]
                else "operations"})
    rows = []
    pallas = {"sparqle_matmul_batched": "sparqle_matmul.py:209",
              "sparqle_matmul_draft_batched": "sparqle_matmul.py:142",
              "sparqle_matmul_packed_batched": "sparqle_matmul.py:250",
              "sparqle_matmul_packed_draft_batched": "sparqle_matmul.py:159",
              "quant_matmul_batched": "quant_matmul.py:45"}
    for name, d in detail.items():
        t = d[0]
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/sparqle_matmul.cu",
            "replaces": f"src/repro/kernels/{pallas[name]}",
            "max_abs_err": 0.0, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None,
            "shape": f"E={t['E']} C={t['C']} K={t['K']} N={t['N']} (a "
                     f"routed gate/up projection at decode; loop of 64 2-D "
                     f"calls "
                     f"{t['loop_ms'] * 1e3:.1f} us); also "
                     + ", ".join(f"C={x['C']} {x['K']}->{x['N']} "
                                 f"{x['ms'] * 1e3:.1f} us (loop "
                                 f"{x['loop_ms'] * 1e3:.1f})"
                                 for x in d[1:])
                     + f"; the batched instance of the Pallas kernel, on the "
                       f"reference's batched path {BATCHED_REF}; {cases} "
                       f"input sets bit-exact (E in {BATCHED_E}, "
                       f"C in {BATCHED_C}, (K, N) in {BATCHED_KN}, "
                       f"{POP_PATTERNS}) in {sweep_s:.1f} s",
            "detail": d})
    return rows


def check_batched_encoder(dev, gen, peaks):
    """The three batched fused encoders (x (E, C, K), an (E, K) mask):
    outputs bit-equal to their plain versions (the 2-D plain version
    expert by expert) over BATCHED_E x BATCHED_C x the K of
    BATCHED_KN, bf16 (f32 too at E = 8), one launch a call; timed at E =
    64, C = 1 and 3, K = 2048 beside the plain version and the loop of
    64 2-D calls. Returns the rows."""
    from repro_torch.core.packing import pad_k
    from repro_torch.kernels import ref
    from repro_torch.kernels import sparqle_encode as E
    from repro_torch.kernels.ref import TILE_K, TILE_M
    entries = {
        "sparqle_encode_fused_batched": (
            lambda *a: E.sparqle_encode_fused(*a, with_pbm=False),
            lambda *a: [t for i, t in enumerate(ref.batched(
                ref.sparqle_encode_fused_ref)(*a)) if i != 2],
            lambda e, c, k: 2 * e * c * k, "sparqle_encode.py:69"),
        "sparqle_quantize_fused_batched": (
            E.sparqle_quantize_fused,
            ref.batched(ref.sparqle_quantize_fused_ref),
            lambda e, c, k: e * c * k, "sparqle_encode.py:40"),
        "sparqle_encode_packed_fused_batched": (
            E.sparqle_encode_packed_fused,
            ref.batched(ref.sparqle_encode_packed_fused_ref),
            lambda e, c, k: e * c * (pad_k(k) + pad_k(k) // 8),
            "sparqle_encode.py:105")}
    t0 = time.perf_counter()
    cases = 0
    for e in BATCHED_E:
        for c in BATCHED_C:
            for k in sorted({k for k, _ in BATCHED_KN}):
                for dt in ((torch.bfloat16, torch.float32) if e == 8
                           else (torch.bfloat16,)):
                    x = (torch.randn((e, c, k), generator=gen, device=dev)
                         * torch.rand((e, c, 1), generator=gen,
                                      device=dev) * 4).to(dt)
                    x[0, 1:] = 0                   # an expert with one row
                    mask = torch.rand((e, k), generator=gen, device=dev) < 0.5
                    for name, (fn, plain, _, _) in entries.items():
                        got = [t for t in fn(x, mask, -8, 23)
                               if t is not None]
                        want = plain(x, mask, -8, 23)
                        if len(got) != len(want) or not all(
                                torch.equal(a, b) for a, b in zip(got, want)):
                            raise AssertionError(
                                f"{name} differs from its plain version at "
                                f"E={e} C={c} K={k} {dt}")
                    cases += 1
    sweep_s = time.perf_counter() - t0
    rows = []
    flat = {"sparqle_encode_fused_batched": lambda *a: E.sparqle_encode_fused(
                *a, with_pbm=False),
            "sparqle_quantize_fused_batched": E.sparqle_quantize_fused,
            "sparqle_encode_packed_fused_batched":
                E.sparqle_encode_packed_fused}
    for name, (fn, plain, out_bytes, pallas) in entries.items():
        x = (torch.randn((8, 3, 2048), generator=gen, device=dev)).to(
            torch.bfloat16)
        mask = torch.rand((8, 2048), generator=gen, device=dev) < 0.5
        check_one_launch(name, lambda: fn(x, mask, -8, 23))
        d = []
        for c in (1, 3):
            e, k = 64, 2048
            x = (torch.randn((e, c, k), generator=gen, device=dev)
                 * 2).to(torch.bfloat16)
            mask = torch.rand((e, k), generator=gen, device=dev) < 0.5
            args = [(x, mask, -8, 23)]
            f2 = flat[name]

            def loop(x, mask, lo, hi, _f2=f2):
                return [_f2(x[i], mask[i], lo, hi) for i in range(x.shape[0])]

            kms = time_ms(fn, args, 100)
            lms = time_ms(loop, args, 5)
            pms = time_ms(plain, args, 2)
            pops = e * -(-c // TILE_M) * -(-k // TILE_K) * 4
            nbytes = encoder_bytes(e * c, k, xb=2, mask=e * k,
                                   planes=out_bytes(e, c, k)
                                   + (0 if "quantize" in name else pops))
            d.append({"E": e, "C": c, "K": k, "ms": kms, "loop_ms": lms,
                      "plain_ms": pms, "bound_ms": nbytes / peaks[0] * 1e3,
                      "bound_by": "bytes"})
        t = d[0]
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/sparqle_encode.cu",
            "replaces": f"src/repro/kernels/{pallas}",
            "max_abs_err": 0.0, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": "bytes",
            "library_ms": None,
            "shape": f"E=64 C=1 K=2048 bf16, scale included (loop of 64 2-D "
                     f"calls {t['loop_ms'] * 1e3:.1f} us); C=3 "
                     f"{d[1]['ms'] * 1e3:.1f} us (loop "
                     f"{d[1]['loop_ms'] * 1e3:.1f}); the batched instance on "
                     f"the reference's batched path {BATCHED_REF}; {cases} "
                     f"input sets bit-exact (E in {BATCHED_E}, C in {BATCHED_C}, K in "
                     f"{sorted({k for k, _ in BATCHED_KN})}) in "
                     f"{sweep_s:.1f} s",
            "detail": d})
    return rows


# ---------------------------------------------------------------------------
# phase 3: the live rows of a routed projection (``rows``)
# ---------------------------------------------------------------------------

# The batched entries with each expert's live row count (``rows``, (E,)
# int32 on the card): the rows at and past it are taken as zero whatever
# the operands hold. Swept bit-exact at E = 64 (C 1, 3 and 17; deepseek-
# moe-16b's routed gate/up and down) and at E = 8, C = 3, 2048 -> 1408,
# whose 176 output tiles split K in two (the arrival counters' path);
# every rows pattern of tests/test_torch_expert_rows.py.
ROWS_PATTERNS = ("empty", "full", "partial", "random")
ROWS_SWEEP = ((64, 1, 2048, 1408), (64, 3, 1408, 2048), (64, 17, 2048, 1408),
              (8, 3, 2048, 1408))
ROWS_ENCODE = ((64, 1, 2048), (64, 17, 1408), (8, 3, 2048))
# Experts a decode step fills at B = 8 (capacity 1): E (1 - (1 - k/E)^8),
# rounded: deepseek-moe-16b (top-6 of 64) 35, deepseek-v3-671b (top-8 of
# 256) 57. The timed rows: 3e-6e and 1e-2e at E = 64, C = 1, 35 live
# (2048 -> 1408; the encoders at K = 2048), and 3e at deepseek-v3's
# routed shapes with 57 of 256 live; each with the live rows and with
# rows=None (the kernel streams every expert) on the same operands, live
# weight copies past the 50 MB L2.
ROWS_LIVE = {64: 35, 256: 57}
ROWS_V3_KN = ((7168, 2048), (2048, 7168))


def rows_pattern(dev, gen, e, c, pattern):
    """(E,) int32 live rows on the card: none, all C, a count cutting an
    m16/n8 row tile for every expert, or random in [0, C] with expert 0
    empty."""
    if pattern == "empty":
        r = torch.zeros(e, dtype=torch.int32, device=dev)
    elif pattern == "full":
        r = torch.full((e,), c, dtype=torch.int32, device=dev)
    elif pattern == "partial":
        r = torch.tensor([max(1, c - 1 - i % 3) if c > 1 else 1
                          for i in range(e)], dtype=torch.int32, device=dev)
    else:
        r = torch.randint(0, c + 1, (e,), generator=gen, device=dev,
                          dtype=torch.int32)
        r[0] = 0
    return r


def live_experts(dev, gen, e, c, n_live):
    """(E,) int32: ``n_live`` experts chosen at random with all C rows
    live, the others empty (the dispatch at decode, capacity C)."""
    r = torch.zeros(e, dtype=torch.int32, device=dev)
    r[torch.randperm(e, generator=gen, device=dev)[:n_live]] = c
    return r


def past_rows(t, rows):
    """(E, C, 1) bool: the rows at and past each expert's count."""
    return (torch.arange(t.shape[1], device=t.device)[None, :]
            >= rows.long()[:, None])[..., None]


def with_garbage(t, rows, gen):
    """``t`` with the rows past the count overwritten: random bytes for an
    int8 plane, NaN and huge values for x."""
    if t.dtype == torch.int8:
        junk = torch.randint(-128, 128, t.shape, generator=gen,
                             device=t.device, dtype=torch.int8)
    else:
        junk = torch.randn(t.shape, generator=gen, device=t.device) * 1e30
        junk.view(-1)[::3] = float("nan")
        junk = junk.to(t.dtype)
    return torch.where(past_rows(t, rows), junk, t)


def counters_clear(dev, where):
    """Raise unless every arrival counter of the device reads 0."""
    from repro_torch.kernels import sparqle_matmul as SM
    buf = SM._COUNTERS.get(dev)
    if buf is not None and int(torch.count_nonzero(buf).item()):
        raise AssertionError(f"arrival counters not 0 after a launch "
                             f"{where}: {buf.nonzero().flatten().tolist()}")


def check_rows_matmul_case(c, rows, where):
    """The five batched matmul entries with ``rows`` on operands that hold
    garbage past the count, f32 and int32 outputs: each torch.equal to
    its plain version (``ref.batched`` zeroes those rows, then runs the
    2-D plain version), packed = unpacked and dense = dual pass, every
    arrival counter 0 after each launch; with every row live, equal to
    the same call with rows=None."""
    from repro_torch.kernels import ref
    dev = c["wp"].device
    full = bool((rows == c["lsb"].shape[1]).all())
    got = {}
    for name, (fn, plain, planes, skip, _) in matmul_instances().items():
        args = (c[planes[0]], c[planes[1]], c["pop"], c["wp"], c["asc"],
                c["wsc"])
        for acc_out in (False, True):
            kw = dict(acc_out=acc_out, msb_skip=skip)
            out = fn(*args, rows=rows, **kw)
            counters_clear(dev, f"{name}_batched {where}")
            want = ref.batched(plain, rows, acts=2)(*args, **kw)
            if not torch.equal(out, want):
                raise AssertionError(f"{name}_batched with rows differs from "
                                     f"its plain version {where} "
                                     f"acc_out={acc_out}")
            if full and not torch.equal(out, fn(*args, **kw)):
                raise AssertionError(f"{name}_batched: rows all C differs "
                                     f"from rows=None {where}")
            got[name, acc_out] = out
    for acc_out in (False, True):
        for a, b in (("sparqle_matmul", "sparqle_matmul_packed"),
                     ("sparqle_matmul_draft", "sparqle_matmul_packed_draft"),
                     ("sparqle_matmul", "quant_matmul")):
            if not torch.equal(got[a, acc_out], got[b, acc_out]):
                raise AssertionError(f"{b}_batched differs from {a}_batched "
                                     f"with rows {where} acc_out={acc_out}")


def rows_encoders():
    """The six batched encoder entries in one call form (x, scale, mask,
    rows) -> outputs (no PBM plane), each beside its 2-D plain version
    (x, scale, mask) and whether it forms the scale itself."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import sparqle_encode as E

    def nopbm(outs):
        return [t for i, t in enumerate(outs) if i != 2]
    return {
        "sparqle_encode_fused_batched": (
            lambda x, s, m, r: nopbm(E.sparqle_encode_fused(
                x, m, -8, 23, with_pbm=False, rows=r)),
            lambda x, s, m: ref.sparqle_encode_fused_ref(x, m, -8, 23),
            nopbm, True),
        "sparqle_quantize_fused_batched": (
            lambda x, s, m, r: list(E.sparqle_quantize_fused(x, m, -8, 23,
                                                             rows=r)),
            lambda x, s, m: ref.sparqle_quantize_fused_ref(x, m, -8, 23),
            list, True),
        "sparqle_encode_packed_fused_batched": (
            lambda x, s, m, r: list(E.sparqle_encode_packed_fused(
                x, m, -8, 23, rows=r)),
            lambda x, s, m: ref.sparqle_encode_packed_fused_ref(x, m, -8, 23),
            list, True),
        "sparqle_encode_batched": (
            lambda x, s, m, r: nopbm(E.sparqle_encode(
                x, s, m, -8, 23, with_pbm=False, rows=r)),
            lambda x, s, m: ref.sparqle_encode_ref(x, s, m, -8, 23),
            nopbm, False),
        "sparqle_quantize_batched": (
            lambda x, s, m, r: [E.sparqle_quantize(x, s, m, -8, 23,
                                                   rows=r)],
            lambda x, s, m: ref.sparqle_quantize_ref(x, s, m, -8, 23),
            lambda o: [o], False),
        "sparqle_encode_packed_batched": (
            lambda x, s, m, r: list(E.sparqle_encode_packed(x, s, m, -8, 23,
                                                            rows=r)),
            lambda x, s, m: ref.sparqle_encode_packed_ref(x, s, m, -8, 23),
            list, False)}


def check_rows_encoder_case(x, mask, rows, gen, where):
    """The six batched encoders with ``rows`` on an x that holds NaN and
    huge values past the count (the scale-taking ones with the fused
    twin's scale): outputs torch.equal to their plain versions; with
    every row live, equal to rows=None."""
    from repro_torch.kernels import ref
    dirty = with_garbage(x, rows, gen)
    scale = rows_encoders()["sparqle_encode_fused_batched"][0](
        dirty, None, mask, rows)[-1]
    full = bool((rows == x.shape[1]).all())
    for name, (fn, plain, pick, fused) in rows_encoders().items():
        got = fn(dirty, scale, mask, rows)
        args = (dirty, mask) if fused else (dirty, scale, mask)
        want = pick(ref.batched(
            (lambda x_, m_: plain(x_, None, m_)) if fused else plain,
            rows)(*args))
        if len(got) != len(want) or not all(
                torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{name} with rows differs from its plain "
                                 f"version {where}")
        if full and not all(torch.equal(a, b) for a, b in
                            zip(got, fn(dirty, scale, mask, None))):
            raise AssertionError(f"{name}: rows all C differs from "
                                 f"rows=None {where}")


def check_rows_matmul_patterns(dev, gen, case, where):
    """check_rows_matmul_case on ``case`` (batched_case) for every rows
    pattern, garbage written past the count; returns the input sets."""
    e, c = case["q"].shape[:2]
    for pattern in ROWS_PATTERNS:
        rows = rows_pattern(dev, gen, e, c, pattern)
        dirty = dict(case)
        for key in ("q", "lsb", "msb", "lp", "mp"):
            dirty[key] = with_garbage(case[key], rows, gen)
        check_rows_matmul_case(dirty, rows, f"{where} rows={pattern}")
    return len(ROWS_PATTERNS)


def check_rows_encoder_patterns(dev, gen, x, mask, where):
    """check_rows_encoder_case on x (E, C, K) for every rows pattern;
    returns the input sets."""
    e, c = x.shape[:2]
    for pattern in ROWS_PATTERNS:
        check_rows_encoder_case(x, mask, rows_pattern(dev, gen, e, c,
                                                      pattern), gen,
                                f"{where} rows={pattern}")
    return len(ROWS_PATTERNS)


def live_matmul_work(rows, c, k, n, plane_row, passes):
    """(bytes, ops) of a batched matmul call with live rows ``rows`` (a
    list): each expert's live rows read (planes, a pass each; ``passes``
    a list, an expert's), the weight of each expert with a live row,
    every expert's scales and its whole C x N f32 output written (a
    skipped row is written as the drain of 0). The all-experts count is
    this with every row live."""
    nbytes = ops = 0.0
    for r, p in zip(rows, passes):
        nbytes += (r * plane_row * p + (k * n // 2 if r else 0)
                   + c * 4 + n * 4 + c * n * 4)
        ops += 2.0 * r * k * n * p
    return nbytes, ops


def live_encoder_bytes(rows, c, k, xb, planes_a_row, pops):
    """The batched encoder's traffic with live rows ``rows``: x and the
    mask of each expert's live rows read, every row's scale, planes and
    the populations written."""
    e = len(rows)
    return (sum(r * k * xb + (k if r else 0) for r in rows) + e * c * 4
            + e * c * planes_a_row + pops)


def _bound(peaks, nbytes, ops=0.0):
    ms = max(nbytes / peaks[0], ops / peaks[1]) * 1e3
    return ms, "bytes" if nbytes / peaks[0] >= ops / peaks[1] else \
        "operations"


def time_rows_matmul(dev, gen, peaks, e, c, k, n, n_live, names,
                     plain: bool = True):
    """The batched matmul entries ``names`` at E experts, C rows, K -> N,
    ``n_live`` experts live (the others empty, their rows zero): device
    time with the live rows and with rows=None on the same operands
    (every expert streamed; the outputs torch.equal, the populations
    those of the zeroed planes), and with every row live, rows all C
    against rows=None (medians of three alternated timings); live weight
    copies past L2. Each beside the live and the all-experts bound, and
    (``plain``) the plain version's time with the live rows."""
    from repro_torch.kernels import ref
    case = batched_case(dev, gen, e, c, k, n, "alternating")
    rows = live_experts(dev, gen, e, c, n_live)
    for key in ("q", "lsb", "msb", "lp", "mp"):
        case[key] = case[key].masked_fill(past_rows(case[key], rows), 0)
    # the populations of the zeroed planes, as the encoder writes them
    # (an empty expert's all 0: rows=None fetches no MSB tile of it)
    case["pop"] = torch.stack([ref.tile_population_padded(
        m != 0, ref.TILE_M, ref.TILE_K) for m in case["msb"]]).contiguous()
    # an expert's MSB pass: the share of its population tiles that are live
    density = ((case["pop"] > 0).flatten(1).float().mean(1)).tolist()
    rl = rows.tolist()
    live_w = sum(1 for r in rl if r) * k * n // 2
    copies = max(1, math.ceil(150e6 / live_w))
    wps = [case["wp"]] + [case["wp"].clone() for _ in range(copies - 1)]
    full = torch.full_like(rows, c)
    inst = matmul_instances()
    out = {}
    for name in names:
        fn, plain_fn, planes, skip, _ = inst[name]
        a0, a1 = case[planes[0]], case[planes[1]]
        args = [(a0, a1, case["pop"], w, case["asc"], case["wsc"])
                for w in wps]

        def call(*a, _fn=fn, _skip=skip, _rows=None):
            return _fn(*a, msb_skip=_skip, rows=_rows)

        # the rows past the count hold 0: the live rows, all C and
        # rows=None give the same bits
        got = call(*args[0], _rows=rows)
        for other in (call(*args[0]), call(*args[0], _rows=full)):
            if not torch.equal(got, other):
                raise AssertionError(f"{name}_batched at E={e} C={c} "
                                     f"{k}->{n}: the live rows differ from "
                                     f"rows=None on zeroed rows")
        del got, other
        plane_row = a0[0].numel() / c
        passes = [1] * e if skip else [1 + d for d in density]
        lb, lops = live_matmul_work(rl, c, k, n, plane_row, passes)
        ab, aops = live_matmul_work([c] * e, c, k, n, plane_row, passes)
        live_ms, live_by = _bound(peaks, lb, lops)
        all_ms, all_by = _bound(peaks, ab, aops)
        t_rows = time_ms(functools.partial(call, _rows=rows), args, 50)
        t_none = time_ms(call, args, 50)
        # every row live: rows all C against rows=None, alternated three
        # times each, the medians
        fulls, nones = [], []
        for _ in range(3):
            fulls.append(time_ms(functools.partial(call, _rows=full), args,
                                 50))
            nones.append(time_ms(call, args, 50))
        t_full, t_none2 = sorted(fulls)[1], sorted(nones)[1]
        p_ms = time_ms(lambda *a, _p=plain_fn, _s=skip: ref.batched(
            _p, rows, acts=2)(*a, msb_skip=_s), args[:1], 2) if plain \
            else None
        out[name] = {"E": e, "C": c, "K": k, "N": n, "live": n_live,
                     "plain_ms": p_ms,
                     "copies": copies, "ms": t_rows, "none_ms": t_none,
                     "full_rows_ms": t_full, "full_none_ms": t_none2,
                     "bound_ms": live_ms, "bound_by": live_by,
                     "all_bound_ms": all_ms, "all_bound_by": all_by}
    del case, wps
    return out


def time_rows_encoders(dev, gen, peaks, e, c, k, n_live):
    """The three fused batched encoders at E, C, K (bf16 x), ``n_live``
    experts live: time with the live rows and with rows=None, beside the
    live and the all-experts byte bounds."""
    from repro_torch.core.packing import pad_k
    from repro_torch.kernels.ref import TILE_K, TILE_M
    x = (torch.randn((e, c, k), generator=gen, device=dev) * 2).to(
        torch.bfloat16)
    mask = torch.rand((e, k), generator=gen, device=dev) < 0.5
    rows = live_experts(dev, gen, e, c, n_live)
    x = x.masked_fill(past_rows(x, rows), 0)
    rl = rows.tolist()
    pops = e * -(-c // TILE_M) * -(-k // TILE_K) * 4
    planes = {"sparqle_encode_fused_batched": (2 * k, pops),
              "sparqle_quantize_fused_batched": (k, 0),
              "sparqle_encode_packed_fused_batched": (
                  pad_k(k) + pad_k(k) // 8, pops)}
    from repro_torch.kernels import ref
    out = {}
    for name, (fn, plain, _, _) in list(rows_encoders().items())[:3]:
        t_rows = time_ms(lambda x_, m_: fn(x_, None, m_, rows), [(x, mask)],
                         100)
        p_ms = time_ms(lambda x_, m_: ref.batched(
            lambda a, b: plain(a, None, b), rows)(x_, m_), [(x, mask)], 2)
        t_none = time_ms(lambda x_, m_: fn(x_, None, m_, None), [(x, mask)],
                         100)
        row_b, pop_b = planes[name]
        live_b = live_encoder_bytes(rl, c, k, 2, row_b, pop_b)
        all_b = live_encoder_bytes([c] * e, c, k, 2, row_b, pop_b)
        out[name] = {"E": e, "C": c, "K": k, "live": n_live, "ms": t_rows,
                     "none_ms": t_none, "plain_ms": p_ms,
                     "bound_ms": live_b / peaks[0] * 1e3,
                     "bound_by": "bytes",
                     "all_bound_ms": all_b / peaks[0] * 1e3}
    return out


def check_expert_rows(dev, gen, peaks):
    """Phase 3's ``rows`` checks: every batched matmul entry over
    ROWS_SWEEP and every batched encoder (fused and scale-taking) over
    ROWS_ENCODE, each rows pattern, bit-exact with its plain version, the
    arrival counters 0 after every launch, one launch a call; then the
    timed rows (ROWS_LIVE). Returns {"cases", "s", "matmul", "encoder",
    "v3"}."""
    from repro_torch.kernels.sparqle_matmul import launch_plan
    t0 = time.perf_counter()
    cases, split = 0, False
    for e, c, k, n in ROWS_SWEEP:
        split |= launch_plan(c, n, k, e).splits > 1
        cases += check_rows_matmul_patterns(
            dev, gen, batched_case(dev, gen, e, c, k, n, "alternating"),
            f"at E={e} C={c} K={k} N={n}")
    if not split:
        raise AssertionError("the rows sweep must split K once")
    for e, c, k in ROWS_ENCODE:
        x = (torch.randn((e, c, k), generator=gen, device=dev) * 3).to(
            torch.bfloat16)
        mask = torch.rand((e, k), generator=gen, device=dev) < 0.5
        cases += check_rows_encoder_patterns(dev, gen, x, mask,
                                             f"at E={e} C={c} K={k}")
    rows = rows_pattern(dev, gen, 8, 3, "random")
    c8 = batched_case(dev, gen, 8, 3, 2048, 1408, "live")
    for name, (fn, _, planes, skip, _) in matmul_instances().items():
        check_one_launch(name + "_batched", lambda: fn(
            c8[planes[0]], c8[planes[1]], c8["pop"], c8["wp"], c8["asc"],
            c8["wsc"], msb_skip=skip, rows=rows))
    x8 = torch.randn((8, 3, 2048), generator=gen, device=dev)
    for name, (fn, _, _, _) in rows_encoders().items():
        check_one_launch(name, lambda: fn(x8, torch.ones(
            (8, 3, 1), device=dev), None, rows))
    sweep_s = time.perf_counter() - t0
    names = list(matmul_instances())
    mm = time_rows_matmul(dev, gen, peaks, 64, 1, 2048, 1408, ROWS_LIVE[64],
                          names)
    enc = time_rows_encoders(dev, gen, peaks, 64, 1, 2048, ROWS_LIVE[64])
    v3 = [time_rows_matmul(dev, gen, peaks, 256, 1, k, n, ROWS_LIVE[256],
                           ["sparqle_matmul"], plain=False)["sparqle_matmul"]
          for k, n in ROWS_V3_KN]
    torch.cuda.empty_cache()
    return {"cases": cases, "s": sweep_s, "matmul": mm, "encoder": enc,
            "v3": v3}


def apply_rows_timing(row, d) -> None:
    """A batched kernel row's time, plain time and bound become those of
    the serve's routing at decode (``d``: live experts, ``rows``); the
    all-experts, rows=None figures it had move into its text and
    detail."""
    row["shape"] = (f"{rows_note(d)} (the serve's routing at decode: the "
                    f"row's time, plain time and bound); every expert live, "
                    f"rows=None: {row['ms'] * 1e3:.2f} us, bound "
                    f"{row['bound_ms'] * 1e3:.2f} us, plain "
                    f"{row['plain_ms'] * 1e3:.1f} us at " + row["shape"])
    row["detail"] = list(row.get("detail", [])) + [dict(d, rows="live")]
    row.update(ms=d["ms"], plain_ms=d["plain_ms"], bound_ms=d["bound_ms"],
               bound_by=d["bound_by"])


def rows_note(d) -> str:
    """One timed rows entry: the time with the live rows against
    rows=None, and the live and all-experts bounds."""
    return (f"E={d['E']} C={d['C']} "
            + (f"{d['K']}->{d['N']}" if "N" in d else f"K={d['K']}")
            + f", {d['live']} of {d['E']} live: {d['ms'] * 1e3:.2f} us "
              f"(rows=None {d['none_ms'] * 1e3:.2f}), live bound "
              f"{d['bound_ms'] * 1e3:.2f} us ({d['bound_by']}, "
              f"{d['bound_ms'] / d['ms'] * 100:.0f}%), all-experts bound "
              f"{d['all_bound_ms'] * 1e3:.2f} us"
            + (f"; every row live: rows all C {d['full_rows_ms'] * 1e3:.2f} "
               f"us vs rows=None {d['full_none_ms'] * 1e3:.2f} us "
               f"({(d['full_rows_ms'] / d['full_none_ms'] - 1) * 100:+.1f}%)"
               if "full_rows_ms" in d else ""))


# deepseek-v3-671b's projection shapes, swept untimed in phase 3 (the
# plain projections at M = 8 decode, 17 ragged and 1,024 the --legacy
# prefill; each (K, N) as (in, out)): wq_a, wkv_a (N = 576), wq_b, wo,
# the dense layers' gate/up and down, the head; the fused encoders at
# their K; the routed experts at E = 256, C = 1 (decode: 64 assignments
# over 256 experts) and 32 (the prefill's 8 x 128 tokens x 8 / 256).
V3_M = (8, 17, 1024)
V3_KN = ((7168, 1536), (7168, 576), (1536, 24576), (16384, 7168),
         (7168, 18432), (18432, 7168), (7168, 129280))
V3_ENCODE_K = (7168, 1536, 16384, 18432, 2048)
V3_BATCHED = dict(e=256, c=(1, 32), kn=((7168, 2048), (2048, 7168)))
# mamba2-2.7b's and jamba-v0.1-52b's, swept alike: the SSD mixer's input
# projections (N = 10,576 and 16,544: a ragged last 64-column block) and
# output projections; the fused encoders at the K phase 3 does not sweep
# (4,096 and 14,336 it does); jamba's routed experts at E = 16, C = 1
# (decode: 8 tokens x top-2 over 16 experts) and 128 (the prefill's 8 x
# 128 tokens x 2 / 16).
SSD_M = (8, 17, 1024)
SSD_KN = ((2560, 10576), (5120, 2560), (4096, 16544), (8192, 4096))
SSD_ENCODE_K = (2560, 5120, 8192)
SSD_BATCHED = dict(e=16, c=(1, 128), kn=((4096, 14336), (14336, 4096)))


def check_arch_shapes(dev, gen, ms, kns, encode_ks, batched):
    """Untimed: the five matmul entries (check_matmul_case) over ms x kns
    x POP_PATTERNS, the fused encoders (check_fused_case) over ms x
    encode_ks x bf16, f32, and the five batched matmul entries and three
    batched encoders at ``batched`` (its E, C and (K, N)), each bit-exact
    with its plain version; there also the five batched matmul entries and
    six batched encoders with every ROWS_PATTERNS count, garbage past it.
    Returns the counts of input sets."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import sparqle_encode as E
    n = {"matmul": 0, "encoder": 0, "batched_matmul": 0,
         "batched_encoder": 0, "rows_matmul": 0, "rows_encoder": 0}
    for k, nn in kns:
        for m in ms:
            for pattern in POP_PATTERNS:
                check_matmul_case(matmul_case(dev, gen, m, k, nn, pattern),
                                  f"at M={m} K={k} N={nn} pop={pattern}")
                n["matmul"] += 1
    for k in encode_ks:
        for m in ms:
            for dt in (torch.bfloat16, torch.float32):
                check_fused_case(*encoder_input(dev, gen, m, k, dt),
                                 f"at M={m} K={k} {dt}")
                n["encoder"] += 1
    e = batched["e"]
    encoders = (
        (lambda *a: E.sparqle_encode_fused(*a, with_pbm=False),
         lambda *a: [t for i, t in enumerate(ref.batched(
             ref.sparqle_encode_fused_ref)(*a)) if i != 2]),
        (E.sparqle_quantize_fused,
         ref.batched(ref.sparqle_quantize_fused_ref)),
        (E.sparqle_encode_packed_fused,
         ref.batched(ref.sparqle_encode_packed_fused_ref)))
    for c in batched["c"]:
        for k, nn in batched["kn"]:
            case = batched_case(dev, gen, e, c, k, nn, "alternating")
            check_batched_matmul_case(case, f"at E={e} C={c} K={k} N={nn}")
            n["batched_matmul"] += 1
            # the live rows at this shape: with C > 64 (jamba's prefill) a
            # count cuts an expert's second row block or leaves it dead
            n["rows_matmul"] += check_rows_matmul_patterns(
                dev, gen, case, f"at E={e} C={c} K={k} N={nn}")
            del case
            x = (torch.randn((e, c, k), generator=gen, device=dev)
                 * 2).to(torch.bfloat16)
            mask = torch.rand((e, k), generator=gen, device=dev) < 0.5
            for fn, plain in encoders:
                got = [t for t in fn(x, mask, -8, 23) if t is not None]
                want = plain(x, mask, -8, 23)
                if len(got) != len(want) or not all(
                        torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"a batched encoder differs from its "
                                         f"plain version at E={e} C={c} K={k}")
            n["batched_encoder"] += 1
            n["rows_encoder"] += check_rows_encoder_patterns(
                dev, gen, x, mask, f"at E={e} C={c} K={k}")
    return n


# The paged decode attention (row 8) at the new architectures' head
# shapes, hd 128, pages of 16: deepseek-moe-16b (MHA, G = 1: the body
# masks 3 of every 4 heads in a block), starcoder2-3b (G = 12) and yi-6b
# (G = 8), beside granite-8b's G = 4 (the row's own timing).
ZOO_ATTN = (("deepseek-moe-16b", 16, 1), ("starcoder2-3b", 2, 12),
            ("yi-6b", 4, 8))


def check_attention_zoo(dev, gen, peaks):
    """Row 8 at ZOO_ATTN: within ATTN_TOL of the plain version (f32), timed
    at B = 8 over up to 16 pages; returns {arch: detail}."""
    from repro_torch.kernels.kv_attention import kv4_paged_decode_attention
    from repro_torch.kernels.ref import kv4_paged_decode_attention_ref
    b, hd, ps, n_s, n_pages = 8, 128, 16, 16, 160
    out = {}
    for arch, kvh, g in ZOO_ATTN:
        pool = kv_pool(dev, gen, n_pages, kvh=kvh)
        perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
        tables = perm[:b * n_s].reshape(b, n_s).to(torch.int32).contiguous()
        pos = torch.tensor([0, 15, 16, 17, 100, 143, 255, 200],
                           dtype=torch.int32, device=dev)
        q = torch.randn((b, kvh, g, hd), generator=gen, device=dev)
        args = (q, *pool, tables, pos)
        err = (kv4_paged_decode_attention(*args)
               - kv4_paged_decode_attention_ref(*args)).abs().max().item()
        if not err <= ATTN_TOL:
            raise AssertionError(f"attention at {arch}'s heads: {err}")
        toks = page_tokens(pos.tolist(), ps, n_s)
        bound, by = attn_bound(peaks, b, toks, toks, extra=b * n_s * 4 + b * 4,
                               kvh=kvh, g=g)
        out[arch] = {"KVH": kvh, "G": g, "max_abs_err": err,
                     "ms": time_ms(kv4_paged_decode_attention, [args], 200),
                     "plain_ms": time_ms(kv4_paged_decode_attention_ref,
                                         [args], 20),
                     "bound_ms": bound, "bound_by": by}
    return out


def smoke_config_on_card(dev, seed: int):
    """The granite-8b smoke config (hd 16, G 2) served on the card with
    pages of 8: the engine, the speculative engine (greedy streams equal
    to the engine's) and the fixed-batch path over a cache of 30
    positions (blocks of 2 tokens, gcd(30, 16)), each through its
    attention kernel; returns the launch counts and the legacy streams'
    agreement with the engine's (reported, not required: the two read
    the cache in different blocks)."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import (build_served_params, legacy_serve,
                                          make_engine, make_prompts,
                                          run_requests)
    cfg = get_config("granite-8b", smoke=True)
    params = build_served_params(cfg, seed, dev, tile_k=16)
    prompts = make_prompts(cfg, seed + 5, 4, 21)
    out = {}
    for name, gamma in (("engine", 0), ("spec", SPEC_GAMMA)):
        kernels.reset_launch_counts()
        r = run_requests(make_engine(cfg, params, batch=4, prompt_len=21,
                                     gen=9, page_size=8, spec_gamma=gamma,
                                     device=dev), prompts, 9)
        out[name] = (r["streams"], kernels.launch_counts())
    kernels.reset_launch_counts()
    legacy = legacy_serve(cfg, params, prompts, 9, dev)["streams"]
    out["legacy"] = (legacy, kernels.launch_counts())
    streams = {k: v[0] for k, v in out.items()}
    if streams["spec"] != streams["engine"]:
        raise AssertionError(f"smoke config on the card: speculative streams "
                             f"{streams['spec']} != {streams['engine']}")
    for k, need in (("engine", "kv_attention"), ("spec", "kv_attention_verify"),
                    ("legacy", "kv_attention_contiguous")):
        if not out[k][1].get(need) or any(len(x) != 9 for x in streams[k]):
            raise AssertionError(f"smoke config on the card, {k}: {need} not "
                                 f"launched or short streams")
    return {"launches": {k: {n: c for n, c in v[1].items()
                             if n.startswith("kv_attention") and c}
                         for k, v in out.items()},
            "legacy_tokens_equal": sum(a == b for x, y in zip(
                legacy, streams["engine"]) for a, b in zip(x, y))}


# ---------------------------------------------------------------------------
# phases 4-11: the engine
# ---------------------------------------------------------------------------

def granite(dev, seed: int):
    """granite-8b at full width and depth, served weights drawn from
    ``seed`` on the card, and the prompts of phases 4 and 5."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_served_params, make_prompts
    cfg = get_config("granite-8b")
    t0 = time.perf_counter()
    params = build_served_params(cfg, seed, dev)
    torch.cuda.synchronize()
    prompts = make_prompts(cfg, seed, SERVE["batch"], SERVE["prompt_len"])
    return cfg, params, prompts, time.perf_counter() - t0


def serve_granite(dev, cfg, params, prompts, spec_gamma: int = 0,
                  token_budget: int = 128, table_lookahead: int = 0,
                  mesh=None, **pool_kw):
    """One serve of the prompts through the Engine (``spec_gamma`` 0) or
    the SpeculativeEngine, launch counters zeroed just before and read
    just after. ``pool_kw`` are further ``make_engine`` keywords: the
    SLOs and attribution of phase 14 (``slos``, ``attribute``; the serve
    then also returns the engine's metrics snapshot), or the KV2
    ladder's PoolConfig fields; the ladder's serve also records the peak share of held KV bytes
    that demotion reclaims (after every step) and the in-band share
    (``page_msb_sparsity``) of each page just before its demotion, whose
    reads are kept out of the demote phase's time.
    ``table_lookahead`` widens the block table by that many tokens (as
    the speculative engine's is by gamma). With a ``mesh`` (phase 13) the
    engine serves this rank's shard, and the serve also returns the
    checksum of the shard it held."""
    from repro_torch import kernels
    from repro_torch.launch.serve import make_engine, run_requests
    shape = dict(SERVE, prompt_len=SERVE["prompt_len"] + table_lookahead)
    eng = make_engine(cfg, params, **shape, page_size=16,
                      token_budget=token_budget,
                      prefill_chunk=32, decode_slots=8,
                      spec_gamma=spec_gamma, device=dev, mesh=mesh,
                      **pool_kw)
    pool, ladder = eng.pool, {"peak": 0.0, "spars": [], "spars_s": 0.0}
    if pool.kv2_armed:
        demote, step = pool.demote, eng.step

        def measured_demote(owner, idx):
            if not pool.tiers_of(owner)[idx] and pool.kv2_free:
                t0 = time.perf_counter()
                ladder["spars"].append(float(pool.page_msb_sparsity(
                    [pool.pages_of(owner)[idx]])[0]))
                ladder["spars_s"] += time.perf_counter() - t0
            return demote(owner, idx)

        def tracked_step():
            out = step()
            saved = pool.kv_bytes_saved()
            if saved:
                ladder["peak"] = max(ladder["peak"], saved / (
                    saved + pool.kv_bytes_held()))
            return out

        pool.demote, eng.step = measured_demote, tracked_step
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    r = run_requests(eng, prompts, SERVE["gen"])
    counts = kernels.launch_counts()
    lat = eng._m_step_lat
    r.update(layers=cfg.n_layers, d_model=cfg.d_model, launches=counts,
             peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
             forwards={ph: lat.count(phase=ph) for ph in
                       ("prefill", "decode", "draft", "verify")},
             step_mode=eng.step_mode)
    if mesh is not None:
        r["checksum"] = tree_checksum(eng.params)
    if r["attribution"] is not None:
        r["snapshot"] = eng.metrics_snapshot()
        r["resident_bytes"] = resident_decode_bytes(eng)
        r["kv2_share"] = eng.kv2_table_share()
    if pool.kv2_armed:
        r["ladder"] = dict(
            ladder, page_bytes=dict(pool._page_bytes),
            demote_s=lat.sum(phase="demote") - ladder["spars_s"],
            graphs=[pool.recodecs.demote_step.graphs,
                    pool.recodecs.promote_step.graphs])
    if r["finished"] != SERVE["batch"] or any(
            len(s) != SERVE["gen"] for s in r["streams"]):
        raise AssertionError(f"unfinished requests: {r['streams']}")
    if any(not 0 <= t < cfg.vocab for s in r["streams"] for t in s):
        raise AssertionError("token outside the vocabulary")
    del eng
    return r


def graphs_vs_eager(dev, cfg, params, prompts):
    """Phase 4b's serves: one engine serving under ``disable_graphs()``
    and one with its steps as CUDA graphs, alternated — a warm serve of
    each (the graph engine's captures), then GRAPH_ROUNDS rounds — each
    serve with the launch counters zeroed just before and read just
    after. Returns {path: [warm serve, timed serves...]}."""
    import contextlib
    from repro_torch import kernels
    from repro_torch.launch.graphs import disable_graphs
    from repro_torch.launch.serve import make_engine, run_requests
    runs = {"eager": [], "graphs": []}
    engines = {path: make_engine(cfg, params, **SERVE, page_size=16,
                                 token_budget=128, prefill_chunk=32,
                                 decode_slots=8, device=dev)
               for path in runs}
    for _ in range(1 + GRAPH_ROUNDS):
        for path, eng in engines.items():
            kernels.reset_launch_counts()
            with (disable_graphs() if path == "eager"
                  else contextlib.nullcontext()):
                r = run_requests(eng, prompts, SERVE["gen"])
            r["launches"] = kernels.launch_counts()
            del r["aggregate"]
            runs[path].append(r)
    if [s.graphs for s in (engines["graphs"]._prefill_fn,
                           engines["graphs"]._decode_fn)] != [1, 1]:
        raise AssertionError("the graph engine did not capture one graph "
                             "a step")
    return runs


RECODEC_CALLS = 20


def recodec_times(dev, cfg):
    """Host ms a page of each KV2 re-codec through ``PageRecodecs`` (the
    engine's path: ids filled, copied in, one replay) on a pool of phase
    6's size at full depth: its capture (the second call), then
    RECODEC_CALLS pages replayed and as many eagerly
    (``disable_graphs()``), the card synced after each run of pages."""
    import contextlib
    from repro_torch.launch.graphs import disable_graphs
    from repro_torch.serving import tiering
    from repro_torch.serving.kv_pool import PoolConfig, init_pool_state
    n_pages = 1 + 8 * math.ceil((SERVE["prompt_len"] + SERVE["gen"]) / 16)
    state = init_pool_state(cfg, PoolConfig(n_pages=n_pages, page_size=16,
                                            kv2_pages=n_pages), dev)
    codecs = tiering.PageRecodecs(dev)
    out = {}
    for op in ("demote", "promote"):
        run = getattr(codecs, op)
        ms = {}
        for path in ("capture", "replay", "eager"):
            calls = 1 if path == "capture" else RECODEC_CALLS
            with (disable_graphs() if path == "eager"
                  else contextlib.nullcontext()):
                if path == "capture":
                    run(state, 1, 2)               # the warm-up
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for i in range(calls):
                    run(state, 1 + i, 2 + i)
                torch.cuda.synchronize()
            ms[path] = (time.perf_counter() - t0) / calls * 1e3
        out[op] = ms
    del state, codecs
    return out


def legacy_prefill_serves(dev, cfg, params, prompts):
    """Phase 4b's ``--legacy`` serves: the prompts three times through one
    ``LegacySteps``, whose prefill warms up eagerly (the caches allocated
    there), is captured, then replays; launch counters zeroed just before
    each serve and read just after, and the card's reserved bytes each
    serve added (the capture's: the prefill graph's memory pool). Raises
    unless the prefill ran warm-up, capture, replay into one graph and
    the three serves' streams and launch counts are equal. Returns the
    three runs."""
    from repro_torch import kernels
    from repro_torch.launch.serve import LegacySteps, legacy_serve
    steps = LegacySteps(cfg, len(prompts), len(prompts[0]) + SERVE["gen"],
                        dev)
    runs = []
    for _ in range(3):
        reserved = torch.cuda.memory_reserved(dev)
        kernels.reset_launch_counts()
        r = legacy_serve(cfg, params, prompts, SERVE["gen"], dev,
                         steps=steps)
        r["launches"] = kernels.launch_counts()
        r["reserved_gb"] = (torch.cuda.memory_reserved(dev) - reserved) / 1e9
        runs.append(r)
    calls = [r["prefill_call"] for r in runs]
    if calls != ["warm-up", "capture", "replay"] or \
            (steps.prefill.graphs, steps.decode.graphs) != (1, 1) or \
            any(r["streams"] != runs[0]["streams"] or
                r["launches"] != runs[0]["launches"] for r in runs):
        raise AssertionError(f"--legacy serves through one LegacySteps: "
                             f"prefill {calls}, graphs "
                             f"{steps.prefill.graphs}/{steps.decode.graphs}")
    del steps
    gc.collect()
    torch.cuda.empty_cache()
    return runs


def check_path(r, need, absent=()):
    """Raise unless every kernel in ``need`` launched and none in
    ``absent`` did in the serve ``r``."""
    counts = r["launches"]
    if not all(counts[k] > 0 for k in need) or any(counts[k]
                                                   for k in absent):
        raise AssertionError(f"launches {counts}: need {need}, absent "
                             f"{absent}")


def row_count_dependence(dev, cfg, params):
    """For B decode rows: how many elements change when the same B rows
    go through rms_norm (f32, and the served dtype) and the tied head
    inside a B*(SPEC_GAMMA+1)-row call (a verify window's row count)
    instead of a B-row one (a decode step's) — the reason the verify
    window runs its norms and head per window position. The f32 norm
    shows a change of the row mean's sum order that a cast of the output
    to bf16 mostly hides."""
    from repro_torch.core.qlinear import linear
    from repro_torch.models.layers import rms_norm
    g = torch.Generator(device=dev).manual_seed(11)
    gamma = params["final_norm"]["gamma"]
    table = params["embed"]["table"].T
    out = {}
    for b in (1, 2, 4, 8, 16):
        x = torch.randn((b * (SPEC_GAMMA + 1), 1, cfg.d_model),
                        generator=g, device=dev)

        def differing(fn, a):
            return int((fn(a[:b]) != fn(a)[:b]).sum().item())

        norm = lambda a: rms_norm(a, gamma, cfg.rms_eps)  # noqa: E731
        out[f"B={b}"] = (
            f"norm f32 {differing(norm, x)}/{b * cfg.d_model}, norm "
            f"{str(cfg.cdtype).split('.')[-1]} "
            f"{differing(norm, x.to(cfg.cdtype))}, head "
            f"{differing(lambda a: linear(a, table), x.to(cfg.cdtype))}"
            f"/{b * cfg.vocab}")
    return out


def fill_random(tree, g):
    """Random bytes and scales in every tensor of a pool or cache tree (a
    used pool), in place; returns the tree."""
    for v in tree.values():
        if isinstance(v, dict):
            fill_random(v, g)
        elif v.dtype == torch.int8:
            v.random_(-128, 128, generator=g)
        else:
            v.uniform_(0.01, 0.2, generator=g)
    return tree


def clone_tree(tree):
    """A copy of a dict tree of tensors."""
    return {k: clone_tree(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def trees_equal(a, b) -> bool:
    """Bit equality of two step results (tensors in dicts and tuples)."""
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and torch.equal(a, b))
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(trees_equal(a[k], b[k]) for k in a))
    if isinstance(a, (tuple, list)):
        return (isinstance(b, (tuple, list)) and len(a) == len(b)
                and all(trees_equal(x, y) for x, y in zip(a, b)))
    return a == b


def window_vs_decode(dev, cfg, params, seed: int):
    """One verify window (T = SPEC_GAMMA + 1) against T decode steps at
    full width and depth, from the same random pool: True when the
    logits and the written pages are bit-equal. Greedy streams of random
    weights may sit on a fixed point; this holds the logits themselves."""
    from repro_torch.launch import steps as S
    from repro_torch.serving.kv_pool import PoolConfig, init_pool_state
    g = torch.Generator(device=dev).manual_seed(seed + 13)
    b, t, ps, n_s = 8, SPEC_GAMMA + 1, 16, 10
    pool = fill_random(init_pool_state(
        cfg, PoolConfig(n_pages=1 + b * n_s, page_size=ps), dev), g)
    vpool = clone_tree(pool)
    tables = (torch.randperm(b * n_s, generator=g, device=dev) + 1).reshape(
        b, n_s).to(torch.int32)
    pos = torch.tensor([3, 14, 30, 47, 62, 95, 126, n_s * ps - t],
                       dtype=torch.int32, device=dev)
    window = torch.randint(0, cfg.vocab, (b, t), generator=g, device=dev,
                           dtype=torch.int32)
    vl, _, _ = S.make_engine_verify_window(cfg)(params, vpool, window, pos,
                                                tables)
    decode = S.make_engine_decode(cfg)
    logits_equal = True
    for i in range(t):
        lg, _, _ = decode(params, pool, window[:, i].contiguous(), pos + i,
                          tables)
        logits_equal &= torch.equal(vl[:, i], lg)
    pages_equal = all(
        torch.equal(vpool["stages"][s][p][k], pool["stages"][s][p][k])
        for s in pool["stages"] for p in pool["stages"][s]
        for k in pool["stages"][s][p])
    return {"logits_equal": logits_equal, "pages_equal": pages_equal}


def graph_cases(cfg, params, dev, seed: int, *, b: int = 8, ps: int = 16,
                n_s: int = 10, chunk: int = 32, gamma: int = SPEC_GAMMA):
    """Every step kind that the engines, the fixed-batch path and the KV2
    ladder run as CUDA graphs, one at a time: (name, step closure, its
    persistent arguments — the params, if it takes them, then the state
    it writes — and the inputs of four calls: a compiled step's warm-up,
    its capture and two replays). The state is a used random pool of b
    slots x n_s pages of ps tokens (with a KV2 slab for the tiered step
    and the re-codecs) or contiguous caches of n_s * ps positions. From
    call to call the positions, block tables and tokens move, a slot is
    left inactive (zero table row, position 0), the prefill chunk runs
    valid = chunk and valid < chunk at other starts, the fixed-batch
    prefill new prompts into the used caches, and the re-codecs other
    pages."""
    from repro_torch.launch import steps as S
    from repro_torch.models.model import init_cache
    from repro_torch.serving import tiering
    from repro_torch.serving.kv_pool import PoolConfig, init_pool_state
    g = torch.Generator(device=dev).manual_seed(seed + 17)
    span, n_pages = n_s * ps, 1 + b * n_s

    def ints(*vals):
        return torch.tensor(vals, dtype=torch.int32, device=dev)

    def tokens(*shape):
        return torch.randint(0, cfg.vocab, shape, generator=g, device=dev,
                             dtype=torch.int32)

    def pool(kv2_pages=0):
        return fill_random(init_pool_state(cfg, PoolConfig(
            n_pages=n_pages, page_size=ps, kv2_pages=kv2_pages), dev), g)

    def batch(call, hi, tiers=False):
        """token, pos in [0, hi), tables (and tier tables) of b slots;
        slot ``call % b`` inactive. The page under pos is at tier 0, as
        the engine promotes it before the step writes there (a write to
        a demoted page goes to the null page, where two slots' writes
        would race)."""
        rows = torch.arange(b, device=dev)
        keep = (rows != call % b).to(torch.int32)
        tables = (torch.randperm(b * n_s, generator=g, device=dev) + 1
                  ).reshape(b, n_s).to(torch.int32) * keep[:, None]
        pos = torch.randint(0, hi, (b,), generator=g, device=dev,
                            dtype=torch.int32) * keep
        out = (tokens(b) * keep, pos, tables)
        if tiers:
            tier = torch.randint(0, 2, (b, n_s), generator=g, device=dev,
                                 dtype=torch.int32) * keep[:, None]
            tier[rows, (pos // ps).long()] = 0
            out += (tier,)
        return out

    def chunk_call(start, valid):
        table = (torch.randperm(n_pages - 1, generator=g, device=dev)[:n_s]
                 + 1)[None].to(torch.int32)
        return tokens(1, chunk), ints(start), ints(valid), table

    yield ("prefill_chunk", S.make_engine_prefill_chunk(cfg), (params, pool()),
           [chunk_call(0, chunk), chunk_call(chunk, chunk),
            chunk_call(2 * chunk, chunk // 2 + 3), chunk_call(ps + 1, chunk - 1)])
    yield ("decode", S.make_engine_decode(cfg), (params, pool()),
           [batch(i, span) for i in range(4)])
    yield ("draft", S.make_engine_decode(cfg, msb_skip=True,
                                         with_telemetry=False),
           (params, pool()), [batch(i, span) for i in range(4)])
    verify = []
    for i in range(4):
        token, pos, tables = batch(i, span - gamma)
        window = tokens(b, gamma + 1)
        window[:, 0] = token
        verify.append((window * (tables[:, :1] != 0), pos, tables))
    yield ("verify", S.make_engine_verify_window(cfg), (params, pool()),
           verify)
    yield ("kv2_decode", S.make_engine_decode(cfg, kv2=True),
           (params, pool(kv2_pages=n_pages)),
           [batch(i, span, tiers=True) for i in range(4)])
    cache = fill_random(init_cache(cfg, b, span, dev), g)
    yield ("legacy_decode", S.make_serve_decode(cfg), (params, cache),
           [batch(i, span)[:2] for i in range(4)])
    # a used cache of span positions, prompts of span - 2 ps tokens
    cache = fill_random(init_cache(cfg, b, span, dev), g)
    yield ("legacy_prefill", S.make_serve_prefill_into(cfg), (params, cache),
           [(tokens(b, span - 2 * ps),) for _ in range(4)])
    # one page id pair a call: a used KV4 page into a KV2 page, and back
    state = pool(kv2_pages=n_pages)
    pages = torch.randperm(n_pages - 1, generator=g, device=dev) + 1
    ids = [(pages[2 * i].int(), pages[2 * i + 1].int()) for i in range(4)]
    yield ("kv2_demote", tiering.demote_page, (state,), ids)
    yield ("kv2_promote", tiering.promote_page, (state,), ids)


def replay_vs_eager(dev, case, graph_type=None) -> bool:
    """One case of :func:`graph_cases` through a compiled step (warm-up,
    capture, replays; ``graph_type`` as ``CompiledStep`` takes it) and
    eagerly on a copy of the same state: True when every call's outputs
    and the state after it are bit-equal and the step captured one
    graph."""
    from repro_torch.launch.graphs import CompiledStep
    _, fn, (*fixed, state), calls = case
    step = CompiledStep(fn, dev, graph_type=graph_type)
    twin = clone_tree(state)
    same = True
    for args in calls:
        got = step(*fixed, state, *args)
        want = fn(*fixed, twin, *args)
        same &= trees_equal(got, want) and trees_equal(state, twin)
    return same and step.graphs == 1


def with_fields(tree, **fields):
    """The served tree with every projection's ``fields`` replaced
    (``mode='dense'``: the W4A8 baseline; ``wire_format='packed'``: the
    packed wire format): the same tensors on the card, no copy."""
    import dataclasses
    from repro_torch.core.qlinear import SparqleLinear
    if isinstance(tree, dict):
        return {k: with_fields(v, **fields) for k, v in tree.items()}
    if isinstance(tree, SparqleLinear):
        return dataclasses.replace(tree, **fields)
    return tree


def logits_equal(dev, cfg, params, other, prompts):
    """One 32-token prefill chunk, then one decode step (8 slots, slot 0
    at position 32), through two served trees of the same weights at
    full depth: True per step when the logits are bit-equal."""
    from repro_torch.launch import steps as S
    from repro_torch.serving.kv_pool import PoolConfig, init_pool_state
    n_s = 9
    table = torch.zeros((8, n_s), dtype=torch.int32, device=dev)
    table[0, :3] = torch.tensor([1, 2, 3])
    toks = torch.tensor([prompts[0][:33]], dtype=torch.int32, device=dev)
    token = torch.zeros((8,), dtype=torch.int32, device=dev)
    token[0] = toks[0, 32]
    pos = torch.zeros((8,), dtype=torch.int32, device=dev)
    pos[0] = 32
    out = []
    for tree in (params, other):
        pool = init_pool_state(cfg, PoolConfig(n_pages=4, page_size=16), dev)
        pl, _, _ = S.make_engine_prefill_chunk(cfg)(
            tree, pool, toks[:, :32].contiguous(), 0, 32, table[:1])
        dl, _, _ = S.make_engine_decode(cfg)(tree, pool, token, pos, table)
        out.append((pl, dl[:1]))
    (ps_, ds_), (pd, dd) = out
    return {"prefill": torch.equal(ps_, pd), "decode": torch.equal(ds_, dd)}


def serve_legacy(dev, cfg, params, prompts):
    """The prompts through the fixed-batch path (``serve --legacy``),
    launch counters zeroed just before and read just after."""
    from repro_torch import kernels
    from repro_torch.launch.serve import legacy_serve
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    r = legacy_serve(cfg, params, prompts, SERVE["gen"], dev)
    r.update(launches=kernels.launch_counts(),
             peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    if any(len(s) != SERVE["gen"] or not all(0 <= t < cfg.vocab for t in s)
           for s in r["streams"]):
        raise AssertionError(f"legacy streams: {r['streams']}")
    return r


def legacy_vs_engine(dev, seed: int):
    """Granite width, 2 layers, f32: the fixed-batch greedy streams and
    the engine's with every prompt prefilled in one chunk (prompt + gen
    a multiple of 16, so the contiguous kernel's blocks are the pages)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import (build_served_params, legacy_serve,
                                          make_engine, make_prompts,
                                          run_requests)
    cfg = get_config("granite-8b").replace(n_layers=2, dtype="float32")
    params = build_served_params(cfg, seed, dev)
    prompts = make_prompts(cfg, seed + 3, 4, 56)
    legacy = legacy_serve(cfg, params, prompts, 8, dev)["streams"]
    eng = make_engine(cfg, params, batch=4, prompt_len=56, gen=8,
                      prefill_chunk=64, token_budget=256, device=dev)
    engine = run_requests(eng, prompts, 8)["streams"]
    return {"equal": legacy == engine,
            "tokens_equal": sum(a == b for x, y in zip(legacy, engine)
                                for a, b in zip(x, y))}


def profile_engine(cfg, params, dev, seed: int, spec_gamma: int = 0,
                   tag: str = ""):
    """Where the time goes: a shorter workload on the same engine shape
    (8 requests x 32 prompt tokens x 8 new), served once to capture the
    engine's step graphs, then again under torch.profiler (device time
    by kernel, device busy share of the wall, the launch counters of
    that run beside the matmul kernels' rows) and under cProfile (host
    time by function), written to chiprun_out/ (file suffix ``tag``).
    Launches here come after the serves' counters were read."""
    import cProfile
    import io
    import pstats
    from repro_torch import kernels
    from repro_torch.launch.serve import (make_engine, make_prompts,
                                          run_requests)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    prompts = make_prompts(cfg, seed + 7, 8, 32)
    tag = tag or (f"_spec{spec_gamma}" if spec_gamma else "")
    eng = make_engine(cfg, params, batch=8, prompt_len=32, gen=8,
                      spec_gamma=spec_gamma, device=dev)
    run_requests(eng, prompts, 8)       # warm: captures the step graphs

    def workload():
        return run_requests(eng, prompts, 8)

    kernels.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        r = workload()
    launches = kernels.launch_counts()
    ka = prof.key_averages()
    # device busy: the kernels' own rows only. An operator's row (say
    # aten::amax) carries the device time of the kernel it launched too,
    # so summing every row counts that time twice.
    rows = sorted(((e.key, getattr(e, "self_device_time_total",
                                   getattr(e, "self_cuda_time_total", 0)),
                    e.count) for e in ka
                   if e.device_type == DeviceType.CUDA),
                  key=lambda r: -r[1])
    dev_us = sum(us for _, us, _ in rows)
    (OUT / f"profile_device{tag}.txt").write_text(ka.table(
        sort_by="self_cuda_time_total", row_limit=40))
    (OUT / f"profile_host{tag}.txt").write_text(ka.table(
        sort_by="self_cpu_time_total", row_limit=40))
    pr = cProfile.Profile()
    pr.enable()
    r2 = workload()
    pr.disable()
    buf = io.StringIO()
    pstats.Stats(pr, stream=buf).sort_stats("tottime").print_stats(40)
    (OUT / f"profile_python{tag}.txt").write_text(buf.getvalue())
    # device time by kernel: shares of the kernel rows' sum
    by_kernel = [{"kernel": name[:80], "share": us / dev_us,
                  "mean_us": us / n, "launches": n}
                 for name, us, n in rows[:12]]
    # the matmul entries launch no drain and no fill of an accumulator:
    # name every drain or fill row there is, and every matmul row
    drain_fill = [{"kernel": name[:120], "launches": n}
                  for name, _, n in rows if "drain" in name or "Fill" in name]
    matmul_rows = [{"kernel": name[:120], "launches": n}
                   for name, _, n in rows if "sparqle_matmul_kernel" in name]
    # the bf16 reductions (the per-token amax ran as one before every
    # encoder until the encoder computed its own scale) and the encoder
    # launches (one a projection)
    amax = [(us, n) for name, us, n in rows
            if "reduce_kernel" in name and "BFloat16" in name]
    enc = [n for name, _, n in rows if "sparqle_encode" in name]
    return {"profiled_wall_s": r["wall_s"], "device_busy_s": dev_us / 1e6,
            "device_busy_share": dev_us / 1e6 / r["wall_s"],
            "cprofiled_wall_s": r2["wall_s"],
            # the same work's device time over the wall of the rerun that
            # ran without CUPTI (which slows every graph launch on the host)
            "device_busy_share_cprofiled": dev_us / 1e6 / r2["wall_s"],
            "by_kernel": by_kernel,
            "drain_fill": drain_fill, "matmul_rows": matmul_rows,
            "launches": launches,
            "kernel_launches": sum(n for _, _, n in rows),
            "bf16_reduce_launches": sum(n for _, n in amax),
            "bf16_reduce_us": sum(us for us, _ in amax),
            "encoder_launches": sum(enc)}


def fill_launches(p) -> int:
    """The drain and fill kernel records of a ``profile_engine`` trace."""
    return sum(r["launches"] for r in p["drain_fill"])


def profile_dense(cfg, params, dense, dev, seed: int, base,
                  tries: int = 3):
    """``profile_engine`` of the dense tree beside ``base``, the base
    tree's trace. Both serves launch the same fills, the engine's own, so
    while their traces hold different numbers of drain or fill records
    the shorter trace lost records in CUPTI, not launches on the card
    (on an H100 one trace of 110,000 kernel records once lacked 70 matmul
    and 59 fill records of one window), and that trace is taken again,
    ``tries`` traces at most in all. A dense serve that launched fills of
    its own keeps more of them whatever the base trace holds. Returns
    the base and dense traces, the dense one with each attempt's counts."""
    d = profile_engine(cfg, dense, dev, seed, tag="_dense")
    attempts = []
    while True:
        attempts.append({"fills": fill_launches(d),
                         "base_fills": fill_launches(base),
                         "matmul": sum(r["launches"]
                                       for r in d["matmul_rows"]),
                         "kernel_launches": d["kernel_launches"]})
        if fill_launches(d) == fill_launches(base) or len(attempts) == tries:
            d["attempts"] = attempts
            return base, d
        if fill_launches(d) < fill_launches(base):
            d = profile_engine(cfg, dense, dev, seed, tag="_dense")
        else:
            base = profile_engine(cfg, params, dev, seed)


def cross_check(dev, seed: int, arch: str = "granite-8b"):
    """``arch``'s width, 2 layers, f32: Engine on the card vs on the CPU
    (deepseek-moe-16b: its dense first layer and one MoE layer)."""
    from repro_torch.configs import get_config
    from repro_torch.core.qlinear import tree_to
    from repro_torch.launch.serve import (build_served_params, make_engine,
                                          make_prompts)
    from repro_torch.serving import SamplingParams
    cfg = get_config(arch).replace(n_layers=2, dtype="float32")
    params = build_served_params(cfg, seed, "cpu")
    prompts = make_prompts(cfg, seed + 1, 2, 32)
    gen = 4
    runs = {}
    for name, device in (("cuda", dev), ("cpu", torch.device("cpu"))):
        eng = make_engine(cfg, tree_to(params, device), batch=2,
                          prompt_len=32, gen=gen, device=device)
        logits = []

        def record(fn):
            def wrapped(*a):
                out = fn(*a)
                logits.append(out[0].float().cpu())
                return out
            return wrapped
        eng._prefill_fn = record(eng._prefill_fn)
        eng._decode_fn = record(eng._decode_fn)
        hs = [eng.submit(p, SamplingParams(max_new_tokens=gen))
              for p in prompts]
        eng.run()
        runs[name] = (logits, [list(h.out_tokens) for h in hs])
    (lg_c, st_c), (lg_p, st_p) = runs["cuda"], runs["cpu"]
    match = sum(a == b for x, y in zip(st_c, st_p) for a, b in zip(x, y))
    total = sum(len(x) for x in st_p)
    # logits compare step by step while both runs fed the same tokens
    n_cmp = len(lg_p) if st_c == st_p else 2
    err = max((a - b).abs().max().item()
              for a, b in zip(lg_c[:n_cmp], lg_p[:n_cmp]))
    scale = max(b.abs().max().item() for b in lg_p[:n_cmp])
    log(f"    {arch} seed {seed}: max |dlogit| {err:.4g} of max |logit| "
        f"{scale:.4g} ({err / scale:.4g} rel) over {n_cmp} steps, greedy "
        f"tokens {match}/{total}")
    tol = LOGIT_TOL_ARCH.get(arch, LOGIT_TOL)
    if not err <= tol * scale:
        raise AssertionError(f"cross-check logits differ: {err} vs "
                             f"{tol} * {scale}")
    if st_c != st_p:
        raise AssertionError(f"cross-check greedy streams differ: cuda "
                             f"{st_c} vs cpu {st_p}")
    return {"arch": arch, "seed": seed, "max_abs_logit_err": err,
            "max_abs_logit": scale,
            "rel_err": err / scale, "steps_compared": n_cmp,
            "greedy_match": f"{match}/{total}"}


# ---------------------------------------------------------------------------
# phase 12: the rest of the zoo the engine serves, and serve --ckpt
# ---------------------------------------------------------------------------

ZOO = ("yi-6b", "starcoder2-3b", "deepseek-moe-16b")
# phase 12's depth cuts: deepseek-moe-16b serves its first 14 of 28
# layers (1 dense, 13 MoE) since the smoke took ~1,160 s twice (its seven
# serves at 28 layers took 64-67 s)
ZOO_LAYERS = {"deepseek-moe-16b": 14}
# a token budget that takes a 32-token chunk of all 8 prompts and 8
# speculative decode slots (2 gamma + 1 tokens each) in one step, so both
# engines cut the same chunks
NODROP_BUDGET = 512
# the 2-D matmul entries and the batched ones
BATCHED = ("sparqle_encode_fused_batched", "sparqle_quantize_fused_batched",
           "sparqle_encode_packed_fused_batched", "sparqle_matmul_batched",
           "sparqle_matmul_draft_batched", "sparqle_matmul_packed_batched",
           "sparqle_matmul_packed_draft_batched", "quant_matmul_batched")


def summary(r):
    """TTFT, TPOT and tokens/s of a serve, and its nonzero launches."""
    return (f"TTFT mean {r['ttft_mean_s'] * 1e3:.1f} ms, TPOT mean "
            f"{r['tpot_mean_s'] * 1e3:.2f} ms, {r['tokens_per_s']:.1f} tok/s, "
            f"{r['steps']} steps, launches "
            f"{ {k: v for k, v in r['launches'].items() if v} }")


def serve_zoo_arch(dev, arch, seed):
    """``arch`` at full width and depth (ZOO_LAYERS' cut where it has
    one), weights drawn from ``seed`` on the card, phase 4's serve (8 x
    128 x 16, CUDA graphs). For
    deepseek-moe-16b also gamma = SPEC_GAMMA, dense and the packed wire
    format (base and gamma): dense and packed streams equal to the base
    serve's, packed gamma's to gamma's, dense logits bit-equal to
    SPARQLe's, one verify window bit-equal to its decode steps at full
    depth, every routed projection one batched encoder and one batched
    matmul launch (3 a MoE layer and forward); the base serve once more
    with rows=None (:func:`rows_off`, the A side of the live rows' A/B:
    streams and launches equal to the base serve's). The gamma serve's streams
    against the base serve's are reported, not required. An expert keeps
    at most ``capacity`` assignments of the tokens routed together (1 at
    decode), so which tokens a step batches decides which are dropped;
    and under a token budget below the batch's prefill, the speculative
    engine (which charges 2 gamma + 1 tokens a decode slot) cuts other
    prefill chunks than the base engine. So the two engines route other
    token sets (JAX's engines part the same way,
    ``tests/test_torch_moe.py``). The speculative engine's block table
    is also wider by gamma tokens (10 pages against 9 here), and the
    attention's split plan and the prefill chunk's softmax width follow
    the table width, so f32 sums run in another order. With the capacity
    factor at E (capacity t top_k: no assignment dropped), a budget that
    prefills every request's chunk each step and the base engine's table
    as wide as the speculative one's, the gamma serve must give the base
    serve's streams.
    Returns {run name: serve summary}."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_served_params, make_prompts
    from repro_torch.models.stages import build_stages
    cfg = get_config(arch)
    cfg = cfg.replace(n_layers=ZOO_LAYERS.get(arch, cfg.n_layers))
    t0 = time.perf_counter()
    params = build_served_params(cfg, seed, dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    prompts = make_prompts(cfg, seed, SERVE["batch"], SERVE["prompt_len"])
    moe_layers = sum(st.repeat * sum(ld.ffn == "moe" for ld in st.period)
                     for st in build_stages(cfg))
    runs = {"base": serve_granite(dev, cfg, params, prompts)}
    base = runs["base"]
    need = ("sparqle_encode_fused", "sparqle_matmul", "kv_attention")
    if moe_layers:
        need += ("sparqle_encode_fused_batched", "sparqle_matmul_batched")
        # A of the live rows' A/B: the base serve with rows=None
        with rows_off():
            runs["base_rows_none"] = serve_granite(dev, cfg, params, prompts)
        runs["spec"] = serve_granite(dev, cfg, params, prompts,
                                     spec_gamma=SPEC_GAMMA)
        dense = with_fields(params, mode="dense")
        runs["dense"] = serve_granite(dev, cfg, dense, prompts)
        runs["dense"]["logits_equal"] = logits_equal(dev, cfg, params, dense,
                                                     prompts)
        packed = with_fields(params, wire_format="packed")
        runs["packed"] = serve_granite(dev, cfg, packed, prompts)
        runs["packed_spec"] = serve_granite(dev, cfg, packed, prompts,
                                            spec_gamma=SPEC_GAMMA)
        del dense, packed
        # capacity t k: an expert can take every assignment of the call
        # (E / top_k gives t only up to a float rounding: 8 x 6 x 10.67
        # rounds to 511, capacity 7)
        nodrop = cfg.replace(capacity_factor=float(cfg.n_experts))
        runs["nodrop"] = serve_granite(dev, nodrop, params, prompts,
                                       token_budget=NODROP_BUDGET,
                                       table_lookahead=SPEC_GAMMA)
        runs["nodrop_spec"] = serve_granite(dev, nodrop, params, prompts,
                                            spec_gamma=SPEC_GAMMA,
                                            token_budget=NODROP_BUDGET)
        runs["spec"]["window_vs_decode"] = window_vs_decode(dev, cfg, params,
                                                            seed)
    check_path(base, need, UNFUSED + tuple(
        b for b in BATCHED if b not in need))
    if moe_layers and runs["base_rows_none"]["launches"] != base["launches"]:
        raise AssertionError(f"{arch}: launches with rows=None differ from "
                             f"the base serve's")
    paths = {"spec": ("sparqle_matmul_draft_batched",),
             "dense": ("sparqle_quantize_fused_batched",
                       "quant_matmul_batched"),
             "packed": ("sparqle_encode_packed_fused_batched",
                        "sparqle_matmul_packed_batched"),
             "packed_spec": ("sparqle_matmul_packed_draft_batched",)}
    same_as = {"spec": None, "packed_spec": "spec", "nodrop": None,
               "nodrop_spec": "nodrop"}
    for name, r in runs.items():
        r["streams_equal_base"] = sum(
            a == b for a, b in zip(r["streams"], base["streams"]))
        ref_run = same_as.get(name, "base")
        if ref_run and r["streams"] != runs[ref_run]["streams"]:
            raise AssertionError(f"{arch} {name}: streams differ from the "
                                 f"{ref_run} serve's")
        if name in paths:
            check_path(r, paths[name], UNFUSED)
        if name == "nodrop_spec":
            check_path(r, paths["spec"], UNFUSED)
        if moe_layers:
            # a verify window routes one MoE call a window position
            fw = sum(n * (SPEC_GAMMA + 1 if ph == "verify" else 1)
                     for ph, n in r["forwards"].items())
            enc = sum(r["launches"][k] for k in BATCHED[:3])
            mm = sum(r["launches"][k] for k in BATCHED[3:])
            if enc != 3 * moe_layers * fw or mm != 3 * moe_layers * fw:
                raise AssertionError(
                    f"{arch} {name}: batched launches {enc}/{mm} for "
                    f"{moe_layers} MoE layers x {fw} forwards")
    if moe_layers and not (all(runs["dense"]["logits_equal"].values()) and
                           all(runs["spec"]["window_vs_decode"].values())):
        raise AssertionError(f"{arch}: dense logits differ from SPARQLe's "
                             f"or the verify window from its decode steps")
    for name, r in runs.items():
        log(f"[12] {arch} {cfg.n_layers}L d={cfg.d_model} {name}: "
            f"{r['requests']} requests, {r['tokens']} tokens, streams equal "
            f"to the base serve's {r['streams_equal_base']}/"
            f"{len(base['streams'])}"
            + (f" ({same_as[name]}'s: all)" if same_as.get(name) else "")
            + f", {summary(r)}, peak {r['peak_mem_gb']:.1f} GB"
            + (f", logits bit-equal to SPARQLe: {r['logits_equal']}"
               if "logits_equal" in r else "")
            + (f", one verify window vs {SPEC_GAMMA + 1} decode steps at "
               f"{cfg.n_layers}L: {r['window_vs_decode']}, acceptance "
               f"{r['aggregate']['spec_acceptance_rate']:.4f}"
               if "window_vs_decode" in r else "")
            + (f", weights built in {t_build:.1f} s" if name == "base"
               else ""))
    del params
    torch.cuda.empty_cache()
    return {name: {k: v for k, v in r.items() if k != "aggregate"}
            for name, r in runs.items()}


def ckpt_round_trip(dev, seed):
    """``serve --ckpt``: the port's ``save`` of deepseek-moe-16b's smoke
    float params, served through the CLI on the card (restore, quantize
    one layer at a time on the card, SyntheticLM prompts); streams equal
    to serving the tree directly."""
    import shutil
    from repro_torch.checkpoint import store
    from repro_torch.configs import get_config
    from repro_torch.core.qlinear import quantize_model_params
    from repro_torch.launch import serve
    from repro_torch.models.schema import init_params
    from repro_torch.models.schema_builder import build_schema
    cfg = get_config("deepseek-moe-16b", smoke=True)
    params = init_params(build_schema(cfg), seed + 11, "cpu")
    path = ROOT / "build" / "ckpt_round_trip"
    shutil.rmtree(path, ignore_errors=True)
    store.save(str(path), {"params": params}, 1)
    shape = dict(batch=4, prompt_len=21, gen=9)
    r = serve.main(["--arch", cfg.name, "--smoke", "--ckpt", str(path),
                    "--batch", "4", "--prompt-len", "21", "--gen", "9",
                    "--page-size", "8"])
    direct = quantize_model_params(params, w_bits=cfg.w_bits, tile_k=16,
                                   device=dev)
    eng = serve.make_engine(cfg, direct, page_size=8, device=dev, **shape)
    want = serve.run_requests(eng, serve.synthetic_prompts(
        cfg, 0, shape["batch"], shape["prompt_len"]), shape["gen"])
    shutil.rmtree(path, ignore_errors=True)
    if r["streams"] != want["streams"]:
        raise AssertionError(f"serve --ckpt streams {r['streams']} != "
                             f"the tree served directly {want['streams']}")
    return {"streams_equal": True, "requests": len(r["streams"])}


# ---------------------------------------------------------------------------
# phase 14: the serve's surface on the card — SLOs, per-step attribution,
# Engine.stream, the CLI's reports — and the calibration half of the core
# ---------------------------------------------------------------------------

# a loose TTFT objective that must hold and a TPOT one no card meets
SLO_SPECS = "ttft:p95<60,tpot:p50<1e-4"
UTIL_MAX = 1.05
# The decode step's attributed bytes over what it must read at the least
# (resident_decode_bytes): the rest is the activations, planes, outputs,
# q and the attention output, the new K/V, the embedding rows and the
# logits — about 3% of granite-8b's weights + KV at 8 slots.
DECODE_BYTES_MARGIN = 0.05


def tree_bytes(tree, floats: bool = True) -> int:
    """The bytes of a param or cache tree's tensors: each projection's
    packed weight, scales and clip mask, and every other tensor whole
    (``floats``) or not at all."""
    from repro_torch.core.qlinear import SparqleLinear
    if isinstance(tree, dict):
        return sum(tree_bytes(v, floats) for v in tree.values())
    if isinstance(tree, SparqleLinear):
        return sum(x.numel() * x.element_size()
                   for x in (tree.w.q, tree.w.scale, tree.col_mask)
                   if x is not None)
    return tree.numel() * tree.element_size() if floats else 0


def resident_decode_bytes(eng) -> int:
    """What one decode step of ``eng`` must read at the least, summed from
    the tensors themselves (not by step_cost's per-kernel rules): every
    projection's packed weight, scales and clip mask, the tied head's
    table (an untied head is a projection), and the KV of every slot's
    block table at its full width, at the pool's own bytes a KV4 page."""
    from repro_torch.core.qlinear import SparqleLinear
    total = tree_bytes(eng.params, floats=False)
    if not isinstance(eng.params.get("lm_head"), SparqleLinear):
        total += tree_bytes(eng.params["embed"])
    return total + (eng._n_slots * eng._n_page_steps
                    * eng.pool._page_bytes[0])


def attributed_serve(dev, cfg, params, prompts, spec_gamma: int = 0):
    """Phase 4's serve (or 5's) through an engine armed with SLO_SPECS and
    attributed (``Engine.attribute_steps``): its summary with the
    validated snapshot's problems, each phase's attribution report and
    the SLO report. Raises when a phase's utilisation is <= 0 or above
    UTIL_MAX (the step's host time must cover its device work), or when
    the decode's attributed bytes fall below what it must read
    (``resident_decode_bytes``) or above that by more than
    DECODE_BYTES_MARGIN. The speculative engine's ``decode`` row times
    the whole draft + verify cycle against one decode step's cost (as
    the JAX package's does), so no utilisation is read from it."""
    from repro_torch.obs import parse_slo_list
    from repro_torch.obs.validate import validate_attribution
    r = serve_granite(dev, cfg, params, prompts, spec_gamma=spec_gamma,
                      slos=parse_slo_list(SLO_SPECS), attribute=True)
    r["attribution_problems"] = validate_attribution(r.pop("snapshot"),
                                                     require=True)
    got, least = r["attribution"]["decode"]["hbm_bytes"], r["resident_bytes"]
    r["decode_bytes_over_resident"] = got / least
    if not least <= got <= least * (1 + DECODE_BYTES_MARGIN):
        raise AssertionError(f"decode attributed {got} B against {least} B "
                             f"of weights, scales, head and KV")
    for phase, row in r["attribution"].items():
        if row.get("cycle"):
            continue
        for key in ("memory_util", "compute_util"):
            if not 0.0 < row.get(key, 0.0) <= UTIL_MAX:
                raise AssertionError(f"{phase} {key} = {row.get(key)}: "
                                     f"outside (0, {UTIL_MAX}]")
    return r


def phase_rows(r) -> str:
    """Per phase: FLOPs and bytes a step, measured mean step, the byte
    floor (bytes over the card's HBM rate), memory and compute
    utilisation (the speculative engine's decode labelled as the whole
    cycle it times)."""
    return "; ".join(
        f"{ph}{' (whole draft+verify cycle)' if c.get('cycle') else ''} "
        f"{c['flops'] / 1e9:.3f} GFLOP, {c['hbm_bytes'] / 1e9:.4f} GB, "
        f"{c['steps']} steps of {c['mean_step_s'] * 1e3:.3f} ms (floor "
        f"{c['floor_s'] * 1e3:.4f} ms), memory util {c['memory_util']:.4f}, "
        f"compute util {c['compute_util']:.6f}"
        for ph, c in sorted(r["attribution"].items()))


def stream_one(dev, cfg, params, prompts, index: int):
    """``Engine.stream`` of prompt ``index`` with the others in flight."""
    from repro_torch.launch.serve import make_engine
    from repro_torch.serving import SamplingParams
    eng = make_engine(cfg, params, **SERVE, page_size=16, token_budget=128,
                      prefill_chunk=32, decode_slots=8, device=dev)
    hs = [eng.submit(p, SamplingParams(max_new_tokens=SERVE["gen"]))
          for p in prompts]
    got = list(eng.stream(hs[index]))
    if got != hs[index].out_tokens:
        raise AssertionError("Engine.stream yielded other tokens than the "
                             "request's out_tokens")
    eng.run()
    return got


def serve_cli(dev):
    """``serve.main`` on the granite-8b smoke config on the card with
    --slo, --attribute and --metrics-out: the snapshot validated, the
    closing report's two lines' values."""
    from repro_torch.launch import serve
    from repro_torch.obs.validate import (validate_attribution,
                                          validate_snapshot)
    path = OUT / "phase14_metrics.json"
    r = serve.main(["--arch", "granite-8b", "--smoke", "--device", str(dev),
                    "--batch", "4", "--prompt-len", "21", "--gen", "9",
                    "--page-size", "8", "--slo", SLO_SPECS, "--attribute",
                    "--metrics-out", str(path)])
    snap = json.loads(path.read_text())
    problems = validate_snapshot(snap) + validate_attribution(snap,
                                                              require=True)
    if problems or r["slo"] is None or "hidden_sparsity" not in r or \
            "costmodel" not in r:
        raise AssertionError(f"serve --slo --attribute: {problems}")
    return {"hidden_sparsity": r["hidden_sparsity"],
            "tpot_pct": r["costmodel"]["tpot_latency_pct"],
            "slo": {x["slo"]: x["violations"] for x in r["slo"]}}


def layer0_sites(cfg, params, prompts, dev):
    """The int8 inputs (per-token quantized) of layer 0's four linear
    sites — q/k/v, o, gate/up, down — on the prompts, each with its
    projection's clip mask and scale: (q, mask, scale) a site."""
    from repro_torch.core.quantize import quantize_activations
    from repro_torch.models import model as M

    class Enough(Exception):
        pass

    seen, linear = [], M.linear

    def capture(x, w, *a, **k):
        seen.append((x, w))
        if len(seen) == 7:              # wq wk wv wo w_gate w_up w_down
            raise Enough
        return linear(x, w, *a, **k)

    M.linear = capture
    try:
        with torch.no_grad():
            M.forward_hidden(cfg, params, {"tokens": torch.tensor(
                prompts, dtype=torch.int32, device=dev)})
    except Enough:
        pass
    finally:
        M.linear = linear
    out = []
    for i in (0, 3, 4, 6):
        x, w = seen[i]
        qt = quantize_activations(x.reshape(-1, x.shape[-1]))
        out.append((qt.q, w.col_mask, qt.scale))
    return out


def calibrate(sites):
    """``global_calibrate`` over the sites: a candidate's error is the
    mean squared clip error in real units over the four sites, its
    sparsity their mean MSB4 sparsity. Returns (result, every
    candidate's (l, h, mse, sparsity))."""
    from repro_torch.core.clipping import apply_clipping, global_calibrate
    from repro_torch.core.sparqle import subprecision_sparsity
    seen = []

    def eval_fn(l, h):
        mse = sp = 0.0
        for q, mask, scale in sites:
            c = apply_clipping(q, mask, l, h)
            err = (c.float() - q.float()) * scale
            mse += float(torch.mean(err * err)) / len(sites)
            sp += float(subprecision_sparsity(c)) / len(sites)
        seen.append((l, h, mse, sp))
        return mse, sp

    return global_calibrate(eval_fn), seen


def algorithm1(device):
    """``learn_clipping_constants`` on ``tests/test_clipping.py``'s
    Algorithm 1 setup (int8 batches in [-40, 56), all columns masked,
    tau 4, (l, h) from (-1, 16), 23 epochs, lr 1, alpha 0.5), its data
    drawn from a fixed seed, run on ``device``."""
    from repro_torch.core.clipping import (init_clip_params,
                                           learn_clipping_constants,
                                           soft_clipping)
    g = torch.Generator().manual_seed(0)
    data = torch.randint(-40, 56, (4, 32, 16), generator=g,
                         dtype=torch.int8)
    mask = torch.ones((16,), device=device)

    def apply_clip(cp, batch):
        y, m = soft_clipping(batch, mask, cp["l"][0], cp["h"][0], tau=4.0)
        return y * 0.01, torch.mean(m)

    def apply_base(batch):
        return batch.float() * 0.01

    cp, hist = learn_clipping_constants(
        apply_clip, apply_base, data,
        init_clip_params(1, l0=-1.0, h0=16.0, device=device), epochs=23,
        lr=1.0, alpha=0.5)
    return float(cp["l"][0]), float(cp["h"][0]), hist


def calibration_on_card(dev, cfg, params, prompts):
    """Phase 14(e): the sweep on the card and on the CPU over the same
    sites (every candidate's sparsity equal, MSE within 1e-6 relative,
    the same (l, h) chosen), and Algorithm 1 on the card against the CPU
    (learned l and h within 1e-4)."""
    sites = layer0_sites(cfg, params, prompts, dev)
    card, card_all = calibrate(sites)
    cpu, cpu_all = calibrate([tuple(t.cpu() for t in s) for s in sites])
    for a, b in zip(card_all, cpu_all):
        if a[:2] != b[:2] or a[3] != b[3] or \
                abs(a[2] - b[2]) > 1e-6 * max(abs(b[2]), 1e-30):
            raise AssertionError(f"calibration candidate differs: card {a} "
                                 f"vs cpu {b}")
    if (card.l, card.h) != (cpu.l, cpu.h):
        raise AssertionError(f"calibration chose {(card.l, card.h)} on the "
                             f"card, {(cpu.l, cpu.h)} on the CPU")
    lc, hc, _ = algorithm1(dev)
    lp, hp, _ = algorithm1(torch.device("cpu"))
    if abs(lc - lp) > 1e-4 or abs(hc - hp) > 1e-4:
        raise AssertionError(f"Algorithm 1: card (l, h) = {(lc, hc)}, CPU "
                             f"{(lp, hp)}")
    return {"chosen": (card.l, card.h), "candidates": len(card_all),
            "sparsity": card.sparsity, "mse": card.error,
            "algorithm1_card": (lc, hc), "algorithm1_cpu": (lp, hp)}


def serve_surface(dev, cfg, params, prompts, base, spec):
    """Phase 14 (a)-(e) on phase 4's tree and prompts; ``base``/``spec``
    are phases 4 and 5's serves, whose streams these must give."""
    t0 = time.perf_counter()
    out = {"base": attributed_serve(dev, cfg, params, prompts),
           "spec": attributed_serve(dev, cfg, params, prompts, SPEC_GAMMA)}
    for name, want in (("base", base), ("spec", spec)):
        r = out[name]
        viol = {x["slo"]: x["violations"] for x in r["slo"]}
        if r["streams"] != want["streams"]:
            raise AssertionError(f"attributed {name} serve: streams differ")
        if r["attribution_problems"]:
            raise AssertionError(f"attributed {name} serve: "
                                 f"{r['attribution_problems']}")
        if viol["ttft:p95<60"] != 0 or viol["tpot:p50<1e-4"] < 1:
            raise AssertionError(f"{name} SLO violations {viol}")
    out["stream"] = stream_one(dev, cfg, params, prompts, 3)
    if out["stream"] != base["streams"][3]:
        raise AssertionError("Engine.stream differs from phase 4's stream")
    out["cli"] = serve_cli(dev)
    out["calibration"] = calibration_on_card(dev, cfg, params, prompts)
    out["wall_s"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# phase 13: tensor-parallel serving, the ranks of a mesh sharing the card
# ---------------------------------------------------------------------------

# The meshes of granite-8b's sharded serves (deepseek-moe-16b's is the
# second), and deepseek-moe-16b's depth there: full width, cut to its
# dense first layer and 1 MoE layer (3 until the smoke with phase 22
# passed 1,000 s).
TP_MESHES = ((1, 2), (2, 2))
MOE_TP_LAYERS = 2
# granite-8b's depth in the sharded serves: its first 2 of 36 layers,
# each serve held against the single-device serve of the same cut tree
# (at 36 the eager gloo serves took 176-316 s and the smoke passed 800 s;
# 12 until phase 22 came in and the smoke passed 1,000 s, then 8 and 4,
# each until it passed 1,000 s again); the sharded decode step stays at
# full depth
TP_GRANITE_LAYERS = 2
# a rank waiting this long in a collective fails the phase
TP_TIMEOUT_S = 600


def tree_tensors(tree):
    """Every tensor of a param tree (projection fields included), in key
    order."""
    from repro_torch.core.qlinear import SparqleLinear
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_tensors(tree[k])
    elif isinstance(tree, SparqleLinear):
        for t in (tree.w.q, tree.w.scale, tree.w.zero, tree.col_mask,
                  tree.l, tree.h):
            if t is not None:
                yield t
    elif tree is not None:
        yield tree


CHECKSUM_ROWS = 1 << 14          # rows summed at a time (64 MB of bytes)


def tree_checksum(tree) -> int:
    """A checksum of a param tree's bytes that also moves when rows move:
    the sum over tensors of each 4,096-byte row's byte sum times (its
    index mod 65,521) + 1; CHECKSUM_ROWS rows at a time, so its int64
    temporaries stay small beside a table of gigabytes."""
    total = 0
    for t in tree_tensors(tree):
        b = t.detach().contiguous().view(-1).view(torch.uint8)
        pad = (-b.numel()) % 4096
        if pad:
            b = torch.cat([b, b.new_zeros(pad)])
        rows = b.view(-1, 4096)
        for r0 in range(0, rows.shape[0], CHECKSUM_ROWS):
            part = rows[r0:r0 + CHECKSUM_ROWS]
            w = torch.arange(r0, r0 + part.shape[0],
                             device=b.device) % 65521 + 1
            total += int((part.sum(1, dtype=torch.int64) * w).sum().item())
            total %= 2 ** 61 - 1
    return total


def gloo_ops(dev, lay):
    """The collectives the sharded steps make, on CUDA tensors over the
    mesh's gloo groups: all-reduce MAX and SUM of int32 and f32 and an
    all-gather of each over the model and the data group; True each
    when the result is the one expected."""
    import torch.distributed as dist
    from repro_torch.distributed.tp import all_gather
    out = {}
    for dt in (torch.int32, torch.float32):
        for name, group, rank, ways in (
                ("model", lay.model_group, lay.coords.model_rank,
                 lay.model_ways),
                ("data", lay.data_group, lay.coords.data_rank,
                 lay.data_ways)):
            v = torch.full((3,), rank + 1, dtype=dt, device=dev)
            mx, sm = v.clone(), v.clone()
            dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=group)
            dist.all_reduce(sm, op=dist.ReduceOp.SUM, group=group)
            want = torch.arange(1, ways + 1, dtype=dt, device=dev)
            out[f"{name} {str(dt).split('.')[-1]}"] = bool(
                (mx == ways).all() and (sm == want.sum()).all()
                and torch.equal(all_gather(v, group),
                                want.repeat_interleave(3)))
    out["backends"] = sorted({dist.get_backend(lay.model_group),
                              dist.get_backend(lay.data_group)})
    return out


def tp_rank(rank, shape, device_type, jobs):
    """Phase 13 on one rank of a ``shape`` (data, model) mesh: each job in
    turn — 'ops' (``gloo_ops``), 'decode' (one sharded decode step from a
    whole pool: its logits), 'serve' (phase 4's serve of a tree through
    the sharded Engine or SpeculativeEngine, the rank's launch counts and
    the checksum of its shard). Returns the results, on the host."""
    from repro_torch.distributed.sharding import shard_pool_state
    from repro_torch.distributed.tp import shard_params
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_mesh, mesh_layout
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = (torch.device("cuda", torch.cuda.current_device())
           if device_type == "cuda" else torch.device(device_type))
    mesh = make_mesh(*shape, device_type=device_type)
    lay = mesh_layout(mesh)
    out = []
    for job in jobs:
        kind = job["kind"]
        if kind == "ops":
            out.append(gloo_ops(dev, lay))
        elif kind == "decode":
            pool = shard_pool_state(job["state"], job["schema"], lay.coords)
            local = shard_params(job["params"], lay.coords.model_rank,
                                 lay.model_ways)
            n = job["token"].shape[0] // lay.data_ways
            lo = lay.coords.data_rank * n
            logits, _, _ = S.make_engine_decode(job["cfg"], mesh=mesh)(
                local, pool, *(t[lo:lo + n] for t in (
                    job["token"], job["pos"], job["tables"])))
            # numpy: a tensor handed back through shared memory would
            # outlive this process
            out.append(logits.float().cpu().numpy())
            del pool, local
        else:
            tree = job["params"]
            if job.get("fields"):
                tree = with_fields(tree, **job["fields"])
            r = serve_granite(dev, job["cfg"], tree, job["prompts"],
                              spec_gamma=job.get("gamma", 0), mesh=mesh)
            r.pop("aggregate")
            out.append(r)
        torch.cuda.empty_cache()
    # release the parent's shared tensors before this process ends
    jobs.clear()
    gc.collect()
    return out


def tp_decode_case(dev, cfg, seed: int, shape):
    """A used pool (random pages) and one decode batch of 8 slots for a
    mesh of ``shape``: data shard d owns pages [d P/D, (d+1) P/D), each
    with its null page, and slot s reads pages of the shard its slot
    lies in. Returns (whole pool state, schema, token, pos, tables in the
    unsharded pool's ids, tables in shard-local ids)."""
    from repro_torch.serving.kv_pool import (PoolConfig, init_pool_state,
                                             pool_schema)
    g = torch.Generator(device=dev).manual_seed(seed + 17)
    d_ways = shape[0]
    n_s, b = 9, 8
    per = 1 + n_s * (b // d_ways)        # distinct pages for every slot
    pc = PoolConfig(n_pages=per * d_ways, page_size=16)
    state = fill_random(init_pool_state(cfg, pc, dev), g)
    tables = torch.zeros((b, n_s), dtype=torch.int32, device=dev)
    pos = torch.randint(16, n_s * 16, (b,), generator=g, device=dev,
                        dtype=torch.int32)
    pos[b - 1] = 0                       # an idle slot on the null page
    shard = torch.arange(b, device=dev) // (b // d_ways)
    for d in range(d_ways):
        free = (torch.randperm(per - 1, generator=g, device=dev) + 1).int()
        for s in range(d * (b // d_ways), (d + 1) * (b // d_ways)):
            used = int(pos[s]) // 16 + 1
            tables[s, :used], free = free[:used], free[used:]
    tables[b - 1] = 0
    whole = tables + (shard * per).int()[:, None]
    token = torch.randint(0, cfg.vocab, (b,), generator=g, device=dev,
                          dtype=torch.int32)
    return state, pool_schema(cfg, pc), token, pos, whole, tables


def row_count_4_vs_8(dev, cfg, params, state, token, pos, tables):
    """At full depth: how many logits of the first 4 slots change when a
    decode step runs those 4 rows alone instead of with all 8 (no
    sharding: the step of one data rank of two against the
    single-device step), and which reductions move — rms_norm (f32 and
    the served dtype) and the tied head on 4 rows inside an 8-row call."""
    from repro_torch.core.qlinear import linear
    from repro_torch.launch import steps as S
    from repro_torch.models.layers import rms_norm
    step = S.make_engine_decode(cfg)
    full, _, _ = step(params, clone_tree(state), token, pos, tables)
    half, _, _ = step(params, clone_tree(state), token[:4], pos[:4],
                      tables[:4])
    g = torch.Generator(device=dev).manual_seed(19)
    x = torch.randn((8, 1, cfg.d_model), generator=g, device=dev)
    gamma = params["final_norm"]["gamma"]
    norm = lambda a: rms_norm(a, gamma, cfg.rms_eps)  # noqa: E731
    head = lambda a: linear(a, params["embed"]["table"].T)  # noqa: E731

    def differing(fn, a):
        return int((fn(a[:4]) != fn(a)[:4]).sum().item())
    return {"logits": int((half != full[:4]).sum().item()),
            "of": 4 * cfg.vocab,
            "norm_f32": differing(norm, x),
            "norm_bf16": differing(norm, x.to(cfg.cdtype)),
            "head": differing(head, x.to(cfg.cdtype))}


def check_scale_in_batched(dev, gen, peaks):
    """The expert-batched encoder entries that take a scale (x (E, C, K),
    a scale (E, C, 1), an (E, K) mask), added for the row-parallel routed
    projection: each bit-equal to its plain version (the 2-D one expert
    by expert) and to its fused twin fed the fused twin's own scale, over
    E 8 and 64, C 1 and 3, K 704 (deepseek-moe-16b's routed d_ff on 2
    model ranks) and 2048, bf16, one launch a call; timed at E = 64, C =
    1, K = 704. Returns their kernel rows."""
    from repro_torch.core.packing import pad_k
    from repro_torch.kernels import ref
    from repro_torch.kernels import sparqle_encode as E
    from repro_torch.kernels.ref import TILE_K, TILE_M
    entries = {
        "sparqle_encode_batched": (
            lambda x, s, m: [t for i, t in enumerate(E.sparqle_encode(
                x, s, m, -8, 23, with_pbm=False)) if i != 2],
            lambda x, s, m: [t for i, t in enumerate(ref.batched(
                ref.sparqle_encode_ref)(x, s, m, -8, 23)) if i != 2],
            lambda x, m: [t for i, t in enumerate(E.sparqle_encode_fused(
                x, m, -8, 23, with_pbm=False)) if i != 2],
            lambda e, c, k: 2 * e * c * k, "sparqle_encode.py:69"),
        "sparqle_quantize_batched": (
            lambda x, s, m: E.sparqle_quantize(x, s, m, -8, 23),
            lambda x, s, m: ref.batched(ref.sparqle_quantize_ref)(
                x, s, m, -8, 23),
            lambda x, m: E.sparqle_quantize_fused(x, m, -8, 23),
            lambda e, c, k: e * c * k, "sparqle_encode.py:40"),
        "sparqle_encode_packed_batched": (
            lambda x, s, m: E.sparqle_encode_packed(x, s, m, -8, 23),
            lambda x, s, m: ref.batched(ref.sparqle_encode_packed_ref)(
                x, s, m, -8, 23),
            lambda x, m: E.sparqle_encode_packed_fused(x, m, -8, 23),
            lambda e, c, k: e * c * (pad_k(k) + pad_k(k) // 8),
            "sparqle_encode.py:105")}
    cases = 0
    for e in (8, 64):
        for c in (1, 3):
            for k in (704, 2048):
                x = (torch.randn((e, c, k), generator=gen, device=dev) * 2
                     ).to(torch.bfloat16)
                mask = torch.rand((e, k), generator=gen, device=dev) < 0.5
                for name, (fn, plain, fused, _, _) in entries.items():
                    twin = fused(x, mask)
                    scale = twin[-1]
                    got = fn(x, scale, mask)
                    got = list(got) if isinstance(got, (list, tuple)) \
                        else [got]
                    want = plain(x, scale, mask)
                    want = list(want) if isinstance(want, (list, tuple)) \
                        else [want]
                    if not all(torch.equal(a, b) for a, b in zip(got, want)) \
                            or not all(torch.equal(a, b) for a, b in
                                       zip(got, twin[:-1])):
                        raise AssertionError(
                            f"{name} differs from its plain version or its "
                            f"fused twin at E={e} C={c} K={k}")
                cases += 1
    rows = []
    for name, (fn, plain, fused, out_bytes, pallas) in entries.items():
        e, c, k = 64, 1, 704
        x = (torch.randn((e, c, k), generator=gen, device=dev) * 2).to(
            torch.bfloat16)
        mask = torch.rand((e, k), generator=gen, device=dev) < 0.5
        scale = fused(x, mask)[-1]
        check_one_launch(name, lambda: fn(x, scale, mask))
        args = [(x, scale, mask)]
        kms = time_ms(fn, args, 100)
        pms = time_ms(plain, args, 2)
        pops = e * -(-c // TILE_M) * -(-k // TILE_K) * 4
        nbytes = encoder_bytes(e * c, k, xb=2, mask=e * k,
                               planes=out_bytes(e, c, k)
                               + (0 if "quantize" in name else pops))
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/sparqle_encode.cu",
            "replaces": f"src/repro/kernels/{pallas}",
            "max_abs_err": 0.0, "ms": kms, "plain_ms": pms,
            "bound_ms": nbytes / peaks[0] * 1e3, "bound_by": "bytes",
            "library_ms": None,
            "shape": f"E=64 C=1 K=704 bf16, the scale given (the "
                     f"row-parallel routed down projection of "
                     f"deepseek-moe-16b on 2 model ranks); {cases} input "
                     f"sets bit-exact with the plain version and the "
                     f"fused twin"})
    return rows


def tp_summary(r):
    return (f"TTFT mean {r['ttft_mean_s'] * 1e3:.1f} ms, TPOT mean "
            f"{r['tpot_mean_s'] * 1e3:.2f} ms, {r['tokens_per_s']:.1f} tok/s, "
            f"{r['steps']} steps, steps {r['step_mode']}")


def tp_summary_single(d):
    r = d["moe_single"]
    return (f"TTFT mean {r['ttft_mean_s'] * 1e3:.1f} ms, TPOT mean "
            f"{r['tpot_mean_s'] * 1e3:.2f} ms, {r['tokens_per_s']:.1f} tok/s, "
            f"{r['steps']} steps (graphs)")


def first_periods(cfg, params, n_layers):
    """``cfg`` and its served tree cut to their first ``n_layers`` (whole
    periods of the first stage), or both as they are where ``n_layers``
    is None."""
    from repro_torch.models.stages import build_stages
    if n_layers is None:
        return cfg, params
    periods = n_layers // len(build_stages(cfg)[0].period)
    return cfg.replace(n_layers=n_layers), dict(params, stages={
        "s0": first_layers(params["stages"]["s0"], periods)})


def first_layers(tree, n: int):
    """A layer-stacked param subtree cut to its first ``n`` layers."""
    from repro_torch.core.qlinear import SparqleLinear, stack_linears
    if isinstance(tree, dict):
        return {k: first_layers(v, n) for k, v in tree.items()}
    if isinstance(tree, SparqleLinear):
        return stack_linears([tree.layer(i) for i in range(n)])
    return tree[:n]


def tensor_parallel(dev, seed: int, base):
    """Phase 13 (module docstring): returns its detail and every rank's
    launch counts of each serve (rank 0's read for the kernels line)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.tp import shard_params
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import spawn_world
    from repro_torch.launch.serve import build_served_params, make_prompts
    cfg, params, prompts, t_build = granite(dev, seed)
    if tree_checksum(params) != base["tree_checksum"]:
        raise AssertionError("granite-8b rebuilt from the seed differs from "
                             "phase 4's tree")
    detail = {"granite_build_s": t_build}

    def expected(tree, ways):
        return [tree_checksum(shard_params(tree, m, ways))
                for m in range(ways)]

    # the single-device decode step of each mesh's case, and the
    # row-count finding (4 rows alone against the same 4 inside 8)
    cases, refs = {}, {}
    for shape in TP_MESHES:
        state, schema, token, pos, whole, local = tp_decode_case(
            dev, cfg, seed, shape)
        ref, _, _ = S.make_engine_decode(cfg)(params, clone_tree(state),
                                              token, pos, whole)
        refs[shape] = ref.float().cpu()
        cases[shape] = dict(kind="decode", cfg=cfg, params=params,
                            state=state, schema=schema, token=token,
                            pos=pos, tables=local if shape[0] > 1 else whole)
        if shape[0] > 1:
            detail["row_count_4_vs_8"] = row_count_4_vs_8(
                dev, cfg, params, state, token, pos, whole)
    # granite cut to TP_GRANITE_LAYERS: its single-device serves
    scfg = cfg.replace(n_layers=TP_GRANITE_LAYERS)
    sparams = dict(params, stages={k: first_layers(v, TP_GRANITE_LAYERS)
                                   for k, v in params["stages"].items()})
    single = {"base": serve_granite(dev, scfg, sparams, prompts),
              "spec": serve_granite(dev, scfg, sparams, prompts,
                                    spec_gamma=SPEC_GAMMA),
              "dense": serve_granite(dev, scfg,
                                     with_fields(sparams, mode="dense"),
                                     prompts)}
    # deepseek-moe-16b at full width, MOE_TP_LAYERS: its single-device
    # serve
    mcfg = get_config("deepseek-moe-16b").replace(n_layers=MOE_TP_LAYERS)
    mparams = build_served_params(mcfg, seed, dev)
    mprompts = make_prompts(mcfg, seed, SERVE["batch"], SERVE["prompt_len"])
    moe_single = serve_granite(dev, mcfg, mparams, mprompts)
    moe_single.pop("aggregate")

    serve = lambda tree, c, p, **kw: dict(  # noqa: E731
        kind="serve", cfg=c, params=tree, prompts=p, **kw)
    jobs = {(1, 2): [dict(kind="ops"), cases[(1, 2)],
                     serve(sparams, scfg, prompts),
                     serve(sparams, scfg, prompts, gamma=SPEC_GAMMA),
                     serve(sparams, scfg, prompts, fields={"mode": "dense"})],
            (2, 2): [dict(kind="ops"), cases[(2, 2)],
                     serve(sparams, scfg, prompts),
                     serve(mparams, mcfg, mprompts),
                     serve(mparams, mcfg, mprompts, fields={"mode": "dense"}),
                     serve(mparams, mcfg, mprompts,
                           fields={"wire_format": "packed"})]}
    names = {(1, 2): ["ops", "decode", "base", "spec", "dense"],
             (2, 2): ["ops", "decode", "base", "moe", "moe_dense",
                      "moe_packed"]}
    want_streams = {name: r["streams"] for name, r in single.items()}
    want_streams.update(moe=moe_single["streams"],
                        moe_dense=moe_single["streams"],
                        moe_packed=moe_single["streams"])
    paths = {"base": ("sparqle_encode_fused", "sparqle_encode",
                      "sparqle_matmul", "kv_attention"),
             "spec": ("sparqle_encode", "sparqle_matmul_draft",
                      "kv_attention_verify"),
             "dense": ("sparqle_quantize_fused", "sparqle_quantize",
                       "quant_matmul"),
             "moe": ("sparqle_encode_fused_batched", "sparqle_encode_batched",
                     "sparqle_matmul_batched", "sparqle_encode"),
             "moe_dense": ("sparqle_quantize_batched",
                           "quant_matmul_batched"),
             "moe_packed": ("sparqle_encode_packed_batched",
                            "sparqle_encode_packed",
                            "sparqle_matmul_packed_batched")}
    sums = {"granite": {}, "moe": {}}
    runs = {}
    for shape, js in jobs.items():
        d, m = shape
        t0 = time.perf_counter()
        res = spawn_world(tp_rank, d * m, shape, dev.type, js,
                          backend="gloo", device_type=dev.type,
                          timeout_s=TP_TIMEOUT_S,
                          deadline_s=TP_TIMEOUT_S)
        wall = time.perf_counter() - t0
        tag = f"{d}x{m}"
        for i, name in enumerate(names[shape]):
            per_rank = [r[i] for r in res]
            runs[tag, name] = per_rank
            if name == "ops":
                if not all(all(v for k, v in o.items() if k != "backends")
                           and o["backends"] == ["gloo"] for o in per_rank):
                    raise AssertionError(f"gloo collectives on CUDA tensors "
                                         f"failed at {tag}: {per_rank}")
            elif name == "decode":
                equal = [torch.equal(torch.from_numpy(lg), refs[shape])
                         for lg in per_rank]
                if not all(equal):
                    raise AssertionError(f"{tag}: a sharded decode step's "
                                         f"logits differ from the "
                                         f"single-device step's: {equal}")
            else:
                tree = mparams if name.startswith("moe") else sparams
                key = "moe" if name.startswith("moe") else "granite"
                if m not in sums[key]:
                    sums[key][m] = expected(tree, m)
                got = [r["checksum"] for r in per_rank]
                if got != [sums[key][m][r % m] for r in range(d * m)]:
                    raise AssertionError(f"{tag} {name}: a rank's weight "
                                         f"shard differs from the parent's "
                                         f"cut of the tree")
                if any(r["streams"] != per_rank[0]["streams"]
                       for r in per_rank):
                    raise AssertionError(f"{tag} {name}: ranks' streams "
                                         f"differ")
                if per_rank[0]["streams"] != want_streams[name]:
                    raise AssertionError(
                        f"{tag} {name}: streams differ from the "
                        f"single-device serve's: {per_rank[0]['streams']} "
                        f"vs {want_streams[name]}")
                check_path(per_rank[0], paths[name])
        detail[f"wall_{tag}_s"] = wall
    # NCCL, one card a rank, with the steps captured as CUDA graphs
    if dev.type == "cuda" and torch.cuda.device_count() >= 2:
        res = spawn_world(tp_rank, 2, (1, 2), "cuda",
                          [serve(params, cfg, prompts)], backend="nccl",
                          device_type="cuda", timeout_s=TP_TIMEOUT_S,
                          deadline_s=TP_TIMEOUT_S)
        if res[0][0]["streams"] != base["streams"] or \
                res[0][0]["step_mode"] != "graphs":
            raise AssertionError("the NCCL mesh serve differs from phase 4")
        runs["1x2", "nccl"] = [r[0] for r in res]
        detail["nccl"] = tp_summary(res[0][0])
    else:
        detail["nccl"] = (f"not run: {torch.cuda.device_count()} card(s), "
                          f"NCCL takes one a rank")
    detail["moe_single"] = {k: moe_single[k] for k in (
        "ttft_mean_s", "tpot_mean_s", "tokens_per_s", "steps")}
    detail["runs"] = {f"{t} {n}": {k: v for k, v in rs[0].items()
                                   if k != "streams"}
                      for (t, n), rs in runs.items()
                      if n not in ("ops", "decode")}
    detail["ops"] = {t: rs[0] for (t, n), rs in runs.items() if n == "ops"}
    detail["granite_single"] = {name: {k: r[k] for k in (
        "ttft_mean_s", "tpot_mean_s", "tokens_per_s", "steps")}
        for name, r in single.items()}
    del params, sparams, mparams
    torch.cuda.empty_cache()
    return detail, runs


# ---------------------------------------------------------------------------
# phase 15: the gemma family through the fixed-batch path (--legacy)
# ---------------------------------------------------------------------------

# The legacy serves at full width and depth: gemma3-27b, 2 requests x
# 2,048 prompt tokens (its window of 1,024 binds in the prefill and in
# every decode step) x 16 new; paligemma-3b, 8 requests x (256 patches +
# 256 prompt tokens) x 16 new. ``tokens`` counts the prompt tokens after
# the patches; the sequences are multiples of flash attention's blocks.
GEMMA_SERVES = {"gemma3-27b": dict(batch=2, tokens=2048, gen=16),
                "paligemma-3b": dict(batch=8, tokens=256, gen=16)}
# The 2-layer f32 cross-checks of the fixed-batch path at full width,
# card against CPU (phases 15 and 17): the config's replacements and the
# prompt tokens. gemma3-27b with a global layer every 2 (one local and one
# global layer run) and a window of 64 over a 128-token prompt, so that
# the window binds: at 2,048 tokens the CPU's plain path would not fit
# the time limit. paligemma-3b with 32 prompt tokens after its 256
# patches. mamba2-2.7b's first 2 layers; jamba-v0.1-52b as one period of
# 2 ([ssd + dense, attn + moe]) with 4 experts (top-2 kept: the CPU's
# plain routed projection unpacks every expert's weight in turn, and
# jamba's experts are 4x deepseek-v3's); both over 128 tokens, the
# serve's chunk of 128 positions.
LEGACY_XC = {"gemma3-27b": (dict(global_every=2, sliding_window=64), 128),
             "paligemma-3b": ({}, 32),
             "mamba2-2.7b": ({}, 128),
             "jamba-v0.1-52b": (dict(attn_every=2, n_experts=4), 128)}
LEGACY_XC_GEN = 4
# projections a layer: wq, wk, wv, wo and the GeGLU's w_gate, w_up, w_down
GEMMA_LINEARS = 7
# the prefill replay's depth where the full one costs the smoke too much:
# gemma3-27b's first 2 of its 10 periods of 6 (10 local and 2 global
# layers; its 2 x 2,048-token prefill takes ~2.4 s a call at 62 layers)
PREFILL_REPLAY_LAYERS = {"gemma3-27b": 12}


def build_on_card(dev, cfg, seed):
    """The served tree of ``cfg`` drawn from ``seed`` on the card, its
    build time, peak and resident bytes. Returns (params, summary)."""
    from repro_torch.launch.serve import build_served_params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = build_served_params(cfg, seed, dev)
    torch.cuda.synchronize()
    return params, {"layers": cfg.n_layers, "d_model": cfg.d_model,
                    "build_s": time.perf_counter() - t0,
                    "build_peak_gb": torch.cuda.max_memory_allocated(dev)
                    / 1e9,
                    "weights_gb": torch.cuda.memory_allocated(dev) / 1e9}


def counted_legacy_serve(dev, cfg, params, prompts, gen, patches=None):
    """``legacy_serve`` of ``prompts`` (decode as CUDA graphs), the launch
    counters zeroed just before and read just after, and its peak; raises
    unless every stream has ``gen`` tokens of the vocabulary. Returns the
    run's summary with ``launches`` and ``peak_mem_gb``."""
    from repro_torch import kernels
    from repro_torch.launch.serve import legacy_serve
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    r = legacy_serve(cfg, params, prompts, gen, dev, patches)
    r.update(launches=kernels.launch_counts(),
             peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    if any(len(x) != gen or not all(0 <= t < cfg.vocab for t in x)
           for x in r["streams"]):
        raise AssertionError(f"{cfg.name} legacy streams: {r['streams']}")
    return r


@contextlib.contextmanager
def rows_off():
    """The A side of the live rows' A/B: inside, ``models/moe.py``'s
    dispatch hands rows=None to the routed projections (every expert's
    weight streamed, as before the count), by substituting the module's
    ``expert_rows`` in this process; restored on exit."""
    from repro_torch.models import moe
    keep = moe.expert_rows
    moe.expert_rows = lambda *a: None
    try:
        yield
    finally:
        moe.expert_rows = keep


def legacy_rows_ab(dev, cfg, params, prompts, gen, base):
    """The ``--legacy`` serve's decode replay with the live rows (B) and
    with rows=None (A, :func:`rows_off`), in the order A B B A, each serve
    with compiled steps of its own (captured anew): its streams and
    per-kernel launch counts equal to ``base`` (the phase's serve, with
    the rows). Returns the ms a replayed step of each serve and the ratio
    of the means, B over A."""
    out = {"none_ms": [], "rows_ms": []}
    for side in ("none", "rows", "rows", "none"):
        with rows_off() if side == "none" else contextlib.nullcontext():
            r = counted_legacy_serve(dev, cfg, params, prompts, gen)
        if r["streams"] != base["streams"] or \
                r["launches"] != base["launches"]:
            raise AssertionError(f"{cfg.name} --legacy with rows={side}: "
                                 f"streams or launches differ from the "
                                 f"phase's serve")
        out[side + "_ms"].append(r["decode_step_s"] * 1e3)
        del r
    out["ratio"] = (sum(out["rows_ms"]) / len(out["rows_ms"])) / (
        sum(out["none_ms"]) / len(out["none_ms"]))
    return out


def rows_ab_note(ab) -> str:
    return (f"decode replay with the live rows "
            f"{', '.join(f'{x:.2f}' for x in ab['rows_ms'])} ms against "
            f"rows=None {', '.join(f'{x:.2f}' for x in ab['none_ms'])} ms "
            f"(serves A B B A, streams and launches equal): "
            f"{ab['ratio']:.3f} of rows=None")


def legacy_replay(dev, cfg, params, b, span, seed) -> bool:
    """The fixed-batch decode step at full depth through a compiled step
    (warm-up, capture, replays) and eagerly (phase 4b's ``legacy_decode``
    case, the logits returned): a random cache of ``span`` positions,
    random tokens and positions, row 0 at the cache's last positions (past
    any window); True when the logits and every cache tensor (packed KV,
    SSD states) are bit-equal after each call."""
    from repro_torch.models import model as M
    g = torch.Generator(device=dev).manual_seed(seed)
    cache = fill_random(M.init_cache(cfg, b, span, dev), g)
    calls = []
    for i in range(4):
        tok = torch.randint(0, cfg.vocab, (b,), generator=g, device=dev,
                            dtype=torch.int32)
        pos = torch.randint(0, span, (b,), generator=g, device=dev,
                            dtype=torch.int32)
        pos[0] = span - 1 - i
        calls.append((tok, pos))

    @torch.no_grad()
    def decode_logits(params, cache, token, pos):
        return M.decode_step(cfg, params, cache, token, pos)

    return replay_vs_eager(dev, ("legacy_decode", decode_logits,
                                 (params, cache), calls))


def prefill_replay(dev, cfg, params, inputs, max_len, seed):
    """The fixed-batch prefill of ``cfg`` (full depth, or the cut of
    PREFILL_REPLAY_LAYERS) through a compiled step (warm-up, capture,
    replay) and eagerly on a copy of the same random cache (phase 4b's
    ``legacy_prefill`` case at a family's serve shape):
    the serve's ``inputs`` (tokens, a VLM's patches), then two other
    random prompt sets behind the same patches. Returns ``equal``, True
    when the token and every cache tensor are bit-equal after each call,
    ``launches_equal``, when each compiled call's launch counts are its
    eager call's, and the calls' times (ms, the card synced around each:
    ``compiled_ms`` warm-up, capture, replay; ``eager_ms``)."""
    from repro_torch import kernels
    from repro_torch.launch import steps as S
    from repro_torch.launch.graphs import CompiledStep
    from repro_torch.models import model as M
    g = torch.Generator(device=dev).manual_seed(seed)
    tokens, rest = inputs[0], tuple(inputs[1:])
    cache = fill_random(M.init_cache(cfg, tokens.shape[0], max_len, dev), g)
    twin = clone_tree(cache)
    fn = S.make_serve_prefill_into(cfg)
    step = CompiledStep(fn, dev)
    calls = [(tokens,) + rest] + [
        (torch.randint(0, cfg.vocab, tokens.shape, generator=g, device=dev,
                       dtype=torch.int32),) + rest for _ in range(2)]
    out = {"layers": cfg.n_layers, "equal": True, "launches_equal": True,
           "compiled_ms": [], "eager_ms": []}
    for args in calls:
        counts = []
        for run, key, state in ((step, "compiled_ms", cache),
                                (fn, "eager_ms", twin)):
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tok = run(params, state, *args)
            torch.cuda.synchronize()
            out[key].append((time.perf_counter() - t0) * 1e3)
            counts.append(kernels.launch_counts())
            if run is step:
                got = tok
        out["equal"] &= trees_equal(got, tok) and trees_equal(cache, twin)
        out["launches_equal"] &= counts[0] == counts[1]
    out["equal"] &= step.graphs == 1
    del step, cache, twin
    gc.collect()
    torch.cuda.empty_cache()
    return out


def check_prefill_replay(arch, r) -> None:
    """Raise unless :func:`prefill_replay`'s result ``r`` holds."""
    if not (r["equal"] and r["launches_equal"]):
        raise AssertionError(f"{arch}: the graph-replayed prefill differs "
                             f"from its eager calls: {r}")


def prefill_replay_note(r) -> str:
    """A phase's log of :func:`prefill_replay`'s result ``r``."""
    return (f"prefill replayed vs eager at {r['layers']}L, token and caches "
            f"bit-equal: {r['equal']}, launch counts equal: "
            f"{r['launches_equal']}, ms warm-up/capture/replay "
            + "/".join(f"{t:.1f}" for t in r["compiled_ms"])
            + " against eager " + "/".join(f"{t:.1f}" for t in r["eager_ms"]))


def serve_gemma(dev, arch, seed):
    """``arch`` at full width and depth, served weights drawn from
    ``seed`` on the card: GEMMA_SERVES' fixed-batch serve through
    ``legacy_serve`` (decode steps as CUDA graphs), launch counters zeroed
    just before and read just after: the windowed contiguous attention
    once a local layer and decode step, the plain one (gemma3) or the
    hd-256 instance (paligemma) once a global layer and step, no paged
    attention, seven matmuls a layer and forward. Then the decode step
    replayed against its eager calls at full depth (``legacy_replay``
    over a cache of the serve's length), and the prefill too
    (``prefill_replay``; gemma3-27b at PREFILL_REPLAY_LAYERS' cut).
    Returns the summary."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_prompts, vlm_patches
    from repro_torch.models.stages import build_stages
    cfg = get_config(arch)
    shape = GEMMA_SERVES[arch]
    b, n, gen = shape["batch"], shape["tokens"], shape["gen"]
    params, out = build_on_card(dev, cfg, seed)
    out["n_prefix"] = cfg.n_prefix
    prompts = make_prompts(cfg, seed, b, n)
    patches = vlm_patches(cfg, seed, b, dev) if cfg.family == "vlm" else None
    r = counted_legacy_serve(dev, cfg, params, prompts, gen, patches)
    out.update(r)
    steps = r["decode_steps"]
    local = sum(st.repeat * sum(1 for ld in st.period if ld.window)
                for st in build_stages(cfg))
    glob = "kv_attention_contiguous" + ("_hd256" if cfg.hd == 256 else "")
    want = {"kv_attention_contiguous_window": local * steps,
            glob: (cfg.n_layers - local) * steps,
            "sparqle_matmul": GEMMA_LINEARS * cfg.n_layers * (1 + steps)}
    counts = out["launches"]
    others = [k for k in ("kv_attention", "kv_attention_verify",
                          "kv_attention_tiered", "kv_attention_contiguous",
                          "kv_attention_contiguous_hd256") + UNFUSED
              if k not in want]
    if any(counts[k] != v for k, v in want.items()) or \
            any(counts[k] for k in others) or \
            not counts["sparqle_encode_fused"]:
        raise AssertionError(f"{arch} legacy launches {counts}: want {want}, "
                             f"none of {others}")
    out["replay_vs_eager"] = legacy_replay(dev, cfg, params, b,
                                           cfg.n_prefix + n + gen, seed + 23)
    if not out["replay_vs_eager"]:
        raise AssertionError(f"{arch}: the graph-replayed decode step "
                             f"differs from its eager calls")
    inputs = (torch.tensor(prompts, dtype=torch.int32, device=dev),)
    rcfg, rparams = first_periods(cfg, params,
                                  PREFILL_REPLAY_LAYERS.get(arch))
    out["prefill_replay"] = prefill_replay(
        dev, rcfg, rparams, inputs + ((patches,) if patches is not None
                                      else ()),
        cfg.n_prefix + n + gen, seed + 37)
    del rparams
    check_prefill_replay(arch, out["prefill_replay"])
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def legacy_cross_check(dev, arch, seed):
    """``arch``'s width at 2 layers, f32, with LEGACY_XC's replacements:
    the fixed-batch prefill and LEGACY_XC_GEN - 1 greedy decode steps on
    the card (kernels) and on the CPU (plain versions), the same weights
    (drawn on the card) and prompts; logits finite and within the arch's
    LOGIT_TOL of max |logit| at every step and the greedy streams
    identical."""
    from repro_torch.configs import get_config
    from repro_torch.core.qlinear import tree_to
    from repro_torch.launch.serve import (build_served_params, make_prompts,
                                          vlm_patches)
    from repro_torch.models import model as M
    over, n = LEGACY_XC[arch]
    cfg = get_config(arch).replace(n_layers=2, dtype="float32", **over)
    params = build_served_params(cfg, seed, dev)
    prompts = make_prompts(cfg, seed + 1, 2, n)
    patches = (vlm_patches(cfg, seed + 1, 2, dev) if cfg.family == "vlm"
               else None)
    plen = cfg.n_prefix + n
    runs = {}
    for name, device in (("cuda", dev), ("cpu", torch.device("cpu"))):
        tree = params if name == "cuda" else tree_to(params, device)
        batch = {"tokens": torch.tensor(prompts, dtype=torch.int32,
                                        device=device)}
        if patches is not None:
            batch["patches"] = patches.to(device)
        with torch.no_grad():
            logits, cache = M.prefill(cfg, tree, batch,
                                      max_len=plen + LEGACY_XC_GEN)
            steps, toks = [logits.float().cpu()], [logits.argmax(-1)]
            for i in range(LEGACY_XC_GEN - 1):
                pos = torch.full((2,), plen + i, dtype=torch.int32,
                                 device=device)
                logits, cache = M.decode_step(cfg, tree, cache,
                                              toks[-1].to(torch.int32), pos)
                steps.append(logits.float().cpu())
                toks.append(logits.argmax(-1))
        runs[name] = (steps, torch.stack(toks, 1).cpu().tolist())
        del tree, cache
    (lg_c, st_c), (lg_p, st_p) = runs["cuda"], runs["cpu"]
    n_cmp = len(lg_p) if st_c == st_p else 1
    err = max((a - b).abs().max().item()
              for a, b in zip(lg_c[:n_cmp], lg_p[:n_cmp]))
    scale = max(b.abs().max().item() for b in lg_p[:n_cmp])
    match = sum(a == b for x, y in zip(st_c, st_p) for a, b in zip(x, y))
    total = sum(len(x) for x in st_p)
    tol = LOGIT_TOL_ARCH.get(arch, LOGIT_TOL)
    if not err <= tol * scale:      # False for NaN too
        raise AssertionError(f"{arch} legacy cross-check logits differ: "
                             f"{err} vs {tol} * {scale}")
    if st_c != st_p:
        raise AssertionError(f"{arch} legacy cross-check greedy streams "
                             f"differ: cuda {st_c} vs cpu {st_p}")
    del params
    torch.cuda.empty_cache()
    return {"arch": arch, "config": dict(over, n_layers=2, dtype="float32",
                                         prompt_tokens=n),
            "max_abs_logit_err": err, "max_abs_logit": scale,
            "rel_err": err / scale, "steps_compared": n_cmp,
            "greedy_match": f"{match}/{total}"}


def legacy_cli(archs, names):
    """``serve.main --legacy --smoke`` of each arch on the card (streams
    of the asked length, the closing report), and without ``--legacy``
    the JAX serve's exit: what the paged path refuses named (one of
    ``names``: the window, the VLM, the mixer), then "(this arch serves
    via --legacy only)". Returns {arch: (hidden sparsity, exit
    message)}."""
    from repro_torch.launch import serve
    out = {}
    for arch in archs:
        r = serve.main(["--arch", arch, "--legacy", "--smoke", "--batch",
                        "2", "--prompt-len", "24", "--gen", "4"])
        if [len(x) for x in r["streams"]] != [4, 4] or \
                not 0 <= r["hidden_sparsity"] <= 1:
            raise AssertionError(f"serve --legacy --smoke {arch}: {r}")
        try:
            serve.main(["--arch", arch, "--smoke"])
        except SystemExit as e:
            msg = str(e)
        else:
            raise AssertionError(f"serve {arch} without --legacy did not "
                                 f"exit")
        if not (msg.endswith("\n(this arch serves via --legacy only)")
                and any(name in msg for name in names)):
            raise AssertionError(f"serve {arch} without --legacy: {msg!r}")
        out[arch] = (r["hidden_sparsity"], msg.replace("\n", " "))
    return out


# Phase 16: deepseek-v3-671b through --legacy at full width (d 7,168, 128
# MLA heads on a 512-wide compressed cache, 256 experts top-8 sigmoid, the
# 129,280-word untied head, the MTP block) and cut depth: its 3 dense
# layers and 4 MoE layers (its 671 B parameters do not fit the card).
V3_LAYERS = 7
V3_SERVE = dict(batch=8, tokens=128, gen=16)
# projections a layer and forward: MLA's wq_a, wq_b, wkv_a, wo (wkv_b is
# absorbed through its dequantized weight, no launch); the dense FFN's 3;
# a MoE layer's shared expert 3 (plain) and routed experts 3 (batched)
V3_MLA_LINEARS, V3_FFN_LINEARS = 4, 3
# The 2-layer f32 cross-check (one dense, one MoE layer) at full width,
# card against CPU, with 16 routed experts, top-8 kept: the CPU's plain
# routed projection unpacks every expert's weight to f64 in turn (117 MB
# an expert and projection), so 256 experts would take minutes a forward
# there; 16 short prompt tokens, MTP logits on the prompt's hidden states.
V3_XC = dict(n_experts=16)
V3_XC_TOKENS = 16
V3_XC_GEN = 4
# The card's greedy token may part from the CPU's only at a near-tie, a
# step where the CPU's top-1 logit leads its top-2 by at most V3_XC_TIE
# (absolute): on seeds 0-2 one step in 8 parted, at gaps 0.113, 0.212
# and 0.023 (NVIDIA H100 80GB HBM3, 700.00 W). At most V3_XC_PARTED
# steps a run may part.
V3_XC_TIE = 0.25
V3_XC_PARTED = 1


def serve_deepseek_v3(dev, seed):
    """deepseek-v3-671b at full width and V3_LAYERS layers, weights drawn
    from ``seed`` on the card (a routed-expert layer a chunk of experts
    at a time): build time and peak; V3_SERVE's fixed-batch serve through
    ``legacy_serve`` (decode as CUDA graphs), launch counters zeroed just
    before and read just after: the fused encoder and dual-pass matmul for
    every plain projection, one batched encoder and one batched matmul
    for every routed one (E = 256), no attention kernel (MLA attends in
    f32 torch, as JAX in XLA); the decode step's logits and caches
    replayed against its eager calls at full depth (bit-equal); the MTP
    logits of 2 prompts once (finite, (2, S-1, V)). Returns the summary."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models import model as M
    from repro_torch.models.stages import build_stages
    cfg = get_config("deepseek-v3-671b").replace(n_layers=V3_LAYERS)
    b, n, gen = V3_SERVE["batch"], V3_SERVE["tokens"], V3_SERVE["gen"]
    params, out = build_on_card(dev, cfg, seed)
    prompts = make_prompts(cfg, seed, b, n)
    r = counted_legacy_serve(dev, cfg, params, prompts, gen)
    out.update(r)
    stages = build_stages(cfg)
    n_moe = sum(st.repeat for st in stages if st.period[0].ffn == "moe")
    plain = (V3_MLA_LINEARS * cfg.n_layers
             + V3_FFN_LINEARS * cfg.n_layers + 1)      # + the head
    forwards = 1 + r["decode_steps"]
    want = {"sparqle_encode_fused": plain * forwards,
            "sparqle_matmul": plain * forwards,
            "sparqle_encode_fused_batched": 3 * n_moe * forwards,
            "sparqle_matmul_batched": 3 * n_moe * forwards}
    counts = out["launches"]
    extra = {k: v for k, v in counts.items() if v and k not in want}
    if any(counts[k] != v for k, v in want.items()) or extra:
        raise AssertionError(f"deepseek-v3 legacy launches {counts}: want "
                             f"{want} and no other")
    out["rows_ab"] = legacy_rows_ab(dev, cfg, params, prompts, gen, r)
    # the decode step's logits and caches: graph replays vs eager calls
    out["replay_vs_eager"] = legacy_replay(dev, cfg, params, b, n + gen,
                                           seed + 29)
    if not out["replay_vs_eager"]:
        raise AssertionError("deepseek-v3: the graph-replayed decode step "
                             "differs from its eager calls")
    out["prefill_replay"] = prefill_replay(
        dev, cfg, params, (torch.tensor(prompts, dtype=torch.int32,
                                        device=dev),), n + gen, seed + 37)
    check_prefill_replay("deepseek-v3", out["prefill_replay"])
    # the MTP head once on the card (the reference runs it in training)
    batch = {"tokens": torch.tensor(prompts[:2], dtype=torch.int32,
                                    device=dev)}
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hidden = M.forward_hidden(cfg, params, batch)
        mtp = M.mtp_logits(cfg, params, hidden, batch)
        torch.cuda.synchronize()
    out["mtp_s"] = time.perf_counter() - t0
    out["mtp_shape"] = list(mtp.shape)
    if out["mtp_shape"] != [2, n - 1, cfg.vocab] or \
            not torch.isfinite(mtp).all():
        raise AssertionError(f"deepseek-v3 mtp logits {out['mtp_shape']}, "
                             f"finite {bool(torch.isfinite(mtp).all())}")
    del params, hidden, mtp
    gc.collect()
    torch.cuda.empty_cache()
    return out


def deepseek_cross_check(dev, seed):
    """deepseek-v3-671b's widths at 2 layers (one dense, one MoE), f32,
    with V3_XC's cut, the same weights (drawn on the card) and prompts on
    the CPU (plain versions) and on the card (kernels): the fixed-batch
    prefill of 2 x V3_XC_TOKENS tokens and V3_XC_GEN - 1 decode steps,
    the CPU greedy and the card fed the CPU's tokens, so that every
    step's logits are compared on the same inputs; the MTP logits of the
    prompts' hidden states. Logits and MTP logits within the arch's
    tolerance of max |logit|; the card's greedy token equal to the CPU's
    at every step but at most V3_XC_PARTED near-ties: steps whose CPU
    top-1 leads its top-2 by no more than V3_XC_TIE (the near-ties are
    counted, and the parted steps reported with their gaps)."""
    from repro_torch.configs import get_config
    from repro_torch.core.qlinear import tree_to
    from repro_torch.launch.serve import build_served_params, make_prompts
    from repro_torch.models import model as M
    cfg = get_config("deepseek-v3-671b").replace(
        n_layers=2, first_dense=1, dtype="float32", **V3_XC)
    params = build_served_params(cfg, seed, dev)
    prompts = make_prompts(cfg, seed + 1, 2, V3_XC_TOKENS)
    plen = V3_XC_TOKENS
    runs, fed = {}, None
    for name, device in (("cpu", torch.device("cpu")), ("cuda", dev)):
        tree = params if name == "cuda" else tree_to(params, device)
        batch = {"tokens": torch.tensor(prompts, dtype=torch.int32,
                                        device=device)}
        with torch.no_grad():
            mtp = M.mtp_logits(cfg, tree, M.forward_hidden(cfg, tree, batch),
                               batch).float().cpu()
            logits, cache = M.prefill(cfg, tree, batch,
                                      max_len=plen + V3_XC_GEN)
            steps = [logits.float().cpu()]
            for i in range(V3_XC_GEN - 1):
                tok = (steps[-1].argmax(-1) if fed is None else fed[:, i])
                pos = torch.full((2,), plen + i, dtype=torch.int32,
                                 device=device)
                logits, cache = M.decode_step(
                    cfg, tree, cache, tok.to(device, torch.int32), pos)
                steps.append(logits.float().cpu())
        runs[name] = (torch.stack(steps, 1), mtp)
        fed = runs["cpu"][0].argmax(-1)
        del tree, cache
    (lg_p, mtp_p), (lg_c, mtp_c) = runs["cpu"], runs["cuda"]
    err, scale = (lg_c - lg_p).abs().max().item(), lg_p.abs().max().item()
    mtp_err = (mtp_c - mtp_p).abs().max().item()
    mtp_scale = mtp_p.abs().max().item()
    greedy_c, greedy_p = lg_c.argmax(-1), lg_p.argmax(-1)
    same = greedy_c == greedy_p
    top2 = lg_p.topk(2, -1).values
    step_err = (lg_c - lg_p).abs().amax(-1)                   # (B, steps)
    near_tie = top2[..., 0] - top2[..., 1] <= V3_XC_TIE
    out = {"config": dict(V3_XC, n_layers=2, first_dense=1, dtype="float32",
                          prompt_tokens=plen),
           "max_abs_logit_err": err, "max_abs_logit": scale,
           "rel_err": err / scale, "mtp_rel_err": mtp_err / mtp_scale,
           "max_abs_mtp_logit": mtp_scale,
           "greedy_match": f"{int(same.sum())}/{same.numel()}",
           "near_ties": int(near_tie.sum()),
           # where the card chose another token: (sequence, step, the
           # CPU's top-1 minus top-2 logit, that step's max |dlogit|)
           "parted": [(b, t, (top2[b, t, 0] - top2[b, t, 1]).item(),
                       step_err[b, t].item())
                      for b, t in (~same).nonzero().tolist()]}
    del params
    torch.cuda.empty_cache()
    tol = LOGIT_TOL_ARCH.get("deepseek-v3-671b", LOGIT_TOL)
    if not (err <= tol * scale and mtp_err <= tol * mtp_scale):
        raise AssertionError(f"deepseek-v3 cross-check logits differ: {out} "
                             f"(tol {tol})")
    if not (same | near_tie).all() or (~same).sum() > V3_XC_PARTED:
        raise AssertionError(f"deepseek-v3 cross-check greedy tokens "
                             f"differ beyond {V3_XC_PARTED} near-tie "
                             f"(top-2 gap <= {V3_XC_TIE}): {out}")
    return out


# Phase 17: the SSD family through --legacy at full width and depth:
# mamba2-2.7b (64 SSD layers, no FFN, tied head) and jamba-v0.1-52b (32
# layers: 4 periods of 7 SSD + 1 attention, MoE of 16 experts top-2 on
# every second layer), 8 requests x 128 prompt tokens x 16 new, bf16.
SSD_SERVES = ("mamba2-2.7b", "jamba-v0.1-52b")
SSD_SERVE = dict(batch=8, tokens=128, gen=16)
# plain projections a layer and forward, by mixer and by FFN: the SSD
# mixer's w_in and w_out, attention's wq, wk, wv, wo, the dense SwiGLU's
# three; a MoE layer's three routed projections run batched (its router
# is a float matmul), and a tied head is a float matmul too
SSD_LINEARS = {"ssd": 2, "attn": 4, "dense": 3, "moe": 0, "none": 0}


def legacy_decode_bytes(cfg, params, cache) -> int:
    """What one fixed-batch decode step must move at the least, summed
    from the tensors themselves: every projection's packed weight, scales
    and clip mask and every other layer leaf read once (all experts of a
    routed layer, as the batched kernels read them), the tied head's
    table, every cache tensor read once (the whole KV cache: its
    positions past the step's are a few percent at the serve's end) and
    the SSD states and conv tails written once more."""
    total = tree_bytes({k: v for k, v in params.items() if k != "embed"})
    if cfg.tie_embeddings:
        total += tree_bytes(params["embed"])
    total += tree_bytes(cache)
    for stage in cache["stages"].values():
        for layer in stage.values():
            total += sum(tree_bytes(layer[k]) for k in ("h", "conv")
                         if k in layer)
    return total


def serve_ssd(dev, arch, seed, peaks):
    """``arch`` at full width and depth, served weights drawn from
    ``seed`` on the card (jamba's routed layers a chunk of experts at a
    time): build time and peak; SSD_SERVE's fixed-batch serve through
    ``legacy_serve`` (decode as CUDA graphs), launch counters zeroed just
    before and read just after: the fused encoder and dual-pass matmul
    for every plain projection (SSD_LINEARS, an untied head), one batched
    encoder and one batched matmul for every routed one (E = 16), the
    contiguous attention once an attention layer and decode step, no
    other kernel; the serve's prompts prefilled once more, its logits and
    every SSD state and conv tail finite (the reference's chunked scan
    overflows to NaN at this chunk); the byte floor of a decode step
    (``legacy_decode_bytes`` over the card's byte rate) and the replay's
    share of it; the decode step's logits, SSD states and caches replayed
    against its eager calls at full depth (bit-equal). Returns the
    summary."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models import model as M
    from repro_torch.models.stages import build_stages
    cfg = get_config(arch)
    b, n, gen = SSD_SERVE["batch"], SSD_SERVE["tokens"], SSD_SERVE["gen"]
    params, out = build_on_card(dev, cfg, seed)
    prompts = make_prompts(cfg, seed, b, n)
    r = counted_legacy_serve(dev, cfg, params, prompts, gen)
    out.update(r)
    layers = [(ld, st.repeat) for st in build_stages(cfg)
              for ld in st.period]
    plain = sum(rep * (SSD_LINEARS[ld.mixer] + SSD_LINEARS[ld.ffn])
                for ld, rep in layers) + (0 if cfg.tie_embeddings else 1)
    routed = sum(3 * rep for ld, rep in layers if ld.ffn == "moe")
    attn = sum(rep for ld, rep in layers if ld.mixer == "attn")
    forwards, steps = 1 + r["decode_steps"], r["decode_steps"]
    want = {"sparqle_encode_fused": plain * forwards,
            "sparqle_matmul": plain * forwards}
    if routed:
        want.update(sparqle_encode_fused_batched=routed * forwards,
                    sparqle_matmul_batched=routed * forwards)
    if attn:
        want["kv_attention_contiguous"] = attn * steps
    counts = out["launches"]
    extra = {k: v for k, v in counts.items() if v and k not in want}
    out["per_forward"] = {"plain": plain, "routed": routed,
                          "attention_per_step": attn}
    if any(counts[k] != v for k, v in want.items()) or extra:
        raise AssertionError(f"{arch} legacy launches {counts}: want {want} "
                             f"and no other")
    if routed:
        out["rows_ab"] = legacy_rows_ab(dev, cfg, params, prompts, gen, r)
    batch = {"tokens": torch.tensor(prompts, dtype=torch.int32, device=dev)}
    with torch.no_grad():
        logits, cache = M.prefill(cfg, params, batch, max_len=n + gen)
    states = [layer[k] for stage in cache["stages"].values()
              for layer in stage.values() for k in ("h", "conv")
              if k in layer]
    out["prefill_finite"] = bool(torch.isfinite(logits).all()) and all(
        bool(torch.isfinite(t).all()) for t in states)
    out["prefill_max_abs_logit"] = logits.float().abs().max().item()
    if not out["prefill_finite"]:
        raise AssertionError(f"{arch}: the prefill's logits or SSD states "
                             f"are not finite")
    out["state_mb"] = sum(t.numel() * t.element_size() for t in states) / 1e6
    out["decode_floor_gb"] = legacy_decode_bytes(cfg, params, cache) / 1e9
    out["decode_floor_ms"] = out["decode_floor_gb"] * 1e9 / peaks[0] * 1e3
    out["floor_share"] = out["decode_floor_ms"] / (r["decode_step_s"] * 1e3)
    del logits, cache, states
    out["replay_vs_eager"] = legacy_replay(dev, cfg, params, b, n + gen,
                                           seed + 31)
    if not out["replay_vs_eager"]:
        raise AssertionError(f"{arch}: the graph-replayed decode step "
                             f"differs from its eager calls")
    out["prefill_replay"] = prefill_replay(
        dev, cfg, params, (batch["tokens"],), n + gen, seed + 37)
    check_prefill_replay(arch, out["prefill_replay"])
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 18: training on the card (no hand-written kernel lies on the train
# step: the float tree's products are torch.matmul, as they are XLA's
# dot_general in the reference); the trained tree then serves through the
# kernels of rows 1, 3 and 8
# ---------------------------------------------------------------------------

TRAIN_LM = "starcoder2-3b"
TRAIN = dict(batch=8, seq=128, steps=3)
TRAIN_KNOBS = dict(microbatch=4, ce_chunk=128)
TRAIN_ENCODER = "hubert-xlarge"
ENCODER_TRAIN = dict(batch=8, seq=128, steps=2)
# the trained tree's serve: one prefill chunk a prompt, then decode steps
TRAIN_SERVE = dict(batch=8, prompt_len=32, gen=4)
# the CLI's loop, run in a child process under deterministic algorithms
TRAIN_CLI = dict(arch="granite-8b", steps=12, ckpt_every=5, fail=8,
                 resume_steps=4)
TRAIN_CLI_ENV = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
TRAIN_CLI_TIMEOUT_S = 300


def _reset_peak(dev) -> None:
    torch.empty(1, device=dev)     # before it, the call finds no allocator
    torch.cuda.reset_peak_memory_stats(dev)


def timed_train_steps(dev, state, step_fn, batch, n: int):
    """``n`` steps on one batch; a step's wall time ends with its loss
    and grad norm read to the host and the device synchronized."""
    rows = []
    for _ in range(n):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize(dev)
        rows.append({"loss": loss, "grad_norm": gnorm,
                     "ms": (time.perf_counter() - t0) * 1e3})
    return state, rows


def _finite_logits(eng):
    """Wrap the engine's prefill-chunk and decode steps so that each
    records whether its logits are all finite (a device flag, read after
    the serve)."""
    flags = []
    for name in ("_prefill_fn", "_decode_fn"):
        def checked(*args, fn=getattr(eng, name)):
            out = fn(*args)
            flags.append(torch.isfinite(out[0]).all())
            return out
        setattr(eng, name, checked)
    return flags


def train_lm(dev, seed):
    """Phase 18a: ``TRAIN_LM`` at full width and depth, bf16 compute on
    f32 masters with bf16 moments, drawn from ``seed`` on the card:
    TRAIN["steps"] steps of ``make_train_step`` (TRAIN_KNOBS: two
    microbatches of 4, CE chunks of 128) on one fixed ``SyntheticLM``
    batch of 8 x 128, each loss finite, the last below the first; then
    the optimizer state freed, the trained tree quantized and served by
    the Engine (TRAIN_SERVE: a 32-token prefill chunk a prompt, then
    decode steps of the 8 sequences), the launch counters zeroed just
    before and read just after: the fused encoder, the dual-pass matmul
    and the paged attention (rows 1, 3 and 8) launched, every step's
    logits finite."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, shard_batch
    from repro_torch.launch import steps as S
    from repro_torch.launch.train import build_state
    from repro_torch.optim.adamw import OptConfig
    cfg = get_config(TRAIN_LM)
    ocfg = OptConfig(warmup_steps=1, total_steps=TRAIN["steps"])
    _reset_peak(dev)
    t0 = time.perf_counter()
    state = build_state(cfg, ocfg, seed, dev)
    torch.cuda.synchronize(dev)
    out = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "build_s": time.perf_counter() - t0,
           "state_gb": tree_bytes({"p": state.params, "mu": state.opt.mu,
                                   "nu": state.opt.nu}) / 1e9}
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN["seq"],
                                  global_batch=TRAIN["batch"], seed=seed))
    batch = shard_batch(data.batch_at(0), dev)
    step_fn = S.make_train_step(cfg, ocfg, S.TrainKnobs(**TRAIN_KNOBS))
    state, out["steps"] = timed_train_steps(dev, state, step_fn, batch,
                                            TRAIN["steps"])
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    losses = [r["loss"] for r in out["steps"]]
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"{cfg.name} training: losses {losses}: want "
                             f"finite and the last below the first")
    params = state.params
    del state, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    prompts = data.batch_at(1)["tokens"][:, :TRAIN_SERVE["prompt_len"]]
    out.update(serve_trained(dev, cfg, params, prompts, (
        "sparqle_encode_fused", "sparqle_matmul", "kv_attention")))
    return out


def serve_trained(dev, cfg, params, prompts, need):
    """A trained float tree (consumed) quantized and served by the Engine
    with graphs (TRAIN_SERVE: a 32-token prefill chunk a prompt, then
    decode steps), the launch counters zeroed just before the serve and
    read just after: raises unless every kernel counter of ``need``
    launched, every step's logits are finite and every stream is whole.
    Returns the quantize time, launches, steps and streams."""
    from repro_torch import kernels
    from repro_torch.core.qlinear import quantize_model_params
    from repro_torch.launch.serve import make_engine, run_requests
    t0 = time.perf_counter()
    qparams = quantize_model_params(params, w_bits=cfg.w_bits)
    torch.cuda.synchronize(dev)
    out = {"quantize_s": time.perf_counter() - t0}
    params.clear()
    gc.collect()
    eng = make_engine(cfg, qparams, **TRAIN_SERVE, page_size=16,
                      token_budget=128, prefill_chunk=32, decode_slots=8,
                      device=dev)
    flags = _finite_logits(eng)
    kernels.reset_launch_counts()
    r = run_requests(eng, prompts.tolist(), TRAIN_SERVE["gen"])
    out["launches"] = counts = kernels.launch_counts()
    out["serve_steps"] = len(flags)
    out["logits_finite"] = bool(torch.stack(flags).all())
    out["streams"] = r["streams"]
    if not all(counts[k] for k in need) or not out["logits_finite"] or any(
            len(s) != TRAIN_SERVE["gen"] for s in r["streams"]):
        raise AssertionError(f"{cfg.name} trained-tree serve: launches "
                             f"{counts} (need {need}), logits finite "
                             f"{out['logits_finite']}, streams "
                             f"{r['streams']}")
    del eng, qparams
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_encoder(dev, seed):
    """Phase 18b: ``TRAIN_ENCODER`` (bidirectional attention, the stub
    frontend's frames in) at full width and depth, bf16: ENCODER_TRAIN
    steps on frames and targets drawn from ``seed`` on the card, the
    losses finite and the second below the first + 1.0 (the reference's
    check of a smoke train step)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps as S
    from repro_torch.launch.train import build_state
    from repro_torch.optim.adamw import OptConfig
    cfg = get_config(TRAIN_ENCODER)
    ocfg = OptConfig(warmup_steps=1, total_steps=4)
    _reset_peak(dev)
    t0 = time.perf_counter()
    state = build_state(cfg, ocfg, seed, dev)
    g = torch.Generator(device=dev).manual_seed(seed + 18)
    b, s = ENCODER_TRAIN["batch"], ENCODER_TRAIN["seq"]
    batch = {"frames": torch.randn((b, s, cfg.d_model), generator=g,
                                   device=dev).to(cfg.cdtype),
             "targets": torch.randint(0, cfg.vocab, (b, s), generator=g,
                                      device=dev, dtype=torch.int32)}
    torch.cuda.synchronize(dev)
    out = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "build_s": time.perf_counter() - t0,
           "state_gb": tree_bytes({"p": state.params, "mu": state.opt.mu,
                                   "nu": state.opt.nu}) / 1e9}
    step_fn = S.make_train_step(cfg, ocfg, S.TrainKnobs(ce_chunk=s))
    state, out["steps"] = timed_train_steps(dev, state, step_fn, batch,
                                            ENCODER_TRAIN["steps"])
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    losses = [r["loss"] for r in out["steps"]]
    if not all(math.isfinite(x) for x in losses) or \
            not losses[1] < losses[0] + 1.0:
        raise AssertionError(f"{cfg.name} training: losses {losses}")
    del state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_cli_child(path: str, mesh: bool = False) -> None:
    """Phase 18c's child process (``--train-cli PATH``), started with
    ``CUBLAS_WORKSPACE_CONFIG`` set: under
    ``torch.use_deterministic_algorithms(True)`` (the card's atomics,
    the embedding's backward among them, otherwise sum in a run-dependent
    order), ``launch/train.main`` on TRAIN_CLI's arch ``--smoke`` twice —
    clean, and with an injected failure and async checkpoints — then a
    ``--resume auto`` run from the clean run's final checkpoint; the two
    final checkpoints' params compared bit for bit. Writes the summary
    to ``path`` as JSON. ``mesh`` (phase 19c, ``--train-cli-mesh PATH``):
    the clean and faulted runs at ``--data-axis MESH_CLI_AXIS
    --dist-backend gloo`` (its ranks, spawned by ``main``, run
    deterministic too), no resumed run."""
    import contextlib
    import io
    from repro_torch.checkpoint import store
    from repro_torch.launch import train
    torch.use_deterministic_algorithms(True)
    c = TRAIN_CLI
    on_mesh = (["--data-axis", str(MESH_CLI_AXIS), "--dist-backend", "gloo"]
               if mesh else [])
    with tempfile.TemporaryDirectory() as d:
        def run(name, *extra, steps=c["steps"]):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                r = train.main(["--arch", c["arch"], "--smoke",
                                "--steps", str(steps),
                                "--ckpt-every", str(c["ckpt_every"]),
                                "--log-every", "4", "--ckpt-dir",
                                f"{d}/{name}", *on_mesh, *extra])
            r["stdout"] = buf.getvalue()
            return r
        clean = run("clean")
        fault = run("fault", "--inject-fail", str(c["fail"]), "--async-ckpt")
        final = {name: store.restore(f"{d}/{name}", c["steps"],
                                     clean["state"])
                 for name in ("clean", "fault")}
        same = all(torch.equal(a, b) for a, b in zip(
            store.flatten(final["clean"].params),
            store.flatten(final["fault"].params)))
        resume = (None if mesh else
                  run("clean", "--resume", "auto", steps=c["resume_steps"]))
    summary = {"device": torch.cuda.get_device_name(0), "argv": on_mesh,
               "deterministic": torch.are_deterministic_algorithms_enabled(),
               "params_bit_equal": same,
               "restarts": fault["report"].restarts,
               "faults_seen": fault["report"].faults_seen,
               "resume_start": resume["start"] if resume else None}
    runs = (("clean", clean), ("fault", fault)) + (
        (("resume", resume),) if resume else ())
    for name, r in runs:
        summary[name] = {"losses": r["losses"], "ms_per_step": r["ms_per_step"],
                         "steps_run": r["report"].steps_run,
                         "stdout": r["stdout"]}
    Path(path).write_text(json.dumps(summary, indent=1))


def train_cli(mesh: bool = False):
    """Phase 18c (19c with ``mesh``): :func:`train_cli_child` in a child
    process (its environment carries TRAIN_CLI_ENV before CUDA starts);
    raises unless the faulted run's final params equal the clean run's
    bit for bit with one restart, every loss is finite and (one device)
    the resumed run started at the clean run's last step."""
    path = OUT / ("train_cli_mesh.json" if mesh else "train_cli.json")
    path.unlink(missing_ok=True)
    env = dict(os.environ, **TRAIN_CLI_ENV)
    flag = "--train-cli-mesh" if mesh else "--train-cli"
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           flag, str(path)], env=env,
                          capture_output=True, text=True,
                          timeout=TRAIN_CLI_TIMEOUT_S)
    if proc.returncode or not path.exists():
        raise AssertionError(f"train CLI child failed ({proc.returncode}):\n"
                             f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    r = json.loads(path.read_text())
    losses = [x for k in ("clean", "fault", "resume") if k in r
              for x in r[k]["losses"]]
    if not (r["params_bit_equal"] and r["restarts"] == 1
            and (mesh or r["resume_start"] == TRAIN_CLI["steps"])
            and all(math.isfinite(x) for x in losses)):
        raise AssertionError(f"train CLI on the card: {r}")
    return r


# ---------------------------------------------------------------------------
# phase 19: training on a (data, model) mesh of ranks sharing the card
# over gloo (state sharded over data, Megatron over model, routed experts
# on the expert axis), the trained tree served, the CLI on a mesh
# ---------------------------------------------------------------------------

MESH_TRAIN_ARCH = "deepseek-moe-16b"
# full width, its first MESH_TRAIN_LAYERS of 28 layers (1 dense, 1 MoE;
# 4 until phase 22 came in: the smoke passed 1,000 s); one step (two ran
# 19.2-43.2 s each at 2x2 over gloo and phase 19 184.3 s, past its 180)
MESH_TRAIN_LAYERS = 2
MESH_TRAIN = dict(batch=8, seq=128, steps=1, mesh=(2, 2))
MESH_TRAIN_KNOBS = dict(microbatch=4, ce_chunk=128)
# 2x2 against 1x1 on the same tree and batch: step 1's loss and grad norm
MESH_LOSS_RTOL = 0.005
MESH_GNORM_RTOL = 0.02
# the four ranks' peaks together must fit the one card
MESH_PEAK_SUM_GB = 80.0
# the CLI on a mesh (19c): phase 18c's run at --data-axis 2
MESH_CLI_AXIS = 2


def mesh_train_config():
    """MESH_TRAIN_ARCH cut to MESH_TRAIN_LAYERS layers, at capacity factor
    ceil(E / top_k), so no assignment drops and the local routing of the
    data shards keeps what the whole batch's routing keeps."""
    from repro_torch.configs import get_config
    cfg = get_config(MESH_TRAIN_ARCH).replace(n_layers=MESH_TRAIN_LAYERS)
    return cfg.replace(capacity_factor=float(math.ceil(cfg.n_experts
                                                       / cfg.top_k)))


def mesh_train_rank(rank, cfg, seed, device_type="cuda",
                    mesh=MESH_TRAIN["mesh"], legacy=False):
    """Phase 19a on one rank of a ``mesh`` (MESH_TRAIN's; a
    ``spawn_world`` rank function) for ``cfg``: this rank's slice of the
    state drawn leaf by leaf, MESH_TRAIN["steps"] sharded steps on its
    rows of one SyntheticLM batch, its peak memory, the checksums of its
    leaves whole over model (and of a segmented leaf's runs held whole);
    then the trained params gathered onto rank 0, which serves them as
    phase 18a serves its tree (19b), or through ``--legacy`` with
    ``legacy`` (20c); the other ranks have freed their memory and
    returned. Returns the rank's numbers."""
    from repro_torch.checkpoint import store
    from repro_torch.core.qlinear import tree_to
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, shard_batch
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.adamw import OptConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = (torch.device("cuda", torch.cuda.current_device())
           if device_type == "cuda" else torch.device(device_type))
    tm = S.TrainMesh(cfg, make_mesh(*mesh, device_type=device_type))
    ocfg = OptConfig(warmup_steps=1, total_steps=MESH_TRAIN["steps"])
    _reset_peak(dev)
    t0 = time.perf_counter()
    state = tm.build_state(ocfg, seed, dev)
    torch.cuda.synchronize(dev)
    c = tm.layout.coords
    out = {"rank": rank, "data_rank": c.data_rank,
           "build_s": time.perf_counter() - t0,
           "state_gb": tree_bytes({"p": state.params, "mu": state.opt.mu,
                                   "nu": state.opt.nu}) / 1e9}
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=MESH_TRAIN["seq"],
                                  global_batch=MESH_TRAIN["batch"],
                                  seed=seed))
    batch = shard_batch(data.batch_at(0), dev, data_rank=c.data_rank,
                        data_ways=c.data_ways,
                        microbatch=MESH_TRAIN_KNOBS["microbatch"])
    step_fn = S.make_train_step(cfg, ocfg, S.TrainKnobs(**MESH_TRAIN_KNOBS),
                                mesh=tm)
    state, out["steps"] = timed_train_steps(dev, state, step_fn, batch,
                                            MESH_TRAIN["steps"])
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    pls = store.flatten(tm.shards.placements)
    out["replicated"] = [
        (pl.data_dim is None, tree_checksum(r))
        for t, pl in zip(store.flatten(state.params), pls)
        for r in ([t] if pl.model_dim is None else
                  [t.narrow(pl.model_dim, lo, n)
                   for lo, n in tm.shards.runs(pl, cut=False)])]
    params = state.params
    del state, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    whole = tm.gather(params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    tm.barrier()                 # every rank's cards' memory released
    out["gather_s"] = time.perf_counter() - t0
    if whole is not None and legacy:
        out["serve"] = serve_trained_legacy(dev, cfg, tree_to(whole, dev),
                                            seed)
    elif whole is not None:
        prompts = data.batch_at(1)["tokens"][:, :TRAIN_SERVE["prompt_len"]]
        out["serve"] = serve_trained(dev, cfg, tree_to(whole, dev), prompts, (
            "sparqle_encode_fused", "sparqle_matmul",
            "sparqle_encode_fused_batched", "sparqle_matmul_batched",
            "kv_attention"))
    return out


def single_train(dev, cfg, seed):
    """The one-device step of phases 19 and 20 on the mesh run's tree
    (the same draws) and batch: MESH_TRAIN["steps"] steps, their losses,
    grad norms and times, and the peak."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM, shard_batch
    from repro_torch.launch import steps as S
    from repro_torch.launch.train import build_state
    from repro_torch.optim.adamw import OptConfig
    ocfg = OptConfig(warmup_steps=1, total_steps=MESH_TRAIN["steps"])
    _reset_peak(dev)
    state = build_state(cfg, ocfg, seed, dev)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=MESH_TRAIN["seq"],
                                  global_batch=MESH_TRAIN["batch"],
                                  seed=seed))
    step_fn = S.make_train_step(cfg, ocfg, S.TrainKnobs(**MESH_TRAIN_KNOBS))
    state, steps = timed_train_steps(
        dev, state, step_fn, shard_batch(data.batch_at(0), dev),
        MESH_TRAIN["steps"])
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    del state, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    return steps, peak


def mesh_against_single(out, ranks, single, model_ways: int) -> None:
    """Fill ``out`` with a mesh run's comparison against its 1x1 run:
    step 1's loss and grad norm, the ranks' peaks summed, and whether
    the checksums of what is whole over model agree across the ranks;
    raise unless every loss is finite and all are within the limits
    (MESH_LOSS_RTOL, MESH_GNORM_RTOL, MESH_PEAK_SUM_GB)."""
    mesh_s, one = ranks[0]["steps"], single
    out["loss_rel"] = abs(mesh_s[0]["loss"] - one[0]["loss"]) / abs(
        one[0]["loss"])
    out["gnorm_rel"] = abs(mesh_s[0]["grad_norm"] - one[0]["grad_norm"]) / \
        abs(one[0]["grad_norm"])
    out["peak_sum_gb"] = sum(r["peak_gb"] for r in ranks)
    rows = {r["data_rank"]: r["replicated"] for r in ranks
            if r["rank"] % model_ways == 0}
    out["replicated_equal"] = all(
        r["replicated"] == rows[r["data_rank"]]
        and [x for whole, x in r["replicated"] if whole]
        == [x for whole, x in ranks[0]["replicated"] if whole]
        for r in ranks)
    out["replicated_leaves"] = len(ranks[0]["replicated"])
    losses = [x["loss"] for r in ranks for x in r["steps"]] + [
        x["loss"] for x in one]
    if not (all(math.isfinite(x) for x in losses)
            and out["loss_rel"] <= MESH_LOSS_RTOL
            and out["gnorm_rel"] <= MESH_GNORM_RTOL
            and out["replicated_equal"]
            and out["peak_sum_gb"] <= MESH_PEAK_SUM_GB):
        raise AssertionError(f"{out.get('arch')} mesh training: {out}")


def mesh_train(dev, cfg, seed):
    """Phases 19a and 19b (module docstring): the MESH_TRAIN world of
    ranks sharing the card over gloo (rank 0 serves the trained tree),
    then the same tree on the same batch at 1x1 after the world has
    ended. Raises unless every loss is finite, step 1's loss is within
    MESH_LOSS_RTOL and its grad norm within MESH_GNORM_RTOL of 1x1's, the
    leaves whole over model are bit-equal across the ranks (checksums),
    and the ranks' peaks sum to at most MESH_PEAK_SUM_GB."""
    from repro_torch.launch.mesh import spawn_world
    d, m = MESH_TRAIN["mesh"]
    t0 = time.perf_counter()
    ranks = spawn_world(mesh_train_rank, d * m, cfg, seed, dev.type,
                        backend="gloo", device_type=dev.type,
                        timeout_s=TP_TIMEOUT_S, deadline_s=TP_TIMEOUT_S)
    out = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "capacity_factor": cfg.capacity_factor,
           "world_s": time.perf_counter() - t0, "ranks": ranks,
           "serve": ranks[0].pop("serve")}
    # 1x1: the one-device step on the same tree (the same draws) and batch
    out["single"], out["single_peak_gb"] = single_train(dev, cfg, seed)
    mesh_against_single(out, ranks, out["single"], m)
    return out


# ---------------------------------------------------------------------------
# phase 20: MLA and SSD layers trained on a model axis (1x2, ranks sharing
# the card over gloo) against 1x1; each trained tree served through
# --legacy
# ---------------------------------------------------------------------------

# full width; the depth cut is forced by memory: deepseek-v3's layer 0
# (MLA, the dense FFN) with its MTP block and untied head is ~3.1 B
# params, ~4.1 B summed over the two ranks (the embedding is whole on
# both), ~14 B a param (f32 master and grad, bf16 moments and compute
# copy): ~58 GB over the two ranks, ~44 GB at 1x1; one of its MoE layers
# alone (11.3 B params) fits no card's train state, so its MoE on the
# expert axis is checked on the CPU only. mamba2-2.7b: 8 of 64 layers
# (40.2 M params a layer; ~0.6 B over the ranks with the tied embedding;
# 16 until the smoke passed 1,150 s)
MLA_SSD_TRAIN = {"deepseek-v3-671b": dict(n_layers=1, first_dense=1),
                 "mamba2-2.7b": dict(n_layers=8)}
MLA_SSD_MESH = (1, 2)
# each trained tree's --legacy serve on rank 0: prompts of MLA_SSD_SERVE
MLA_SSD_SERVE = dict(batch=4, tokens=32, gen=4)


def mla_ssd_configs():
    from repro_torch.configs import get_config
    return [get_config(arch).replace(**cut)
            for arch, cut in MLA_SSD_TRAIN.items()]


def serve_trained_legacy(dev, cfg, params, seed):
    """Phase 20c: a trained float tree (consumed) quantized and served
    through ``--legacy`` (MLA_SSD_SERVE's prompts from ``seed``): the
    prefill's and one decode step's logits finite, then the counted
    serve (``counted_legacy_serve``: the counters zeroed just before and
    read just after); raises unless rows 1 and 3 (the fused encoder and
    the dual-pass matmul) launched and no attention kernel did (MLA and
    SSD attend in torch). Returns the quantize time, launches, times."""
    from repro_torch.core.qlinear import quantize_model_params
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models import model as M
    t0 = time.perf_counter()
    qparams = quantize_model_params(params, w_bits=cfg.w_bits)
    torch.cuda.synchronize(dev)
    out = {"quantize_s": time.perf_counter() - t0}
    params.clear()
    gc.collect()
    torch.cuda.empty_cache()
    b, n, gen = (MLA_SSD_SERVE[k] for k in ("batch", "tokens", "gen"))
    prompts = make_prompts(cfg, seed, b, n)
    with torch.no_grad():
        tokens = torch.tensor(prompts, dtype=torch.int32, device=dev)
        logits, cache = M.prefill(cfg, qparams, {"tokens": tokens},
                                  max_len=n + 1)
        step, _ = M.decode_step(cfg, qparams, cache, logits.argmax(-1).to(
            torch.int32), torch.full((b,), n, dtype=torch.int32, device=dev))
        out["logits_finite"] = bool(torch.isfinite(logits).all()
                                    and torch.isfinite(step).all())
    del cache
    r = counted_legacy_serve(dev, cfg, qparams, prompts, gen)
    out.update({k: r[k] for k in ("launches", "prefill_s", "decode_step_s",
                                  "streams", "peak_mem_gb")})
    counts = out["launches"]
    need = ("sparqle_encode_fused", "sparqle_matmul")
    if not (all(counts[k] for k in need) and out["logits_finite"]) or any(
            v for k, v in counts.items() if k.startswith("kv_attention")):
        raise AssertionError(f"{cfg.name} trained-tree --legacy serve: "
                             f"launches {counts} (need {need}, no "
                             f"attention kernel), logits finite "
                             f"{out['logits_finite']}")
    del qparams
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mla_ssd_rank(rank, seed, device_type="cuda"):
    """Phase 20a/20b/20c on one rank of the MLA_SSD_MESH world: each
    config of ``mla_ssd_configs`` in turn through ``mesh_train_rank``
    (its tree served through ``--legacy`` on rank 0)."""
    return [mesh_train_rank(rank, cfg, seed, device_type, MLA_SSD_MESH,
                            legacy=True) for cfg in mla_ssd_configs()]


def mla_ssd_single(rank, seed, device_type="cuda"):
    """Phase 20's 1x1 runs, in a child process of their own: each config
    of ``mla_ssd_configs`` through ``single_train``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = (torch.device("cuda", torch.cuda.current_device())
           if device_type == "cuda" else torch.device(device_type))
    return [single_train(dev, cfg, seed) for cfg in mla_ssd_configs()]


def mla_ssd_train(dev, seed):
    """Phase 20 (module docstring): the MLA_SSD_MESH world, then the 1x1
    child; raises unless each arch's mesh run holds against its 1x1 run
    (``mesh_against_single``). Returns each arch's summary."""
    from repro_torch.launch.mesh import spawn_world
    d, m = MLA_SSD_MESH
    t0 = time.perf_counter()
    ranks = spawn_world(mla_ssd_rank, d * m, seed, dev.type,
                        backend="gloo", device_type=dev.type,
                        timeout_s=TP_TIMEOUT_S, deadline_s=TP_TIMEOUT_S)
    world_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    (single,) = spawn_world(mla_ssd_single, 1, seed, dev.type,
                            backend="gloo", device_type=dev.type,
                            timeout_s=TP_TIMEOUT_S, deadline_s=TP_TIMEOUT_S)
    single_s = time.perf_counter() - t0
    out = {}
    for i, cfg in enumerate(mla_ssd_configs()):
        per = [r[i] for r in ranks]
        o = {"arch": cfg.name, "layers": cfg.n_layers,
             "d_model": cfg.d_model, "ranks": per,
             "serve": per[0].pop("serve"), "single": single[i][0],
             "single_peak_gb": single[i][1]}
        mesh_against_single(o, per, o["single"], m)
        out[cfg.name] = o
    out["world_s"], out["single_s"] = world_s, single_s
    return out


# ---------------------------------------------------------------------------
# phase 21: the examples and the static checks
# ---------------------------------------------------------------------------

# 21a: the quickstart at the linear its cost model prices
QUICKSTART_ARGV = ["--m", "2048", "--k", "4096", "--n", "11008"]
# 21b: the calibrate-and-serve recipe at granite-8b's full width, 2 layers
CALIBRATE_ARGV = ["--full", "--layers", "2"]
# 21c: the failover run at the example's full config, its 60 steps
FAILOVER_ARGV = ["--d-model", "512"]
# Algorithm 1's learned (l, h), card against CPU: f32 SGD on the same
# stream, gradients summed in other orders
ALG1_TOL = 1e-4
ANALYSIS_TIMEOUT_S = 300


def load_example(name: str):
    """``examples/<name>.py`` as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(dev, name: str, argv):
    """One example's ``main`` on the card with the launch counters zeroed
    just before and read just after; its printout goes to
    ``chiprun_out/<name>.txt``. Returns (the module, its result, the
    nonzero launch counts, seconds)."""
    from repro_torch import kernels
    ex = load_example(name)
    buf = io.StringIO()
    torch.cuda.synchronize(dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        r = ex.main([*argv, "--device", "cuda"])
    torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    (OUT / f"{name}.txt").write_text(buf.getvalue())
    return ex, r, counts, secs


def start_analysis():
    """21d: ``python -m repro_torch.analysis --check --no-mesh`` in a
    child process, on the CPU, while the card runs 21a-c."""
    log_file = open(OUT / "analysis.txt", "w")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.analysis", "--check",
         "--no-mesh", "--report", str(OUT / "analysis_report.json")],
        cwd=ROOT, env=env, stdout=log_file, stderr=subprocess.STDOUT)
    return proc, log_file, time.perf_counter()


def finish_analysis(proc, log_file, t0) -> dict:
    """Wait for 21d's child; raises unless it exits 0 with no stale
    allowlist entry."""
    try:
        rc = proc.wait(timeout=max(1.0, ANALYSIS_TIMEOUT_S -
                                   (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise
    finally:
        log_file.close()
    secs = time.perf_counter() - t0
    text = (OUT / "analysis.txt").read_text()
    if rc or "warning: stale" in text:
        raise AssertionError(f"repro_torch.analysis --check exited {rc}:\n"
                             f"{text[-4000:]}")
    summary = [ln for ln in text.splitlines()
               if ln.startswith("repro_torch.analysis v")]
    return {"rc": rc, "seconds": secs, "summary": summary[-1]}


def examples_phase(dev, seed: int) -> dict:
    """Phase 21 (module docstring). Raises on any failed check."""
    child = start_analysis()
    try:
        out = {"quickstart": quickstart_on_card(dev, seed),
               "calibrate": calibrate_on_card(dev, seed),
               "failover": failover_on_card(dev, seed)}
    except BaseException:
        child[0].kill()
        child[0].wait()
        child[1].close()
        raise
    out["analysis"] = finish_analysis(*child)
    return out


def quickstart_on_card(dev, seed: int) -> dict:
    """21a: rows 3 and 6 launched once each; dual pass = dense."""
    _, r, counts, secs = run_example(
        dev, "quickstart_torch", QUICKSTART_ARGV + ["--seed", str(seed)])
    if counts != {"sparqle_matmul": 1, "quant_matmul": 1} or not r["exact"]:
        raise AssertionError(f"quickstart on the card: launches {counts}, "
                             f"exact {r['exact']}")
    return {"launches": counts, "s": secs, "exact": r["exact"],
            "s0": r["s0"], "s1": r["s1"], "skipped": r["skipped"],
            "latency_saved": r["latency_saved"],
            "energy_saved": r["energy_saved"]}


def calibrate_on_card(dev, seed: int) -> dict:
    """21b: the recipe on the card, its sweep and Algorithm 1 rerun on
    the CPU from the card's calibration stream, the served tokens."""
    ex, r, counts, secs = run_example(
        dev, "calibrate_and_serve_torch",
        CALIBRATE_ARGV + ["--seed", str(seed)])
    cfg = r["cfg"]
    q8, mask = r["q8"].cpu(), r["mask"].cpu()
    t0 = time.perf_counter()
    best, cands = ex.sweep(q8, mask)
    (l1, h1), _ = ex.algorithm1(q8, mask, float(best.l), float(best.h))
    cpu_s = time.perf_counter() - t0
    card = r["best"]
    alg1_err = max(abs(l1 - r["clip"][0]), abs(h1 - r["clip"][1]))
    tokens = [t for row in r["tokens"] for t in row]
    ok = ((card.l, card.h) == (best.l, best.h)
          and [c[3] for c in r["candidates"]] == [c[3] for c in cands]
          and alg1_err <= ALG1_TOL
          and all(0 <= t < cfg.vocab for t in tokens))
    check_path({"launches": collections.defaultdict(int, counts)},
               ("sparqle_encode_fused", "sparqle_matmul",
                "kv_attention_contiguous"), UNFUSED)
    if not ok:
        raise AssertionError(
            f"calibrate-and-serve on the card: sweep ({card.l}, {card.h}) "
            f"vs CPU ({best.l}, {best.h}), Algorithm 1 |err| {alg1_err}, "
            f"tokens {r['tokens']}")
    del r
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": counts, "s": secs, "cpu_s": cpu_s,
            "layers": cfg.n_layers, "d_model": cfg.d_model,
            "lh": (card.l, card.h), "sparsity": card.sparsity,
            "candidates": len(cands), "learned": (l1, h1),
            "alg1_err": alg1_err, "tokens": tokens[:ex.GEN]}


def failover_on_card(dev, seed: int) -> dict:
    """21c: one restart, restored params bit-equal, the loss falls."""
    _, r, _, secs = run_example(dev, "train_with_failover_torch",
                                FAILOVER_ARGV + ["--seed", str(seed)])
    losses = r["losses"]
    if not (r["report"].restarts == 1 and r["restored_equal"]
            and losses[-1] < losses[0]
            and all(math.isfinite(x) for x in losses)):
        raise AssertionError(f"failover on the card: {r['report']}, "
                             f"restored equal {r['restored_equal']}, "
                             f"losses {losses[0]} -> {losses[-1]}")
    return {"s": secs, "params_m": r["n_params"] / 1e6,
            "restarts": r["report"].restarts,
            "steps_run": r["report"].steps_run,
            "restored_step": r["restored_step"],
            "loss": (losses[0], losses[-1])}


# ---------------------------------------------------------------------------
# phase 22: the dry-run, its plan held against rank 0 on the card, and the
# --legacy steps on a (data, model) mesh
# ---------------------------------------------------------------------------

# ``python -m repro_torch.launch.dryrun --list``: the reference's 32
# runnable cells and 8 skips
DRYRUN_LIST_CELLS = 32
DRYRUN_LIST_SKIPS = 8
DRYRUN_LIST_HEAD = ("starcoder2-3b train_4k", "starcoder2-3b prefill_32k",
                    "starcoder2-3b decode_32k", "granite-8b train_4k")
# the four cells planned on the host (22a) and run as rank 0 on the card
# (22b), on 16x16 under the baseline profile
DRYRUN_CELLS = (("granite-8b", "decode_32k"), ("gemma3-27b", "long_500k"),
                ("granite-8b", "prefill_32k"), ("starcoder2-3b", "train_4k"))
# the cells planned (22a) and run on the card (22b) at a cut of their
# layers, the same cut in both: at full depth the prefill's eager flash
# loop (2,048 blocks a layer) took 51.4-59.4 s and the train step 36.9 s
# on the card, most of phase 22 (PERF.md)
DRYRUN_CARD_LAYERS = {("granite-8b", "prefill_32k"): 4,
                      ("starcoder2-3b", "train_4k"): 4}
DRYRUN_TIMEOUT_S = 600
# rank 0's measured peak within max(PEAK_REL, PEAK_ABS_B) of the plan's
PEAK_REL = 0.05
PEAK_ABS_B = 256 * 2 ** 20
# each kernel op of a trace and the counters of its launches
OP_KERNELS = {
    "sparqle_encode": ("sparqle_encode", "sparqle_encode_batched"),
    "sparqle_quantize": ("sparqle_quantize", "sparqle_quantize_batched"),
    "sparqle_encode_packed": ("sparqle_encode_packed",
                              "sparqle_encode_packed_batched"),
    "sparqle_encode_fused": ("sparqle_encode_fused",
                             "sparqle_encode_fused_batched"),
    "sparqle_quantize_fused": ("sparqle_quantize_fused",
                               "sparqle_quantize_fused_batched"),
    "sparqle_encode_packed_fused": ("sparqle_encode_packed_fused",
                                    "sparqle_encode_packed_fused_batched"),
    "sparqle_matmul": ("sparqle_matmul", "sparqle_matmul_batched",
                       "sparqle_matmul_draft", "sparqle_matmul_draft_batched"),
    "sparqle_matmul_packed": ("sparqle_matmul_packed",
                              "sparqle_matmul_packed_batched",
                              "sparqle_matmul_packed_draft",
                              "sparqle_matmul_packed_draft_batched"),
    "quant_matmul": ("quant_matmul", "quant_matmul_batched"),
    "kv4_paged_decode_attention": ("kv_attention",),
    "kv4_paged_verify_attention": ("kv_attention_verify",),
    "kv_tiered_paged_decode_attention": ("kv_attention_tiered",),
    "kv4_decode_attention": ("kv_attention_contiguous",
                             "kv_attention_contiguous_window",
                             "kv_attention_contiguous_hd256"),
    "kv4_decode_attention_partial": ("kv_attention_partial",),
}
# 22c: granite-8b's width at MESH_LEGACY_LAYERS layers, f32, served through
# the --legacy steps at 1x2 (batch 8) and 2x1 (batch 1) against one device
MESH_LEGACY_LAYERS = 2
MESH_LEGACY_CASES = (((1, 2), 8), ((2, 1), 1))
MESH_LEGACY_PROMPT, MESH_LEGACY_GEN, MESH_LEGACY_MAXLEN = 64, 8, 128


def start_dryrun():
    """22a: ``--list``, then the four cells planned on the host, each in a
    child process of its own (``python -m repro_torch.launch.dryrun``,
    fake CUDA tensors, no card), while the card runs the other phases."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun"]
    listing = subprocess.run(cmd + ["--list"], cwd=ROOT, env=env,
                             capture_output=True, text=True, check=True,
                             timeout=120).stdout.splitlines()
    cells = [ln for ln in listing if not ln.startswith("SKIP")]
    skips = [ln for ln in listing if ln.startswith("SKIP")]
    if (len(cells), len(skips)) != (DRYRUN_LIST_CELLS, DRYRUN_LIST_SKIPS) \
            or tuple(cells[:4]) != DRYRUN_LIST_HEAD:
        raise AssertionError(f"dryrun --list: {len(cells)} cells, "
                             f"{len(skips)} skips: {listing[:6]}")
    procs = []
    for arch, shape in DRYRUN_CELLS:
        log_file = open(OUT / f"dryrun_{arch}__{shape}.txt", "w")
        layers = DRYRUN_CARD_LAYERS.get((arch, shape))
        if layers is None:
            argv = cmd + ["--arch", arch, "--shape", shape, "--mesh",
                          "singlepod", "--out", str(OUT / "dryrun")]
        else:       # the cell's config cut to ``layers``, planned alike
            path = OUT / "dryrun" / "singlepod" / f"{arch}__{shape}.json"
            argv = [sys.executable, "-c", (
                "import json, os; "
                "from repro_torch.configs import get_config; "
                "from repro_torch.launch.dryrun import lower_cell; "
                f"p = {str(path)!r}; "
                "os.makedirs(os.path.dirname(p), exist_ok=True); "
                f"cfg = get_config({arch!r}).replace(n_layers={layers}); "
                f"rec = lower_cell({arch!r}, {shape!r}, 'singlepod', "
                "cfg=cfg); "
                "json.dump(rec, open(p, 'w'), indent=1)")]
        procs.append((arch, shape, log_file, subprocess.Popen(
            argv, cwd=ROOT, env=env, stdout=log_file,
            stderr=subprocess.STDOUT)))
    return {"procs": procs, "t0": time.perf_counter(), "cells": len(cells),
            "skips": len(skips)}


def finish_dryrun(state) -> dict:
    """Wait for 22a's children; raises unless each exits 0. Returns the
    records by (arch, shape) and the host's wall time."""
    recs = {}
    for arch, shape, log_file, proc in state["procs"]:
        try:
            rc = proc.wait(timeout=max(1.0, DRYRUN_TIMEOUT_S - (
                time.perf_counter() - state["t0"])))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            raise
        finally:
            log_file.close()
        text = (OUT / f"dryrun_{arch}__{shape}.txt").read_text()
        if rc:
            raise AssertionError(f"dryrun {arch} {shape} exited {rc}:\n"
                                 f"{text[-3000:]}")
        recs[(arch, shape)] = json.loads(
            (OUT / "dryrun" / "singlepod" / f"{arch}__{shape}.json"
             ).read_text())
    return {"records": recs, "s": time.perf_counter() - state["t0"],
            "cells": state["cells"], "skips": state["skips"]}


def dryrun_on_card(dev, seed: int, plans) -> dict:
    """22b: each planned cell (at its DRYRUN_CARD_LAYERS cut, as planned)
    as rank 0 of a fake 16x16 world on the card,
    one call of its whole step on real tensors of random contents,
    collectives elided, timed (wall, synchronised): the peak of
    ``torch.cuda.max_memory_allocated`` against the plan's within
    max(PEAK_REL, PEAK_ABS_B), each kernel's launches equal to the count
    of its op in the plan's trace."""
    from repro_torch import kernels
    from repro_torch.launch.dryrun import lower_cell
    out = {}
    for arch, shape in DRYRUN_CELLS:
        plan = plans[(arch, shape)]
        gc.collect()
        torch.cuda.empty_cache()
        _reset_peak(dev)
        base = torch.cuda.memory_allocated(dev)
        kernels.reset_launch_counts()
        layers = DRYRUN_CARD_LAYERS.get((arch, shape))
        cfg = None
        if layers is not None:
            from repro_torch.configs import get_config
            cfg = get_config(arch).replace(n_layers=layers)
        rec = lower_cell(arch, shape, "singlepod", fake=False,
                         device=str(dev), fill_seed=seed, timed=1,
                         tally_run=False, cfg=cfg)
        peak = torch.cuda.max_memory_allocated(dev) - base
        counts = kernels.launch_counts()
        tol = max(PEAK_REL * plan["peak_b"], PEAK_ABS_B)
        if not abs(peak - plan["peak_b"]) <= tol:
            raise AssertionError(f"22b {arch} {shape}: measured peak {peak} "
                                 f"B against the plan's {plan['peak_b']} B")
        for op, n in plan["kernel_ops"].items():
            got = sum(counts[k] for k in OP_KERNELS[op])
            if got != n:
                raise AssertionError(f"22b {arch} {shape}: {op} launched "
                                     f"{got} times, traced {n}")
        if sum(counts.values()) != sum(plan["kernel_ops"].values()):
            raise AssertionError(f"22b {arch} {shape}: launches {counts} "
                                 f"beyond the plan's {plan['kernel_ops']}")
        out[(arch, shape)] = {"peak_b": peak, "plan_b": plan["peak_b"],
                              "step_s": rec["step_s"], "launches": counts,
                              "flops": plan["flops_hlo"],
                              "coll_b": plan["collective_bytes"]["total"]}
        del rec
    return out


def mesh_legacy_config():
    from repro_torch.configs import get_config
    return get_config("granite-8b").replace(n_layers=MESH_LEGACY_LAYERS,
                                            dtype="float32")


def mesh_legacy_run(dev, seed: int, batch: int, shape=None, rank: int = 0):
    """granite-8b at MESH_LEGACY_LAYERS layers, f32, drawn from ``seed``:
    prefill of ``batch`` prompts and MESH_LEGACY_GEN greedy decode steps
    through the --legacy steps, on one device or (``shape``) as ``rank``
    of a (data, model) world of ranks sharing the card over gloo. Returns
    the rank's tokens and logits (numpy) and its launch counts."""
    from repro_torch import kernels
    from repro_torch.distributed.tp import tp_scope
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import mesh_coords, serve_groups
    from repro_torch.models import model as M
    from repro_torch.models.schema import init_quantized_params
    from repro_torch.models.schema_builder import build_schema
    cfg = mesh_legacy_config()
    params = init_quantized_params(build_schema(cfg), seed, dev,
                                   float_dtype=cfg.cdtype)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab, (batch, MESH_LEGACY_PROMPT),
                           generator=g, device=dev, dtype=torch.int32)
    pre_ctx = dec_ctx = None
    if shape is not None:
        layout = {"data": shape[0], "model": shape[1]}
        groups = serve_groups(layout)
        coords = mesh_coords(layout, rank)
        sms = [S.serve_mesh(cfg, layout, coords, groups,
                            global_batch=batch, max_len=MESH_LEGACY_MAXLEN,
                            kind=k) for k in ("prefill", "decode")]
        params = sms[0].local(params, sms[0].specs)
        tokens = sms[0].local(tokens, S.batch_specs(
            {"t": tokens}, layout)["t"])
        pre_ctx = S.serve_context(sms[0])
        dec_ctx = S.serve_context(sms[1], tokens.shape[0])
    kernels.reset_launch_counts()
    toks, logits = [], []
    with torch.no_grad():
        with tp_scope(pre_ctx):
            lg, cache = M.prefill(cfg, params, {"tokens": tokens},
                                  max_len=MESH_LEGACY_MAXLEN)
        for i in range(MESH_LEGACY_GEN + 1):
            tok = torch.argmax(lg, -1).to(torch.int32)
            toks.append(tok.cpu().numpy())
            logits.append(lg.float().cpu().numpy())
            if i == MESH_LEGACY_GEN:
                break
            pos = torch.full_like(tok, MESH_LEGACY_PROMPT + i)
            with tp_scope(dec_ctx):
                lg, cache = M.decode_step(cfg, params, cache, tok, pos)
    torch.cuda.synchronize()
    return {"tokens": toks, "logits": logits,
            "launches": kernels.launch_counts()}


def mesh_legacy_rank(rank, seed):
    """22c's rank (a world of 2): each MESH_LEGACY_CASES shape in turn on
    its card; rank 0 first runs the one-device references. Returns
    {shape: its run} and, on rank 0, {"single": {batch: run}}."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    out = {}
    if rank == 0:
        out["single"] = {b: mesh_legacy_run(dev, seed, b)
                         for _, b in MESH_LEGACY_CASES}
    for shape, batch in MESH_LEGACY_CASES:
        out[shape] = mesh_legacy_run(dev, seed, batch, shape, rank)
    return out


def start_mesh_legacy(seed: int):
    """22c's world of two ranks sharing the card over gloo, in a thread
    beside 22b: returns (the thread, the list its ranks' results land
    in)."""
    import threading
    from repro_torch.launch.mesh import spawn_world
    got: list = []

    def world():
        try:
            got.extend(spawn_world(mesh_legacy_rank, 2, seed,
                                   backend="gloo", device_type="cuda",
                                   timeout_s=TP_TIMEOUT_S))
        except BaseException as e:   # re-raised by finish_mesh_legacy
            got.append(e)

    th = threading.Thread(target=world)
    th.start()
    return th, got


def finish_mesh_legacy(state) -> dict:
    """22c: the --legacy steps on a (data, model) mesh of ranks sharing the
    card over gloo, at 1x2 (the batch over data, the cache cut along its
    positions over model) and 2x1 with one sequence (the cache cut over
    data): every rank's greedy tokens equal the one-device run's rows,
    its logits within LOGIT_TOL of their max; the partial attention
    (row 7p) launched where the cache is cut."""
    th, ranks = state
    th.join()
    if len(ranks) != 2 or isinstance(ranks[0], BaseException):
        raise AssertionError(f"22c: the world failed: {ranks}")
    out = {}
    for shape, batch in MESH_LEGACY_CASES:
        single = ranks[0]["single"][batch]
        worst, equal = 0.0, True
        for rank, r in enumerate(ranks):
            r = r[shape]
            rows = r["tokens"][0].shape[0]
            lo = (rank // shape[1]) * rows if rows != batch else 0
            for a, b in zip(r["tokens"], single["tokens"]):
                equal &= bool((a == b[lo:lo + rows]).all())
            for a, b in zip(r["logits"], single["logits"]):
                ref = b[lo:lo + rows]
                worst = max(worst, float(abs(a - ref).max()
                                         / max(abs(ref).max(), 1e-30)))
            if r["launches"]["kv_attention_partial"] == 0:
                raise AssertionError(f"22c {shape}: rank {rank} launched no "
                                     f"partial attention")
        if not equal or worst > LOGIT_TOL:
            raise AssertionError(f"22c {shape} B={batch}: tokens equal "
                                 f"{equal}, logits {worst:.3g} of max")
        out[f"{shape[0]}x{shape[1]}"] = {
            "batch": batch, "tokens_equal": equal, "logit_rel": worst,
            "partial_launches": ranks[0][shape]["launches"][
                "kv_attention_partial"]}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel checks (phases 1-3)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--train-cli", default="", help=argparse.SUPPRESS)
    ap.add_argument("--train-cli-mesh", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    if args.train_cli or args.train_cli_mesh:   # phase 18c's, 19c's child
        train_cli_child(args.train_cli or args.train_cli_mesh,
                        mesh=bool(args.train_cli_mesh))
        return 0
    from repro_torch import kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    OUT.mkdir(exist_ok=True)

    card = nvidia_smi_line()
    log(f"[1] card: {card}")
    peaks = peaks_for(card.split(",")[0])

    t0 = time.perf_counter()
    kernels.build_all()
    log(f"[2] built {len(kernels.KERNELS)} kernels in "
        f"{time.perf_counter() - t0:.1f} s")
    (OUT / "kernel_build.log").write_text("\n".join(
        f"== {k.name}\n{k.build_log}" for k in kernels.KERNELS.values()))

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rows = [check_encoder(dev, gen, peaks), check_matmul(dev, gen, peaks),
            check_attention(dev, gen, peaks),
            check_draft_matmul(dev, gen, peaks),
            check_verify_attention(dev, gen, peaks),
            check_quantize(dev, gen, peaks),
            check_dense_matmul(dev, gen, peaks),
            check_tiered_attention(dev, gen, peaks),
            check_encoder_packed(dev, gen, peaks),
            *check_matmul_packed(dev, gen, peaks),
            check_contiguous_attention(dev, gen, peaks),
            *check_gemma_attention(dev, gen, peaks),
            check_partial_attention(dev, gen, peaks),
            *check_batched_encoder(dev, gen, peaks),
            *check_batched_matmul(dev, gen, peaks)]
    er = check_expert_rows(dev, gen, peaks)
    for r in rows:
        d = er["encoder"].get(r["name"]) or er["matmul"].get(
            r["name"][:-len("_batched")])
        if r["name"].endswith("_batched") and d:
            apply_rows_timing(r, d)
    log(f"[3] expert rows (``rows``): {er['cases']} input sets bit-exact "
        f"with the plain versions (the five batched matmul entries at (E, "
        f"C, K, N) in {ROWS_SWEEP}, the six batched encoders at (E, C, K) "
        f"in {ROWS_ENCODE}, rows {ROWS_PATTERNS}, garbage past the count; "
        f"packed = unpacked, dense = dual pass; arrival counters 0 after "
        f"every launch; one launch a call) in {er['s']:.1f} s; timed: "
        + "; ".join(f"{name}_batched {rows_note(d)}"
                    for name, d in er["matmul"].items())
        + "; " + "; ".join(f"{name} {rows_note(d)}"
                           for name, d in er["encoder"].items())
        + "; deepseek-v3's routed shapes: " + "; ".join(
            f"sparqle_matmul_batched {rows_note(d)}" for d in er["v3"]))
    attn_zoo = check_attention_zoo(dev, gen, peaks)
    log("[3] kv4_paged_decode_attention at the zoo's head shapes (B=8, "
        "hd=128, ps=16, Pmax=16, f32 q): " + "; ".join(
            f"{a} KVH={d['KVH']} G={d['G']}: {d['ms'] * 1e3:.2f} us vs plain "
            f"{d['plain_ms'] * 1e3:.1f} us, bound {d['bound_ms'] * 1e3:.2f} "
            f"us ({d['bound_by']}), err {d['max_abs_err']:.3g}"
            for a, d in attn_zoo.items()))
    t0 = time.perf_counter()
    n_shapes = check_attention_shapes(dev, gen)
    small = smoke_config_on_card(dev, args.seed)
    log(f"[3] attention at {n_shapes} other shapes (hd, G, ps) "
        f"{ATTN_SHAPES}: decode within {ATTN_TOL} of plain, verify = "
        f"decode, tiered = decode on clamped pages, contiguous = paged "
        f"tiling and round_kv, f32 and bf16; granite-8b smoke config (hd "
        f"16, G 2) on the card, pages of 8: spec streams = engine streams, "
        f"legacy (blocks of 2) tokens equal to the engine's "
        f"{small['legacy_tokens_equal']}/36, attention launches "
        f"{small['launches']}; {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    n_cases = check_matmul_family(dev, gen)
    log(f"[3] W4A8 matmul family: {n_cases} input sets (M in "
        f"{MATMUL_M}, (K, N) in {MATMUL_KN}, populations {POP_PATTERNS}, "
        f"q=-128 w=-8), all five entries bit-exact with their plain "
        f"versions, packed = unpacked and dense = dual pass, f32 and int32 "
        f"outputs, {time.perf_counter() - t0:.1f} s")
    for arch, shapes in (
            ("deepseek-v3-671b", (V3_M, V3_KN, V3_ENCODE_K, V3_BATCHED)),
            ("mamba2-2.7b and jamba-v0.1-52b",
             (SSD_M, SSD_KN, SSD_ENCODE_K, SSD_BATCHED))):
        t0 = time.perf_counter()
        ms, kns, encode_ks, batched = shapes
        sw = check_arch_shapes(dev, gen, *shapes)
        log(f"[3] {arch} shapes, all bit-exact with their plain versions: "
            f"the five matmul entries on {sw['matmul']} input sets (M in "
            f"{ms}, (K, N) in {kns}, populations {POP_PATTERNS}), the fused "
            f"encoders on {sw['encoder']} (K in {encode_ks}, bf16 and f32), "
            f"the five batched matmul entries and three batched encoders at "
            f"E={batched['e']}, C in {batched['c']}, (K, N) in "
            f"{batched['kn']} ({sw['batched_matmul']} and "
            f"{sw['batched_encoder']} input sets), and there with the live "
            f"rows {ROWS_PATTERNS}, garbage past the count, the five "
            f"batched matmul entries and six batched encoders "
            f"({sw['rows_matmul']} and {sw['rows_encoder']} input sets; "
            f"packed = unpacked, dense = dual pass, arrival counters 0); "
            f"{time.perf_counter() - t0:.1f} s")
    for r in rows:
        log(f"[3] {r['name']}: ok (err {r['max_abs_err']:.3g}), "
            f"{r['ms'] * 1e3:.1f} us vs plain {r['plain_ms'] * 1e3:.1f} us, "
            f"bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}) at "
            f"{r['shape']}")
        for f in r.get("formats", []):
            log(f"[3]   formats at M={f['M']} 4096->14336, populations "
                f"{f['pop']} ({f['live'] * 100:.0f}% of tiles live): dense "
                f"{f['quant_matmul'] * 1e3:.1f} us, dual pass "
                f"{f['sparqle_matmul'] * 1e3:.1f} us, draft "
                f"{f['sparqle_matmul_draft'] * 1e3:.1f} us")
    detail = {"card": card, "kernels": rows, "attention_zoo": attn_zoo,
              "expert_rows": er}
    # the launch counter of each kernel row, and the phase that reads it
    # rows 1, 3 and 7: the launches of phase 21b's calibrate-and-serve
    # example, 6: of 21a's quickstart (the last paths the smoke drives);
    # 1e, 3e and 8: of phase 19b's serve (the tree trained on the 2x2
    # mesh)
    counter = {"sparqle_encode_fused": ("sparqle_encode_fused",
                                        "calibrate"),
               "sparqle_matmul": ("sparqle_matmul", "calibrate"),
               "kv4_paged_decode_attention": ("kv_attention", "mesh_serve"),
               "sparqle_matmul_draft": ("sparqle_matmul_draft", "spec"),
               "kv4_paged_verify_attention": ("kv_attention_verify",
                                              "spec"),
               "sparqle_quantize_fused": ("sparqle_quantize_fused", "dense"),
               "quant_matmul": ("quant_matmul", "quickstart"),
               "kv_tiered_paged_decode_attention": ("kv_attention_tiered",
                                                    "kv2"),
               "sparqle_encode_packed_fused": ("sparqle_encode_packed_fused",
                                               "packed"),
               "sparqle_matmul_packed": ("sparqle_matmul_packed", "packed"),
               "sparqle_matmul_packed_draft": ("sparqle_matmul_packed_draft",
                                               "packed_spec"),
               "kv4_decode_attention": ("kv_attention_contiguous",
                                        "calibrate"),
               # row 7's instances of the gemma family's --legacy serves
               "kv4_decode_attention_window": (
                   "kv_attention_contiguous_window", "gemma3"),
               "kv4_decode_attention_hd256": (
                   "kv_attention_contiguous_hd256", "paligemma"),
               # row 7p: phase 22b's rank 0 on the card (the decode cells)
               "kv4_decode_attention_partial": ("kv_attention_partial",
                                                "dryrun_card"),
               # the expert-batched entries: deepseek-moe-16b's serves
               "sparqle_encode_fused_batched": (
                   "sparqle_encode_fused_batched", "mesh_serve"),
               "sparqle_matmul_batched": ("sparqle_matmul_batched",
                                          "mesh_serve"),
               "sparqle_matmul_draft_batched": (
                   "sparqle_matmul_draft_batched", "moe_spec"),
               "sparqle_quantize_fused_batched": (
                   "sparqle_quantize_fused_batched", "moe_dense"),
               "quant_matmul_batched": ("quant_matmul_batched", "moe_dense"),
               "sparqle_encode_packed_fused_batched": (
                   "sparqle_encode_packed_fused_batched", "moe_packed"),
               "sparqle_matmul_packed_batched": (
                   "sparqle_matmul_packed_batched", "moe_packed"),
               "sparqle_matmul_packed_draft_batched": (
                   "sparqle_matmul_packed_draft_batched", "moe_packed_spec"),
               # the expert-batched entries that take a scale: phase 13's
               # row-parallel routed projections (rank 0's counts)
               "sparqle_encode_batched": ("sparqle_encode_batched",
                                          "tp_moe"),
               "sparqle_quantize_batched": ("sparqle_quantize_batched",
                                            "tp_moe_dense"),
               "sparqle_encode_packed_batched": (
                   "sparqle_encode_packed_batched", "tp_moe_packed")}
    if not args.kernels_only:
        cfg, params, prompts, t_build = granite(dev, args.seed)
        # every serve runs before any profiler: a profiled run leaves the
        # process slower on the host (phase 10 measures by how much)
        eng = serve_granite(dev, cfg, params, prompts)
        check_path(eng, ("sparqle_encode_fused", "sparqle_matmul",
                         "kv_attention"), UNFUSED)
        # phase 13 rebuilds this tree from the seed and checks it is this
        eng["tree_checksum"] = tree_checksum(params)
        log(f"[4] granite-8b {eng['layers']}L d={eng['d_model']}: "
            f"{eng['requests']} requests, {eng['tokens']} tokens, "
            f"{eng['tokens_per_s']:.1f} tok/s, TTFT mean "
            f"{eng['ttft_mean_s'] * 1e3:.1f} ms, TPOT mean "
            f"{eng['tpot_mean_s'] * 1e3:.2f} ms, {eng['steps']} steps, "
            f"launches {eng['launches']}, weights built in "
            f"{t_build:.1f} s, peak {eng['peak_mem_gb']:.1f} GB")
        # phase 4b: the compiled steps against eager ones
        t0 = time.perf_counter()
        gve = graphs_vs_eager(dev, cfg, params, prompts)
        gve["replay_vs_eager"] = {
            case[0]: replay_vs_eager(dev, case)
            for case in graph_cases(cfg, params, dev, args.seed)}
        gve["legacy"] = leg = legacy_prefill_serves(dev, cfg, params, prompts)
        gve["recodec_ms"] = rc = recodec_times(dev, cfg)
        leg_decode_ms = [r["decode_step_s"] * 1e3 for r in leg]
        serves = gve["eager"] + gve["graphs"]
        same_gve = [r["streams"] == eng["streams"] for r in serves]
        same_counts = [r["launches"] == gve["eager"][0]["launches"]
                       for r in serves + [eng]]

        def times(path, key, scale=1e3):
            return "/".join(f"{r[key] * scale:.2f}" for r in gve[path])
        log(f"[4b] granite-8b {cfg.n_layers}L CUDA graphs vs eager, "
            f"{1 + GRAPH_ROUNDS} serves each alternated (the first warm: "
            f"the graph engine captures there): TPOT mean ms eager "
            f"{times('eager', 'tpot_mean_s')}, graphs "
            f"{times('graphs', 'tpot_mean_s')}; TTFT mean ms eager "
            f"{times('eager', 'ttft_mean_s')}, graphs "
            f"{times('graphs', 'ttft_mean_s')}; tok/s eager "
            f"{times('eager', 'tokens_per_s', 1)}, graphs "
            f"{times('graphs', 'tokens_per_s', 1)}; streams equal to phase "
            f"4: {sum(same_gve)}/{len(same_gve)} serves, launch counts "
            f"equal: {sum(same_counts)}/{len(same_counts)} (phase 4 "
            f"included); each step kind replayed vs eager at "
            f"{cfg.n_layers}L, bits equal: {gve['replay_vs_eager']}; "
            f"--legacy prefill through one LegacySteps, 3 serves: eager "
            f"{leg[0]['prefill_s'] * 1e3:.2f} ms (the caches' allocation "
            f"included), capture and first replay "
            f"{leg[1]['prefill_s'] * 1e3:.2f} ms (the serve added "
            f"{leg[1]['reserved_gb']:.3f} GB reserved), replay "
            f"{leg[2]['prefill_replay_s'] * 1e3:.2f} ms; decode "
            f"{'/'.join(f'{r_ms:.2f}' for r_ms in leg_decode_ms)} "
            f"ms/step; streams and launches equal in the 3; "
            f"KV2 re-codec a page, ms (capture, replay, eager; "
            f"{RECODEC_CALLS} pages): "
            + "; ".join(f"{op} " + "/".join(f"{v:.3f}" for v in ms.values())
                        for op, ms in rc.items())
            + f"; {time.perf_counter() - t0:.1f} s")
        if not (all(same_gve) and all(same_counts)
                and all(gve["replay_vs_eager"].values())):
            raise AssertionError("the compiled steps differ from eager ones")
        spec = serve_granite(dev, cfg, params, prompts, spec_gamma=SPEC_GAMMA)
        check_path(spec, ("sparqle_encode_fused", "sparqle_matmul",
                          "kv_attention", "sparqle_matmul_draft",
                          "kv_attention_verify"), UNFUSED)
        spec["row_count_dependence"] = row_count_dependence(dev, cfg, params)
        spec["window_vs_decode"] = window_vs_decode(dev, cfg, params,
                                                    args.seed)
        same = [a == b for a, b in zip(spec["streams"], eng["streams"])]
        agg = spec["aggregate"]
        log(f"[5] granite-8b {spec['layers']}L speculative gamma="
            f"{SPEC_GAMMA}: acceptance {agg['spec_acceptance_rate']:.4f}, "
            f"{agg['spec_tokens_per_step']:.3f} tokens/cycle, TPOT mean "
            f"{spec['tpot_mean_s'] * 1e3:.2f} ms (base "
            f"{eng['tpot_mean_s'] * 1e3:.2f} ms), "
            f"{spec['tokens_per_s']:.1f} tok/s (base "
            f"{eng['tokens_per_s']:.1f}), {spec['steps']} steps, greedy "
            f"streams equal to phase 4: {sum(same)}/{len(same)}, launches "
            f"{spec['launches']}, peak {spec['peak_mem_gb']:.1f} GB; "
            f"elements that change "
            f"when B rows run inside a {SPEC_GAMMA + 1}B-row call: "
            f"{spec['row_count_dependence']}; one verify window vs "
            f"{SPEC_GAMMA + 1} decode steps at {cfg.n_layers}L: "
            f"{spec['window_vs_decode']}")
        if not all(spec["window_vs_decode"].values()):
            raise AssertionError("the verify window's logits or pages differ "
                                 "from the decode steps'")
        if not all(same):
            raise AssertionError(f"speculative greedy streams differ from "
                                 f"the base engine's: {spec['streams']} vs "
                                 f"{eng['streams']}")
        # phase 6: the KV2 precision ladder, armed but idle, then an
        # aggressive cold sweep (bench_serving.py's serving_kv2 settings)
        n_pages = 1 + 8 * math.ceil((SERVE["prompt_len"] + SERVE["gen"])
                                    / 16)
        idle = serve_granite(dev, cfg, params, prompts, kv2_pages=n_pages,
                             demote_after_steps=10**9)
        kv2 = serve_granite(dev, cfg, params, prompts, kv2_pages=n_pages,
                            demote_after_steps=1, demote_min_sparsity=0.0,
                            attribute=True)
        lad = kv2["ladder"]
        per_page = lad["page_bytes"][0] - lad["page_bytes"][1]
        agg2 = kv2["aggregate"]
        same_idle = [a == b for a, b in zip(idle["streams"], eng["streams"])]
        same_kv2 = [a == b for a, b in zip(kv2["streams"], eng["streams"])]
        spars = lad["spars"]
        log(f"[6] granite-8b {kv2['layers']}L KV2 ladder ({n_pages} KV2 "
            f"pages): armed idle - {idle['aggregate']['pool_demotions']} "
            f"demotions, streams equal to phase 4: "
            f"{sum(same_idle)}/{len(same_idle)}, launches "
            f"{idle['launches']}; aggressive sweep - "
            f"{agg2['pool_demotions']} demotions, "
            f"{agg2['pool_promotions']} promotions, kv_bytes_reclaimed "
            f"{agg2['kv_bytes_reclaimed']} ({per_page} B a page), peak "
            f"{lad['peak'] * 100:.2f}% of held KV bytes reclaimed, demote "
            f"phase {lad['demote_s']:.3f} s over {kv2['steps']} steps, mean "
            f"in-band share of the pages demoted "
            f"{sum(spars) / max(len(spars), 1):.4f} (min "
            f"{min(spars, default=0):.4f}, max {max(spars, default=0):.4f}), "
            f"re-codec graphs (demote, promote) {lad['graphs']}, "
            f"streams equal to phase 4: {sum(same_kv2)}/{len(same_kv2)}, "
            f"TPOT mean {kv2['tpot_mean_s'] * 1e3:.2f} ms (idle "
            f"{idle['tpot_mean_s'] * 1e3:.2f}, base "
            f"{eng['tpot_mean_s'] * 1e3:.2f}), launches {kv2['launches']}; "
            f"attributed decode "
            f"{kv2['attribution']['decode']['hbm_bytes'] / 1e9:.6f} GB a "
            f"step at the KV2 share of its table reads "
            f"{kv2['kv2_share']:.4f}")
        if not 0 < kv2["kv2_share"] < 1:
            raise AssertionError(f"KV2 sweep: the decodes read a KV2 share "
                                 f"of {kv2['kv2_share']}")
        for run in (idle, kv2):
            check_path(run, ("sparqle_encode_fused", "sparqle_matmul",
                             "kv_attention_tiered"),
                       ("kv_attention",) + UNFUSED)
            if run["launches"]["kv_attention_tiered"] != \
                    cfg.n_layers * run["forwards"]["decode"]:
                raise AssertionError("tiered attention launches != layers "
                                     "x decode steps")
        if idle["aggregate"]["pool_demotions"] or not all(same_idle):
            raise AssertionError("the armed-idle ladder demoted or changed "
                                 "a stream")
        if not agg2["pool_demotions"] or agg2["kv_bytes_reclaimed"] != \
                agg2["pool_demotions"] * per_page:
            raise AssertionError(f"KV2 sweep: {agg2}")
        # a re-codec runs eagerly once, then is captured and replayed
        want = [int(agg2[f"pool_{k}"] >= 2) for k in ("demotions",
                                                      "promotions")]
        if lad["graphs"] != want or idle["ladder"]["graphs"] != [0, 0]:
            raise AssertionError(f"KV2 re-codec graphs {lad['graphs']} "
                                 f"(idle {idle['ladder']['graphs']}), want "
                                 f"{want}")
        # phase 7: the dense W4A8 baseline on the same int4 weights
        dense = with_fields(params, mode="dense")
        dn = serve_granite(dev, cfg, dense, prompts)
        dn["logits_equal"] = logits_equal(dev, cfg, params, dense, prompts)
        fw = dn["forwards"]["prefill"] + dn["forwards"]["decode"]
        same_dn = [a == b for a, b in zip(dn["streams"], eng["streams"])]
        log(f"[7] granite-8b {dn['layers']}L dense W4A8: streams equal to "
            f"phase 4: {sum(same_dn)}/{len(same_dn)}, logits bit-equal to "
            f"SPARQLe at {cfg.n_layers}L: {dn['logits_equal']}, TTFT mean "
            f"{dn['ttft_mean_s'] * 1e3:.1f} ms (SPARQLe "
            f"{eng['ttft_mean_s'] * 1e3:.1f}), TPOT mean "
            f"{dn['tpot_mean_s'] * 1e3:.2f} ms (SPARQLe "
            f"{eng['tpot_mean_s'] * 1e3:.2f}), {dn['tokens_per_s']:.1f} "
            f"tok/s (SPARQLe {eng['tokens_per_s']:.1f}), {fw} forwards, "
            f"launches {dn['launches']}")
        check_path(dn, ("sparqle_quantize_fused", "quant_matmul",
                        "kv_attention"),
                   ("sparqle_encode_fused", "sparqle_matmul") + UNFUSED)
        if dn["launches"]["quant_matmul"] != 252 * fw:
            raise AssertionError("dense matmul launches != 252 per forward")
        if not all(same_dn) or not all(dn["logits_equal"].values()):
            raise AssertionError("the dense serve differs from SPARQLe")
        # phase 8: the packed wire format on the same weights
        # the unpacked tree served again just before: a serve's host time
        # drifts over a process's serves, so TPOT compares neighbours
        again = serve_granite(dev, cfg, params, prompts)
        packed = with_fields(params, wire_format="packed")
        pk = serve_granite(dev, cfg, packed, prompts)
        pk["logits_equal"] = logits_equal(dev, cfg, params, packed, prompts)
        pk_spec = serve_granite(dev, cfg, packed, prompts,
                                spec_gamma=SPEC_GAMMA)
        unpacked = ("sparqle_encode_fused", "sparqle_matmul",
                    "sparqle_matmul_draft", "sparqle_quantize_fused",
                    "quant_matmul") + UNFUSED
        check_path(pk, ("sparqle_encode_packed_fused",
                        "sparqle_matmul_packed", "kv_attention"),
                   unpacked + ("sparqle_matmul_packed_draft",))
        check_path(pk_spec, ("sparqle_encode_packed_fused",
                             "sparqle_matmul_packed",
                             "sparqle_matmul_packed_draft", "kv_attention",
                             "kv_attention_verify"), unpacked)
        fw = pk["forwards"]["prefill"] + pk["forwards"]["decode"]
        same_pk = [a == b for a, b in zip(pk["streams"], eng["streams"])]
        same_pks = [a == b for a, b in zip(pk_spec["streams"],
                                           eng["streams"])]
        log(f"[8] granite-8b {pk['layers']}L packed wire format: streams "
            f"equal to phase 4: {sum(same_pk)}/{len(same_pk)} (gamma="
            f"{SPEC_GAMMA}: {sum(same_pks)}/{len(same_pks)}), logits "
            f"bit-equal to the unpacked tree at {cfg.n_layers}L: "
            f"{pk['logits_equal']}, TTFT mean {pk['ttft_mean_s'] * 1e3:.1f} "
            f"ms (unpacked just before {again['ttft_mean_s'] * 1e3:.1f}, "
            f"phase 4 {eng['ttft_mean_s'] * 1e3:.1f}), TPOT mean "
            f"{pk['tpot_mean_s'] * 1e3:.2f} ms (unpacked just before "
            f"{again['tpot_mean_s'] * 1e3:.2f}, phase 4 "
            f"{eng['tpot_mean_s'] * 1e3:.2f}), {pk['tokens_per_s']:.1f} "
            f"tok/s (unpacked just before {again['tokens_per_s']:.1f}), "
            f"{fw} forwards, "
            f"launches {pk['launches']}; gamma={SPEC_GAMMA}: TPOT mean "
            f"{pk_spec['tpot_mean_s'] * 1e3:.2f} ms (unpacked "
            f"{spec['tpot_mean_s'] * 1e3:.2f}), launches "
            f"{pk_spec['launches']}")
        for name in ("sparqle_encode_packed_fused", "sparqle_matmul_packed"):
            if pk["launches"][name] != 252 * fw:
                raise AssertionError(f"{name} launches != 252 per forward")
        if not (all(same_pk) and all(same_pks)
                and all(pk["logits_equal"].values())):
            raise AssertionError("the packed serves differ from phase 4")
        # phase 9: the fixed-batch --legacy path
        lg = serve_legacy(dev, cfg, params, prompts)
        steps = lg["decode_steps"]
        same_lg = [a == b for a, b in zip(lg["streams"], eng["streams"])]
        lg["vs_engine_2l"] = legacy_vs_engine(dev, args.seed)
        lg["same_as_4b"] = all(r["streams"] == lg["streams"]
                               for r in gve["legacy"])
        log(f"[9] granite-8b {cfg.n_layers}L --legacy {SERVE['batch']} x "
            f"{SERVE['prompt_len']} x {SERVE['gen']}: prefill "
            f"{lg['prefill_s'] * 1e3:.1f} ms, decode "
            f"{lg['decode_step_s'] * 1e3:.2f} ms/step over "
            f"{lg['decode_timed_steps']} graph replays (warm-up and capture "
            f"{lg['decode_warmup_s'] * 1e3:.1f} ms) "
            f"(engine TPOT {eng['tpot_mean_s'] * 1e3:.2f} ms), streams "
            f"equal to phase 4: {sum(same_lg)}/{len(same_lg)} (not "
            f"required: the engine prefills in chunks of 32), launches "
            f"{lg['launches']}, peak {lg['peak_mem_gb']:.1f} GB, streams "
            f"equal to phase 4b's three (prefill warm-up, capture, replay): "
            f"{lg['same_as_4b']}; granite "
            f"width 2L f32 legacy vs engine (prefill unchunked): "
            f"{lg['vs_engine_2l']}")
        check_path(lg, ("sparqle_encode_fused", "sparqle_matmul",
                        "kv_attention_contiguous"),
                   ("kv_attention", "kv_attention_verify",
                    "kv_attention_tiered") + UNFUSED)
        if lg["launches"]["kv_attention_contiguous"] != cfg.n_layers * steps:
            raise AssertionError("contiguous attention launches != layers x "
                                 "decode steps")
        if lg["launches"]["sparqle_matmul"] != 252 * (1 + steps):
            raise AssertionError("legacy matmul launches != 252 per forward")
        if not lg["vs_engine_2l"]["equal"]:
            raise AssertionError("legacy streams differ from the engine's "
                                 "with the prefill unchunked")
        if not lg["same_as_4b"]:
            raise AssertionError("phase 4b's --legacy serves (prefill "
                                 "replayed) differ from phase 9's")
        # phase 14 runs here, before the profilers of phase 10 (a profiled
        # process stays slower on the host): the serve's surface on phase
        # 4's tree and prompts, and the core's calibration on the card
        surf = serve_surface(dev, cfg, params, prompts, eng, spec)
        for name in ("base", "spec"):
            r = surf[name]
            log(f"[14] {card}: granite-8b {cfg.n_layers}L attributed "
                f"{name} serve (SLOs {SLO_SPECS}): streams equal to phase "
                f"{4 if name == 'base' else 5}, validate_attribution [], "
                f"SLO violations "
                f"{ {x['slo']: x['violations'] for x in r['slo']} }; "
                f"decode bytes {r['decode_bytes_over_resident']:.4f} x the "
                f"{r['resident_bytes'] / 1e9:.4f} GB of weights, scales, "
                f"head and KV it must read; {phase_rows(r)}")
        cal = surf["calibration"]
        log(f"[14] {card}: Engine.stream of prompt 3 = its phase 4 stream; "
            f"serve --slo --attribute --metrics-out (smoke config on the "
            f"card): snapshot valid, SLO violations {surf['cli']['slo']}, "
            f"hidden MSB4 sparsity {surf['cli']['hidden_sparsity']:.4f}, "
            f"cost-model TPOT -{surf['cli']['tpot_pct']:.2f}% (the paper's "
            f"accelerator); calibration of layer 0's four sites on phase "
            f"4's prompts: {cal['candidates']} candidates equal on the card "
            f"and the CPU, chose (l, h) = {cal['chosen']} (sparsity "
            f"{cal['sparsity']:.4f}, mse {cal['mse']:.4g}); Algorithm 1 "
            f"card {cal['algorithm1_card']} vs CPU {cal['algorithm1_cpu']}; "
            f"{surf['wall_s']:.1f} s")
        detail["serve_surface"] = surf
        # phase 10: where the time goes, then the base serve once more
        eng["profile"] = profile_engine(cfg, params, dev, args.seed)
        spec["profile"] = profile_engine(cfg, params, dev, args.seed,
                                         SPEC_GAMMA)
        eng["profile"], dprof = profile_dense(cfg, params, dense, dev,
                                              args.seed, eng["profile"])
        dn["profile"] = dprof
        after = serve_granite(dev, cfg, params, prompts)
        split = ", ".join(f"{k['kernel'][:40]} {k['share'] * 100:.1f}% "
                          f"({k['mean_us']:.1f} us x {k['launches']})"
                          for k in eng["profile"]["by_kernel"][:8])
        prof = spec["profile"]
        fills = [fill_launches(p) for p in (eng["profile"], dprof)]
        log(f"[10] profiled reruns (8 requests x 32 prompt x 8 new, CUDA "
            f"graphs captured by a first run): base device busy "
            f"{eng['profile']['device_busy_s']:.3f} s of "
            f"{eng['profile']['profiled_wall_s']:.2f} s wall (busy share "
            f"{eng['profile']['device_busy_share']:.3f}; over the "
            f"cProfiled rerun's {eng['profile']['cprofiled_wall_s']:.3f} s "
            f"wall {eng['profile']['device_busy_share_cprofiled']:.3f}), "
            f"by kernel: "
            f"{split}; speculative device busy {prof['device_busy_s']:.3f} "
            f"s of {prof['profiled_wall_s']:.2f} s wall (idle "
            f"{1 - prof['device_busy_share']:.3f}; over the cProfiled "
            f"rerun's wall {1 - prof['device_busy_share_cprofiled']:.3f}); "
            f"phase 4's serve after "
            f"the profilers: {after['wall_s']:.2f} s wall, TPOT mean "
            f"{after['tpot_mean_s'] * 1e3:.2f} ms (phase 4: "
            f"{eng['wall_s']:.2f} s, {eng['tpot_mean_s'] * 1e3:.2f} ms), "
            f"streams equal: {after['streams'] == eng['streams']}; drain or "
            f"fill rows (base): {eng['profile']['drain_fill']}; bf16 "
            f"reduce_kernel launches (base) "
            f"{eng['profile']['bf16_reduce_launches']} "
            f"({eng['profile']['bf16_reduce_us'] / 1e3:.1f} ms) beside "
            f"{eng['profile']['encoder_launches']} encoder launches; dense "
            f"device busy {dprof['device_busy_s']:.3f} s of "
            f"{dprof['profiled_wall_s']:.2f} s wall, matmul rows "
            f"{dprof['matmul_rows']} for {dprof['launches']['quant_matmul']} "
            f"quant_matmul launches, drain or fill rows {dprof['drain_fill']}"
            f", device kernel launches {dprof['kernel_launches']} (base "
            f"{eng['profile']['kernel_launches']}); dense traces taken "
            f"{len(dprof['attempts'])}: {dprof['attempts']}")
        # the dense matmul is one kernel a call: its instance's row counts
        # the wrapper's launches, and no drain or fill comes with it (the
        # engine's own fills, in both runs, are the only ones)
        want = dprof["launches"]["quant_matmul"]
        if not want or [r["launches"] for r in dprof["matmul_rows"]] != \
                [want] or fills[1] > fills[0]:
            raise AssertionError(
                f"the dense serve's matmul is not one kernel a call: "
                f"{dprof['matmul_rows']} for {want} launches, drain or fill "
                f"launches {fills[1]} (base {fills[0]})")
        del params, dense, packed
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        xc = [cross_check(dev, args.seed + i) for i in range(XC_SEEDS)]
        worst = max(xc, key=lambda r: r["rel_err"])
        log(f"[11] cross-check granite width 2L f32 cuda vs cpu, "
            f"{XC_SEEDS} seeds: worst max |dlogit| "
            f"{worst['max_abs_logit_err']:.3g} of max |logit| "
            f"{worst['max_abs_logit']:.3g} ({worst['rel_err']:.3g} rel, "
            f"tol {LOGIT_TOL} rel), greedy tokens "
            f"{', '.join(r['greedy_match'] for r in xc)}, "
            f"{time.perf_counter() - t0:.1f} s")
        # phase 12: yi-6b, starcoder2-3b and deepseek-moe-16b at full
        # width and depth, their 2-layer f32 cross-checks, serve --ckpt
        zoo = {}
        for arch in ZOO:
            t0 = time.perf_counter()
            zoo[arch] = serve_zoo_arch(dev, arch, args.seed)
            zoo[arch]["cross_check"] = xz = cross_check(dev, args.seed, arch)
            log(f"[12] {arch} cross-check 2L f32 cuda vs cpu: max |dlogit| "
                f"{xz['max_abs_logit_err']:.3g} of max |logit| "
                f"{xz['max_abs_logit']:.3g} ({xz['rel_err']:.3g} rel, tol "
                f"{LOGIT_TOL_ARCH.get(arch, LOGIT_TOL)}), greedy tokens "
                f"{xz['greedy_match']}; "
                f"{time.perf_counter() - t0:.1f} s for the arch")
        t0 = time.perf_counter()
        detail["ckpt_round_trip"] = ckpt_round_trip(dev, args.seed)
        log(f"[12] serve --ckpt: the port's save of deepseek-moe-16b's smoke "
            f"float params served through the CLI on the card, streams equal "
            f"to the tree served directly "
            f"({detail['ckpt_round_trip']['requests']} requests), "
            f"{time.perf_counter() - t0:.1f} s")
        # phase 13: tensor-parallel serving, ranks sharing the card
        t0 = time.perf_counter()
        tp_rows = check_scale_in_batched(dev, gen, peaks)
        tpd, tp_runs = tensor_parallel(dev, args.seed, eng)
        for r in tp_rows:
            log(f"[13] {r['name']}: ok (err {r['max_abs_err']:.3g}), "
                f"{r['ms'] * 1e3:.1f} us vs plain {r['plain_ms'] * 1e3:.1f} "
                f"us, bound {r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}) "
                f"at {r['shape']}")
        ops = "; ".join(f"{t}: " + ", ".join(
            f"{k} {v}" for k, v in o.items()) for t, o in tpd["ops"].items())
        log(f"[13] gloo collectives on CUDA tensors over the mesh groups "
            f"(all-reduce MAX and SUM, all-gather): {ops}")
        rc = tpd["row_count_4_vs_8"]
        log(f"[13] granite-8b {cfg.n_layers}L row count: a 4-row decode "
            f"step against the same rows of the 8-row step (one card, no "
            f"mesh): logits differing {rc['logits']}/{rc['of']}; 4 rows "
            f"inside 8: rms_norm f32 {rc['norm_f32']}/{4 * cfg.d_model}, "
            f"bf16 {rc['norm_bf16']}, tied head {rc['head']}/{rc['of']}; "
            f"the sharded steps norm their rows at their global places in a "
            f"zero-padded batch of 8 and gather the rows before the head")
        for (tag, name), rs in tp_runs.items():
            if name in ("ops", "decode"):
                continue
            r = rs[0]
            log(f"[13] mesh {tag} {name}: {r['layers']}L d={r['d_model']}, "
                f"streams equal to the single-device serve's on all "
                f"{len(rs)} ranks, weight shards = the parent's cut, "
                f"{tp_summary(r)} (rank 0), launches "
                f"{ {k: v for k, v in r['launches'].items() if v} }")
        log(f"[13] one decode step at {cfg.n_layers}L, logits bit-equal to "
            f"the single-device step's at meshes "
            f"{', '.join(f'{d}x{m}' for d, m in TP_MESHES)} on every rank; "
            f"NCCL + CUDA graphs: {tpd['nccl']}; deepseek-moe-16b "
            f"{MOE_TP_LAYERS}L single device {tp_summary_single(tpd)}; "
            f"{time.perf_counter() - t0:.1f} s")
        rows += tp_rows
        # phase 15: the gemma family through --legacy, last of the serves
        # (phases 12 and 13 freed their trees)
        gc.collect()
        torch.cuda.empty_cache()
        t15 = time.perf_counter()
        gemma = {}
        for arch in GEMMA_SERVES:
            t0 = time.perf_counter()
            gemma[arch] = r = serve_gemma(dev, arch, args.seed)
            r["cross_check"] = xg = legacy_cross_check(dev, arch, args.seed)
            shape = GEMMA_SERVES[arch]
            pre = f"{r['n_prefix']} patches + " if r["n_prefix"] else ""
            log(f"[15] {card}: {arch} {r['layers']}L d={r['d_model']} "
                f"--legacy {shape['batch']} x ({pre}{shape['tokens']}) x "
                f"{shape['gen']}: prefill {r['prefill_s'] * 1e3:.1f} ms, "
                f"decode {r['decode_step_s'] * 1e3:.2f} ms/step over "
                f"{r['decode_timed_steps']} graph replays (of "
                f"{r['decode_steps']} steps; warm-up and capture "
                f"{r['decode_warmup_s'] * 1e3:.1f} ms), launches "
                f"{ {k: v for k, v in r['launches'].items() if v} }, weights "
                f"{r['weights_gb']:.2f} GB built in {r['build_s']:.1f} s "
                f"(build peak {r['build_peak_gb']:.1f} GB), serve peak "
                f"{r['peak_mem_gb']:.1f} GB; decode step replayed vs eager "
                f"at {r['layers']}L, bits equal: {r['replay_vs_eager']}; "
                f"{prefill_replay_note(r['prefill_replay'])}; "
                f"2L f32 {xg['config']} cuda vs cpu: max |dlogit| "
                f"{xg['max_abs_logit_err']:.3g} of max |logit| "
                f"{xg['max_abs_logit']:.3g} ({xg['rel_err']:.3g} rel, tol "
                f"{LOGIT_TOL}), greedy tokens {xg['greedy_match']}; "
                f"{time.perf_counter() - t0:.1f} s")
        cli = legacy_cli(GEMMA_SERVES, ("window=", "got vlm"))
        log(f"[15] serve --legacy --smoke on the card: "
            + "; ".join(f"{a}: hidden MSB4 sparsity {sp:.4f}, without "
                        f"--legacy exits: {msg!r}"
                        for a, (sp, msg) in cli.items())
            + f"; phase 15 {time.perf_counter() - t15:.1f} s")
        detail["gemma"] = {"serves": gemma, "cli": cli}
        # phase 22a: the dry-run's four cells planned on the host, beside
        # phases 16-21 on the card
        dry = start_dryrun()
        # phase 16: deepseek-v3-671b through --legacy, after phase 15
        # freed the gemma trees
        t16 = time.perf_counter()
        v3 = serve_deepseek_v3(dev, args.seed)
        log(f"[16] {card}: deepseek-v3-671b {v3['layers']}L "
            f"d={v3['d_model']} (3 dense + 4 MoE layers, MTP block) "
            f"--legacy {V3_SERVE['batch']} x {V3_SERVE['tokens']} x "
            f"{V3_SERVE['gen']}: weights {v3['weights_gb']:.2f} GB built "
            f"in {v3['build_s']:.1f} s (build peak "
            f"{v3['build_peak_gb']:.1f} GB), prefill "
            f"{v3['prefill_s'] * 1e3:.1f} ms, decode "
            f"{v3['decode_step_s'] * 1e3:.2f} ms/step over "
            f"{v3['decode_timed_steps']} graph replays (of "
            f"{v3['decode_steps']} steps; warm-up and capture "
            f"{v3['decode_warmup_s'] * 1e3:.1f} ms), serve peak "
            f"{v3['peak_mem_gb']:.1f} GB, launches "
            f"{ {k: v for k, v in v3['launches'].items() if v} }; "
            f"{rows_ab_note(v3['rows_ab'])}; decode "
            f"step replayed vs eager at {v3['layers']}L, logits and caches "
            f"bit-equal: {v3['replay_vs_eager']}; "
            f"{prefill_replay_note(v3['prefill_replay'])}; MTP logits "
            f"{v3['mtp_shape']} finite in {v3['mtp_s'] * 1e3:.1f} ms")
        t0 = time.perf_counter()
        xv = deepseek_cross_check(dev, args.seed)
        v3["cross_check"] = xv
        v3["cli"] = cli3 = legacy_cli(("deepseek-v3-671b",),
                                      ("mixer='mla'",))["deepseek-v3-671b"]
        log(f"[16] deepseek-v3-671b 2L f32 {xv['config']} cuda vs cpu: max "
            f"|dlogit| {xv['max_abs_logit_err']:.3g} of max |logit| "
            f"{xv['max_abs_logit']:.3g} ({xv['rel_err']:.3g} rel, tol "
            f"{LOGIT_TOL_ARCH.get('deepseek-v3-671b', LOGIT_TOL)}), MTP "
            f"logits {xv['mtp_rel_err']:.3g} rel, greedy tokens "
            f"{xv['greedy_match']} (the card fed the CPU's tokens; "
            f"{xv['near_ties']} near-ties, top-2 gap <= {V3_XC_TIE}; parted "
            f"(seq, step, top-2 gap, max |dlogit|): {xv['parted']}); serve --legacy --smoke: hidden MSB4 "
            f"sparsity {cli3[0]:.4f}, without --legacy exits: {cli3[1]!r}; "
            f"{time.perf_counter() - t0:.1f} s; phase 16 "
            f"{time.perf_counter() - t16:.1f} s")
        detail["deepseek_v3"] = v3
        # phase 17: the SSD family through --legacy, after phase 16 freed
        # its trees
        t17 = time.perf_counter()
        ssd = {}
        for arch in SSD_SERVES:
            t0 = time.perf_counter()
            ssd[arch] = r = serve_ssd(dev, arch, args.seed, peaks)
            r["cross_check"] = xs = legacy_cross_check(dev, arch, args.seed)
            log(f"[17] {card}: {arch} {r['layers']}L d={r['d_model']} "
                f"--legacy {SSD_SERVE['batch']} x {SSD_SERVE['tokens']} x "
                f"{SSD_SERVE['gen']}: weights {r['weights_gb']:.2f} GB built "
                f"in {r['build_s']:.1f} s (build peak "
                f"{r['build_peak_gb']:.1f} GB), prefill "
                f"{r['prefill_s'] * 1e3:.1f} ms (logits and SSD states "
                f"finite: {r['prefill_finite']}, max |logit| "
                f"{r['prefill_max_abs_logit']:.3g}), decode "
                f"{r['decode_step_s'] * 1e3:.2f} ms/step over "
                f"{r['decode_timed_steps']} graph replays (of "
                f"{r['decode_steps']} steps; warm-up and capture "
                f"{r['decode_warmup_s'] * 1e3:.1f} ms), byte floor "
                f"{r['decode_floor_ms']:.3f} ms for "
                f"{r['decode_floor_gb']:.3f} GB a step (SSD states "
                f"{r['state_mb']:.1f} MB read and written), replay at "
                f"{r['floor_share']:.3f} of the floor; serve peak "
                f"{r['peak_mem_gb']:.1f} GB, launches "
                f"{ {k: v for k, v in r['launches'].items() if v} } "
                f"({r['per_forward']} a forward); "
                + (f"{rows_ab_note(r['rows_ab'])}; " if "rows_ab" in r
                   else "")
                + f"decode step replayed vs "
                f"eager at {r['layers']}L, logits and states bit-equal: "
                f"{r['replay_vs_eager']}; "
                f"{prefill_replay_note(r['prefill_replay'])}; 2L f32 "
                f"{xs['config']} cuda vs cpu: "
                f"max |dlogit| {xs['max_abs_logit_err']:.3g} of max |logit| "
                f"{xs['max_abs_logit']:.3g} ({xs['rel_err']:.3g} rel, tol "
                f"{LOGIT_TOL_ARCH.get(arch, LOGIT_TOL)}), greedy tokens "
                f"{xs['greedy_match']}; {time.perf_counter() - t0:.1f} s")
        cli = legacy_cli(SSD_SERVES, ("mixer='ssd'",))
        log(f"[17] serve --legacy --smoke on the card: "
            + "; ".join(f"{a}: hidden MSB4 sparsity {sp:.4f}, without "
                        f"--legacy exits: {msg!r}"
                        for a, (sp, msg) in cli.items())
            + f"; phase 17 {time.perf_counter() - t17:.1f} s")
        detail["ssd"] = {"serves": ssd, "cli": cli}
        # phase 18: training, after phase 17 freed its trees
        t18 = time.perf_counter()
        lm = train_lm(dev, args.seed)
        st = lm["steps"]
        log(f"[18] {card}: {lm['arch']} {lm['layers']}L d={lm['d_model']} "
            f"trained at full width and depth (bf16 compute, f32 masters, "
            f"bf16 moments: state {lm['state_gb']:.2f} GB built in "
            f"{lm['build_s']:.1f} s), {TRAIN['batch']} x {TRAIN['seq']} "
            f"SyntheticLM batch, microbatches of "
            f"{TRAIN_KNOBS['microbatch']}, CE chunks of "
            f"{TRAIN_KNOBS['ce_chunk']}, remat: losses "
            f"{[round(r['loss'], 4) for r in st]}, grad norms "
            f"{[round(r['grad_norm'], 4) for r in st]}, step ms "
            f"{[round(r['ms'], 1) for r in st]} (steps 2-3 mean "
            f"{sum(r['ms'] for r in st[1:]) / len(st[1:]):.1f} ms, "
            f"synchronized), peak {lm['peak_gb']:.2f} GB; trained tree "
            f"quantized in {lm['quantize_s']:.1f} s and served "
            f"({TRAIN_SERVE['batch']} x {TRAIN_SERVE['prompt_len']} + "
            f"{TRAIN_SERVE['gen']}, {lm['serve_steps']} engine steps, logits "
            f"finite: {lm['logits_finite']}), launches "
            f"{ {k: v for k, v in lm['launches'].items() if v} }")
        enc = train_encoder(dev, args.seed)
        st = enc["steps"]
        log(f"[18] {card}: {enc['arch']} {enc['layers']}L "
            f"d={enc['d_model']} (bidirectional) trained at full width and "
            f"depth, bf16, frames {ENCODER_TRAIN['batch']} x "
            f"{ENCODER_TRAIN['seq']} x {enc['d_model']}: state "
            f"{enc['state_gb']:.2f} GB, losses "
            f"{[round(r['loss'], 4) for r in st]}, grad norms "
            f"{[round(r['grad_norm'], 4) for r in st]}, step ms "
            f"{[round(r['ms'], 1) for r in st]}, peak {enc['peak_gb']:.2f} GB")
        cl = train_cli()
        log(f"[18] launch/train.main {TRAIN_CLI['arch']} --smoke on the card "
            f"in a child process (CUBLAS_WORKSPACE_CONFIG=:4096:8, "
            f"torch.use_deterministic_algorithms(True)): "
            f"{TRAIN_CLI['steps']} steps, --ckpt-every "
            f"{TRAIN_CLI['ckpt_every']}, clean losses "
            f"{[round(x, 4) for x in cl['clean']['losses'][::4]]} (every 4th)"
            f"; with --inject-fail {TRAIN_CLI['fail']} --async-ckpt: "
            f"{cl['restarts']} restart, {cl['fault']['steps_run']} steps run, "
            f"final params bit-equal to the clean run's: "
            f"{cl['params_bit_equal']}; --resume auto started at step "
            f"{cl['resume_start']}; "
            f"{cl['clean']['ms_per_step']:.1f} ms/step clean; phase 18 "
            f"{time.perf_counter() - t18:.1f} s")
        detail["train"] = {"lm": lm, "encoder": enc, "cli": cl}
        # phase 19: training on a (data, model) mesh sharing the card
        t19 = time.perf_counter()
        mt = mesh_train(dev, mesh_train_config(), args.seed)
        r0, ms = mt["ranks"][0], mt["serve"]
        log(f"[19] {card}: {mt['arch']} {mt['layers']}L "
            f"d={mt['d_model']} trained on a "
            f"{MESH_TRAIN['mesh'][0]}x{MESH_TRAIN['mesh'][1]} mesh of "
            f"ranks sharing the card over gloo (capacity factor "
            f"{mt['capacity_factor']:g}, {MESH_TRAIN['batch']} x "
            f"{MESH_TRAIN['seq']}, microbatches of "
            f"{MESH_TRAIN_KNOBS['microbatch']}): losses "
            f"{[round(x['loss'], 4) for x in r0['steps']]} against 1x1 "
            f"{[round(x['loss'], 4) for x in mt['single']]} (step 1 "
            f"rel {mt['loss_rel']:.2e}), grad norms "
            f"{[round(x['grad_norm'], 4) for x in r0['steps']]} against "
            f"{[round(x['grad_norm'], 4) for x in mt['single']]} (rel "
            f"{mt['gnorm_rel']:.2e}); step ms rank 0 "
            f"{[round(x['ms'], 1) for x in r0['steps']]}, 1x1 "
            f"{[round(x['ms'], 1) for x in mt['single']]}; peaks GB "
            f"{[round(r['peak_gb'], 2) for r in mt['ranks']]} (sum "
            f"{mt['peak_sum_gb']:.2f}; 1x1 {mt['single_peak_gb']:.2f}), "
            f"state a rank {r0['state_gb']:.2f} GB built in "
            f"{r0['build_s']:.1f} s; {mt['replicated_leaves']} leaves "
            f"whole over model bit-equal across ranks: "
            f"{mt['replicated_equal']}; world {mt['world_s']:.1f} s")
        log(f"[19] {card}: the 2x2-trained tree gathered onto rank 0 "
            f"({r0['gather_s']:.1f} s), quantized in {ms['quantize_s']:.1f} "
            f"s and served there ({TRAIN_SERVE['batch']} x "
            f"{TRAIN_SERVE['prompt_len']} + {TRAIN_SERVE['gen']}, "
            f"{ms['serve_steps']} engine steps, logits finite: "
            f"{ms['logits_finite']}), launches "
            f"{ {k: v for k, v in ms['launches'].items() if v} }")
        mcl = train_cli(mesh=True)
        log(f"[19] launch/train.main {TRAIN_CLI['arch']} --smoke "
            f"--data-axis {MESH_CLI_AXIS} --dist-backend gloo in a child "
            f"process (deterministic algorithms): clean losses "
            f"{[round(x, 4) for x in mcl['clean']['losses'][::4]]} (every "
            f"4th); with --inject-fail {TRAIN_CLI['fail']} --async-ckpt: "
            f"{mcl['restarts']} restart, {mcl['fault']['steps_run']} steps "
            f"run, final params bit-equal to the clean run's: "
            f"{mcl['params_bit_equal']}; {mcl['clean']['ms_per_step']:.1f} "
            f"ms/step clean; phase 19 {time.perf_counter() - t19:.1f} s")
        detail["mesh_train"] = {"train": mt, "serve": ms, "cli": mcl}
        # phase 20: MLA and SSD layers trained on a model axis
        t20 = time.perf_counter()
        mls = mla_ssd_train(dev, args.seed)
        for arch in MLA_SSD_TRAIN:
            a = mls[arch]
            r0, sv = a["ranks"][0], a["serve"]
            log(f"[20] {card}: {arch} {a['layers']}L d={a['d_model']} "
                f"trained at {MLA_SSD_MESH[0]}x{MLA_SSD_MESH[1]} (ranks "
                f"sharing the card over gloo; {MESH_TRAIN['batch']} x "
                f"{MESH_TRAIN['seq']}, microbatches of "
                f"{MESH_TRAIN_KNOBS['microbatch']}, CE chunks of "
                f"{MESH_TRAIN_KNOBS['ce_chunk']}): loss "
                f"{r0['steps'][0]['loss']:.6f} against 1x1 "
                f"{a['single'][0]['loss']:.6f} (rel {a['loss_rel']:.2e}), "
                f"grad norm {r0['steps'][0]['grad_norm']:.6f} against "
                f"{a['single'][0]['grad_norm']:.6f} (rel "
                f"{a['gnorm_rel']:.2e}); step ms rank 0 "
                f"{r0['steps'][0]['ms']:.1f}, 1x1 "
                f"{a['single'][0]['ms']:.1f}; peaks GB "
                f"{[round(r['peak_gb'], 2) for r in a['ranks']]} (sum "
                f"{a['peak_sum_gb']:.2f}; 1x1 {a['single_peak_gb']:.2f}), "
                f"state a rank {r0['state_gb']:.2f} GB built in "
                f"{r0['build_s']:.1f} s; {a['replicated_leaves']} leaves "
                f"and runs whole over model bit-equal across ranks: "
                f"{a['replicated_equal']}")
            log(f"[20] {card}: the 1x2-trained {arch} tree gathered onto "
                f"rank 0 ({r0['gather_s']:.1f} s), quantized in "
                f"{sv['quantize_s']:.1f} s and served through --legacy "
                f"({MLA_SSD_SERVE['batch']} x {MLA_SSD_SERVE['tokens']} + "
                f"{MLA_SSD_SERVE['gen']}: prefill {sv['prefill_s'] * 1e3:.1f}"
                f" ms, decode step {sv['decode_step_s'] * 1e3:.2f} ms, "
                f"logits finite: {sv['logits_finite']}), launches "
                f"{ {k: v for k, v in sv['launches'].items() if v} }")
        log(f"[20] world {mls['world_s']:.1f} s, 1x1 child "
            f"{mls['single_s']:.1f} s; phase 20 "
            f"{time.perf_counter() - t20:.1f} s")
        detail["mla_ssd_train"] = mls
        # phase 21: the examples and the static checks
        t21 = time.perf_counter()
        exs = examples_phase(dev, args.seed)
        qs, cb, fo, an = (exs[k] for k in ("quickstart", "calibrate",
                                           "failover", "analysis"))
        log(f"[21] {card}: examples/quickstart_torch.py at "
            f"{' x '.join(QUICKSTART_ARGV[1::2])}: dual pass = dense "
            f"bit for bit {qs['exact']}, launches {qs['launches']}, MSB4 "
            f"sparsity {qs['s0'] * 100:.1f}% -> {qs['s1'] * 100:.1f}% "
            f"clipped, {qs['skipped'] * 100:.0f}% of tiles skipped, cost "
            f"model latency -{qs['latency_saved']:.1f}% energy "
            f"-{qs['energy_saved']:.1f}%; {qs['s']:.1f} s (21a)")
        log(f"[21] {card}: examples/calibrate_and_serve_torch.py "
            f"{' '.join(CALIBRATE_ARGV)} (granite-8b {cb['layers']}L "
            f"d={cb['d_model']}): sweep (l, h) = {cb['lh']} and all "
            f"{cb['candidates']} candidates' sparsity equal to the CPU's, "
            f"Algorithm 1 ({cb['learned'][0]:.4f}, {cb['learned'][1]:.4f}) "
            f"|card - CPU| {cb['alg1_err']:.2e}, tokens[0] {cb['tokens']}, "
            f"launches {cb['launches']}; {cb['s']:.1f} s on the card, "
            f"{cb['cpu_s']:.1f} s for the CPU rerun (21b)")
        log(f"[21] {card}: examples/train_with_failover_torch.py "
            f"{' '.join(FAILOVER_ARGV)} ({fo['params_m']:.1f}M params): "
            f"{fo['restarts']} restart, {fo['steps_run']} steps run, "
            f"restored step {fo['restored_step']} bit-equal, loss "
            f"{fo['loss'][0]:.4f} -> {fo['loss'][1]:.4f}; {fo['s']:.1f} s "
            f"(21c)")
        log(f"[21] {card}: python -m repro_torch.analysis --check "
            f"--no-mesh in a child process: exit {an['rc']}, no stale "
            f"entry, {an['summary']}, "
            f"{an['seconds']:.1f} s beside 21a-c; phase 21 "
            f"{time.perf_counter() - t21:.1f} s")
        detail["examples"] = exs
        # phase 22: the dry-run's plan against rank 0 on the card, and the
        # --legacy steps on a (data, model) mesh
        t22 = time.perf_counter()
        plans = finish_dryrun(dry)
        log(f"[22] dry-run on the host: --list {plans['cells']} cells, "
            f"{plans['skips']} skips; planned on 16x16 (baseline, meta "
            f"tensors, rank 0 of a fake world of 256): " + "; ".join(
                f"{a} {sh}: peak {r['peak_b'] / 2**30:.2f} GiB (arguments "
                f"{r['memory']['argument_size_b'] / 2**30:.2f}), "
                f"{r['flops_hlo']:.3e} FLOPs, collectives "
                f"{r['collective_bytes']['total']:.3e} B, fits "
                f"{r['device_memory_of']}: {r['fits']}, traced in "
                f"{r['lower_s']} s" for (a, sh), r in
                plans["records"].items())
            + f"; {plans['s']:.1f} s beside phases 16-21 (22a)")
        mleg_state = start_mesh_legacy(args.seed)     # 22c beside 22b
        dcard = dryrun_on_card(dev, args.seed, plans["records"])
        log(f"[22] {card}: rank 0 of 16x16 on the card, random data, "
            f"collectives elided: " + "; ".join(
                f"{a} {sh}: peak {r['peak_b'] / 2**30:.3f} GiB measured, "
                f"{r['plan_b'] / 2**30:.3f} planned, step "
                f"{r['step_s'] * 1e3:.1f} ms (collectives elided, random "
                f"data), launches = traced ops"
                for (a, sh), r in dcard.items()) + " (22b, beside 22c)")
        mleg = finish_mesh_legacy(mleg_state)
        log(f"[22] {card}: granite-8b {MESH_LEGACY_LAYERS}L full width f32 "
            f"--legacy steps on a mesh, ranks sharing the card over gloo, "
            f"prefill {MESH_LEGACY_PROMPT} + {MESH_LEGACY_GEN} decode "
            f"tokens: " + "; ".join(
                f"{m} B={r['batch']}: tokens equal to one device "
                f"{r['tokens_equal']}, logits {r['logit_rel']:.2e} of max "
                f"(tol {LOGIT_TOL}), rank 0's 7p launches "
                f"{r['partial_launches']}" for m, r in mleg.items())
            + f" (22c); phase 22 {time.perf_counter() - t22:.1f} s")
        detail["dryrun"] = {
            "plans": {f"{a}__{sh}": r for (a, sh), r in
                      plans["records"].items()},
            "card": {f"{a}__{sh}": r for (a, sh), r in dcard.items()},
            "mesh_legacy": mleg}
        dry_launches = {k: sum(r["launches"][k] for r in dcard.values())
                        for k in next(iter(dcard.values()))["launches"]}
        launches = [mls[a]["serve"]["launches"] for a in MLA_SSD_TRAIN]
        mla_ssd_serve = {"launches": {k: sum(c[k] for c in launches)
                                      for k in launches[0]}}
        moe = zoo["deepseek-moe-16b"]
        runs = {"base": eng, "mesh_serve": ms,
                "dryrun_card": {"launches": dry_launches},
                "mla_ssd_serve": mla_ssd_serve, "spec": spec, "kv2": kv2,
                "quickstart": qs, "calibrate": cb,
                "dense": dn,
                "packed": pk, "packed_spec": pk_spec, "legacy": lg,
                "gemma3": gemma["gemma3-27b"],
                "paligemma": gemma["paligemma-3b"], "deepseek_v3": v3,
                **{f"moe_{k}" if k != "base" else "moe": v
                   for k, v in moe.items() if k != "cross_check"},
                **{f"tp_{n}": rs[0] for (t, n), rs in tp_runs.items()
                   if n.startswith("moe")}}
        detail["zoo"] = zoo
        strip = lambda r: {k: v for k, v in r.items()  # noqa: E731
                           if k != "aggregate"}
        detail.update(engine=strip(eng), graphs_vs_eager=gve,
                      spec_engine=strip(spec),
                      spec_aggregate={k: v for k, v in agg.items()
                                      if k.startswith(("spec_", "steps"))},
                      kv2_idle=strip(idle), kv2_engine=strip(kv2),
                      kv2_aggregate=agg2, dense_engine=strip(dn),
                      packed_engine=strip(pk), unpacked_again=strip(again),
                      packed_spec_engine=strip(pk_spec), legacy=lg,
                      after_profilers=strip(after),
                      cross_check=xc, build_s=t_build, tensor_parallel=tpd)
        for r in rows:
            key, phase = counter[r["name"]]
            r["launches"] = runs[phase]["launches"][key]
    else:
        rows += check_scale_in_batched(dev, gen, peaks)
        for r in rows:
            r["launches"] = 0
    (OUT / "chip_smoke.json").write_text(json.dumps(detail, indent=1,
                                                    default=str))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log("kernels: " + json.dumps([{k: r[k] for k in keys} for r in rows]))
    log(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
