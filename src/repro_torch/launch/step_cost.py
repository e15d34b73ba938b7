"""The work of one serving step, counted from its shapes.

The port's counterpart of the JAX package's ``launch/hlo_analysis.py``:
where the reference walks a step's optimized HLO, this module walks the
served param tree (a rank's shard under tensor parallelism) and the
step's shapes, and returns what one call of the step computes and moves
on one rank:

  * ``flops``: 2·M·K·N for each pass of every projection (two passes for
    a SPARQLe projection, one for the draft's LSB4-only pass and for the
    dense mode), routed experts at their E x capacity rows as the batched
    kernel computes them, the MoE router's f32 product and the head at
    the rows the step computes; attention 4·H·hd for each (query, key)
    pair over the block table's full width (``n_page_steps x
    page_size``), as the reference's attention program computes it (the
    prefill chunk's queries also see the chunk's own keys). On the
    reference's ``tiny-attr`` configuration these are the reference's
    attributed FLOPs in all four phases.
  * ``hbm_bytes``: a FLOOR on the step's HBM traffic, by the per-kernel
    rules of :func:`encoder_bytes`, :func:`matmul_work` and
    :func:`attention_work` (``chip_smoke.py``'s kernel bounds call the
    same three): each kernel's inputs read once and its outputs written
    once — the encoder's x, mask, planes (as the wire
    format holds them), tile populations and scale; the matmul's planes
    (the MSB plane for every tile: attribution is static), packed int4
    weights, scales and f32 output; each sequence's KV pages read once a
    KV head over the table's width at (hd/2 + 4) bytes a token for K and
    again for V ((hd/4 + 4) for a KV2 page, at the share of the table a
    KV2 engine measured its decodes reading), the pages written, q and the
    attention output; the head's weight and logits; the embedding rows.
    It is not the reference's byte proxy (the operands and results of
    every top-level HLO op, the whole pool state at every op), and the
    glue between kernels (norms, RoPE, residual adds, casts) is not in
    it.
  * ``coll_bytes``: collective payload by kind, as the reference names
    them (``all-reduce``, ``all-gather``, ``total``), counted as the
    results the rank receives: under a model axis each row-parallel site
    does one f32 MAX all-reduce of its rows' amax and one int32 SUM
    all-reduce of its M·N accumulator, and an untied head all-gathers its
    vocab shards; under a data axis the decode, draft and verify steps
    all-gather the flat rows before every MoE routing, the hidden rows
    before the head and their per-layer telemetry, and the replicated
    prefill chunk hands its owner's logits and telemetry to every data
    rank through f32 SUM all-reduces.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core.packing import pad_k
from repro_torch.core.qlinear import SparqleLinear
from repro_torch.distributed.tp import _ROW_KEYS
from repro_torch.kernels.ref import TILE_K, TILE_M
from repro_torch.models.moe import capacity
from repro_torch.models.stages import build_stages

PHASES = ("prefill", "decode", "draft", "verify")
# telemetry keys a telemetered step gathers over the data axis
_TELEMETRY_KEYS = 3


@dataclasses.dataclass(frozen=True)
class StepWork:
    """What ONE call of a step computes and moves on one rank."""
    flops: float
    hbm_bytes: float
    coll_bytes: Dict[str, float]


class _Tally:
    def __init__(self):
        self.flops = 0.0
        self.bytes = 0.0
        self.reduce = 0.0
        self.gather = 0.0

    def work(self) -> StepWork:
        return StepWork(self.flops, self.bytes, {
            "all-reduce": self.reduce, "all-gather": self.gather,
            "total": self.reduce + self.gather})


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def encoder_bytes(m: int, k: int, *, xb: int, mask: int,
                  planes: float) -> float:
    """The encoder's traffic: x (M x K at ``xb`` bytes) and ``mask``
    bytes of column mask read, the M f32 scales and ``planes`` bytes of
    planes and tile populations written."""
    return m * k * xb + mask + m * 4 + planes


def matmul_work(m: int, k: int, n: int, *, plane_row: float,
                passes: float) -> Tuple[float, float]:
    """(bytes, ops) of one W4A8 matmul call: ``plane_row`` bytes a row of
    one activation plane read once a pass, the int4 weights (K·N/2), the
    M + N f32 scales and the f32 M x N output; 2·M·K·N ops a pass.
    ``passes`` is 2 for the dual pass counted statically, 1 for a draft
    or the dense entry, and 1 + the share of live tiles where a
    measurement knows the MSB plane's populations."""
    return (m * plane_row * passes + k * n // 2 + m * 4 + n * 4 + m * n * 4,
            2.0 * m * k * n * passes)


def attention_work(queries: int, heads: int, hd: int, kv_heads: int, *,
                   kv4_tokens: float, pairs: float, qb: int,
                   kv2_tokens: float = 0.0) -> Tuple[float, float]:
    """(bytes, flops) of one paged attention call: q and its output
    (``queries`` x ``heads`` x ``hd`` at ``qb`` bytes), ``kv4_tokens``
    tokens of KV4 pages read once a KV head at (hd/2 + 4) bytes for K and
    again for V, ``kv2_tokens`` of KV2 pages at (hd/4 + 4); 4·heads·hd
    flops for each of ``pairs`` (query, key) pairs."""
    nbytes = (2 * queries * heads * hd * qb
              + kv4_tokens * kv_heads * 2 * (hd // 2 + 4)
              + kv2_tokens * kv_heads * 2 * (hd // 4 + 4))
    return nbytes, 4.0 * pairs * heads * hd


def _linear(t: _Tally, sl: SparqleLinear, m: int, *, xb: int, draft: bool,
            row_site: bool, expert: bool = False) -> None:
    """One projection of ``m`` rows (``expert``: ``m`` rows for each of
    its E experts): the encoder and the matmul kernels. Shapes are read
    from the trailing dims, so a layer-stacked weight counts one layer."""
    q = sl.w.q
    k = q.shape[-2] * 2 if sl.packed else q.shape[-2]
    n = q.shape[-1]
    e = q.shape[-3] if expert else 1
    passes = 1 if sl.mode == "dense" or draft else 2
    pops = _cdiv(m, TILE_M) * _cdiv(k, TILE_K) * 4
    if sl.mode == "dense":
        planes, plane_row = m * k, k
    elif sl.wire_format == "packed":
        kp = pad_k(k)
        planes, plane_row = m * kp + m * kp // 8 + pops, kp // 2
    else:
        planes, plane_row = 2 * m * k + pops, k
    mask = k if sl.col_mask is not None else 0
    mm_bytes, ops = matmul_work(m, k, n, plane_row=plane_row, passes=passes)
    t.flops += e * ops
    t.bytes += e * (encoder_bytes(m, k, xb=xb, mask=mask, planes=planes)
                    + mm_bytes)
    if row_site:
        t.reduce += e * (m * 4 + m * n * 4)


def _layer_linears(t: _Tally, p, m: int, *, xb: int, draft: bool,
                   model_tp: bool, keys) -> None:
    for key in keys:
        sl = p.get(key)
        if isinstance(sl, SparqleLinear):
            _linear(t, sl, m, xb=xb, draft=draft,
                    row_site=model_tp and key in _ROW_KEYS)


def _moe(t: _Tally, cfg: ModelConfig, mp, tokens: int, *, xb: int,
         draft: bool, model_tp: bool, gathered: bool) -> None:
    """One routed-MoE call on ``tokens`` (the whole batch's) rows."""
    d = cfg.d_model
    n_exp = mp["w_router"].shape[-1]
    if gathered:
        t.gather += tokens * d * xb
    t.flops += 2.0 * tokens * d * n_exp
    t.bytes += (d * n_exp * mp["w_router"].element_size() + tokens * d * xb
                + tokens * n_exp * 4)
    cap = capacity(tokens, cfg.top_k, n_exp, cfg.capacity_factor)
    for key in ("w_gate", "w_up", "w_down"):
        _linear(t, mp[key], cap, xb=xb, draft=draft,
                row_site=model_tp and key == "w_down", expert=True)
    _layer_linears(t, mp, tokens, xb=xb, draft=draft, model_tp=model_tp,
                   keys=("w_shared_gate", "w_shared_up", "w_shared_down"))


def step_cost(cfg: ModelConfig, params, phase: str, *, rows: int,
              table_tokens: int, window: int = 1, data_ways: int = 1,
              model_ways: int = 1, kv2_share: float = 0.0) -> StepWork:
    """The work of one call of ``phase`` on one rank.

    ``params`` is the served tree this rank holds (its shard under a
    model axis). ``rows``: the prefill chunk's width, or the decode
    slots of the whole batch (each data rank runs ``rows / data_ways``
    of them); ``table_tokens`` the block table's width in tokens;
    ``window`` the verify window's tokens a slot (γ + 1); ``kv2_share``
    the share of table tokens read from KV2 pages.
    """
    if phase not in PHASES:
        raise ValueError(f"phase {phase!r}: expected one of {PHASES}")
    t = _Tally()
    xb = 4 if cfg.dtype == "float32" else 2
    hd = cfg.hd
    draft = phase == "draft"
    model_tp = model_ways > 1
    sharded = data_ways > 1 and phase != "prefill"
    if phase == "prefill":
        seqs, queries, keys, moe_calls, moe_tokens, head_rows = (
            1, rows, table_tokens + rows, 1, rows, 1)
    else:
        if rows % data_ways:
            raise ValueError(f"rows={rows} do not split over {data_ways} "
                             f"data ways")
        seqs = rows // data_ways
        w = window if phase == "verify" else 1
        queries, keys, moe_calls, moe_tokens, head_rows = (
            seqs * w, table_tokens, w, rows, rows * w)
    kv_reads = seqs * table_tokens       # table tokens, every sequence
    n_layers = 0
    for si, stage in enumerate(build_stages(cfg)):
        sp = params["stages"][f"s{si}"]
        for pi, ld in enumerate(stage.period):
            p = sp[f"p{pi}"]           # layer-stacked: shapes per layer
            n_layers += stage.repeat
            lt = _Tally()
            _layer_linears(lt, p, queries, xb=xb, draft=draft,
                           model_tp=model_tp, keys=("wq", "wk", "wv", "wo"))
            heads = p["wq"].w.q.shape[-1] // hd
            kv_heads = p["wk"].w.q.shape[-1] // hd
            nbytes, flops = attention_work(
                queries, heads, hd, kv_heads, qb=xb, pairs=queries * keys,
                kv4_tokens=kv_reads * (1 - kv2_share),
                kv2_tokens=kv_reads * kv2_share)
            lt.flops += flops
            # ... and the new tokens' K/V written to their KV4 pages
            lt.bytes += nbytes + queries * kv_heads * 2 * (hd // 2 + 4)
            if phase == "prefill":      # the chunk's own K/V, unquantized
                lt.bytes += 2 * rows * kv_heads * hd * xb
            if ld.ffn == "moe":
                for _ in range(moe_calls):
                    _moe(lt, cfg, p["moe"], moe_tokens, xb=xb, draft=draft,
                         model_tp=model_tp, gathered=sharded)
            else:
                _layer_linears(lt, p, queries, xb=xb, draft=draft,
                               model_tp=model_tp,
                               keys=("w_gate", "w_up", "w_down", "w_fc",
                                     "w_proj"))
            t.flops += lt.flops * stage.repeat
            t.bytes += lt.bytes * stage.repeat
            t.reduce += lt.reduce * stage.repeat
            t.gather += lt.gather * stage.repeat
    d, vocab = cfg.d_model, cfg.vocab
    table = params["embed"]["table"]
    t.bytes += queries * d * table.element_size()          # embedding rows
    if sharded:
        t.gather += head_rows * d * xb
        if phase != "draft":
            t.gather += _TELEMETRY_KEYS * n_layers * head_rows * 4
    elif data_ways > 1:     # the owner's logits, sparsity, layer telemetry
        t.reduce += (vocab + 1 + _TELEMETRY_KEYS * n_layers) * 4
    head = params.get("lm_head")
    if isinstance(head, SparqleLinear):
        _linear(t, head, head_rows, xb=xb, draft=draft, row_site=False)
        if model_tp and head.w.q.shape[-1] != vocab:
            t.gather += head_rows * vocab * xb
    else:                                   # the tied float table
        t.flops += 2.0 * head_rows * d * vocab
        t.bytes += (vocab * d * table.element_size() + head_rows * d * xb
                    + head_rows * vocab * xb)
    return t.work()
