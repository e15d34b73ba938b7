"""Paged-serving subset of the unified model (torch twin of
``repro.models.model``): a full-attention GQA decoder served from a paged
packed-KV4 pool in SPARQLe mode.

Params keep the JAX tree layout — ``params["stages"]["s0"]["p0"]["wq"]``
with a leading layer axis — and the JAX ``lax.scan`` over layers is a
Python loop here. Every projection goes through
:func:`repro_torch.core.qlinear.linear`. The pool is updated IN PLACE:
the JAX steps donate the pool buffer and return a new one; writing into
the stacked page tensors directly saves the whole-pool copy the
functional form would cost, and each function still returns the pool for
symmetry with its JAX twin. Prefill attention is plain torch, as it is
plain jnp in the reference; decode attention runs the paged KV4 kernel.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.qlinear import linear, tree_index
from repro_torch.core.quantize import quantize_activations, quantize_weights
from repro_torch.core.sparqle import subprecision_sparsity
from repro_torch.kernels.kv_attention import kv4_paged_decode_attention
from repro_torch.kernels.ref import unpack_kv4
from repro_torch.models.layers import (NEG_INF, act_wire_telemetry, embed,
                                       rms_norm, rope,
                                       stack_sublayer_telemetry)
from repro_torch.models.stages import LayerDef, build_stages

Params = Dict[str, Any]
Cache = Dict[str, Any]


def _norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm_type != "rms":
        raise NotImplementedError("layer norm is not ported")
    return rms_norm(x, p["gamma"], cfg.rms_eps)


def _kv_quant(cfg: ModelConfig, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., hd) -> (nibbles packed two per byte along hd, f32 scale)."""
    qt = quantize_weights(x, bits=cfg.kv_bits, axis=-1)
    q = qt.q
    if cfg.kv_bits == 4 and q.shape[-1] % 2 == 0:
        q = ((q[..., 0::2] & 0xF) | ((q[..., 1::2] & 0xF) << 4)).to(
            torch.int8)
    return q, qt.scale[..., 0]


def _kv_dequant(cfg: ModelConfig, q: torch.Tensor, s: torch.Tensor,
                dtype) -> torch.Tensor:
    if cfg.kv_bits == 4:
        q = unpack_kv4(q)
    return (q.float() * s[..., None]).to(dtype)


def _attn_qkv(cfg: ModelConfig, p: Params, h: torch.Tensor, positions,
              theta: float):
    """h (..., D) -> q (..., H, hd), k/v (..., KVH, hd), roped."""
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = linear(h, p["wq"], p.get("bq"))
    k = linear(h, p["wk"], p.get("bk"))
    v = linear(h, p["wv"], p.get("bv"))
    q = q.reshape(*q.shape[:-1], H, hd)
    k = k.reshape(*k.shape[:-1], KVH, hd)
    v = v.reshape(*v.shape[:-1], KVH, hd)
    if cfg.use_qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.rms_eps)
        k = rms_norm(k, p["k_norm"], cfg.rms_eps)
    return rope(q, positions, theta), rope(k, positions, theta), v


def dense_ffn(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp_type != "swiglu":
        raise NotImplementedError(f"mlp_type {cfg.mlp_type!r} is not ported")
    h = _norm(cfg, p["ln2"], x)
    g = linear(h, p["w_gate"])
    g = g * torch.sigmoid(g)
    return linear(g * linear(h, p["w_up"]), p["w_down"])


def head_logits(cfg: ModelConfig, params: Params,
                x: torch.Tensor) -> torch.Tensor:
    x = _norm(cfg, params["final_norm"], x)
    if cfg.tie_embeddings:
        return linear(x, params["embed"]["table"].T)
    return linear(x, params["lm_head"])


def _embed(cfg: ModelConfig, params: Params,
           tokens: torch.Tensor) -> torch.Tensor:
    x = embed(tokens, params["embed"]["table"]).to(cfg.cdtype)
    if cfg.name.startswith("gemma"):
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.cdtype)
    return x


def check_paged_support(cfg: ModelConfig) -> None:
    """Raise unless every layer fits the paged attention serving path."""
    if cfg.family in ("encoder", "vlm"):
        raise NotImplementedError(
            f"paged serving needs a token-only decoder, got {cfg.family}")
    if cfg.kv_bits != 4 or cfg.hd % 2:
        raise NotImplementedError(
            f"paged pool stores packed int4 KV: kv_bits=4, even head_dim "
            f"required (got kv_bits={cfg.kv_bits}, hd={cfg.hd})")
    for stage in build_stages(cfg):
        for ld in stage.period:
            if ld.mixer != "attn" or ld.window:
                raise NotImplementedError(
                    f"paged serving supports full-attention GQA layers only "
                    f"(got mixer={ld.mixer!r}, window={ld.window})")


def _layers(cfg: ModelConfig, params: Params, pool: Cache):
    """Yield (LayerDef, layer params, layer pool) in depth order; the
    layer pool holds views into the stacked page tensors."""
    for si, stage in enumerate(build_stages(cfg)):
        sp = params["stages"][f"s{si}"]
        sc = pool["stages"][f"s{si}"]
        for rep in range(stage.repeat):
            for pi, ld in enumerate(stage.period):
                yield (ld, tree_index(sp[f"p{pi}"], rep),
                       {k: v[rep] for k, v in sc[f"p{pi}"].items()})


def _act_subprecision_sparsity(x: torch.Tensor) -> torch.Tensor:
    """Per-row MSB4 sparsity of the int8-quantized activations."""
    q = quantize_activations(x, bits=8, per_token=True).q
    return subprecision_sparsity(q, axis=-1)


def _write_kv(pool: Cache, page, off, kq, ks, vq, vs) -> None:
    pool["k_q"][page, off] = kq
    pool["k_s"][page, off] = ks
    pool["v_q"][page, off] = vq
    pool["v_s"][page, off] = vs


def attn_decode_paged(cfg: ModelConfig, ld: LayerDef, p: Params,
                      x: torch.Tensor, pool: Cache,
                      block_tables: torch.Tensor, pos: torch.Tensor
                      ) -> Tuple[torch.Tensor, Cache]:
    """One-token attention against the paged pool. x: (B, D)."""
    b, _ = x.shape
    kvh, g = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    theta = ld.rope_theta or cfg.rope_theta
    h = _norm(cfg, p["ln"], x)
    q, k_new, v_new = _attn_qkv(cfg, p, h, pos, theta)
    kq, ks = _kv_quant(cfg, k_new)
    vq, vs = _kv_quant(cfg, v_new)
    ps = pool["k_q"].shape[1]
    n_steps = block_tables.shape[1]
    bidx = torch.arange(b, device=x.device)
    page = block_tables[bidx, torch.clamp(pos // ps, 0, n_steps - 1).long()]
    _write_kv(pool, page.long(), (pos % ps).long(), kq, ks, vq, vs)
    o = kv4_paged_decode_attention(
        q.reshape(b, kvh, g, cfg.hd).contiguous(), pool["k_q"], pool["k_s"],
        pool["v_q"], pool["v_s"], block_tables, pos)
    o = o.reshape(b, cfg.n_heads * cfg.hd)
    return linear(o, p["wo"], p.get("bo")), pool


def decode_step_paged(cfg: ModelConfig, params: Params, pool: Cache,
                      token: torch.Tensor, pos: torch.Tensor,
                      block_tables: torch.Tensor
                      ) -> Tuple[torch.Tensor, Cache, Dict[str, torch.Tensor]]:
    """One continuous-batching decode step over the paged pool.

    token/pos (B,) int32, block_tables (B, Pmax) int32; inactive slots
    carry an all-zero table row and write into the null page 0. Returns
    (logits (B, V), pool, telemetry): ``sparsity`` (B,), and per layer
    (L, B) ``layer_sparsity`` / ``layer_wire_bytes`` /
    ``layer_dense_bytes`` of the hidden stream entering the layer.
    """
    x = _embed(cfg, params, token)
    tels = []
    for ld, p, lpool in _layers(cfg, params, pool):
        tels.append(act_wire_telemetry(x))
        y, _ = attn_decode_paged(cfg, ld, p, x, lpool, block_tables, pos)
        x = x + y
        x = x + dense_ffn(cfg, p, x[:, None, :])[:, 0]
    telemetry = {"sparsity": _act_subprecision_sparsity(x)}
    for key, v in stack_sublayer_telemetry(tels).items():
        telemetry[f"layer_{key}"] = v
    logits = head_logits(cfg, params, x[:, None, :])[:, 0]
    return logits, pool, telemetry


def _attn_prefill_chunk_paged(cfg: ModelConfig, ld: LayerDef, p: Params,
                              x: torch.Tensor, pool: Cache,
                              block_table: torch.Tensor, start: int,
                              valid: int) -> Tuple[torch.Tensor, Cache]:
    """Chunked-prefill attention for ONE sequence. x: (1, C, D).

    Queries attend to the dequantized pool for positions < start and to
    the float chunk K/V for the chunk itself."""
    _, c, _ = x.shape
    kvh, g, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.hd
    dev = x.device
    theta = ld.rope_theta or cfg.rope_theta
    h = _norm(cfg, p["ln"], x)
    ar = torch.arange(c, device=dev)
    positions = start + ar
    q, k, v = _attn_qkv(cfg, p, h, positions, theta)

    ps = pool["k_q"].shape[1]
    n_steps = block_table.shape[1]
    kq, ks = _kv_quant(cfg, k)
    vq, vs = _kv_quant(cfg, v)
    step = torch.clamp(positions // ps, 0, n_steps - 1)
    page = torch.where(ar < valid, block_table[0, step], 0).long()
    _write_kv(pool, page, (positions % ps).long(), kq[0], ks[0], vq[0], vs[0])

    tbl = block_table[0].long()
    kp = pool["k_q"][tbl].reshape(n_steps * ps, kvh, hd // 2)
    ksp = pool["k_s"][tbl].reshape(n_steps * ps, kvh)
    vp = pool["v_q"][tbl].reshape(n_steps * ps, kvh, hd // 2)
    vsp = pool["v_s"][tbl].reshape(n_steps * ps, kvh)
    k_cat = torch.cat([_kv_dequant(cfg, kp, ksp, torch.float32)[None],
                       k.float()], 1)
    v_cat = torch.cat([_kv_dequant(cfg, vp, vsp, torch.float32)[None],
                       v.float()], 1)

    lmax = n_steps * ps
    i = ar[:, None]
    j = torch.arange(lmax + c, device=dev)[None, :]
    allow = torch.where(j < lmax, j < start, (j - lmax) <= i)
    qg = q.reshape(1, c, kvh, g, hd).float()
    s = torch.einsum("bikgd,bjkd->bkgij", qg, k_cat) * hd ** -0.5
    s = torch.where(allow[None, None, None], s, NEG_INF)
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgij,bjkd->bikgd", pr, v_cat)
    o = o.reshape(1, c, cfg.n_heads * hd).to(x.dtype)
    return linear(o, p["wo"], p.get("bo")), pool


def prefill_chunk_paged(cfg: ModelConfig, params: Params, pool: Cache,
                        tokens: torch.Tensor, start: int, valid: int,
                        block_table: torch.Tensor
                        ) -> Tuple[torch.Tensor, Cache, Dict[str, torch.Tensor]]:
    """Prefill one chunk of ONE sequence into the paged pool.

    tokens (1, C) int32 (tail-padded; ``valid`` counts real tokens),
    ``start`` the absolute position of tokens[0, 0], block_table
    (1, Pmax). Returns (logits (1, V) at the last valid position, pool,
    telemetry over the chunk's valid tokens).
    """
    x = _embed(cfg, params, tokens)
    tels = []
    for ld, p, lpool in _layers(cfg, params, pool):
        tels.append(act_wire_telemetry(x))
        y, _ = _attn_prefill_chunk_paged(cfg, ld, p, x, lpool, block_table,
                                         start, valid)
        x = x + y
        x = x + dense_ffn(cfg, p, x)
    c = tokens.shape[1]
    valid_tok = (torch.arange(c, device=x.device) < valid).float()
    n_valid = max(float(min(max(valid, 0), c)), 1.0)
    sp_tok = _act_subprecision_sparsity(x[0])
    tel = {k: v[:, 0, :] for k, v in stack_sublayer_telemetry(tels).items()}
    telemetry = {
        "sparsity": (sp_tok * valid_tok).sum() / n_valid,
        "layer_sparsity": (tel["sparsity"] * valid_tok).sum(-1) / n_valid,
        "layer_wire_bytes": (tel["wire_bytes"] * valid_tok).sum(-1),
        "layer_dense_bytes": (tel["dense_bytes"] * valid_tok).sum(-1),
    }
    last = max(valid - 1, 0)
    logits = head_logits(cfg, params, x[:, last:last + 1])[:, 0]
    return logits, pool, telemetry
