"""Parameter schema of a decoder with GQA, MLA or SSD mixers and dense
(SwiGLU, GeGLU or GELU), MoE or no FFNs, and deepseek-v3's MTP block
(torch twin of ``repro.models.schema_builder``'s decoder parts). Every
leaf under ``stages/s<i>/p<j>`` (and ``mtp/block``) carries the leading
layer (repeat) axis, with the projection names ``core.qlinear``
quantizes."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.schema import ParamSpec, Schema
from repro_torch.models.stages import LayerDef, build_stages


def _norm_schema(cfg: ModelConfig, dim: int) -> Schema:
    if cfg.norm_type == "layer":
        return {"gamma": ParamSpec((dim,), (None,), init="ones"),
                "beta": ParamSpec((dim,), (None,), init="zeros")}
    return {"gamma": ParamSpec((dim,), (None,), init="zeros")}


def _attn_schema(cfg: ModelConfig) -> Schema:
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s: Schema = {
        "ln": _norm_schema(cfg, d),
        "wq": ParamSpec((d, h * hd), ("embed", "heads_flat")),
        "wk": ParamSpec((d, kvh * hd), ("embed", "heads_flat")),
        "wv": ParamSpec((d, kvh * hd), ("embed", "heads_flat")),
        "wo": ParamSpec((h * hd, d), ("heads_flat", "embed")),
    }
    if cfg.use_bias:
        s.update({
            "bq": ParamSpec((h * hd,), (None,), init="zeros"),
            "bk": ParamSpec((kvh * hd,), (None,), init="zeros"),
            "bv": ParamSpec((kvh * hd,), (None,), init="zeros"),
            "bo": ParamSpec((d,), (None,), init="zeros"),
        })
    if cfg.use_qk_norm:
        s["q_norm"] = ParamSpec((hd,), (None,), init="zeros")
        s["k_norm"] = ParamSpec((hd,), (None,), init="zeros")
    return s


def _mla_schema(cfg: ModelConfig) -> Schema:
    """deepseek-v3's MLA: the q low-rank pair with its norm, the joint
    compressed-KV + shared rope-key projection with the KV norm, the KV
    up-projection (absorbed at run time) and the output."""
    d, h = cfg.d_model, cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    rq, rkv = cfg.q_lora_rank, cfg.kv_lora_rank
    return {
        "ln": _norm_schema(cfg, d),
        "wq_a": ParamSpec((d, rq), ("embed", None)),
        "q_norm": ParamSpec((rq,), (None,), init="zeros"),
        "wq_b": ParamSpec((rq, h * (dn + dr)), (None, "heads_flat")),
        "wkv_a": ParamSpec((d, rkv + dr), ("embed", None)),
        "kv_norm": ParamSpec((rkv,), (None,), init="zeros"),
        "wkv_b": ParamSpec((rkv, h * (dn + dv)), (None, "heads_flat")),
        "wo": ParamSpec((h * dv, d), ("heads_flat", "embed")),
    }


def _ssd_schema(cfg: ModelConfig) -> Schema:
    """The Mamba-2 SSD mixer: the joint input projection to z, x, B, C and
    dt; the depthwise conv over x, B, C; A's log, the skip D, dt's bias,
    the gated norm's gain; the output projection."""
    d, din = cfg.d_model, cfg.d_inner
    g, n, p_ = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_head_dim
    nh = din // p_
    conv_ch = din + 2 * g * n
    return {
        "ln": _norm_schema(cfg, d),
        "w_in": ParamSpec((d, 2 * din + 2 * g * n + nh), ("embed", "mlp")),
        "conv_w": ParamSpec((cfg.conv_width, conv_ch), (None, "conv")),
        "conv_b": ParamSpec((conv_ch,), ("conv",), init="zeros"),
        "a_log": ParamSpec((g, nh // g), (None, None), init="zeros"),
        "d_skip": ParamSpec((g, nh // g), (None, None), init="ones"),
        "dt_bias": ParamSpec((nh,), (None,), init="zeros"),
        "gn": ParamSpec((din,), (None,), init="zeros"),
        "w_out": ParamSpec((din, d), ("mlp", "embed")),
    }


def _dense_ffn_schema(cfg: ModelConfig) -> Schema:
    d, f = cfg.d_model, cfg.d_ff
    s: Schema = {"ln2": _norm_schema(cfg, d)}
    if cfg.mlp_type in ("swiglu", "geglu"):
        s.update({
            "w_gate": ParamSpec((d, f), ("embed", "mlp")),
            "w_up": ParamSpec((d, f), ("embed", "mlp")),
            "w_down": ParamSpec((f, d), ("mlp", "embed")),
        })
    elif cfg.mlp_type == "gelu":      # plain (non-gated) GELU MLP
        s.update({
            "w_fc": ParamSpec((d, f), ("embed", "mlp")),
            "w_proj": ParamSpec((f, d), ("mlp", "embed")),
        })
        if cfg.use_bias:
            s["b_fc"] = ParamSpec((f,), ("mlp",), init="zeros")
            s["b_proj"] = ParamSpec((d,), (None,), init="zeros")
    else:
        raise NotImplementedError(f"mlp_type {cfg.mlp_type!r} is not ported")
    return s


def _moe_ffn_schema(cfg: ModelConfig) -> Schema:
    """Router, routed experts (E, D, F) / (E, F, D) and the shared
    experts folded into one wide SwiGLU."""
    d, e = cfg.d_model, cfg.n_experts
    f = cfg.moe_d_ff or cfg.d_ff
    moe: Schema = {
        "w_router": ParamSpec((d, e), ("embed", None)),
        "w_gate": ParamSpec((e, d, f), ("experts", "embed", None)),
        "w_up": ParamSpec((e, d, f), ("experts", "embed", None)),
        "w_down": ParamSpec((e, f, d), ("experts", None, "embed")),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        moe.update({
            "w_shared_gate": ParamSpec((d, fs), ("embed", "mlp")),
            "w_shared_up": ParamSpec((d, fs), ("embed", "mlp")),
            "w_shared_down": ParamSpec((fs, d), ("mlp", "embed")),
        })
    return {"ln2": _norm_schema(cfg, d), "moe": moe}


_MIXERS = {"attn": _attn_schema, "mla": _mla_schema, "ssd": _ssd_schema}
_FFNS = {"dense": _dense_ffn_schema, "moe": _moe_ffn_schema,
         "none": lambda cfg: {}}


def layer_schema(cfg: ModelConfig, ld: LayerDef) -> Schema:
    if ld.mixer not in _MIXERS or ld.ffn not in _FFNS:
        raise NotImplementedError(f"layer {ld} is not ported")
    return {**_MIXERS[ld.mixer](cfg), **_FFNS[ld.ffn](cfg)}


def _stack(schema: Schema, repeat: int) -> Schema:
    out: Schema = {}
    for k, v in schema.items():
        out[k] = (_stack(v, repeat) if isinstance(v, dict) else
                  ParamSpec((repeat,) + v.shape, ("layers",) + v.axes,
                            v.dtype, v.init, v.scale))
    return out


def build_schema(cfg: ModelConfig) -> Schema:
    d, v = cfg.d_model, cfg.vocab
    schema: Schema = {
        "embed": {"table": ParamSpec((v, d), ("vocab", "embed"),
                                     init="embed", scale=0.02)},
        "stages": {},
        "final_norm": _norm_schema(cfg, d),
    }
    for si, stage in enumerate(build_stages(cfg)):
        schema["stages"][f"s{si}"] = {
            f"p{pi}": _stack(layer_schema(cfg, ld), stage.repeat)
            for pi, ld in enumerate(stage.period)}
    if not cfg.tie_embeddings:
        schema["lm_head"] = ParamSpec((d, v), ("embed", "vocab"), scale=0.02)
    if cfg.mtp_depth:
        # deepseek-v3's multi-token prediction: one extra block a depth,
        # sharing the embedding and the head with the trunk
        mtp_ld = LayerDef("mla" if cfg.use_mla else "attn", "dense")
        mcfg = cfg if cfg.d_ff else cfg.replace(d_ff=cfg.moe_d_ff * 4)
        schema["mtp"] = {
            "norm_h": _norm_schema(cfg, d),
            "norm_e": _norm_schema(cfg, d),
            "proj": ParamSpec((2 * d, d), (None, "embed")),
            "block": _stack(layer_schema(mcfg, mtp_ld), cfg.mtp_depth),
        }
    return schema
