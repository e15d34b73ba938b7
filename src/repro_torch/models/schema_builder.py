"""Parameter schema of a GQA decoder with dense (SwiGLU, GeGLU or GELU)
or MoE FFNs (torch twin of the attention and FFN parts of
``repro.models.schema_builder``). Every leaf under
``stages/s<i>/p<j>`` carries the leading layer (repeat) axis, with the
projection names ``core.qlinear`` quantizes."""
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


def layer_schema(cfg: ModelConfig, ld: LayerDef) -> Schema:
    if ld.mixer != "attn" or ld.ffn not in ("dense", "moe"):
        raise NotImplementedError(f"layer {ld} is not ported")
    ffn = _dense_ffn_schema if ld.ffn == "dense" else _moe_ffn_schema
    return {**_attn_schema(cfg), **ffn(cfg)}


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
    return schema
