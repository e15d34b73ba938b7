"""Parameter schema of a dense GQA decoder (torch twin of the attention +
dense-FFN parts of ``repro.models.schema_builder``). Every leaf under
``stages/s<i>/p<j>`` carries the leading layer (repeat) axis, with the
projection names ``core.qlinear`` quantizes."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.schema import ParamSpec, Schema
from repro_torch.models.stages import LayerDef, build_stages


def _norm_schema(cfg: ModelConfig, dim: int) -> Schema:
    if cfg.norm_type != "rms":
        raise NotImplementedError("layer norm is not ported")
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
    if cfg.mlp_type != "swiglu":
        raise NotImplementedError(f"mlp_type {cfg.mlp_type!r} is not ported")
    d, f = cfg.d_model, cfg.d_ff
    return {
        "ln2": _norm_schema(cfg, d),
        "w_gate": ParamSpec((d, f), ("embed", "mlp")),
        "w_up": ParamSpec((d, f), ("embed", "mlp")),
        "w_down": ParamSpec((f, d), ("mlp", "embed")),
    }


def layer_schema(cfg: ModelConfig, ld: LayerDef) -> Schema:
    if ld.mixer != "attn" or ld.ffn != "dense":
        raise NotImplementedError(f"layer {ld} is not ported")
    return {**_attn_schema(cfg), **_dense_ffn_schema(cfg)}


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
