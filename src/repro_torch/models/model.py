"""The unified model (torch twin of ``repro.models.model``): a GQA
decoder (RMSNorm or LayerNorm, optional qk-norm; a SwiGLU, GeGLU, biased
GELU or MoE FFN) or a bidirectional encoder (hubert: the stub frontend's
frames in, no decode step), trained on its float tree through
``forward_hidden`` (remat, the MoE load-balance loss) and served in
SPARQLe mode from a paged packed-KV4 pool (the engine: full-attention
token-only decoders, as JAX's ``check_paged_support`` allows) or from
one contiguous (B, Smax) packed-KV4 cache a layer (``prefill``/
``decode_step``, the fixed-batch ``serve --legacy`` path, which also
takes sliding-window layers and a VLM's bidirectional image prefix: the
gemma family; deepseek-v3's MLA layers, absorbed attention on a packed
compressed-KV cache, with its MTP head ``mtp_logits``; and Mamba-2's SSD
mixer, mamba2's and jamba's, on a recurrent state and conv tail a
layer).

Params keep the JAX tree layout — ``params["stages"]["s0"]["p0"]["wq"]``
with a leading layer axis — and the JAX ``lax.scan`` over layers is a
Python loop here. Every projection goes through
:func:`repro_torch.core.qlinear.linear`. The pool is updated IN PLACE:
the JAX steps donate the pool buffer and return a new one; writing into
the stacked page tensors directly saves the whole-pool copy the
functional form would cost, and each function still returns the pool for
symmetry with its JAX twin. Prefill attention is plain torch, as it is
plain jnp in the reference; decode attention runs the paged KV4 kernel
(the mixed KV4/KV2 tier kernel when the precision ladder is armed) and
the speculative verify window its multi-token twin. The contiguous
decode runs the contiguous KV4 kernel on the packed cache, which is
never dequantized in device memory (JAX dequantizes it to the compute
dtype and calls the plain ``decode_attention``: equal to rounding at
f32; at bf16 the two differ by the bf16 rounding of K/V).

Under tensor parallelism (``distributed/tp.py``: a step body runs inside
``tp_scope``) the same functions run a rank's shard, on a per-shard
config with the head counts divided by the model ways. The row-parallel
call sites are marked ``tp="row"`` (``wo``, ``w_down``, ``w_proj``, the
routed and shared experts' down projections) and the untied head
all-gathers its vocab shards over the model group. A data-sharded step
(decode, draft, verify: each data rank holds ``local_rows`` of the
decode slots) all-gathers the flat batch over the data group before MoE
routing (capacity and ranking are functions of the whole batch) and the
final hidden rows before the head, so every rank returns the whole
batch's logits; and it runs each norm on its rows placed at their global
positions in a zero-padded batch of the global row count: on the card
the f32 sum order of a row reduction follows the number of rows, so the
norms then give the single-device step's bits. Outside a TP context
nothing of this runs.

The ``--legacy`` steps on a mesh (``TPContext.serve_mesh``, section
"the --legacy steps on a (pod, data, model) mesh" below) hold every leaf
as its placement says, gather a layer over data before it runs and cut
the contiguous caches along their positions; the encoder prefills too.

A mesh train step (``TPContext.train``, ``launch/steps.py``) runs the
same functions on a rank's float shards under autograd: column-parallel
inputs through copy-to-model, row-parallel outputs through
reduce-from-model, the untied head's vocab shards gathered, attention on
the rank's heads (``shard_model_config``), and the MoE by
``moe_ffn_dist``'s rules (:func:`_moe_ffn_train`). MLA and SSD mixers
run the rank's heads too (:func:`mla_full`, :func:`ssd_full`): every
path from a tensor whole over model to the heads takes one copy-to-model,
placed after what every rank computes whole (the q and KV LoRA norms;
an SSD mixer's B and C, after its conv). Each data rank holds
its rows of every microbatch and norms them alone: training's contract
is a tolerance, so the zero-padded norm of serving is not used.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.qlinear import (ShardedLinear, SparqleLinear, linear,
                                      msb_skip_scope, tree_index)
from repro_torch.core.quantize import quantize_activations, quantize_weights
from repro_torch.core.sparqle import subprecision_sparsity
from repro_torch.distributed.tp import (all_gather, gather_from_model,
                                        gather_heads, model_input, tp_ctx,
                                        validate_tp_config)
from repro_torch.kernels.kv_attention import (
    CONTIGUOUS_BLOCK, kv4_decode_attention, kv4_decode_attention_partial,
    kv4_paged_decode_attention,
    kv4_paged_verify_attention, kv_tiered_paged_decode_attention)
from repro_torch.kernels.ref import unpack_kv4
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssd as ssd_lib
from repro_torch.models.layers import (NEG_INF, AttnSpec,
                                       act_wire_telemetry, blocks, embed,
                                       flash_attention, gelu_tanh, layer_norm,
                                       rms_norm, rope, silu, softmax,
                                       stack_sublayer_telemetry)
from repro_torch.models.stages import LayerDef, build_stages

Params = Dict[str, Any]
Cache = Dict[str, Any]


def _norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """The layer's norm on x (rows, ...). A data-sharded step's local rows
    run at their global positions in a zero-padded batch of the global
    row count (module docstring)."""
    def norm(r):
        if cfg.norm_type == "layer":
            return layer_norm(r, p["gamma"], p["beta"], cfg.rms_eps)
        return rms_norm(r, p["gamma"], cfg.rms_eps)

    ctx = tp_ctx()
    if ctx is None or ctx.batch_group is None or \
            x.shape[0] != ctx.local_rows:
        return norm(x)
    n, lo = x.shape[0], x.shape[0] * ctx.batch_rank
    padded = x.new_zeros((n * ctx.batch_ways,) + tuple(x.shape[1:]))
    padded[lo:lo + n] = x
    return norm(padded)[lo:lo + n]


def _gather_rows(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """A data-sharded step's batch dim ``dim`` of ``t`` gathered over the
    data group in slot order (``t`` itself otherwise)."""
    ctx = tp_ctx()
    if ctx is None or ctx.batch_group is None:
        return t
    return all_gather(t, ctx.batch_group, dim)


def _global_rows(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` of x (rows, ...), a product whose CPU GEMM's sum order
    follows the row count: a data-sharded mesh step runs it on every
    rank's rows (gathered in slot order) and keeps its own, so its bits
    are the one-device step's; ``fn(x)`` otherwise."""
    ctx = tp_ctx()
    if ctx is None or ctx.serve_mesh is None or ctx.batch_group is None:
        return fn(x)
    n = x.shape[0]
    return fn(_gather_rows(x))[ctx.batch_rank * n:(ctx.batch_rank + 1) * n]


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
              theta: float, window: bool = False):
    """h (..., D) -> q (..., H, hd), k/v (..., KVH, hd), roped. ``window``:
    h is a (B, T, D) verify window, whose q/k norms run per position."""
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = model_input(h)
    q = linear(h, p["wq"], p.get("bq"))
    k = linear(h, p["wk"], p.get("bk"))
    v = linear(h, p["wv"], p.get("bv"))
    if q.shape[-1] != H * hd:   # a train step that gathers the heads
        q, k, v = gather_heads(q), gather_heads(k), gather_heads(v)
    q = q.reshape(*q.shape[:-1], H, hd)
    k = k.reshape(*k.shape[:-1], KVH, hd)
    v = v.reshape(*v.shape[:-1], KVH, hd)
    if cfg.use_qk_norm:
        norm = _per_position if window else (lambda fn, x: fn(x))
        q = norm(lambda r: rms_norm(r, p["q_norm"], cfg.rms_eps), q)
        k = norm(lambda r: rms_norm(r, p["k_norm"], cfg.rms_eps), k)
    return rope(q, positions, theta), rope(k, positions, theta), v


def dense_ffn(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    return _mlp(cfg, p, _norm(cfg, p["ln2"], x))


def _mlp(cfg: ModelConfig, p: Params, h: torch.Tensor) -> torch.Tensor:
    """The dense FFN on its already-normed input: SwiGLU, GeGLU (the
    gemma family: the tanh GELU as the gate), or the plain tanh-GELU MLP
    with its biases."""
    h = model_input(h)
    if cfg.mlp_type == "gelu":
        return linear(gelu_tanh(linear(h, p["w_fc"], p.get("b_fc"))),
                      p["w_proj"], p.get("b_proj"), tp="row")
    if cfg.mlp_type not in ("swiglu", "geglu"):
        raise NotImplementedError(f"mlp_type {cfg.mlp_type!r} is not ported")
    act = silu if cfg.mlp_type == "swiglu" else gelu_tanh
    g = act(linear(h, p["w_gate"]))
    return linear(g * linear(h, p["w_up"]), p["w_down"], tp="row")


def moe_ffn(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
            with_aux: bool = False
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The MoE FFN on x (..., D): routed experts over the flattened
    tokens (capacity from their count), plus the shared experts. A
    data-sharded step routes the whole batch: the flat rows gathered over
    the data group (in global slot order, so dispatch, capacity and
    combine are the single-device ones), its own rows sliced back out.

    Returns (output, the load-balance aux loss, an f32 scalar over the
    routed rows, with ``with_aux``; None without: the serving steps never
    read it, as XLA drops it from JAX's)."""
    h = _norm(cfg, p["ln2"], x)
    flat = h.reshape(-1, h.shape[-1])
    ctx = tp_ctx()
    if ctx is not None and ctx.train:
        y, aux = _moe_ffn_train(cfg, p["moe"], flat, with_aux, ctx)
        return y.reshape(h.shape), aux
    t_local = flat.shape[0]
    flat = _gather_rows(flat)
    mp = p["moe"]
    sm, kw = _serve_mesh(), {}
    if sm is not None and mp["w_gate"].w.q.shape[0] != cfg.n_experts:
        # a mesh step's experts cut over model: the rank's run, summed
        kw = dict(expert_lo=sm.index("model") * mp["w_gate"].w.q.shape[0],
                  sum_group=sm.group("model"), down_tp=None)
    y = moe_lib.moe_ffn(flat, mp["w_router"], mp["w_gate"], mp["w_up"],
                        mp["w_down"], top_k=cfg.top_k,
                        capacity_factor=cfg.capacity_factor,
                        router_type=cfg.router_type, **kw)
    if cfg.n_shared_experts:
        y = y + moe_lib.shared_expert_ffn(flat, mp["w_shared_gate"],
                                          mp["w_shared_up"],
                                          mp["w_shared_down"])
    aux = (moe_lib.load_balance_loss(flat, mp["w_router"], cfg.top_k)
           if with_aux else None)
    if y.shape[0] != t_local:
        lo = tp_ctx().batch_rank * t_local
        y = y[lo:lo + t_local]
    return y.reshape(h.shape), aux


def _moe_ffn_train(cfg: ModelConfig, mp: Params, flat: torch.Tensor,
                   with_aux: bool, ctx) -> Tuple[torch.Tensor,
                                                 Optional[torch.Tensor]]:
    """A mesh train step's MoE on this data rank's rows flat (T_local, D):
    routed by ``moe_ffn_dist``'s rules, the shared experts column/row,
    and this rank's rows' term of the global aux loss (the top-k counts
    all-reduced over data)."""
    y = moe_lib.moe_ffn_dist(
        flat, mp["w_router"], mp["w_gate"], mp["w_up"], mp["w_down"],
        top_k=cfg.top_k, model_rank=ctx.model_rank, model_ways=ctx.ways,
        group=ctx.group, capacity_factor=cfg.capacity_factor,
        router_type=cfg.router_type)
    if cfg.n_shared_experts:
        y = y + moe_lib.shared_expert_ffn(flat, mp["w_shared_gate"],
                                          mp["w_shared_up"],
                                          mp["w_shared_down"])
    aux = (moe_lib.load_balance_loss(
        flat, mp["w_router"], cfg.top_k,
        count_group=ctx.data_group if ctx.data_ways > 1 else None)
        if with_aux else None)
    return y, aux


def check_train_mesh(cfg: ModelConfig, model_ways: int,
                     gather_heads: bool = False) -> None:
    """Raise unless a train step can shard ``cfg`` ``model_ways`` ways on
    the model axis: the TP divisibility checks (``validate_tp_config``:
    the attention and MLA heads, the KV heads, the FFN widths, an untied
    vocab, an SSD mixer's heads and B/C groups). GQA, MLA and SSD mixers
    all shard by head; the data axis alone trains every arch the
    one-device step trains. ``gather_heads``: GQA heads the model ways do
    not divide are gathered whole instead (every model rank attends every
    head; the dry-run's production meshes), so they are not checked."""
    if model_ways > 1:
        validate_tp_config(cfg, model_ways, heads=not gather_heads
                           or cfg.use_mla)


def _add_ffn(cfg: ModelConfig, ld: LayerDef, p: Params,
             x: torch.Tensor) -> torch.Tensor:
    """x (..., D) plus the layer's FFN (dense or MoE) on it; x itself for
    a layer without one (mamba2's ``ffn="none"``)."""
    if ld.ffn == "none":
        return x
    if ld.ffn == "moe":
        return x + moe_ffn(cfg, p, x)[0]
    return x + dense_ffn(cfg, p, x)


def head_logits(cfg: ModelConfig, params: Params,
                x: torch.Tensor) -> torch.Tensor:
    """Final norm and head. The tied head's table is replicated (token
    lookup needs all of it) but on a mesh step, whose table is cut by
    vocab over model; an untied head is column-parallel under TP. Vocab
    shards are all-gathered in model-rank order."""
    x = _norm(cfg, params["final_norm"], x)
    if cfg.tie_embeddings:   # whole, or cut by vocab on a mesh step
        logits = linear(x, params["embed"]["table"].T)
    else:
        w = params["lm_head"]
        whole = (w.w.q if isinstance(w, SparqleLinear) else w).shape[-1] \
            == cfg.vocab           # a head the model ways do not cut
        logits = linear(x if whole else model_input(x), w)
    ctx = tp_ctx()
    if ctx is not None and ctx.ways > 1 and logits.shape[-1] != cfg.vocab:
        logits = (gather_from_model(logits) if ctx.train else
                  all_gather(logits, ctx.group, logits.ndim - 1))
    return logits


def _embed(cfg: ModelConfig, params: Params,
           tokens: torch.Tensor) -> torch.Tensor:
    x = _lookup(cfg, params, tokens).to(cfg.cdtype)
    if cfg.family == "vlm" or cfg.name.startswith("gemma"):  # gemma scaling
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.cdtype)
    return x


def _check_kv4(cfg: ModelConfig, what: str, mla: bool = False) -> None:
    """Packed KV4 needs kv_bits 4 and an even width of what is packed:
    the head dim, or MLA's compressed KV (``kv_lora_rank``)."""
    name, short, width = (("kv_lora_rank", "kv_lora_rank",
                           cfg.kv_lora_rank) if mla
                          else ("head_dim", "hd", cfg.hd))  # JAX's words
    if cfg.kv_bits != 4 or width % 2:
        raise NotImplementedError(
            f"{what} stores packed int4 KV: kv_bits=4, even {name} "
            f"required (got kv_bits={cfg.kv_bits}, {short}={width})")


def check_paged_support(cfg: ModelConfig) -> None:
    """Raise unless every layer fits the paged attention serving path
    (the engines): JAX's check, refusing windows and VLMs too."""
    if cfg.family in ("encoder", "vlm"):
        raise NotImplementedError(
            f"paged serving needs a token-only decoder, got {cfg.family}")
    _check_kv4(cfg, "paged pool")
    for stage in build_stages(cfg):
        for ld in stage.period:
            if ld.mixer != "attn" or ld.window:
                raise NotImplementedError(
                    f"paged serving supports full-attention GQA layers only "
                    f"(got mixer={ld.mixer!r}, window={ld.window})")


def check_contiguous_support(cfg: ModelConfig) -> None:
    """Raise unless every layer fits the port's contiguous-cache path
    (``prefill``/``decode_step``, ``serve --legacy``): GQA attention
    layers, sliding windows and a VLM's bidirectional prefix included,
    MLA layers (deepseek-v3, whose packed cache is the compressed KV: its
    ``kv_lora_rank`` must be even, its ``hd`` is never read) and SSD
    layers (mamba2, jamba: the KV4 check only where an attention layer
    exists; mamba2 has no heads, its ``hd`` is never read); encoders have
    no decode step (the JAX serve refuses them too): they train only."""
    if cfg.family == "encoder":
        raise NotImplementedError(
            "contiguous serving: encoder models (bidirectional attention, "
            "no decode step) do not serve; they train "
            "(repro_torch.launch.train)")
    mixers = {ld.mixer for stage in build_stages(cfg) for ld in stage.period}
    for mixer in sorted(mixers - set(_MIXER_FULL)):
        raise NotImplementedError(
            f"contiguous serving: {mixer!r} layers are not ported "
            f"(got mixer={mixer!r})")
    if "attn" in mixers:
        _check_kv4(cfg, "contiguous KV cache")
    if "mla" in mixers:
        _check_kv4(cfg, "contiguous MLA cache", mla=True)


def check_prefill_support(cfg: ModelConfig) -> None:
    """Raise unless ``prefill`` takes ``cfg``: what the contiguous path
    serves, and an encoder (frames in, bidirectional attention, packed
    KV4 caches written; ``serve`` still refuses it, as the reference's
    does)."""
    if cfg.family != "encoder":
        check_contiguous_support(cfg)
        return
    if {ld.mixer for st in build_stages(cfg) for ld in st.period} != {"attn"}:
        raise NotImplementedError("encoder prefill: attention layers only")
    _check_kv4(cfg, "contiguous KV cache")


def init_cache_mesh(cfg: ModelConfig, sm, max_len: int, device) -> Cache:
    """The zeroed caches one rank of a mesh step holds: each leaf of
    ``models/registry.py`` ``cache_schema`` at the global batch cut as
    its ``spec_for`` placement says."""
    from repro_torch.models.qschema import tree_local_shapes
    from repro_torch.models.registry import cache_schema
    schema = cache_schema(cfg, sm.global_batch, max_len)
    shapes = tree_local_shapes(schema, sm.mesh_shape, sm.rules)

    def zeros(spec, shape):
        if isinstance(spec, dict):
            return {k: zeros(v, shape[k]) for k, v in spec.items()}
        return torch.zeros(shape, dtype=spec.dtype, device=device)

    return zeros(schema, shapes)


def _layers(cfg: ModelConfig, params: Params, pool: Optional[Cache]):
    """Yield (LayerDef, layer params, layer pool) in depth order; the
    layer pool (a paged pool's or a contiguous cache's, None without
    one) holds views into the stacked tensors."""
    sm = _serve_mesh()
    for si, stage in enumerate(build_stages(cfg)):
        sp = params["stages"][f"s{si}"]
        sc = None if pool is None else pool["stages"][f"s{si}"]
        per = [_unbind_layers(sp[f"p{pi}"], stage.repeat)
               for pi in range(len(stage.period))]
        specs = (None if sm is None else
                 [sm.layer_spec(sm.specs["stages"][f"s{si}"][f"p{pi}"])
                  for pi in range(len(stage.period))])
        for rep in range(stage.repeat):
            for pi, ld in enumerate(stage.period):
                p = per[pi][rep]
                if sm is not None:    # a mesh step: this layer gathered
                    p = sm.compute(p, specs[pi])
                yield (ld, p,
                       None if sc is None else
                       {k: v[rep] for k, v in sc[f"p{pi}"].items()})


def _unbind_layers(tree, n: int):
    """A layer-stacked param subtree as ``n`` per-layer subtrees: float
    leaves through one ``torch.unbind`` each (the same views as indexing;
    under autograd one backward stacks the layers' gradients, where n
    selects would each write a zero-filled gradient of the whole stack),
    a ``SparqleLinear`` through its ``layer``."""
    if isinstance(tree, dict):
        per = {k: _unbind_layers(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per.items()} for i in range(n)]
    if isinstance(tree, SparqleLinear):
        return [tree.layer(i) for i in range(n)]
    return list(torch.unbind(tree, 0))


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
                      block_tables: torch.Tensor, pos: torch.Tensor,
                      tier_tables: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Cache]:
    """One-token attention against the paged pool. x: (B, D).

    With ``tier_tables`` (B, Pmax) the mixed-tier kernel reads each page
    from the slab its tier id names (the KV2 precision ladder). The write
    still lands in the KV4 slab: the engine promotes a page before it is
    written, so a tier-1 id under ``pos`` is masked to the null page."""
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
    step = torch.clamp(pos // ps, 0, n_steps - 1).long()
    page = block_tables[bidx, step]
    if tier_tables is not None:
        # a demoted page id indexes the KV2 slab: never scatter there
        page = torch.where(tier_tables[bidx, step] == 0, page, 0)
    _write_kv(pool, page.long(), (pos % ps).long(), kq, ks, vq, vs)
    q = q.reshape(b, kvh, g, cfg.hd).contiguous()
    kv4 = (pool["k_q"], pool["k_s"], pool["v_q"], pool["v_s"])
    if tier_tables is None:
        o = kv4_paged_decode_attention(q, *kv4, block_tables, pos)
    else:
        o = kv_tiered_paged_decode_attention(
            q, *kv4, pool["k2_q"], pool["k2_s"], pool["v2_q"], pool["v2_s"],
            block_tables, tier_tables, pos)
    o = o.reshape(b, cfg.n_heads * cfg.hd)
    return linear(o, p["wo"], p.get("bo"), tp="row"), pool


def decode_step_paged(cfg: ModelConfig, params: Params, pool: Cache,
                      token: torch.Tensor, pos: torch.Tensor,
                      block_tables: torch.Tensor, *,
                      tier_tables: Optional[torch.Tensor] = None,
                      msb_skip: bool = False, with_telemetry: bool = True
                      ) -> Tuple[torch.Tensor, Cache, Dict[str, torch.Tensor]]:
    """One continuous-batching decode step over the paged pool.

    token/pos (B,) int32, block_tables (B, Pmax) int32; inactive slots
    carry an all-zero table row and write into the null page 0. Returns
    (logits (B, V), pool, telemetry): ``sparsity`` (B,), and per layer
    (L, B) ``layer_sparsity`` / ``layer_wire_bytes`` /
    ``layer_dense_bytes`` of the hidden stream entering the layer.

    ``msb_skip`` runs every sparqle projection LSB4-only: the draft step
    of self-speculative decoding, whose K/V writes the verify window
    overwrites. ``with_telemetry=False`` computes no wire accounting and
    returns an empty telemetry dict (the draft's lean form).
    ``tier_tables`` (B, Pmax) arms the KV2 precision ladder's read path
    (see :func:`attn_decode_paged`); the pool must hold the KV2 slab.
    """
    with msb_skip_scope(msb_skip):
        x = _embed(cfg, params, token)
        tels = []
        for ld, p, lpool in _layers(cfg, params, pool):
            if with_telemetry:
                tels.append(act_wire_telemetry(x))
            y, _ = attn_decode_paged(cfg, ld, p, x, lpool, block_tables, pos,
                                     tier_tables)
            x = x + y
            x = _add_ffn(cfg, ld, p, x[:, None, :])[:, 0]
        x = _gather_rows(x)
        telemetry: Dict[str, torch.Tensor] = {}
        if with_telemetry:
            telemetry["sparsity"] = _act_subprecision_sparsity(x)
            for key, v in stack_sublayer_telemetry(tels).items():
                telemetry[f"layer_{key}"] = _gather_rows(v, 1)
        logits = head_logits(cfg, params, x[:, None, :])[:, 0]
    return logits, pool, telemetry


def _per_position(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` on each window position's contiguous (B, ...) slice of x
    (B, T, ...), restacked along dim 1.

    On the card the f32 sum order of a row reduction (PyTorch picks its
    reduce kernel's block shape from the number of rows) and cuBLAS's
    algorithm for the head depend on how many rows a call gets. A verify
    window runs B*T rows where a decode step runs B, so its row-reducing
    float ops (the norms) and its head run per position at the decode
    step's shape: window token t then gets the bits a decode step at
    ``pos + t`` gets, which the greedy identity of speculative decoding
    needs. The integer linears, RoPE and the elementwise ops do not
    depend on the row count and run over the whole window at once."""
    return torch.stack([fn(x[:, t].contiguous()) for t in range(x.shape[1])],
                       1)


def attn_verify_paged(cfg: ModelConfig, ld: LayerDef, p: Params,
                      x: torch.Tensor, pool: Cache,
                      block_tables: torch.Tensor, pos: torch.Tensor
                      ) -> Tuple[torch.Tensor, Cache]:
    """Draft-window attention for speculative verification. x: (B, T, D).

    Window token t of sequence b sits at ``pos[b] + t``. All T tokens'
    K/V are quantized and written into their page slots first, in place
    (overwriting what the LSB4-only draft left there); then one
    multi-token kernel call attends, each token masked to its own
    position."""
    b, t, _ = x.shape
    kvh, g = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    theta = ld.rope_theta or cfg.rope_theta
    h = _per_position(lambda r: _norm(cfg, p["ln"], r), x)
    positions = pos.long()[:, None] + torch.arange(t, device=x.device)
    q, k_new, v_new = _attn_qkv(cfg, p, h, positions, theta, window=True)
    kq, ks = _kv_quant(cfg, k_new)
    vq, vs = _kv_quant(cfg, v_new)
    ps = pool["k_q"].shape[1]
    n_steps = block_tables.shape[1]
    step = torch.clamp(positions // ps, 0, n_steps - 1)
    page = torch.gather(block_tables.long(), 1, step)           # (B, T)
    _write_kv(pool, page, positions % ps, kq, ks, vq, vs)
    o = kv4_paged_verify_attention(
        q.reshape(b, t, kvh, g, cfg.hd).contiguous(), pool["k_q"],
        pool["k_s"], pool["v_q"], pool["v_s"], block_tables, pos)
    o = o.reshape(b, t, cfg.n_heads * cfg.hd)
    return linear(o, p["wo"], p.get("bo"), tp="row"), pool


def verify_window_paged(cfg: ModelConfig, params: Params, pool: Cache,
                        tokens: torch.Tensor, pos: torch.Tensor,
                        block_tables: torch.Tensor
                        ) -> Tuple[torch.Tensor, Cache, Dict[str, torch.Tensor]]:
    """Score a whole draft window in one full-precision batched step.

    tokens (B, T) int32 — window token 0 is the last accepted token,
    tokens 1..T-1 the draft proposals; pos (B,) int32 — absolute position
    of tokens[:, 0]; block_tables (B, Pmax) int32. Returns
    (logits (B, T, V), pool, telemetry): ``logits[:, t]`` equals what a
    decode step at ``pos + t`` gives, and the pool holds full-precision
    K/V at every window position. Telemetry: ``sparsity`` (B,) and
    ``layer_sparsity`` (L, B) are means over the window,
    ``layer_wire_bytes`` / ``layer_dense_bytes`` (L, B) sums over it.
    """
    x = _embed(cfg, params, tokens)                          # (B, T, D)
    tels = []
    for ld, p, lpool in _layers(cfg, params, pool):
        tels.append(act_wire_telemetry(x))
        y, _ = attn_verify_paged(cfg, ld, p, x, lpool, block_tables, pos)
        x = x + y
        if ld.ffn == "moe":
            # one routed-MoE call a window position, on the B rows a
            # decode step routes: capacity depends on the token count
            x = x + _per_position(
                lambda r: moe_ffn(cfg, p, r[:, None, :])[0][:, 0], x)
        else:
            x = x + _mlp(cfg, p, _per_position(   # as decode: (B, 1, D)
                lambda r: _norm(cfg, p["ln2"], r[:, None, :])[:, 0], x))
    x = _gather_rows(x)
    tel = {k: _gather_rows(v, 1)                             # (L, B, T)
           for k, v in stack_sublayer_telemetry(tels).items()}
    telemetry = {
        "sparsity": _act_subprecision_sparsity(x).mean(-1),
        "layer_sparsity": tel["sparsity"].mean(-1),
        "layer_wire_bytes": tel["wire_bytes"].sum(-1),
        "layer_dense_bytes": tel["dense_bytes"].sum(-1),
    }
    logits = _per_position(
        lambda r: head_logits(cfg, params, r[:, None, :])[:, 0], x)
    return logits, pool, telemetry


def _attn_prefill_chunk_paged(cfg: ModelConfig, ld: LayerDef, p: Params,
                              x: torch.Tensor, pool: Cache,
                              block_table: torch.Tensor, start: torch.Tensor,
                              valid: torch.Tensor
                              ) -> Tuple[torch.Tensor, Cache]:
    """Chunked-prefill attention for ONE sequence. x: (1, C, D);
    ``start``/``valid`` (1,) int32 on x's device.

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
    return linear(o, p["wo"], p.get("bo"), tp="row"), pool


def prefill_chunk_paged(cfg: ModelConfig, params: Params, pool: Cache,
                        tokens: torch.Tensor, start, valid,
                        block_table: torch.Tensor
                        ) -> Tuple[torch.Tensor, Cache, Dict[str, torch.Tensor]]:
    """Prefill one chunk of ONE sequence into the paged pool.

    tokens (1, C) int32 (tail-padded; ``valid`` counts real tokens),
    ``start`` the absolute position of tokens[0, 0], block_table
    (1, Pmax). ``start``/``valid`` are Python ints or (1,) int32 tensors
    on the tokens' device, as JAX traces them: the engine passes tensors,
    so that one captured graph serves every chunk. Returns (logits (1, V)
    at the last valid position, pool, telemetry over the chunk's valid
    tokens).
    """
    dev = tokens.device
    start = torch.as_tensor(start, dtype=torch.int32, device=dev).reshape(1)
    valid = torch.as_tensor(valid, dtype=torch.int32, device=dev).reshape(1)
    x = _embed(cfg, params, tokens)
    tels = []
    for ld, p, lpool in _layers(cfg, params, pool):
        tels.append(act_wire_telemetry(x))
        y, _ = _attn_prefill_chunk_paged(cfg, ld, p, x, lpool, block_table,
                                         start, valid)
        x = x + y
        x = _add_ffn(cfg, ld, p, x)   # MoE: all C rows, padding included
    c = tokens.shape[1]
    valid_tok = (torch.arange(c, device=dev) < valid).float()
    # a device scalar: the card divides truly, as JAX does (a Python
    # number would be a multiply by its reciprocal there)
    n_valid = valid_tok.sum().clamp_min(1.0)
    sp_tok = _act_subprecision_sparsity(x[0])
    tel = {k: v[:, 0, :] for k, v in stack_sublayer_telemetry(tels).items()}
    telemetry = {
        "sparsity": (sp_tok * valid_tok).sum() / n_valid,
        "layer_sparsity": (tel["sparsity"] * valid_tok).sum(-1) / n_valid,
        "layer_wire_bytes": (tel["wire_bytes"] * valid_tok).sum(-1),
        "layer_dense_bytes": (tel["dense_bytes"] * valid_tok).sum(-1),
    }
    # one row, clamped into the chunk as JAX's dynamic slice clamps it
    last = (valid - 1).clamp(0, c - 1).long()
    logits = head_logits(cfg, params, x.index_select(1, last))[:, 0]
    return logits, pool, telemetry


# ---------------------------------------------------------------------------
# contiguous-cache entry points (the fixed-batch path, ``serve --legacy``)
#
# Each layer owns a (B, Smax, KVH, hd/2) packed-KV4 cache (layer-stacked
# like the pool: (L, B, Smax, ...)). The JAX scans over layers are the
# Python loop of ``_layers``, and the cache is written in place.
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cpu") -> Cache:
    """Zeroed contiguous caches, the layout JAX's ``prefill`` returns: a
    GQA layer's packed K/V (B, Smax, KVH, hd/2) and their scales, an MLA
    layer's packed compressed KV ``ckv_q`` (B, Smax, kv_lora_rank/2), its
    scales ``ckv_s`` (B, Smax) and the shared rope key ``kr`` (B, Smax,
    qk_rope_dim) in the compute dtype, an SSD layer's state ``h`` (B, G,
    H/G, P, N) f32 and conv tail ``conv`` (B, W-1, d_inner + 2GN) in the
    compute dtype (no Smax: the state is the sequence's summary); each
    layer-stacked."""
    def zeros(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    stages = {}
    for si, stage in enumerate(build_stages(cfg)):
        per = {}
        for pi, ld in enumerate(stage.period):
            lead = (stage.repeat, batch, max_len)
            if ld.mixer == "ssd":
                din, g, n, p_ = (cfg.d_inner, cfg.ssm_groups,
                                 cfg.ssm_state, cfg.ssm_head_dim)
                nh = din // p_
                per[f"p{pi}"] = {
                    "h": zeros((stage.repeat, batch, g, nh // g, p_, n)),
                    "conv": zeros((stage.repeat, batch, cfg.conv_width - 1,
                                   din + 2 * g * n), cfg.cdtype)}
                continue
            if ld.mixer == "mla":
                per[f"p{pi}"] = {
                    "ckv_q": zeros(lead + (cfg.kv_lora_rank // 2,),
                                   torch.int8),
                    "ckv_s": zeros(lead),
                    "kr": zeros(lead + (cfg.qk_rope_dim,), cfg.cdtype)}
                continue
            kv = lead + (cfg.n_kv_heads,)
            per[f"p{pi}"] = {
                "k_q": zeros(kv + (cfg.hd // 2,), torch.int8),
                "k_s": zeros(kv),
                "v_q": zeros(kv + (cfg.hd // 2,), torch.int8),
                "v_s": zeros(kv)}
        stages[f"s{si}"] = per
    return {"stages": stages}


def attn_full(cfg: ModelConfig, ld: LayerDef, p: Params, x: torch.Tensor,
              positions: torch.Tensor, prefix_len: int,
              cache: Optional[Cache]) -> Tuple[torch.Tensor,
                                               Optional[Cache]]:
    """Prefill attention over the whole sequence, x (B, S, D). With a
    layer ``cache`` (B, Smax, ...) the quantized K/V of positions [0, S)
    are written into it in place (JAX pads a new cache to Smax)."""
    b, s, _ = x.shape
    theta = ld.rope_theta or cfg.rope_theta
    h = _norm(cfg, p["ln"], x)
    q, k, v = _attn_qkv(cfg, p, h, positions, theta)
    spec = AttnSpec(causal=cfg.causal, window=ld.window,
                    prefix_len=prefix_len)
    o = flash_attention(q, k, v, spec).reshape(b, s, cfg.n_heads * cfg.hd)
    if cache is not None:
        kq, ks = _kv_quant(cfg, k)
        vq, vs = _kv_quant(cfg, v)
        cache["k_q"][:, :s] = kq
        cache["k_s"][:, :s] = ks
        cache["v_q"][:, :s] = vq
        cache["v_s"][:, :s] = vs
    return linear(o, p["wo"], p.get("bo"), tp="row"), cache


def attn_decode(cfg: ModelConfig, ld: LayerDef, p: Params, x: torch.Tensor,
                cache: Cache, pos: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
    """One-token attention against the contiguous cache. x (B, D). The
    new token's K/V land at ``pos`` in place; the contiguous KV4 kernel
    reads the packed cache in blocks of ``CONTIGUOUS_BLOCK`` tokens (or
    of the largest divisor of Smax it shares with that), each K and V
    element dequantized in x's dtype, as JAX's ``_kv_dequant`` does; a
    sliding-window layer's keys more than ``ld.window - 1`` behind pos
    are masked and their blocks not read."""
    b, _ = x.shape
    kvh, g = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    theta = ld.rope_theta or cfg.rope_theta
    h = _norm(cfg, p["ln"], x)
    q, k_new, v_new = _attn_qkv(cfg, p, h, pos, theta)
    kq, ks = _kv_quant(cfg, k_new)
    vq, vs = _kv_quant(cfg, v_new)
    bidx, at = torch.arange(b, device=x.device), pos.long()
    cache["k_q"][bidx, at] = kq
    cache["k_s"][bidx, at] = ks
    cache["v_q"][bidx, at] = vq
    cache["v_s"][bidx, at] = vs
    bs = math.gcd(cache["k_q"].shape[1], CONTIGUOUS_BLOCK)
    o = kv4_decode_attention(q.reshape(b, kvh, g, cfg.hd).contiguous(),
                             cache["k_q"], cache["k_s"], cache["v_q"],
                             cache["v_s"], pos, bs=bs, round_kv=True,
                             window=ld.window)
    o = o.reshape(b, cfg.n_heads * cfg.hd)
    return linear(o, p["wo"], p.get("bo"), tp="row"), cache


# ---------------------------------------------------------------------------
# MLA mixer (deepseek-v3): absorbed attention on the compressed KV cache
#
# As in JAX, attention scores are taken directly against the compressed
# KV (``ckv``, kv_lora_rank wide) and the shared rope key: W_uk is
# absorbed into the query and W_uv applied to the context, so no per-head
# K/V is ever formed. The absorbed products contract activations with
# activations, so they stay float (f32): plain torch einsums, as they are
# XLA einsums in the reference (no Pallas kernel computes them); the
# cache is packed KV4 and dequantized whole at each decode step, as JAX
# dequantizes it.
# ---------------------------------------------------------------------------


def _mla_q(cfg: ModelConfig, p: Params, h: torch.Tensor, positions):
    """h (..., D) -> q_nope (..., H, dn), q_rope (..., H, dr), roped. A
    mesh train step copies the q LoRA's normed output to model, where the
    rank's heads begin (``wq_a`` and ``q_norm`` are whole over model:
    their grads are then the whole sums on every rank)."""
    H, dn, dr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    cq = rms_norm(linear(h, p["wq_a"]), p["q_norm"], cfg.rms_eps)
    q = linear(model_input(cq), p["wq_b"]).reshape(*h.shape[:-1], H,
                                                   dn + dr)
    return q[..., :dn], rope(q[..., dn:], positions, cfg.rope_theta)


def _mla_ckv(cfg: ModelConfig, p: Params, h: torch.Tensor, positions):
    """h (..., D) -> the normed compressed KV (..., rkv) and the roped
    shared rope key (..., dr)."""
    rkv = cfg.kv_lora_rank
    ckv_full = linear(h, p["wkv_a"])
    ckv = rms_norm(ckv_full[..., :rkv], p["kv_norm"], cfg.rms_eps)
    kr = rope(ckv_full[..., rkv:][..., None, :], positions, cfg.rope_theta)
    return ckv, kr[..., 0, :]


def _mla_absorbed_weights(cfg: ModelConfig, p: Params):
    """``wkv_b`` split into W_uk (rkv, H, dn) and W_uv (rkv, H, dv); a
    quantized ``wkv_b`` through its f32 dequantized form (absorption is a
    float rewrite)."""
    w = p["wkv_b"]
    if isinstance(w, SparqleLinear):
        w = w.dequantize()
    dn = cfg.qk_nope_dim
    w = w.reshape(cfg.kv_lora_rank, cfg.n_heads, dn + cfg.v_head_dim)
    return w[..., :dn], w[..., dn:]


def _mla_flash(qn, qr, ckv, kr, w_uk, w_uv, *, causal: bool,
               bq: int = 512, bkv: int = 1024) -> torch.Tensor:
    """Blockwise absorbed MLA attention, JAX's block loop: q_nope/q_rope
    (B, S, H, dn/dr) over ckv (B, S, rkv) and kr (B, S, dr); returns
    (B, S, H, dv) in q's dtype. A sequence the blocks do not divide is
    tail-padded (causal only: the mask hides the padded keys from every
    real query)."""
    b, s_orig, h, dn = qn.shape
    dr = qr.shape[-1]
    scale = (dn + dr) ** -0.5
    bq, bkv = min(bq, s_orig), min(bkv, s_orig)
    pad = max((-s_orig) % bq, (-s_orig) % bkv)
    if pad:
        assert causal, "non-causal MLA would attend padded positions"
        qn, qr, ckv, kr = (torch.cat([t, t.new_zeros(
            (b, pad) + tuple(t.shape[2:]))], 1) for t in (qn, qr, ckv, kr))
    s = s_orig + pad
    if s % bq or s % bkv:
        raise ValueError(f"blocks ({bq}, {bkv}) do not divide {s}")
    dev = qn.device
    wk, wv = w_uk.float(), w_uv.float()
    res = torch.empty((b, s, h, wv.shape[-1]), dtype=qn.dtype, device=dev)
    for iq in blocks(s // bq):
        rows = slice(iq * bq, (iq + 1) * bq)
        q_eff = torch.einsum("bihd,rhd->bihr", qn[:, rows].float(), wk)
        qrb = qr[:, rows].float()
        qpos = iq * bq + torch.arange(bq, device=dev)
        m = torch.full((b, h, bq), NEG_INF, device=dev)
        den = torch.zeros((b, h, bq), device=dev)
        acc = torch.zeros((b, h, bq, ckv.shape[-1]), device=dev)
        for jk in blocks(s // bkv):
            cols = slice(jk * bkv, (jk + 1) * bkv)
            cb, krb = ckv[:, cols].float(), kr[:, cols].float()
            sc = torch.einsum("bihr,bjr->bhij", q_eff, cb)
            sc = sc + torch.einsum("bihd,bjd->bhij", qrb, krb)
            sc = sc * scale
            if causal:
                kpos = jk * bkv + torch.arange(bkv, device=dev)
                sc = torch.where(kpos[None, :] <= qpos[:, None], sc, NEG_INF)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            pr = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            den = den * corr + pr.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhij,bjr->bhir", pr,
                                                       cb)
            m = m_new
        ctx = acc / torch.clamp_min(den, 1e-30)[..., None]
        res[:, rows] = torch.einsum("bhir,rhd->bihd", ctx, wv).to(qn.dtype)
    return res[:, :s_orig]


def mla_full(cfg: ModelConfig, ld: LayerDef, p: Params, x: torch.Tensor,
             positions: torch.Tensor, prefix_len: int,
             cache: Optional[Cache]) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Prefill MLA over the whole sequence, x (B, S, D). With a layer
    ``cache`` the packed compressed KV, its scales and the rope keys of
    positions [0, S) are written into it in place. A mesh train step
    runs the rank's heads (``wq_b``, ``wkv_b`` cut by head, ``wo``
    row-parallel): the compressed KV and the rope key, computed whole on
    every model rank, enter the per-head products through copy-to-model,
    as the q LoRA's output does (:func:`_mla_q`), so every path from a
    leaf whole over model to the heads takes one model-group sum."""
    b, s, _ = x.shape
    h = _norm(cfg, p["ln"], x)
    qn, qr = _mla_q(cfg, p, h, positions)
    ckv, kr = _mla_ckv(cfg, p, h, positions)
    w_uk, w_uv = _mla_absorbed_weights(cfg, p)
    o = _mla_flash(qn, qr, model_input(ckv), model_input(kr), w_uk, w_uv,
                   causal=cfg.causal)
    if cache is not None:
        cq, cs = _kv_quant(cfg, ckv)
        cache["ckv_q"][:, :s] = cq
        cache["ckv_s"][:, :s] = cs
        cache["kr"][:, :s] = kr
    return linear(o.reshape(b, s, cfg.n_heads * cfg.v_head_dim),
                  p["wo"], tp="row"), cache


def mla_decode(cfg: ModelConfig, ld: LayerDef, p: Params, x: torch.Tensor,
               cache: Cache, pos: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
    """One-token MLA against the contiguous compressed cache, x (B, D).
    The new token's compressed KV is quantized into the cache at ``pos``
    in place, then the whole cache is dequantized to x's dtype and the
    f32 softmax masked to positions <= pos, as in JAX."""
    b, _ = x.shape
    H, dn, dr, dv = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    h = _norm(cfg, p["ln"], x)
    qn, qr = _mla_q(cfg, p, h, pos)                  # (B, H, dn/dr)
    ckv_new, kr_new = _mla_ckv(cfg, p, h, pos)       # (B, rkv) / (B, dr)
    cq, cs = _kv_quant(cfg, ckv_new)
    bidx, at = torch.arange(b, device=x.device), pos.long()
    cache["ckv_q"][bidx, at] = cq
    cache["ckv_s"][bidx, at] = cs
    cache["kr"][bidx, at] = kr_new
    ckv = _kv_dequant(cfg, cache["ckv_q"], cache["ckv_s"], x.dtype).float()
    w_uk, w_uv = _mla_absorbed_weights(cfg, p)
    q_eff = _global_rows(lambda t: torch.einsum("bhd,rhd->bhr", t,
                                                w_uk.float()), qn.float())
    sc = torch.einsum("bhr,bjr->bhj", q_eff, ckv)
    sc = sc + torch.einsum("bhd,bjd->bhj", qr.float(), cache["kr"].float())
    sc = sc * (dn + dr) ** -0.5
    allow = (torch.arange(ckv.shape[1], device=x.device)[None, :]
             <= pos[:, None])
    pr = softmax(torch.where(allow[:, None, :], sc, NEG_INF))
    ctx = torch.einsum("bhj,bjr->bhr", pr, ckv)
    o = _global_rows(lambda t: torch.einsum("bhr,rhd->bhd", t,
                                            w_uv.float()), ctx)
    return linear(o.reshape(b, H * dv).to(x.dtype), p["wo"]), cache


# ---------------------------------------------------------------------------
# SSD mixer (mamba2 / jamba): the joint input projection, the causal conv,
# the chunked scan (prefill) or one recurrence step (decode), the gated
# norm and the output projection. The two projections run the kernels;
# the mixer between them is f32 torch, as it is XLA in the reference
# (``models/ssd.py``). The layer's state and conv tail are written into
# the cache in place.
# ---------------------------------------------------------------------------


def _ssd_dims(cfg: ModelConfig, p: Params):
    """(d_inner, groups, state, head dim, heads) of the layer's mixer as
    its params hold it: a mesh train step's shard (its heads, its groups
    or all of them) reads its widths from its leaves, the one-device
    mixer the config's."""
    din, g = p["gn"].shape[-1], p["a_log"].shape[-2]
    return din, g, cfg.ssm_state, cfg.ssm_head_dim, p["dt_bias"].shape[-1]


def _ssd_bc_whole(cfg: ModelConfig, p: Params) -> bool:
    """Whether a mesh train step's shard holds B and C whole (one group
    over model ranks that share it) rather than its groups' slice."""
    ctx = tp_ctx()
    return (ctx is not None and ctx.train and ctx.ways > 1
            and p["a_log"].shape[-2] == cfg.ssm_groups)


def _ssd_in(cfg: ModelConfig, p: Params, h: torch.Tensor):
    """The input projection of the normed h -> z (gate), xbc (the conv's
    input: x, B, C) and dt (one a head). On a mesh train step z, x and dt
    are column-parallel (h through copy-to-model); B and C, whole on
    every model rank when the groups do not divide, come from the plain
    h in a product of their own (their copy to model follows the conv,
    :func:`ssd_full`)."""
    din, g, n, _, _ = _ssd_dims(cfg, p)
    w, bc = p["w_in"], 2 * din + 2 * g * n
    if _ssd_bc_whole(cfg, p):
        hm = model_input(h)
        zx = linear(hm, w[..., :2 * din])
        return (zx[..., :din],
                torch.cat([zx[..., din:], linear(h, w[..., 2 * din:bc])], -1),
                linear(hm, w[..., bc:]))
    zxbcdt = linear(model_input(h), w)
    return zxbcdt[..., :din], zxbcdt[..., din:bc], zxbcdt[..., bc:]


def ssd_full(cfg: ModelConfig, ld: LayerDef, p: Params, x: torch.Tensor,
             positions: torch.Tensor, prefix_len: int,
             cache: Optional[Cache]) -> Tuple[torch.Tensor, Optional[Cache]]:
    """The SSD mixer over the whole sequence, x (B, S, D). With a layer
    ``cache`` the final state and the last W-1 positions of the raw
    (pre-conv) x, B, C are written into it in place. A mesh train step
    runs the rank's heads (``distributed/sharding.py``'s segmented cut):
    B and C held whole enter the heads through copy-to-model after the
    conv and SiLU, the gated norm's mean of squares is a model-group sum
    over the global d_inner, and ``w_out`` is row-parallel."""
    b, s, _ = x.shape
    din, g, n, p_, nh = _ssd_dims(cfg, p)
    h = _norm(cfg, p["ln"], x)
    z, xbc, dt = _ssd_in(cfg, p, h)
    conv_out = silu(ssd_lib.causal_conv1d(xbc, p["conv_w"], p["conv_b"]))
    xs = conv_out[..., :din].reshape(b, s, g, nh // g, p_)
    bc = conv_out[..., din:]
    if _ssd_bc_whole(cfg, p):
        bc = model_input(bc)
    b_in = bc[..., :g * n].reshape(b, s, g, n)
    c_in = bc[..., g * n:].reshape(b, s, g, n)
    dt = ssd_lib.softplus(dt + p["dt_bias"]).reshape(b, s, g, nh // g)
    y, h_fin = ssd_lib.ssd_chunked(xs, dt, p["a_log"], b_in, c_in,
                                   p["d_skip"], cfg.ssm_chunk)
    ctx = tp_ctx()
    ways = ctx.ways if ctx is not None and ctx.train else 1
    y = ssd_lib.gated_rms_norm(y.reshape(b, s, din), z, p["gn"],
                               cfg.rms_eps, ways=ways)
    if cache is not None:
        cache["h"].copy_(h_fin)
        cache["conv"].copy_(xbc[:, s - (cfg.conv_width - 1):s])
    return linear(y, p["w_out"], tp="row"), cache


def ssd_decode(cfg: ModelConfig, ld: LayerDef, p: Params, x: torch.Tensor,
               cache: Cache, pos: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
    """One recurrence step, x (B, D): the conv over the cached tail and
    the new token, one SSD state update; the new state and tail are
    copied into the layer's cache views (a CUDA graph's buffers keep
    their addresses). ``pos`` is not read: the state is position-free."""
    b, _ = x.shape
    din, g, n, p_, nh = _ssd_dims(cfg, p)
    h = _norm(cfg, p["ln"], x)
    z, xbc, dt = _ssd_in(cfg, p, h)
    conv_new, conv_out = ssd_lib.conv1d_step(cache["conv"], xbc,
                                             p["conv_w"], p["conv_b"])
    conv_out = silu(conv_out)
    xs = conv_out[..., :din].reshape(b, g, nh // g, p_)
    b_in = conv_out[..., din:din + g * n].reshape(b, g, n)
    c_in = conv_out[..., din + g * n:].reshape(b, g, n)
    dt = ssd_lib.softplus(dt + p["dt_bias"]).reshape(b, g, nh // g)
    y, h_new = ssd_lib.ssd_decode_step(cache["h"], xs, dt, p["a_log"],
                                       b_in, c_in, p["d_skip"])
    cache["h"].copy_(h_new)
    cache["conv"].copy_(conv_new)
    y = ssd_lib.gated_rms_norm(y.reshape(b, din), z, p["gn"], cfg.rms_eps)
    return linear(y, p["w_out"]), cache


# ---------------------------------------------------------------------------
# the --legacy steps on a (pod, data, model) mesh (``distributed/tp.py``
# ``ServeMesh``): the cache cut along its positions (``kv_seq``) over the
# model axis, and over data too where the batch is whole there; the
# mixers run the rank's heads where the heads divide the model ways, the
# projections as their placement cuts them (``core/qlinear.py``
# ``ShardedLinear``). Decode attention over a cache cut along its
# positions is a partial attention over the rank's slice (row 7p) and a
# merge: one f32 MAX all-reduce of the log-sum-exp and one f32 SUM
# all-reduce of the rescaled outputs with their weights, the partitioned
# softmax GSPMD lowers. Prefill writes each rank's own positions.
# ---------------------------------------------------------------------------


def _serve_mesh():
    ctx = tp_ctx()
    return None if ctx is None else ctx.serve_mesh


def _whole_cols(y: torch.Tensor, w) -> torch.Tensor:
    """A column-cut projection's output whole over model (the ranks'
    columns in model-rank order); ``y`` itself for a whole projection."""
    if isinstance(w, ShardedLinear) and w.cut == "col":
        return all_gather(y, w.group, y.ndim - 1)
    return y


class _KvSlice:
    """The rank's slice of a cache cut along its positions: ``n``
    positions from global position ``start``, merged over ``group`` of
    ``ways`` ranks."""

    def __init__(self, sm, entry, n_local: int):
        self.n, self.ways = n_local, sm.ways(entry)
        self.start = sm.index(entry) * n_local
        self.group = sm.group(entry) if self.ways > 1 else None

    def write(self, t: torch.Tensor, new: torch.Tensor, pos: torch.Tensor):
        """Write ``new`` (B, ...) at global ``pos`` (B,) into the slice
        ``t`` (B, n, ...) where this rank holds it (a select: the rows
        that lie elsewhere keep their value)."""
        b = t.shape[0]
        at = pos.long() - self.start
        own = (at >= 0) & (at < self.n)
        idx = at.clamp(0, self.n - 1)
        bidx = torch.arange(b, device=t.device)
        keep = own.reshape((b,) + (1,) * (new.ndim - 1))
        t[bidx, idx] = torch.where(keep, new.to(t.dtype), t[bidx, idx])

    def write_prefix(self, t: torch.Tensor, new: torch.Tensor) -> None:
        """Write positions [0, S) of ``new`` (B, S, ...) that this rank
        holds into ``t``."""
        lo, hi = self.start, min(self.start + self.n, new.shape[1])
        if hi > lo:
            t[:, :hi - lo] = new[:, lo:hi]

    def merge(self, out: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
        """The attention over every slice from this rank's f32 ``out``
        (..., d) and ``lse`` (...): one MAX and one SUM all-reduce."""
        if self.group is None:
            return out
        mx = lse.clone()
        dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=self.group)
        w = torch.exp(lse - mx)
        both = torch.cat([out * w[..., None], w[..., None]], -1)
        dist.all_reduce(both, op=dist.ReduceOp.SUM, group=self.group)
        return both[..., :-1] / both[..., -1:]


def _spec_entry(spec, dim: int):
    """A dim's entry of a (trailing-None-trimmed) spec."""
    return spec[dim] if dim < len(spec) else None


def _kv_slice(cache: Cache, key: str):
    """The layer cache's position slice (its leaf ``key``'s dim 1,
    ``kv_seq``)."""
    sm = _serve_mesh()
    return _KvSlice(sm, _spec_entry(sm.cache_specs[key], 1),
                    cache[key].shape[1])


def _rank_heads(cfg: ModelConfig) -> Optional[Tuple[int, int]]:
    """(first head, heads) this rank computes at prefill: its 1/model of
    the query heads when they divide, else None (every head)."""
    sm = _serve_mesh()
    m = sm.model_ways
    if m == 1 or cfg.n_heads % m:
        return None
    n = cfg.n_heads // m
    return sm.index("model") * n, n


def attn_full_mesh(cfg: ModelConfig, ld: LayerDef, p: Params,
                   x: torch.Tensor, positions: torch.Tensor,
                   prefix_len: int, cache: Optional[Cache]):
    """:func:`attn_full` on a mesh: q, k, v whole over model, attention
    over the rank's heads (every head where they do not divide), the
    rank's positions of K/V written into its cache slice."""
    b, s, _ = x.shape
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    theta = ld.rope_theta or cfg.rope_theta
    h = _norm(cfg, p["ln"], x)
    q = _whole_cols(linear(h, p["wq"], p.get("bq")), p["wq"])
    k = _whole_cols(linear(h, p["wk"], p.get("bk")), p["wk"])
    v = _whole_cols(linear(h, p["wv"], p.get("bv")), p["wv"])
    q, k, v = (q.reshape(b, s, H, hd), k.reshape(b, s, KVH, hd),
               v.reshape(b, s, KVH, hd))
    if cfg.use_qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.rms_eps)
        k = rms_norm(k, p["k_norm"], cfg.rms_eps)
    q, k = rope(q, positions, theta), rope(k, positions, theta)
    spec = AttnSpec(causal=cfg.causal, window=ld.window,
                    prefix_len=prefix_len)
    heads = _rank_heads(cfg)
    if heads is None:
        o = flash_attention(q, k, v, spec).reshape(b, s, H * hd)
    else:
        lo, n = heads
        g = H // KVH
        if n % g == 0:      # whole GQA groups: their KV heads
            kr = k[:, :, lo // g:(lo + n) // g]
            vr = v[:, :, lo // g:(lo + n) // g]
        else:               # part of a group: its KV head a query head
            idx = torch.arange(lo, lo + n, device=x.device) // g
            kr, vr = k[:, :, idx], v[:, :, idx]
        o = flash_attention(q[:, :, lo:lo + n], kr, vr, spec).reshape(
            b, s, n * hd)
    if cache is not None:
        sl = _kv_slice(cache, "k_q")
        for key, t in (("k", k), ("v", v)):
            tq, ts = _kv_quant(cfg, t)
            sl.write_prefix(cache[key + "_q"], tq)
            sl.write_prefix(cache[key + "_s"], ts)
    return linear(o, p["wo"], p.get("bo"), tp="row"), cache


def attn_decode_mesh(cfg: ModelConfig, ld: LayerDef, p: Params,
                     x: torch.Tensor, cache: Cache, pos: torch.Tensor):
    """:func:`attn_decode` on a mesh: q, k, v whole over model, the new
    K/V written where its position lies, the partial attention (row 7p)
    over the rank's positions for every head, merged."""
    b, _ = x.shape
    kvh, g, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.hd
    theta = ld.rope_theta or cfg.rope_theta
    h = _norm(cfg, p["ln"], x)
    q = _whole_cols(linear(h, p["wq"], p.get("bq")), p["wq"])
    k = _whole_cols(linear(h, p["wk"], p.get("bk")), p["wk"])
    v = _whole_cols(linear(h, p["wv"], p.get("bv")), p["wv"])
    q, k, v = (q.reshape(b, cfg.n_heads, hd), k.reshape(b, kvh, hd),
               v.reshape(b, kvh, hd))
    if cfg.use_qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.rms_eps)
        k = rms_norm(k, p["k_norm"], cfg.rms_eps)
    q, k = rope(q, pos, theta), rope(k, pos, theta)
    sl = _kv_slice(cache, "k_q")
    for key, t in (("k", k), ("v", v)):
        tq, ts = _kv_quant(cfg, t)
        sl.write(cache[key + "_q"], tq, pos)
        sl.write(cache[key + "_s"], ts, pos)
    out, lse = kv4_decode_attention_partial(
        q.reshape(b, kvh, g, hd).contiguous(), cache["k_q"], cache["k_s"],
        cache["v_q"], cache["v_s"], pos, start=sl.start, round_kv=True,
        window=ld.window)
    o = sl.merge(out, lse).to(x.dtype).reshape(b, cfg.n_heads * hd)
    return linear(o, p["wo"], p.get("bo"), tp="row"), cache


def _mla_heads(cfg: ModelConfig, p: Params) -> ModelConfig:
    """The config of the rank's MLA heads: ``wq_b`` and ``wkv_b`` cut by
    head over model, ``wo`` by the same heads' rows."""
    sm = _serve_mesh()
    m = sm.model_ways
    if m == 1:
        return cfg
    if cfg.n_heads % m or not (
            isinstance(p["wq_b"], ShardedLinear) and p["wq_b"].cut == "col"
            and isinstance(p["wkv_b"], ShardedLinear)
            and p["wkv_b"].cut == "col"):
        raise NotImplementedError(
            f"MLA on a model axis of {m} needs its {cfg.n_heads} heads cut "
            f"whole over it")
    return cfg.replace(n_heads=cfg.n_heads // m)


def mla_full_mesh(cfg: ModelConfig, ld: LayerDef, p: Params,
                  x: torch.Tensor, positions: torch.Tensor,
                  prefix_len: int, cache: Optional[Cache]):
    """:func:`mla_full` on a mesh: the rank's heads over the whole
    compressed KV (computed whole on every rank), its positions written
    into its cache slice."""
    b, s, _ = x.shape
    hc = _mla_heads(cfg, p)
    h = _norm(cfg, p["ln"], x)
    qn, qr = _mla_q(hc, p, h, positions)
    ckv, kr = _mla_ckv(cfg, p, h, positions)
    w_uk, w_uv = _mla_absorbed_weights(hc, p)
    o = _mla_flash(qn, qr, ckv, kr, w_uk, w_uv, causal=cfg.causal)
    if cache is not None:
        sl = _kv_slice(cache, "ckv_q")
        cq, cs = _kv_quant(cfg, ckv)
        sl.write_prefix(cache["ckv_q"], cq)
        sl.write_prefix(cache["ckv_s"], cs)
        sl.write_prefix(cache["kr"], kr.to(cache["kr"].dtype))
    return linear(o.reshape(b, s, hc.n_heads * cfg.v_head_dim), p["wo"],
                  tp="row"), cache


def mla_decode_mesh(cfg: ModelConfig, ld: LayerDef, p: Params,
                    x: torch.Tensor, cache: Cache, pos: torch.Tensor):
    """:func:`mla_decode` on a mesh: the rank's heads' absorbed queries
    gathered whole over model, every head attends the rank's positions
    (masked by global position), the context merged, then the rank's
    heads through W_uv and the row-cut ``wo``."""
    b, _ = x.shape
    hc = _mla_heads(cfg, p)
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    h = _norm(cfg, p["ln"], x)
    qn, qr = _mla_q(hc, p, h, pos)
    ckv_new, kr_new = _mla_ckv(cfg, p, h, pos)
    sl = _kv_slice(cache, "ckv_q")
    cq, cs = _kv_quant(cfg, ckv_new)
    sl.write(cache["ckv_q"], cq, pos)
    sl.write(cache["ckv_s"], cs, pos)
    sl.write(cache["kr"], kr_new, pos)
    w_uk, w_uv = _mla_absorbed_weights(hc, p)
    q_eff = torch.einsum("bhd,rhd->bhr", qn.float(), w_uk.float())
    q_eff, qr = q_eff.contiguous(), qr.float().contiguous()
    if hc is not cfg:
        grp = p["wq_b"].group
        q_eff, qr = all_gather(q_eff, grp, 1), all_gather(qr, grp, 1)
    ckv = _kv_dequant(cfg, cache["ckv_q"], cache["ckv_s"], x.dtype).float()
    sc = torch.einsum("bhr,bjr->bhj", q_eff, ckv)
    sc = sc + torch.einsum("bhd,bjd->bhj", qr, cache["kr"].float())
    sc = sc * (dn + dr) ** -0.5
    j = sl.start + torch.arange(ckv.shape[1], device=x.device)
    allow = (j[None, :] <= pos.long()[:, None])[:, None, :]
    sc = torch.where(allow, sc, float("-inf"))
    lse = torch.logsumexp(sc, dim=-1)
    pr = torch.where(allow, torch.exp(
        sc - torch.where(torch.isfinite(lse), lse, 0.0)[..., None]), 0.0)
    ctx = sl.merge(torch.einsum("bhj,bjr->bhr", pr, ckv), lse)
    if hc is not cfg:
        lo = p["wq_b"].rank * hc.n_heads
        ctx = ctx[:, lo:lo + hc.n_heads]
    o = torch.einsum("bhr,rhd->bhd", ctx, w_uv.float())
    return linear(o.reshape(b, hc.n_heads * cfg.v_head_dim).to(x.dtype),
                  p["wo"], tp="row"), cache


def _ssd_mesh_in(cfg: ModelConfig, p: Params, h: torch.Tensor, hcache):
    """The SSD input projection whole over model: (z, xbc, dt, the rank's
    heads (first, count) as its state cache holds them)."""
    din, g, n, p_ = (cfg.d_inner, cfg.ssm_groups, cfg.ssm_state,
                     cfg.ssm_head_dim)
    zxbcdt = _whole_cols(linear(h, p["w_in"]), p["w_in"])
    bc = 2 * din + 2 * g * n
    hg = hcache.shape[-3]             # the rank's heads a group
    nh = din // p_
    lo = _serve_mesh().index("model") * hg if hg != nh // g else 0
    return zxbcdt[..., :din], zxbcdt[..., din:bc], zxbcdt[..., bc:], lo, hg


def _ssd_heads(cfg: ModelConfig, p: Params, conv_out, z, dt, lo: int,
               hg: int):
    """The rank's heads [lo, lo + hg) of a group (G = 1 or heads whole):
    their x, the whole B and C, their dt, A, D, gate and norm gain."""
    din, g, n, p_ = (cfg.d_inner, cfg.ssm_groups, cfg.ssm_state,
                     cfg.ssm_head_dim)
    lead = conv_out.shape[:-1]
    nh_g = din // p_ // g
    if hg != nh_g and g != 1:
        raise NotImplementedError("SSD heads cut over model with groups "
                                  "> 1")
    xs = conv_out[..., :din].reshape(*lead, g, nh_g, p_)[..., lo:lo + hg, :]
    b_in = conv_out[..., din:din + g * n].reshape(*lead, g, n)
    c_in = conv_out[..., din + g * n:].reshape(*lead, g, n)
    dt = ssd_lib.softplus(dt + p["dt_bias"]).reshape(
        *lead, g, nh_g)[..., lo:lo + hg]
    ch = slice(lo * p_, (lo + hg) * p_)
    return (xs, b_in, c_in, dt, p["a_log"][..., lo:lo + hg],
            p["d_skip"][..., lo:lo + hg], z[..., ch], p["gn"][ch])


def _gated_norm_mesh(cfg: ModelConfig, y, z, gamma, whole: bool):
    """Mamba-2's gated norm on the rank's channels, the mean of squares
    over d_inner summed over model when the heads are cut."""
    if whole:
        return ssd_lib.gated_rms_norm(y, z, gamma, cfg.rms_eps)
    yz = y.float() * silu(z.float())
    ss = (yz * yz).sum(-1, keepdim=True)
    sm = _serve_mesh()
    dist.all_reduce(ss, op=dist.ReduceOp.SUM, group=sm.group("model"))
    var = ss / cfg.d_inner
    return ((yz * torch.rsqrt(var + cfg.rms_eps))
            * (1.0 + gamma.float())).to(y.dtype)


def _conv_whole(cache: Cache) -> torch.Tensor:
    sm = _serve_mesh()
    return sm.gather(cache["conv"], 2, _spec_entry(sm.cache_specs["conv"],
                                                   2))


def _conv_own(cache: Cache, whole: torch.Tensor) -> torch.Tensor:
    """The rank's channels of a whole conv tail, as its cache holds
    them."""
    n = cache["conv"].shape[-1]
    if n == whole.shape[-1]:
        return whole
    sm = _serve_mesh()
    lo = sm.index(_spec_entry(sm.cache_specs["conv"], 2)) * n
    return whole[..., lo:lo + n]


def ssd_full_mesh(cfg: ModelConfig, ld: LayerDef, p: Params,
                  x: torch.Tensor, positions: torch.Tensor,
                  prefix_len: int, cache: Optional[Cache]):
    """:func:`ssd_full` on a mesh: the joint projection whole over model,
    the conv over every channel, the scan over the rank's heads (its
    state's), the gated norm over d_inner, the row-cut output."""
    b, s, _ = x.shape
    h = _norm(cfg, p["ln"], x)
    z, xbc, dt, lo, hg = _ssd_mesh_in(cfg, p, h, cache["h"])
    conv_out = silu(ssd_lib.causal_conv1d(xbc, p["conv_w"], p["conv_b"]))
    xs, b_in, c_in, dt, a_log, d_skip, z, gn = _ssd_heads(
        cfg, p, conv_out, z, dt, lo, hg)
    y, h_fin = ssd_lib.ssd_chunked(xs, dt, a_log, b_in, c_in, d_skip,
                                   cfg.ssm_chunk)
    whole = hg * cfg.ssm_groups * cfg.ssm_head_dim == cfg.d_inner
    y = _gated_norm_mesh(cfg, y.reshape(b, s, -1), z, gn, whole)
    cache["h"].copy_(h_fin)
    cache["conv"].copy_(_conv_own(cache,
                                  xbc[:, s - (cfg.conv_width - 1):s]))
    return linear(y, p["w_out"], tp="row"), cache


def ssd_decode_mesh(cfg: ModelConfig, ld: LayerDef, p: Params,
                    x: torch.Tensor, cache: Cache, pos: torch.Tensor):
    """:func:`ssd_decode` on a mesh: the conv tail gathered whole over
    model, the step over every channel, the rank's heads' state update."""
    b, _ = x.shape
    h = _norm(cfg, p["ln"], x)
    z, xbc, dt, lo, hg = _ssd_mesh_in(cfg, p, h, cache["h"])
    conv_new, conv_out = ssd_lib.conv1d_step(_conv_whole(cache), xbc,
                                             p["conv_w"], p["conv_b"])
    conv_out = silu(conv_out)
    xs, b_in, c_in, dt, a_log, d_skip, z, gn = _ssd_heads(
        cfg, p, conv_out, z, dt, lo, hg)
    y, h_new = ssd_lib.ssd_decode_step(cache["h"], xs, dt, a_log, b_in,
                                       c_in, d_skip)
    cache["h"].copy_(h_new)
    cache["conv"].copy_(_conv_own(cache, conv_new))
    whole = hg * cfg.ssm_groups * cfg.ssm_head_dim == cfg.d_inner
    y = _gated_norm_mesh(cfg, y.reshape(b, -1), z, gn, whole)
    return linear(y, p["w_out"], tp="row"), cache


def _mesh_top(cfg: ModelConfig, params: Params) -> Params:
    """``params`` with its top-level leaves (the embedding table, the
    final norm, an untied head) in compute form for a mesh step."""
    sm = _serve_mesh()
    if sm is None:
        return params
    top = {k: sm.compute(params[k], sm.specs[k])
           for k in ("embed", "final_norm", "lm_head") if k in params}
    return {**params, **top}


def _mesh_head(cfg: ModelConfig, params: Params,
               x: torch.Tensor) -> torch.Tensor:
    """The head's logits (B, V) of the last hidden rows x (B, D). A mesh
    step whose batch is cut over data gathers the rows first and keeps
    its own rows of the logits: the head's float product then runs at
    the one-device step's row count (a CPU GEMM's sum order follows it),
    as the sharded engine's decode does."""
    return _global_rows(
        lambda t: head_logits(cfg, params, t[:, None, :])[:, 0], x)


def _lookup(cfg: ModelConfig, params: Params,
            tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings. A mesh step whose table is cut by vocab over
    model looks each token up on the rank that holds it and sums the
    ranks' rows (one of them nonzero) over model: exact."""
    table = params["embed"]["table"]
    sm = _serve_mesh()
    v_loc = table.shape[0]
    if sm is None or v_loc == cfg.vocab:
        return embed(tokens, table)
    ids = tokens.long() - sm.index("model") * v_loc
    own = (ids >= 0) & (ids < v_loc)
    e = (embed(ids.clamp(0, v_loc - 1), table).float()
         * own[..., None])
    dist.all_reduce(e, op=dist.ReduceOp.SUM, group=sm.group("model"))
    return e.to(table.dtype)


def _mesh_mixers(sm, ld: LayerDef, cache) -> bool:
    """Whether a mesh step runs the layer's mesh mixer: where the model
    axis is cut or its cache is cut along its positions (else the
    one-device mixer on the rank's rows gives the one-device bits)."""
    if sm is None:
        return False
    if sm.model_ways > 1:
        return True
    if ld.mixer == "ssd" or cache is None:
        return False
    key = "k_q" if ld.mixer == "attn" else "ckv_q"
    return sm.ways(_spec_entry(sm.cache_specs[key], 1)) > 1


_MIXER_FULL = {"attn": attn_full, "mla": mla_full, "ssd": ssd_full}
_MIXER_DEC = {"attn": attn_decode, "mla": mla_decode, "ssd": ssd_decode}
_MESH_FULL = {"attn": attn_full_mesh, "mla": mla_full_mesh,
              "ssd": ssd_full_mesh}
_MESH_DEC = {"attn": attn_decode_mesh, "mla": mla_decode_mesh,
             "ssd": ssd_decode_mesh}


def _apply_layer_full(cfg, ld: LayerDef, p: Params, x, positions,
                      prefix_len, cache, with_aux: bool = False):
    """One layer over the whole sequence. Returns (x, cache, the MoE
    layer's load-balance loss with ``with_aux``, else None)."""
    mixers = (_MESH_FULL if _mesh_mixers(_serve_mesh(), ld, cache)
              else _MIXER_FULL)
    y, cache = mixers[ld.mixer](cfg, ld, p, x, positions, prefix_len, cache)
    x = x + y
    if ld.ffn == "moe":
        y, aux = moe_ffn(cfg, p, x, with_aux=with_aux)
        return x + y, cache, aux
    return _add_ffn(cfg, ld, p, x), cache, None


def _apply_layer_decode(cfg, ld: LayerDef, p: Params, x, cache, pos):
    mixers = (_MESH_DEC if _mesh_mixers(_serve_mesh(), ld, cache)
              else _MIXER_DEC)
    y, cache = mixers[ld.mixer](cfg, ld, p, x, cache, pos)
    x = x + y
    return _add_ffn(cfg, ld, p, x[:, None, :])[:, 0], cache


def embed_inputs(cfg: ModelConfig, params: Params,
                 batch: Dict[str, torch.Tensor]):
    """Returns (x (B, S, D), positions (S,), prefix_len). An encoder's
    ``batch["frames"]`` (B, S, D) are the stub frontend's precomputed
    frame embeddings, cast to the compute dtype. A VLM's
    ``batch["patches"]`` (B, n_prefix, D), the stub vision tower's
    precomputed embeddings, go in front of the token embeddings and
    attend bidirectionally (``prefix_len`` = their count); the gemma
    family's sqrt(d) scaling covers both."""
    if cfg.family == "encoder":
        x = batch["frames"].to(cfg.cdtype)
        return x, torch.arange(x.shape[1], device=x.device), 0
    if cfg.family != "vlm":
        x = _embed(cfg, params, batch["tokens"])
        return x, torch.arange(x.shape[1], device=x.device), 0
    dt = cfg.cdtype
    patches = batch["patches"].to(dt)
    tok = _lookup(cfg, params, batch["tokens"]).to(dt)
    x = torch.cat([patches, tok], dim=1) * torch.tensor(cfg.d_model ** 0.5,
                                                         dtype=dt)
    return x, torch.arange(x.shape[1], device=x.device), patches.shape[1]


def forward_hidden(cfg: ModelConfig, params: Params,
                   batch: Dict[str, torch.Tensor], *, remat: bool = False,
                   with_aux: bool = False):
    """Forward without the head (final pre-norm hidden states) [, the
    MoE layers' load-balance losses summed in f32, in layer order].

    ``remat``: each layer runs under ``torch.utils.checkpoint`` (not
    reentrant), which keeps only the layer's input and recomputes the
    rest in the backward pass: the counterpart of JAX's
    ``jax.checkpoint(nothing_saveable)`` over the layer scan. Any arch
    runs, encoders and VLMs included; with no cache nothing is written in
    place, so autograd differentiates every mixer."""
    x, positions, prefix_len = embed_inputs(cfg, params, batch)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for ld, p, _ in _layers(cfg, params, None):
        def layer(h, ld=ld, p=p):
            h, _, aux = _apply_layer_full(cfg, ld, p, h, positions,
                                          prefix_len, None, with_aux)
            return h, aux
        if remat:
            x, aux = torch.utils.checkpoint.checkpoint(layer, x,
                                                       use_reentrant=False)
        else:
            x, aux = layer(x)
        if aux is not None:
            total = total + aux
    return (x, total) if with_aux else x


def forward(cfg: ModelConfig, params: Params,
            batch: Dict[str, torch.Tensor], *, remat: bool = False,
            with_aux: bool = False):
    """Full-sequence forward -> logits (B, S, V) [, aux loss]."""
    x, aux = forward_hidden(cfg, params, batch, remat=remat, with_aux=True)
    logits = head_logits(cfg, params, x)
    return (logits, aux) if with_aux else logits


def prefill(cfg: ModelConfig, params: Params,
            batch: Dict[str, torch.Tensor], *, max_len: int
            ) -> Tuple[torch.Tensor, Cache]:
    """Prefill: logits of the LAST position (B, V) and the caches of
    Smax = ``max_len`` positions. An encoder takes its frames and attends
    bidirectionally (its caches are written as a decoder's). Under a
    mesh step's context (``ServeMesh``) ``params`` is the rank's tree as
    its placement holds it, the batch the rank's rows, and the caches
    come back as the rank's slices."""
    check_prefill_support(cfg)
    params = _mesh_top(cfg, params)
    x, positions, prefix_len = embed_inputs(cfg, params, batch)
    sm = _serve_mesh()
    cache = (init_cache(cfg, x.shape[0], max_len, x.device) if sm is None
             else init_cache_mesh(cfg, sm, max_len, x.device))
    for ld, p, lcache in _layers(cfg, params, cache):
        x, _, _ = _apply_layer_full(cfg, ld, p, x, positions, prefix_len,
                                    lcache)
    return _mesh_head(cfg, params, x[:, -1, :]), cache


def decode_step(cfg: ModelConfig, params: Params, cache: Cache,
                token: torch.Tensor, pos: torch.Tensor
                ) -> Tuple[torch.Tensor, Cache]:
    """One decode step. token (B,) int32, pos (B,) int32 -> logits
    (B, V); the cache is updated in place and returned. An encoder has
    no decode step."""
    if cfg.family == "encoder":
        raise ValueError("encoder-only model has no decode step")
    params = _mesh_top(cfg, params)
    x = _embed(cfg, params, token)
    for ld, p, lcache in _layers(cfg, params, cache):
        x, _ = _apply_layer_decode(cfg, ld, p, x, lcache, pos)
    return _mesh_head(cfg, params, x), cache


def mtp_logits(cfg: ModelConfig, params: Params, hidden: torch.Tensor,
               batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """deepseek-v3's multi-token prediction: token t+2 from the trunk's
    hidden state at t and the embedding of token t+1. ``hidden`` is the
    trunk's final pre-norm hidden states (B, S, D) (``forward_hidden``);
    returns logits (B, S-1, V), position i predicting tokens[i+2], through
    ``mtp_depth`` MLA + dense blocks and the trunk's head. Training's
    loss reads it (``launch/steps.py``); no serve calls it."""
    mp = params["mtp"]
    tok = batch["tokens"]
    h = _norm(cfg, mp["norm_h"], hidden[:, :-1, :])
    e = _norm(cfg, mp["norm_e"],
              embed(tok[:, 1:], params["embed"]["table"]).to(h.dtype))
    x = linear(torch.cat([h, e], dim=-1), mp["proj"])
    positions = torch.arange(x.shape[1], device=x.device)
    ld = LayerDef("mla" if cfg.use_mla else "attn", "dense")
    for rep in range(cfg.mtp_depth):
        x, _, _ = _apply_layer_full(cfg, ld, tree_index(mp["block"], rep),
                                    x, positions, 0, None)
    return head_logits(cfg, params, x)
