"""The serving step functions (torch twin of the serving steps of
``repro.launch.steps``), as plain closures over the config: the engine's
prefill, decode (full or LSB4-only draft) and speculative verify window,
and the fixed-batch path's whole-prompt prefill and decode over
contiguous caches (``make_serve_prefill``/``make_serve_decode``).

The decode step takes a (B, Pmax) tier table too when the KV2 precision
ladder is armed. All keep the JAX steps' static shapes — a (1, C) prefill
chunk whose start and valid count are (1,) device tensors, a (B,) decode
batch and a (B, T) verify window over a (B, Pmax) block table, inactive
slots on the null page — and read no device value on the host, so the
engines and the fixed-batch decode run them as CUDA graphs
(``launch/graphs.py``), one capture per shape. All update the pool in
place and return it (the JAX steps return a new one).

With a ``mesh`` (a ("data", "model") ``DeviceMesh``, ``launch/mesh.py``)
the engine steps run this rank's shard as SPMD, as the JAX package's
``shard_map`` of the same bodies: on a per-shard config (head counts
divided by the model ways) under the TP context of ``distributed/tp``.
The prefill chunk is replicated over data: it takes a (D, Pmax) table,
one row a data shard, the owner's holding the sequence's shard-local
pages and every other row all-null, so a non-owner computes into its
null page; the owner's logits and telemetry reach every rank through a
SUM all-reduce over the data group of values masked to zero elsewhere
(exact: one nonzero term). Decode, draft and verify take this data
rank's slice of the slots and return the whole batch's logits and
telemetry (``models/model.py`` gathers the rows), so every rank samples
the same tokens.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.tp import shard_model_config, tp_scope
from repro_torch.launch.mesh import mesh_layout
from repro_torch.models import model as M


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def make_serve_prefill(cfg: ModelConfig, max_len: int):
    """(params, batch {"tokens": (B, S)}, and for a VLM "patches"
    (B, n_prefix, D) in front of them) -> (greedy next token (B,) int32,
    contiguous caches of ``max_len`` positions)."""

    @torch.no_grad()
    def serve_prefill(params, batch):
        logits, cache = M.prefill(cfg, params, batch, max_len=max_len)
        return _greedy(logits), cache

    return serve_prefill


def make_serve_decode(cfg: ModelConfig):
    """(params, cache, token (B,), pos (B,)) -> (greedy next token (B,)
    int32, cache updated in place)."""

    @torch.no_grad()
    def serve_decode(params, cache, token, pos):
        logits, cache = M.decode_step(cfg, params, cache, token, pos)
        return _greedy(logits), cache

    return serve_decode


def _mesh_layout(cfg: ModelConfig, mesh):
    """(this rank's MeshLayout, the per-shard config)."""
    lay = mesh_layout(mesh)
    return lay, shard_model_config(cfg, lay.model_ways)


def make_engine_prefill_chunk(cfg: ModelConfig, *, mesh=None):
    """(params, pool, tokens (1, C), start (1,), valid (1,), block_table
    (1, Pmax)) -> (logits (1, V) at the last valid position, pool,
    telemetry); ``start``/``valid`` int32 tensors (or Python ints). With
    a ``mesh`` the table is (D, Pmax), one row a data shard (module
    docstring)."""
    if mesh is None:
        @torch.no_grad()
        def prefill_chunk(params, pool, tokens, start, valid, block_table):
            return M.prefill_chunk_paged(cfg, params, pool, tokens, start,
                                         valid, block_table)

        return prefill_chunk

    lay, lcfg = _mesh_layout(cfg, mesh)
    d = lay.coords.data_rank

    def owner_only(t, mine):
        # f32 holds every value exactly: x + 0 = x
        t32 = torch.where(mine, t.float(), torch.zeros((), device=t.device))
        dist.all_reduce(t32, op=dist.ReduceOp.SUM, group=lay.data_group)
        return t32.to(t.dtype)

    @torch.no_grad()
    def prefill_chunk_sharded(params, pool, tokens, start, valid, tables):
        table = tables[d:d + 1]
        with tp_scope(lay.context()):
            logits, pool, tel = M.prefill_chunk_paged(
                lcfg, params, pool, tokens, start, valid, table)
        if lay.data_ways > 1:
            mine = (table != 0).any()
            logits = owner_only(logits, mine)
            tel = {k: owner_only(v, mine) for k, v in tel.items()}
        return logits, pool, tel

    return prefill_chunk_sharded


def make_engine_decode(cfg: ModelConfig, *, msb_skip: bool = False,
                       with_telemetry: bool = True, kv2: bool = False,
                       mesh=None):
    """(params, pool, token (B,), pos (B,), block_tables (B, Pmax))
    -> (logits (B, V), pool, telemetry). Raw logits come back: sampling
    is per request and lives host-side in the engine.

    ``msb_skip=True`` makes the LSB4-only draft step of the speculative
    engine; ``with_telemetry=False`` drops the wire accounting (the
    telemetry comes back empty) — the draft runs γ times per cycle.
    ``kv2=True`` makes the precision-ladder step: it takes ``tier_tables``
    (B, Pmax) after ``block_tables`` and reads each page from the slab
    its tier id names (the pool must hold the KV2 slab). With a ``mesh``
    token/pos/block_tables are this data rank's slots and the logits and
    telemetry the whole batch's; the ladder runs unsharded only."""
    if mesh is not None:
        if kv2:
            raise NotImplementedError(
                "the KV2 precision ladder is unsharded-only (kv2=True with "
                "a mesh is not wired up)")
        lay, lcfg = _mesh_layout(cfg, mesh)

        @torch.no_grad()
        def engine_decode_sharded(params, pool, token, pos, block_tables):
            with tp_scope(lay.context(local_rows=token.shape[0])):
                return M.decode_step_paged(lcfg, params, pool, token, pos,
                                           block_tables, msb_skip=msb_skip,
                                           with_telemetry=with_telemetry)

        return engine_decode_sharded
    if kv2:
        @torch.no_grad()
        def engine_decode_kv2(params, pool, token, pos, block_tables,
                              tier_tables):
            return M.decode_step_paged(cfg, params, pool, token, pos,
                                       block_tables, tier_tables=tier_tables,
                                       msb_skip=msb_skip,
                                       with_telemetry=with_telemetry)

        return engine_decode_kv2

    @torch.no_grad()
    def engine_decode(params, pool, token, pos, block_tables):
        return M.decode_step_paged(cfg, params, pool, token, pos,
                                   block_tables, msb_skip=msb_skip,
                                   with_telemetry=with_telemetry)

    return engine_decode


def make_engine_verify_window(cfg: ModelConfig, *, mesh=None):
    """(params, pool, tokens (B, T), pos (B,), block_tables (B, Pmax))
    -> (logits (B, T, V), pool, telemetry): one full-precision step
    scores every window position of every decode slot and overwrites the
    draft's K/V (``models.model.verify_window_paged``). With a ``mesh``
    the inputs are this data rank's slots, the outputs the whole
    batch's."""
    if mesh is not None:
        lay, lcfg = _mesh_layout(cfg, mesh)

        @torch.no_grad()
        def engine_verify_sharded(params, pool, tokens, pos, block_tables):
            with tp_scope(lay.context(local_rows=tokens.shape[0])):
                return M.verify_window_paged(lcfg, params, pool, tokens, pos,
                                             block_tables)

        return engine_verify_sharded

    @torch.no_grad()
    def engine_verify(params, pool, tokens, pos, block_tables):
        return M.verify_window_paged(cfg, params, pool, tokens, pos,
                                     block_tables)

    return engine_verify
