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
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def make_serve_prefill(cfg: ModelConfig, max_len: int):
    """(params, batch {"tokens": (B, S)}) -> (greedy next token (B,)
    int32, contiguous caches of ``max_len`` positions)."""

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


def make_engine_prefill_chunk(cfg: ModelConfig):
    """(params, pool, tokens (1, C), start (1,), valid (1,), block_table
    (1, Pmax)) -> (logits (1, V) at the last valid position, pool,
    telemetry); ``start``/``valid`` int32 tensors (or Python ints)."""

    @torch.no_grad()
    def prefill_chunk(params, pool, tokens, start, valid, block_table):
        return M.prefill_chunk_paged(cfg, params, pool, tokens, start, valid,
                                     block_table)

    return prefill_chunk


def make_engine_decode(cfg: ModelConfig, *, msb_skip: bool = False,
                       with_telemetry: bool = True, kv2: bool = False):
    """(params, pool, token (B,), pos (B,), block_tables (B, Pmax))
    -> (logits (B, V), pool, telemetry). Raw logits come back: sampling
    is per request and lives host-side in the engine.

    ``msb_skip=True`` makes the LSB4-only draft step of the speculative
    engine; ``with_telemetry=False`` drops the wire accounting (the
    telemetry comes back empty) — the draft runs γ times per cycle.
    ``kv2=True`` makes the precision-ladder step: it takes ``tier_tables``
    (B, Pmax) after ``block_tables`` and reads each page from the slab
    its tier id names (the pool must hold the KV2 slab)."""
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


def make_engine_verify_window(cfg: ModelConfig):
    """(params, pool, tokens (B, T), pos (B,), block_tables (B, Pmax))
    -> (logits (B, T, V), pool, telemetry): one full-precision step
    scores every window position of every decode slot and overwrites the
    draft's K/V (``models.model.verify_window_paged``)."""

    @torch.no_grad()
    def engine_verify(params, pool, tokens, pos, block_tables):
        return M.verify_window_paged(cfg, params, pool, tokens, pos,
                                     block_tables)

    return engine_verify
