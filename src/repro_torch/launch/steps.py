"""The engine's two step functions (torch twin of the engine steps of
``repro.launch.steps``), as plain closures over the config.

Both keep the JAX steps' static shapes — a (1, C) prefill chunk and a
(B,) decode batch over a (B, Pmax) block table, inactive slots on the
null page — so they can be captured as CUDA graphs later. Both update
the pool in place and return it (the JAX steps return a new one).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M


def make_engine_prefill_chunk(cfg: ModelConfig):
    """(params, pool, tokens (1, C), start, valid, block_table (1, Pmax))
    -> (logits (1, V) at the last valid position, pool, telemetry)."""

    @torch.no_grad()
    def prefill_chunk(params, pool, tokens, start: int, valid: int,
                      block_table):
        return M.prefill_chunk_paged(cfg, params, pool, tokens, start, valid,
                                     block_table)

    return prefill_chunk


def make_engine_decode(cfg: ModelConfig):
    """(params, pool, token (B,), pos (B,), block_tables (B, Pmax))
    -> (logits (B, V), pool, telemetry). Raw logits come back: sampling
    is per request and lives host-side in the engine."""

    @torch.no_grad()
    def engine_decode(params, pool, token, pos, block_tables):
        return M.decode_step_paged(cfg, params, pool, token, pos,
                                   block_tables)

    return engine_decode
