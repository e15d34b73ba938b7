"""Continuous-batching serving over a paged packed-KV4 cache pool:
``kv_pool`` (pages, null page, eviction), ``scheduler`` (FCFS token
budget, chunked prefill, slot backfill, preemption), ``engine`` (the
serving loop over the step functions) and ``spec_decode`` (the
self-speculative engine: LSB4-only drafts, batched verify)."""
from repro_torch.obs import Observability
from repro_torch.serving.engine import Engine
from repro_torch.serving.kv_pool import PagedKVPool, PoolConfig
from repro_torch.serving.scheduler import (Request, SamplingParams, Scheduler,
                                           SchedulerConfig)
from repro_torch.serving.spec_decode import SpecConfig, SpeculativeEngine

__all__ = ["Engine", "Observability", "PagedKVPool", "PoolConfig",
           "Request", "SamplingParams", "Scheduler", "SchedulerConfig",
           "SpecConfig", "SpeculativeEngine"]
