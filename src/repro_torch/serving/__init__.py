"""Continuous-batching serving over a paged packed-KV4 cache pool:
``kv_pool`` (pages, null page, eviction), ``scheduler`` (FCFS token
budget, chunked prefill, slot backfill, preemption) and ``engine`` (the
serving loop over the two step functions)."""
from repro_torch.obs import Observability
from repro_torch.serving.engine import Engine
from repro_torch.serving.kv_pool import PagedKVPool, PoolConfig
from repro_torch.serving.scheduler import (Request, SamplingParams, Scheduler,
                                           SchedulerConfig)

__all__ = ["Engine", "Observability", "PagedKVPool", "PoolConfig",
           "Request", "SamplingParams", "Scheduler", "SchedulerConfig"]
