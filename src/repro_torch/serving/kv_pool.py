"""Paged packed-KV4 cache pool (torch twin of ``repro.serving.kv_pool``,
KV4 tier, one shard).

The pool owns, per layer, a slab of fixed-size pages in the SPARQLe cache
wire format — K/V int4 nibbles packed two per byte plus one f32 scale per
(token, kv head) — stacked over layers like the params. Page 0 is the
reserved null page: inactive decode slots and padded prefill tokens
write there, and it is never allocated. Host-side state (free list,
ownership, eviction counter) lives here; the device tensors are
``state``, which the model steps update in place.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import check_paged_support
from repro_torch.models.schema import ParamSpec, Schema
from repro_torch.models.stages import build_stages

NULL_PAGE = 0


@dataclasses.dataclass(frozen=True)
class PoolConfig:
    n_pages: int = 64        # physical pages, including the reserved null page
    page_size: int = 16      # tokens per page


def pool_schema(cfg: ModelConfig, pool: PoolConfig) -> Schema:
    """ParamSpec tree of the device pool state."""
    check_paged_support(cfg)
    kvh, hd = cfg.n_kv_heads, cfg.hd
    np_, ps = pool.n_pages, pool.page_size

    def layer_pool(repeat: int) -> Schema:
        return {
            "k_q": ParamSpec((repeat, np_, ps, kvh, hd // 2),
                             ("layers", "pages", None, "kv_heads", None),
                             torch.int8, init="zeros"),
            "k_s": ParamSpec((repeat, np_, ps, kvh),
                             ("layers", "pages", None, "kv_heads"),
                             torch.float32, init="ones"),
            "v_q": ParamSpec((repeat, np_, ps, kvh, hd // 2),
                             ("layers", "pages", None, "kv_heads", None),
                             torch.int8, init="zeros"),
            "v_s": ParamSpec((repeat, np_, ps, kvh),
                             ("layers", "pages", None, "kv_heads"),
                             torch.float32, init="ones"),
        }

    return {"stages": {
        f"s{si}": {f"p{pi}": layer_pool(stage.repeat)
                   for pi, _ in enumerate(stage.period)}
        for si, stage in enumerate(build_stages(cfg))}}


def init_pool_state(cfg: ModelConfig, pool: PoolConfig, device="cpu"):
    """Materialize the device page tensors (zeros; scales one)."""
    def walk(tree):
        if isinstance(tree, ParamSpec):
            fill = torch.ones if tree.init == "ones" else torch.zeros
            return fill(tree.shape, dtype=tree.dtype, device=device)
        return {k: walk(v) for k, v in tree.items()}
    return walk(pool_schema(cfg, pool))


class PagedKVPool:
    """Free-list page allocator over the device pool state.

    ``on_evict(owner, pages)`` fires when :meth:`evict` reclaims a live
    owner's pages (the scheduler's preemption hook). ``obs`` registers
    the allocation/release/eviction counters on the engine's registry.
    """

    def __init__(self, cfg: ModelConfig, pool_cfg: PoolConfig, obs=None,
                 device="cpu"):
        if pool_cfg.n_pages < 2:
            raise ValueError("need at least one page beyond the null page")
        self.cfg = cfg
        self.pool_cfg = pool_cfg
        self.state = init_pool_state(cfg, pool_cfg, device)
        self._free = collections.deque(range(1, pool_cfg.n_pages))
        self._owned: Dict[object, List[int]] = {}
        self.evictions = 0
        self.on_evict: Optional[Callable[[object, List[int]], None]] = None
        if obs is not None:
            r = obs.registry
            self._m_evict = r.counter(
                "serving_pool_evictions_total",
                "live owners preempted out of their pages", unit="evictions")
            self._m_alloc = r.counter(
                "serving_pool_pages_allocated_total",
                "pages handed to owners", unit="pages")
            self._m_freed = r.counter(
                "serving_pool_pages_released_total",
                "pages returned to the free lists (release/truncate/evict)",
                unit="pages")
        else:
            self._m_evict = self._m_alloc = self._m_freed = None

    @property
    def page_size(self) -> int:
        return self.pool_cfg.page_size

    @property
    def n_usable_pages(self) -> int:
        return self.pool_cfg.n_pages - 1

    @property
    def num_free(self) -> int:
        return len(self._free)

    def pages_of(self, owner) -> List[int]:
        return list(self._owned.get(owner, ()))

    def allocate(self, n: int, owner) -> Optional[List[int]]:
        """Pop ``n`` pages for ``owner``; None (no partial grab) if short."""
        if n < 0:
            raise ValueError(n)
        if n == 0:
            return []
        if n > len(self._free):
            return None
        pages = [self._free.popleft() for _ in range(n)]
        self._owned.setdefault(owner, []).extend(pages)
        if self._m_alloc is not None:
            self._m_alloc.inc(n)
        return pages

    def release(self, owner) -> List[int]:
        """Return all of ``owner``'s pages to the free list."""
        pages = self._owned.pop(owner, [])
        self._free.extend(pages)
        if pages and self._m_freed is not None:
            self._m_freed.inc(len(pages))
        return pages

    def truncate(self, owner, n_tokens: int) -> List[int]:
        """Release ``owner``'s pages past a token count: keep the first
        ``ceil(n_tokens / page_size)`` (a partly filled last page whole)
        and free the rest — the KV rollback of rejected speculative
        tokens. Not a preemption: no eviction is counted and the hook
        does not fire. Truncating to 0 tokens removes the owner;
        truncating past the held range does nothing."""
        if n_tokens < 0:
            raise ValueError(n_tokens)
        keep = -(-n_tokens // self.page_size)
        pages = self._owned.get(owner)
        if pages is None or len(pages) <= keep:
            return []
        tail = pages[keep:]
        del pages[keep:]
        if not pages:
            del self._owned[owner]
        self._free.extend(tail)
        if self._m_freed is not None:
            self._m_freed.inc(len(tail))
        return tail

    def evict(self, owner) -> List[int]:
        """Preemption hook: reclaim a live owner's pages (no-op for an
        owner holding none)."""
        pages = self.pages_of(owner)
        if not pages:
            return []
        if self.on_evict is not None:
            self.on_evict(owner, pages)
        self.evictions += 1
        if self._m_evict is not None:
            self._m_evict.inc()
        return self.release(owner)

    def utilization(self) -> float:
        return 1.0 - self.num_free / max(self.n_usable_pages, 1)
