"""Paged packed-KV4 cache pool with the KV2 precision ladder (torch twin
of ``repro.serving.kv_pool``).

The pool owns, per layer, a slab of fixed-size pages in the SPARQLe cache
wire format — K/V int4 nibbles packed two per byte plus one f32 scale per
(token, kv head) — stacked over layers like the params. Page 0 is the
reserved null page: inactive decode slots and padded prefill tokens
write there, and it is never allocated. Host-side state (free lists,
ownership, tiers, eviction and ladder counters) lives here; the device
tensors are ``state``, which the model steps update in place.

With ``PoolConfig.kv2_pages > 0`` a second slab holds demoted (KV2)
pages: nibbles clamped to the int2 band and packed four per byte, with
their own null page 0. Cold pages of decode-set owners demote to it
(``demote_cold``; ``demote_for_pressure`` is the scheduler's rung before
a preemption), and a page about to be written promotes back (``touch``).
Both re-codecs run on the device as compiled steps
(``serving/tiering.py`` ``PageRecodecs``), one graph each for every
page; the bookkeeping around them stays here, on the host.

Mesh sharding (tensor-parallel serving, ``distributed/``): over the
model axis every rank holds the same page structure (only the KV-head
dim is sliced), so one host-side free list drives every model shard in
lock step and one block table indexes all of them. Over the data axis
``n_shards`` > 1 splits the pages into per-shard sub-pools, each with
its own free list and its own null page (local id 0); block tables
carry shard-local ids and an owner's pages all live in one shard. Every
rank keeps the host state of every shard (all ranks run the same
scheduler) and, with ``shard`` coordinates, the device state of its own
slice only. The KV2 ladder runs unsharded only.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import MeshCoords, local_shape
from repro_torch.models.model import check_paged_support
from repro_torch.models.schema import ParamSpec, Schema
from repro_torch.models.stages import build_stages
from repro_torch.serving.tiering import KV2_HIGH, KV2_LOW, PageRecodecs

NULL_PAGE = 0


@dataclasses.dataclass(frozen=True)
class PoolConfig:
    n_pages: int = 64        # physical pages, including the reserved null page
    page_size: int = 16      # tokens per page
    # -- KV2 precision ladder (0 pages disables it entirely) ---------------
    kv2_pages: int = 0       # KV2-tier pages, including a reserved null page
    demote_min_sparsity: float = 0.75   # page_msb_sparsity floor to demote
    demote_after_steps: int = 4         # engine steps a page must sit cold


def pool_schema(cfg: ModelConfig, pool: PoolConfig) -> Schema:
    """ParamSpec tree of the device pool state (the KV2 slab too when the
    ladder is armed)."""
    check_paged_support(cfg)
    kvh, hd = cfg.n_kv_heads, cfg.hd
    np_, ps = pool.n_pages, pool.page_size
    n2 = pool.kv2_pages
    if n2:
        if n2 < 2:
            raise ValueError("kv2_pages must be >= 2 (one usable page "
                             "beyond the reserved KV2 null page)")
        if hd % 4:
            raise ValueError(f"KV2 tier packs 4 fields/byte: head_dim "
                             f"{hd} must be a multiple of 4")

    def slab(repeat: int, prefix: str, pages: int, packed: int) -> Schema:
        q = ParamSpec((repeat, pages, ps, kvh, packed),
                      ("layers", "pages", None, "kv_heads", None),
                      torch.int8, init="zeros")
        s = ParamSpec((repeat, pages, ps, kvh),
                      ("layers", "pages", None, "kv_heads"),
                      torch.float32, init="ones")
        return {f"k{prefix}_q": q, f"k{prefix}_s": s,
                f"v{prefix}_q": q, f"v{prefix}_s": s}

    def layer_pool(repeat: int) -> Schema:
        leaves = slab(repeat, "", np_, hd // 2)
        if n2:
            leaves.update(slab(repeat, "2", n2, hd // 4))
        return leaves

    return {"stages": {
        f"s{si}": {f"p{pi}": layer_pool(stage.repeat)
                   for pi, _ in enumerate(stage.period)}
        for si, stage in enumerate(build_stages(cfg))}}


def init_pool_state(cfg: ModelConfig, pool: PoolConfig, device="cpu",
                    shard: Optional[MeshCoords] = None):
    """Materialize the device page tensors (zeros; scales one): the whole
    pool, or with ``shard`` one mesh rank's slice of it (its data shard's
    pages, its model shard's KV heads)."""
    def walk(tree):
        if isinstance(tree, ParamSpec):
            fill = torch.ones if tree.init == "ones" else torch.zeros
            shape = (tree.shape if shard is None
                     else local_shape(tree.shape, tree.axes, shard))
            return fill(shape, dtype=tree.dtype, device=device)
        return {k: walk(v) for k, v in tree.items()}
    return walk(pool_schema(cfg, pool))


class PagedKVPool:
    """Free-list page allocator over the device pool state.

    ``on_evict(owner, pages)`` fires when :meth:`evict` reclaims a live
    owner's pages (the scheduler's preemption hook). ``obs`` registers
    the allocation/release/eviction counters on the engine's registry.
    ``n_shards`` data shards split the pages (module docstring);
    ``shard`` (a mesh rank's coordinates) sizes the device state to that
    rank's slice, else it holds the whole pool.
    """

    def __init__(self, cfg: ModelConfig, pool_cfg: PoolConfig, obs=None,
                 device="cpu", n_shards: int = 1,
                 shard: Optional[MeshCoords] = None, mempool=None):
        if n_shards < 1:
            raise ValueError(n_shards)
        if pool_cfg.n_pages % n_shards:
            raise ValueError(f"n_pages={pool_cfg.n_pages} must divide over "
                             f"{n_shards} data shards")
        if pool_cfg.n_pages // n_shards < 2:
            raise ValueError("need at least one page beyond the null page "
                             "in every shard")
        if pool_cfg.kv2_pages and n_shards > 1:
            raise NotImplementedError(
                "the KV2 precision ladder supports unsharded pools only "
                "(kv2_pages > 0 with a data mesh is not wired up)")
        self.cfg = cfg
        self.pool_cfg = pool_cfg
        self.n_shards = n_shards
        self.pages_per_shard = pool_cfg.n_pages // n_shards
        self.state = init_pool_state(cfg, pool_cfg, device, shard)
        self._shard_free = [collections.deque(range(1, self.pages_per_shard))
                            for _ in range(n_shards)]
        # shard 0's free list: the whole pool's when unsharded, the only
        # one the KV2 ladder (unsharded only) takes pages from
        self._free = self._shard_free[0]
        self._owned: Dict[object, List[int]] = {}
        self._owner_shard: Dict[object, int] = {}
        self.evictions = 0
        self.on_evict: Optional[Callable[[object, List[int]], None]] = None
        # -- KV2 tier bookkeeping (empty and inert when kv2_pages == 0) ----
        # _tier[owner][i] is the tier (0=KV4, 1=KV2) of _owned[owner][i];
        # a tier-1 entry of _owned is a KV2-slab page id. _stamp is the
        # pool clock at each page's last write (coldness); _spars caches a
        # cold page's measured sparsity (pages behind the write frontier
        # do not change).
        self.clock = 0
        self._free_kv2 = collections.deque(range(1, pool_cfg.kv2_pages))
        # the re-codecs, compiled steps on the engine's graph memory pool
        # (``mempool``) where it shares one
        self.recodecs = (PageRecodecs(device, mempool)
                         if pool_cfg.kv2_pages else None)
        self._tier: Dict[object, List[int]] = {}
        self._stamp: Dict[object, List[int]] = {}
        self._spars: Dict[object, List[Optional[float]]] = {}
        self.demotions = 0
        self.promotions = 0
        self.kv_bytes_reclaimed = 0
        self._owner_demotions: Dict[object, int] = {}
        self._owner_promotions: Dict[object, int] = {}
        # owners whose pages may be demoted: the decode batch, refreshed
        # every step. Prefill attention reads the pool through a
        # tier-unaware gather, so a demoted page of a mid-prefill owner
        # would be read as garbage.
        self._demotable: set = set()
        self._page_bytes = {0: 0, 1: 0}
        for name, leaf in _leaves(self.state):
            tier = 1 if name.startswith(("k2_", "v2_")) else 0
            # leaf dims: (layers, pages, page_size, ...); bytes per page
            self._page_bytes[tier] += (leaf.numel() * leaf.element_size()
                                       // leaf.shape[1])
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
            self._m_demote = r.counter(
                "serving_pool_demotions_total",
                "pages re-encoded down the ladder (KV4 -> KV2)",
                unit="pages")
            self._m_promote = r.counter(
                "serving_pool_promotions_total",
                "demoted pages re-encoded back up (KV2 -> KV4) on touch",
                unit="pages")
            self._m_reclaimed = r.counter(
                "serving_pool_kv_bytes_reclaimed_total",
                "KV HBM bytes freed by demotion events (cumulative; "
                "promotions do not subtract)", unit="bytes")
        else:
            self._m_evict = self._m_alloc = self._m_freed = None
            self._m_demote = self._m_promote = self._m_reclaimed = None

    @property
    def page_size(self) -> int:
        return self.pool_cfg.page_size

    @property
    def n_usable_pages(self) -> int:
        return self.pool_cfg.n_pages - self.n_shards   # a null page a shard

    @property
    def usable_pages_per_shard(self) -> int:
        return self.pages_per_shard - 1

    @property
    def num_free(self) -> int:
        return sum(len(f) for f in self._shard_free)

    def free_in_shard(self, shard: int) -> int:
        return len(self._shard_free[shard])

    def pages_of(self, owner) -> List[int]:
        return list(self._owned.get(owner, ()))

    def shard_of(self, owner) -> int:
        """Data shard holding ``owner``'s pages (0 when it holds none)."""
        return self._owner_shard.get(owner, 0)

    def allocate(self, n: int, owner, shard: int = 0) -> Optional[List[int]]:
        """Pop ``n`` pages of ``shard`` for ``owner``; None (no partial
        grab) if that shard is short. Ids are shard-local; an owner's
        pages all come from one shard."""
        if n < 0:
            raise ValueError(n)
        if not 0 <= shard < self.n_shards:
            raise ValueError(f"shard {shard} out of range")
        if self._owner_shard.get(owner, shard) != shard:
            raise ValueError(
                f"owner {owner!r} already holds pages in shard "
                f"{self._owner_shard[owner]}, cannot allocate in {shard}")
        if n == 0:
            return []
        free = self._shard_free[shard]
        if n > len(free):
            return None
        pages = [free.popleft() for _ in range(n)]
        self._owned.setdefault(owner, []).extend(pages)
        self._owner_shard[owner] = shard
        self._tier.setdefault(owner, []).extend([0] * n)
        self._stamp.setdefault(owner, []).extend([self.clock] * n)
        self._spars.setdefault(owner, []).extend([None] * n)
        if self._m_alloc is not None:
            self._m_alloc.inc(n)
        return pages

    def _free_page(self, page: int, tier: int, shard: int = 0) -> None:
        (self._free_kv2 if tier else self._shard_free[shard]).append(page)

    def release(self, owner) -> List[int]:
        """Return all of ``owner``'s pages to their tiers' free lists."""
        pages = self._owned.pop(owner, [])
        tiers = self._tier.pop(owner, [0] * len(pages))
        self._stamp.pop(owner, None)
        self._spars.pop(owner, None)
        self._demotable.discard(owner)
        shard = self._owner_shard.pop(owner, 0)
        for p, t in zip(pages, tiers):
            self._free_page(p, t, shard)
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
        tail_tiers = self._tier[owner][keep:]
        shard = self._owner_shard[owner]
        del pages[keep:]
        for m in (self._tier, self._stamp, self._spars):
            del m[owner][keep:]
        if not pages:
            del self._owned[owner]
            for m in (self._tier, self._stamp, self._spars,
                      self._owner_shard):
                m.pop(owner, None)
        for p, t in zip(tail, tail_tiers):
            self._free_page(p, t, shard)
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

    # -- KV2 precision ladder ---------------------------------------------

    @property
    def kv2_armed(self) -> bool:
        return self.pool_cfg.kv2_pages > 0

    @property
    def kv2_free(self) -> int:
        return len(self._free_kv2)

    @property
    def kv2_used(self) -> int:
        return (self.pool_cfg.kv2_pages - 1 - len(self._free_kv2)
                if self.kv2_armed else 0)

    def tiers_of(self, owner) -> List[int]:
        """Per-page tier (0=KV4, 1=KV2) parallel to :meth:`pages_of`."""
        return list(self._tier.get(owner, ()))

    def tier_stats_of(self, owner) -> Dict[str, int]:
        """Cumulative ladder transitions of ``owner``'s pages over its
        whole lifetime (they survive release and preemption)."""
        return {"demotions": self._owner_demotions.get(owner, 0),
                "promotions": self._owner_promotions.get(owner, 0)}

    def kv_bytes_saved(self) -> int:
        """KV bytes currently freed by demotion: held KV2 pages priced at
        the KV4 rate minus the KV2 rate they occupy."""
        held_kv2 = sum(sum(t) for t in self._tier.values())
        return held_kv2 * (self._page_bytes[0] - self._page_bytes[1])

    def kv_bytes_held(self) -> int:
        """KV bytes of all held pages at their current tiers."""
        return sum(self._page_bytes[t] for tiers in self._tier.values()
                   for t in tiers)

    def tick(self) -> None:
        """Advance the demotion coldness clock (one engine step)."""
        self.clock += 1

    def set_demotable(self, owners) -> None:
        """Declare the owners whose pages demotion may touch this step
        (the decode batch); replaces the previous set."""
        self._demotable = set(owners)

    def touch(self, owner, lo: int, hi: int) -> None:
        """Mark ``owner``'s page indices ``[lo, hi]`` as about to be
        written: stamp the clock, drop the cached sparsity, and promote a
        demoted page back to KV4 (writes always land in the KV4 slab).
        Call BEFORE the step whose writes cover the range; out-of-range
        indices are ignored."""
        pages = self._owned.get(owner)
        if not pages:
            return
        for i in range(max(lo, 0), min(hi, len(pages) - 1) + 1):
            if self._tier[owner][i] and not self.promote(owner, i):
                raise RuntimeError(f"cannot promote page {i} of {owner!r}: "
                                   f"the KV4 slab is exhausted")
            self._stamp[owner][i] = self.clock
            self._spars[owner][i] = None

    def demote(self, owner, idx: int) -> bool:
        """Re-encode ``owner``'s ``idx``-th page KV4 -> KV2 (False when
        the KV2 slab is full or the page is already demoted)."""
        if not self.kv2_armed or self._tier[owner][idx] or \
                not self._free_kv2:
            return False
        src = self._owned[owner][idx]
        dst = self._free_kv2.popleft()
        self.recodecs.demote(self.state, src, dst)
        self._free.append(src)
        self._owned[owner][idx] = dst
        self._tier[owner][idx] = 1
        self.demotions += 1
        self._owner_demotions[owner] = \
            self._owner_demotions.get(owner, 0) + 1
        saved = self._page_bytes[0] - self._page_bytes[1]
        self.kv_bytes_reclaimed += saved
        if self._m_demote is not None:
            self._m_demote.inc()
            self._m_reclaimed.inc(saved)
        return True

    def promote(self, owner, idx: int) -> bool:
        """Re-encode ``owner``'s ``idx``-th page KV2 -> KV4 (exact; False
        when the KV4 slab has no free page)."""
        if not self._tier[owner][idx]:
            return True
        if not self._free:
            return False
        src = self._owned[owner][idx]
        dst = self._free.popleft()
        self.recodecs.promote(self.state, src, dst)
        self._free_kv2.append(src)
        self._owned[owner][idx] = dst
        self._tier[owner][idx] = 0
        self.promotions += 1
        self._owner_promotions[owner] = \
            self._owner_promotions.get(owner, 0) + 1
        if self._m_promote is not None:
            self._m_promote.inc()
        return True

    def _demote_candidates(self, shard: Optional[int], min_age: int):
        """(stamp, owner, idx) of demotable pages, coldest first: tier 0,
        owner in the :meth:`set_demotable` set (and in ``shard`` unless
        None), at least ``min_age`` ticks since the last write, never an
        owner's final (write frontier) page."""
        out = []
        for owner, pages in self._owned.items():
            if owner not in self._demotable or (
                    shard is not None and self.shard_of(owner) != shard):
                continue
            for i in range(len(pages) - 1):        # frontier page excluded
                if not self._tier[owner][i] and \
                        self.clock - self._stamp[owner][i] >= min_age:
                    out.append((self._stamp[owner][i], owner, i))
        out.sort(key=lambda c: c[0])
        return out

    def _page_sparsity(self, owner, idx: int) -> float:
        cached = self._spars[owner][idx]
        if cached is None:
            cached = float(self.page_msb_sparsity(
                [self._owned[owner][idx]])[0])
            self._spars[owner][idx] = cached
        return cached

    def demote_cold(self, max_pages: Optional[int] = None) -> int:
        """Background sweep (the engine calls it every step): demote cold
        pages — untouched for ``demote_after_steps`` ticks — whose
        ``page_msb_sparsity`` clears ``demote_min_sparsity``, coldest
        first, while the KV2 slab (and ``max_pages``) allows. Returns the
        pages demoted."""
        if not self.kv2_armed:
            return 0
        done = 0
        floor = self.pool_cfg.demote_min_sparsity
        for _, owner, i in self._demote_candidates(
                None, self.pool_cfg.demote_after_steps):
            if not self._free_kv2 or (max_pages is not None
                                      and done >= max_pages):
                break
            if floor > 0.0 and self._page_sparsity(owner, i) < floor:
                continue
            if self.demote(owner, i):
                done += 1
        return done

    def demote_for_pressure(self, shard: int = 0, n: int = 1) -> int:
        """The ladder's rung between "no free page" and preemption: demote
        up to ``n`` of ``shard``'s coldest non-frontier KV4 pages whatever
        their sparsity, freeing KV4 pages without evicting anyone. Returns
        the pages freed."""
        if not self.kv2_armed:
            return 0
        done = 0
        for _, owner, i in self._demote_candidates(shard, 1):
            if done >= n or not self._free_kv2:
                break
            if self.demote(owner, i):
                done += 1
        return done

    # -- telemetry ---------------------------------------------------------

    def page_msb_sparsity(self, pages: List[int]) -> np.ndarray:
        """Per-page share of the stored K/V nibbles inside the int2 band
        [KV2_LOW, KV2_HIGH] = [-2, 1] (signed: ``nib >> 2 == 0`` would
        wrongly drop -2 and -1), averaged over K and V across every layer
        — what a demotion keeps exactly. ``pages`` are KV4 page ids."""
        if not pages:
            return np.zeros((0,), np.float32)
        tot, cnt = None, 0
        for name, leaf in _leaves(self.state):
            if name not in ("k_q", "v_q"):    # the KV2 slab has its own ids
                continue
            sel = leaf[:, torch.tensor(pages, device=leaf.device)]
            lo = (sel << 4) >> 4
            hi = sel >> 4
            nib = torch.stack([lo, hi], -1)     # (L, n, ps, kvh, hd/2, 2)
            sub = (nib >= KV2_LOW) & (nib <= KV2_HIGH)
            # an integer count over a float mean: the count is exact, so
            # the f32 quotient is the one the JAX package's jnp.mean gives
            count = sub.sum(dim=(0, 2, 3, 4, 5), dtype=torch.int64)
            per_page = count.float() / (sub.numel() // len(pages))
            tot = per_page if tot is None else tot + per_page
            cnt += 1
        return (tot / max(cnt, 1)).cpu().numpy().astype(np.float32)

    def utilization(self) -> float:
        return 1.0 - self.num_free / max(self.n_usable_pages, 1)


def _leaves(tree, name: str = ""):
    """(leaf name, tensor) of every tensor in a nested pool-state dict."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, k)
    else:
        yield name, tree
