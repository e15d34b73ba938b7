"""Continuous-batching scheduler: FCFS admission under a token budget
(torch-side copy of ``repro.serving.scheduler``, with the speculative
lookahead, the KV2 ladder rung and the data-sharded pool of
tensor-parallel serving: decode slots split contiguously over the pool's
data shards, a request's pages pinned to its slot's shard, preemption
and the gridlock breaker confined to the contended shard).

Every engine step the scheduler emits a :class:`StepPlan`:

  * ``decode``  — the running requests (one token each). Each running
    request that crosses a page boundary gets one new page; if the pool
    is out of pages the scheduler climbs the eviction ladder: first
    demote the coldest decode-owned page KV4 -> KV2 (when the precision
    ladder is armed), then preempt the *youngest* page holder
    (recompute-style: its pages are evicted and it re-enters the waiting
    queue with its generated tokens folded into the prompt).
  * ``prefill`` — FCFS chunks of waiting prompts, bounded by the step's
    remaining token budget, free decode slots, and free pages.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
from typing import List, Optional, Tuple

from repro_torch.obs import REQUEST_TRACK_BASE
from repro_torch.serving.kv_pool import PagedKVPool

WAITING, PREFILL, RUNNING, FINISHED = ("waiting", "prefill", "running",
                                       "finished")


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    max_new_tokens: int = 16
    temperature: float = 0.0          # 0 -> greedy
    seed: int = 0
    stop_token: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    max_decode_batch: int = 8        # decode slots (step batch width)
    token_budget: int = 64           # tokens processed per engine step
    prefill_chunk: int = 32          # tokens per prefill call
    max_pages_per_seq: int = 16      # block-table width
    # speculative decoding (serving/spec_decode.py): a γ-draft slot burns
    # 2γ+1 compute tokens a step (γ draft + γ+1 verify) and writes K/V up
    # to γ positions past its context; budget, page growth and admission
    # account for both
    decode_tokens_per_slot: int = 1  # compute tokens per decode slot/step
    decode_lookahead: int = 0        # KV positions written past pos (= γ)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    sampling: SamplingParams
    arrival: float
    context: List[int] = dataclasses.field(default_factory=list)
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    prefilled: int = 0
    status: str = WAITING
    slot: Optional[int] = None
    t_first: Optional[float] = None
    t_last: Optional[float] = None
    sparsity_sum: float = 0.0
    sparsity_n: int = 0
    wire_bytes_sum: float = 0.0      # measured packed-wire activation bytes
    dense_bytes_sum: float = 0.0     # dense int8 baseline for the same acts
    wire_tokens: int = 0             # tokens the wire telemetry covered
    draft_tokens: int = 0            # LSB4-only draft tokens (no telemetry)
    preemptions: int = 0
    # speculative decoding (serving/spec_decode.py)
    draft_proposed: int = 0          # LSB4-only drafts the verifier judged
    draft_accepted: int = 0          # ... of those, accepted
    spec_steps: int = 0              # draft+verify cycles run
    spec_emitted: int = 0            # tokens emitted by those cycles
    # KV2 precision ladder: page tier transitions of this request's cache
    kv_demotions: int = 0
    kv_promotions: int = 0

    def __post_init__(self):
        if not self.context:
            self.context = list(self.prompt)

    @property
    def n_generated(self) -> int:
        return len(self.out_tokens)

    @property
    def done(self) -> bool:
        return self.status == FINISHED

    def stats(self) -> dict:
        """Per-request serving statistics (NaN where undefined)."""
        ttft = (self.t_first - self.arrival
                if self.t_first is not None else float("nan"))
        if self.t_first is not None and self.n_generated > 1:
            tpot = (self.t_last - self.t_first) / (self.n_generated - 1)
        else:
            tpot = float("nan")
        return {
            "ttft_s": ttft,
            "tpot_s": tpot,
            "n_generated": self.n_generated,
            "act_sparsity": (self.sparsity_sum / self.sparsity_n
                             if self.sparsity_n else float("nan")),
            "act_wire_bytes_per_token": (
                self.wire_bytes_sum / self.wire_tokens
                if self.wire_tokens else float("nan")),
            "wire_tokens": self.wire_tokens,
            "draft_tokens": self.draft_tokens,
            "act_wire_compression_pct": (
                (1.0 - self.wire_bytes_sum / self.dense_bytes_sum) * 100.0
                if self.dense_bytes_sum else float("nan")),
            "preemptions": self.preemptions,
            # drafts the full-precision verifier accepted, and emitted
            # tokens per draft+verify cycle (>= 1: the correction lands)
            "spec_acceptance_rate": (
                self.draft_accepted / self.draft_proposed
                if self.draft_proposed else float("nan")),
            "spec_tokens_per_step": (
                self.spec_emitted / self.spec_steps
                if self.spec_steps else float("nan")),
            "kv_demotions": self.kv_demotions,
            "kv_promotions": self.kv_promotions,
        }


@dataclasses.dataclass
class StepPlan:
    prefill: List[Tuple[Request, int, int]]   # (request, start, n_tokens)
    decode: List[Request]

    @property
    def empty(self) -> bool:
        return not self.prefill and not self.decode


class Scheduler:
    def __init__(self, pool: PagedKVPool, cfg: SchedulerConfig, obs=None):
        """``obs`` registers queue/running gauges, admission/preemption
        counters and per-request lifecycle spans; None disables them."""
        self.pool = pool
        self.cfg = cfg
        self.obs = obs
        if obs is not None:
            r = obs.registry
            self._m_submitted = r.counter(
                "serving_requests_submitted_total", "requests accepted by "
                "submit()", unit="requests")
            self._m_finished = r.counter(
                "serving_requests_finished_total", "requests that reached "
                "FINISHED", unit="requests")
            self._m_preempted = r.counter(
                "serving_preemptions_total", "recompute-style preemptions "
                "(pages evicted, request re-queued)", unit="preemptions")
            self._m_queue = r.gauge(
                "serving_queue_depth", "waiting requests after the last "
                "schedule()", unit="requests")
            self._m_running = r.gauge(
                "serving_running_slots", "decode slots occupied after the "
                "last schedule()", unit="slots")
        self._phase_spans: dict = {}
        self.waiting: collections.deque[Request] = collections.deque()
        self.running: List[Request] = []
        self._free_slots = list(range(cfg.max_decode_batch))
        self._rid = itertools.count()
        # slots are handed out in the unsharded scheduler's ascending
        # order: the slot index is MoE routing's stable tie-break, so
        # another slot layout would route other bits
        if cfg.max_decode_batch % pool.n_shards:
            raise ValueError(
                f"max_decode_batch={cfg.max_decode_batch} must divide over "
                f"the pool's {pool.n_shards} data shards")
        self._slots_per_shard = cfg.max_decode_batch // pool.n_shards

    def _shard(self, req: Request) -> int:
        """Data shard of the request's decode slot (0 unsharded)."""
        if self.pool.n_shards == 1 or req.slot is None:
            return 0
        return req.slot // self._slots_per_shard

    def _lifecycle(self, req: Request, phase: Optional[str], **args) -> None:
        """Close the request's open lifecycle span and open the next."""
        if self.obs is None:
            return
        tr = self.obs.tracer
        tr.end(self._phase_spans.pop(req.rid, None))
        if phase is not None:
            self._phase_spans[req.rid] = tr.begin(
                phase, track=REQUEST_TRACK_BASE + req.rid, rid=req.rid,
                **args)

    def submit(self, prompt: List[int], sampling: SamplingParams,
               arrival: float) -> Request:
        cap = self.cfg.max_pages_per_seq * self.pool.page_size
        # a draft window near the end writes K/V up to decode_lookahead
        # positions past the last sampled token: those slots must exist
        need = (len(prompt) + sampling.max_new_tokens
                + self.cfg.decode_lookahead)
        if need > cap:
            raise ValueError(
                f"request needs {need} token slots but the block table "
                f"caps a sequence at {cap} (max_pages_per_seq * page_size)")
        room = self.pool.usable_pages_per_shard * self.pool.page_size
        if need > room:
            raise ValueError(
                f"request needs {need} token slots; every pool shard holds "
                f"only {room} (a request's pages live in one data shard)")
        if not prompt:
            raise ValueError("empty prompt")
        if sampling.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        req = Request(rid=next(self._rid), prompt=list(prompt),
                      sampling=sampling, arrival=arrival)
        self.waiting.append(req)
        if self.obs is not None:
            self._m_submitted.inc()
            self.obs.tracer.set_track_name(REQUEST_TRACK_BASE + req.rid,
                                           f"request {req.rid}")
            self._lifecycle(req, WAITING)
        return req

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    def prefill_advanced(self, req: Request, n: int) -> bool:
        """Account ``n`` prefilled tokens; True when the prompt is done."""
        req.prefilled += n
        return req.prefilled >= len(req.context)

    def to_running(self, req: Request) -> None:
        if req in self.waiting:
            self.waiting.remove(req)
        req.status = RUNNING
        self.running.append(req)
        self._lifecycle(req, "decode", slot=req.slot)

    def finish(self, req: Request) -> None:
        req.status = FINISHED
        ts = self.pool.tier_stats_of(req.rid)
        req.kv_demotions = ts["demotions"]
        req.kv_promotions = ts["promotions"]
        if req in self.running:
            self.running.remove(req)
        if req in self.waiting:
            self.waiting.remove(req)
        if req.slot is not None:
            self._free_slots.append(req.slot)
            req.slot = None
        self.pool.release(req.rid)
        self._lifecycle(req, None)
        if self.obs is not None:
            self._m_finished.inc()
            self.obs.tracer.instant("finished",
                                    track=REQUEST_TRACK_BASE + req.rid,
                                    rid=req.rid, n_generated=req.n_generated)

    def preempt(self, req: Request) -> None:
        """Evict pages, fold generated tokens into the prompt, re-queue in
        arrival order."""
        self.pool.evict(req.rid)
        req.preemptions += 1
        req.prefilled = 0
        if req in self.running:
            self.running.remove(req)
        if req in self.waiting:
            self.waiting.remove(req)
        req.status = WAITING
        if self.obs is not None:
            self._m_preempted.inc()
        self._lifecycle(req, WAITING, preempted=True)
        idx = next((i for i, r in enumerate(self.waiting)
                    if (r.arrival, r.rid) > (req.arrival, req.rid)),
                   len(self.waiting))
        self.waiting.insert(idx, req)

    def _pages_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.pool.page_size)

    def _ensure_decode_page(self, req: Request) -> bool:
        """Grow the block table to cover this step's writes, through
        ``pos + decode_lookahead`` under speculation."""
        need = self._pages_needed(len(req.context)
                                  + self.cfg.decode_lookahead)
        have = len(self.pool.pages_of(req.rid))
        if need <= have:
            return True
        return self.pool.allocate(need - have, req.rid,
                                  shard=self._shard(req)) is not None

    def schedule(self) -> StepPlan:
        plan = StepPlan(prefill=[], decode=[])
        # only the decode set's pages may be demoted (everyone else is
        # read through tier-unaware gathers): refresh it before the
        # pressure rung below can act
        if self.pool.kv2_armed:
            self.pool.set_demotable(
                [r.rid for r in self.running if r.status == RUNNING])

        # 1. decode set — grow pages; on pressure demote a cold page
        # (rung 1, KV4 -> KV2), else preempt the youngest page holder
        for req in sorted(self.running, key=lambda r: (r.arrival, r.rid)):
            if req.status != RUNNING:
                continue
            while not self._ensure_decode_page(req):
                shard = self._shard(req)
                if self.pool.demote_for_pressure(shard):
                    continue
                # only a holder in the same data shard frees its pages
                victims = [r for r in self.running
                           if r is not req and r.status == RUNNING
                           and self._shard(r) == shard]
                victims += [r for r in self.waiting
                            if r is not req and self.pool.pages_of(r.rid)
                            and self.pool.shard_of(r.rid) == shard]
                victim = max(victims, key=lambda r: (r.arrival, r.rid),
                             default=None)
                if victim is None:
                    raise RuntimeError("page pool exhausted by one request")
                self.preempt(victim)
        plan.decode = [r for r in sorted(self.running,
                                         key=lambda r: (r.arrival, r.rid))
                       if r.status == RUNNING]

        # 2. prefill — FCFS chunks under the remaining token budget (a
        # speculative decode slot burns 2γ+1 compute tokens, not 1)
        budget = (self.cfg.token_budget
                  - len(plan.decode) * self.cfg.decode_tokens_per_slot)
        for req in list(self.waiting):
            if budget <= 0:
                break
            if req.slot is None:
                if not self._free_slots:
                    break
                req.slot = self._free_slots.pop(0)
            target = len(req.context)
            chunk = min(self.cfg.prefill_chunk, target - req.prefilled,
                        budget)
            need = self._pages_needed(req.prefilled + chunk)
            have = len(self.pool.pages_of(req.rid))
            if need > have and self.pool.allocate(
                    need - have, req.rid, shard=self._shard(req)) is None:
                break
            if req.status != PREFILL:
                self._lifecycle(req, PREFILL, slot=req.slot)
            req.status = PREFILL
            plan.prefill.append((req, req.prefilled, chunk))
            budget -= chunk
            if req.prefilled + chunk < target:
                break

        # 3. gridlock breaker: everyone mid-prefill holding pages and
        # nobody can move — evict the youngest page holder
        if plan.empty and self.has_work() and not self.running:
            by_shard: dict = {}
            for r in self.waiting:
                if self.pool.pages_of(r.rid):
                    by_shard.setdefault(self.pool.shard_of(r.rid),
                                        []).append(r)
            # a shard with two holders is contended: evict its youngest
            crowded = [rs for rs in by_shard.values() if len(rs) > 1]
            if crowded:
                self.preempt(max(crowded[0],
                                 key=lambda r: (r.arrival, r.rid)))
                return self.schedule()
            raise RuntimeError(
                "scheduler gridlock: pool too small for the waiting work")
        if self.obs is not None:
            self._m_queue.set(len(self.waiting))
            self._m_running.set(len(self.running))
        return plan
