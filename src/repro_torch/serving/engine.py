"""Continuous-batching serving engine over the paged packed-KV4 pool
(torch twin of ``repro.serving.engine``).

Ties together the scheduler, the page pool and the two step functions of
``launch/steps.py``: ``prefill_chunk`` — one (1, prefill_chunk) slice of
one prompt — and ``decode`` — one token for every decode slot at once,
through the paged decode-attention kernel. Inactive decode slots ride
along pointing at the null page. On a CUDA device each step runs as a
CUDA graph, captured at its second call and replayed after
(``launch/graphs.py``, as the JAX engine jits its steps). Sampling is
host-side numpy, as in the JAX engine. ``PoolConfig(kv2_pages > 0)``
arms the KV2 precision ladder: the decode step reads each page through
its tier id (the mixed-tier kernel), the page about to be written is
promoted first, and cold pages are demoted after each step; both
re-codecs run as CUDA graphs too, on the engine's graph memory pool
(``serving/tiering.py`` ``PageRecodecs``).

    eng = Engine(cfg, qparams)                 # device="cuda" by default
    h = eng.submit([1, 2, 3], SamplingParams(max_new_tokens=8))
    for tok in eng.stream(h):                  # or eng.run()
        ...
    print(h.out_tokens, h.stats())

``slos=`` arms the SLO watchdog (``obs/slo.py``) on TTFT, TPOT and the
queue depth; ``attribute_steps()`` counts each step's work from its
shapes (``launch/step_cost.py``) and joins it with the measured step
times into the roofline and cost-model drift gauges
(``obs/attribution.py``).

``mesh=`` (a ("data", "model") ``DeviceMesh`` of ``launch/mesh.py``)
makes the engine one rank of a tensor-parallel serve: every rank builds
the same engine and runs the same host loop (scheduler, pool
bookkeeping of every data shard, sampling) while its steps run its
shard (``launch/steps.py``); weights shard Megatron-style on "model",
the pool on KV heads over "model" and on pages over "data", and decode
slots split contiguously over "data". Greedy streams, steps and
evictions equal the single-device engine's. After each step the ranks
all-gather a digest of the tokens they emitted and raise if any
differs, so a divergence fails at once rather than hanging in the next
collective. Under gloo (several ranks on one card) the steps run
eagerly, which ``step_mode`` and the stats name.
"""
from __future__ import annotations

import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.qlinear import tree_to
from repro_torch.distributed.tp import (all_gather, shard_params,
                                        validate_tp_config)
from repro_torch.launch.graphs import CompiledStep
from repro_torch.launch.mesh import mesh_layout
from repro_torch.models.model import check_paged_support
from repro_torch.obs import Observability, attach_engine_slos
from repro_torch.serving.kv_pool import PagedKVPool, PoolConfig
from repro_torch.serving.scheduler import (Request, SamplingParams, Scheduler,
                                           SchedulerConfig)


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without a card raises
    (the port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain versions on the CPU")
    return dev


class Engine:
    def __init__(self, cfg: ModelConfig, params,
                 pool_config: Optional[PoolConfig] = None,
                 sched_config: Optional[SchedulerConfig] = None,
                 clock=time.monotonic,
                 obs: Optional[Observability] = None,
                 device="cuda", mesh=None, slos=None):
        """``params`` is the served (quantized) tree; it is moved to
        ``device`` (a no-op for tensors already there). ``obs`` is the
        metrics registry + tracer every layer reports into. ``mesh``
        (module docstring): ``params`` is the whole tree, of which this
        rank keeps its shard; a mesh of one rank is no mesh. ``slos``
        (``obs.slo.SLO``s) arms the SLO watchdog: ``ttft``/``tpot`` are
        fed at emit time, ``queue_depth`` once a scheduler iteration."""
        from repro_torch.launch import steps as S
        check_paged_support(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self._clock = clock
        self.obs = obs if obs is not None else Observability(clock=clock)
        self._init_metrics()
        self.slo = attach_engine_slos(self, slos)
        self._attr = None   # StepAttribution, built by attribute_steps()
        # block-table entries the decodes read, and those on KV2 pages
        self._table_entries = self._table_kv2 = 0
        self._attr_kv2_share = 0.0     # the share decode was counted at
        pool_config = pool_config or PoolConfig()
        sched_config = sched_config or SchedulerConfig()
        self.mesh = mesh if mesh is not None and mesh.size() > 1 else None
        self.layout = None
        n_shards, shard = 1, None
        if self.mesh is not None:
            self.layout = lay = mesh_layout(self.mesh)
            validate_tp_config(cfg, lay.model_ways)
            if sched_config.max_decode_batch % lay.data_ways:
                raise ValueError(
                    f"max_decode_batch={sched_config.max_decode_batch} must "
                    f"divide over the data axis ({lay.data_ways}): each data "
                    f"shard owns a contiguous slice of decode slots")
            if pool_config.kv2_pages:
                raise NotImplementedError(
                    "the KV2 precision ladder is unsharded-only (kv2_pages "
                    "> 0 with a mesh is not wired up)")
            params = shard_params(params, lay.coords.model_rank,
                                  lay.model_ways)
            n_shards, shard = lay.data_ways, lay.coords
        self.params = tree_to(params, self.device)
        # gloo collectives are host work, which a CUDA graph cannot hold
        self._gloo = self.layout is not None and self.layout.backend == "gloo"
        cuda = self.device.type == "cuda"
        self.step_mode = ("eager" if not cuda else
                          "eager (gloo collectives)" if self._gloo
                          else "graphs")
        # one graph memory pool for every step of this engine, the KV2
        # re-codecs' included
        self._mempool = (torch.cuda.graph_pool_handle()
                         if cuda and not self._gloo else None)
        self.pool = PagedKVPool(cfg, pool_config, obs=self.obs,
                                device=self.device, n_shards=n_shards,
                                shard=shard, mempool=self._mempool)
        # the KV2 precision ladder: the decode step gains a tier table,
        # and demotion/promotion run host-side around it
        self._kv2 = self.pool.kv2_armed
        self.sched = Scheduler(self.pool, sched_config, obs=self.obs)
        scfg = self.sched.cfg
        self._chunk = scfg.prefill_chunk
        self._n_slots = scfg.max_decode_batch
        self._n_page_steps = scfg.max_pages_per_seq
        self._prefill_fn = self._compiled(
            S.make_engine_prefill_chunk(cfg, mesh=self.mesh))
        self._decode_fn = self._compiled(
            S.make_engine_decode(cfg, kv2=self._kv2, mesh=self.mesh))
        self._rngs: Dict[int, np.random.Generator] = {}
        self.steps = 0
        self.layer_wire_bytes: Optional[np.ndarray] = None
        self.layer_dense_bytes: Optional[np.ndarray] = None
        self.layer_sparsity_sum: Optional[np.ndarray] = None
        self.wire_tokens = 0

    def _init_metrics(self) -> None:
        r = self.obs.registry
        self._m_steps = r.counter(
            "serving_engine_steps_total", "scheduler iterations run",
            unit="steps")
        self._m_tokens = r.counter(
            "serving_tokens_processed_total", "compute tokens through the "
            "step functions, by phase", unit="tokens",
            labelnames=("phase",))
        self._m_emitted = r.counter(
            "serving_tokens_emitted_total", "sampled tokens handed to "
            "requests", unit="tokens")
        self._m_ttft = r.histogram(
            "serving_ttft_seconds", "request arrival to first emitted "
            "token", unit="seconds")
        self._m_tpot = r.histogram(
            "serving_tpot_seconds", "gap between consecutive emitted "
            "tokens of one request", unit="seconds")
        self._m_step_lat = r.histogram(
            "serving_step_seconds", "host-side latency of one engine-step "
            "phase (includes device sync)", unit="seconds",
            labelnames=("phase",))
        self._m_wire = r.counter(
            "serving_wire_bytes_total", "measured packed-wire activation "
            "bytes (inter-layer hidden stream)", unit="bytes")
        self._m_dense = r.counter(
            "serving_dense_bytes_total", "dense int8 baseline bytes for "
            "the same activations", unit="bytes")
        self._g_pool_free = r.gauge(
            "serving_pool_pages_free", "free pages across all shards",
            unit="pages")
        self._g_pool_util = r.gauge(
            "serving_pool_utilization_ratio", "fraction of usable pages "
            "allocated", unit="ratio")
        self._g_layer_wire = r.gauge(
            "serving_layer_wire_bytes_per_token", "measured wire bytes "
            "per telemetered token entering each layer", unit="bytes",
            labelnames=("layer",))
        self._g_layer_sparsity = r.gauge(
            "serving_layer_msb_sparsity_ratio", "token-weighted MSB4 "
            "sub-precision sparsity of the hidden stream entering each "
            "layer", unit="ratio", labelnames=("layer",))
        self._g_kv2_used = r.gauge(
            "serving_pool_kv2_pages_used", "pages currently held at the "
            "KV2 tier (0 when the ladder is disarmed)", unit="pages")
        self._g_kv_saved = r.gauge(
            "serving_pool_kv_bytes_saved", "KV HBM bytes currently freed "
            "by demoted pages (KV4 cost minus KV2 cost of held KV2 "
            "pages)", unit="bytes")

    def _compiled(self, fn) -> CompiledStep:
        """A step closure run as a compiled step on the engine's device
        (always eagerly under gloo collectives)."""
        if self._gloo:
            return CompiledStep(fn, self.device, capture=False)
        return CompiledStep(fn, self.device, mempool=self._mempool)

    # -- public API --------------------------------------------------------

    def submit(self, prompt: List[int],
               sampling: SamplingParams = SamplingParams()) -> Request:
        return self.sched.submit([int(t) for t in prompt], sampling,
                                 self._clock())

    def stream(self, req: Request) -> Iterator[int]:
        """Drive the engine until ``req`` finishes, yielding its tokens
        as they are produced (other in-flight requests progress too)."""
        seen = 0
        while True:
            while seen < len(req.out_tokens):
                yield req.out_tokens[seen]
                seen += 1
            if req.done:
                return
            self.step()

    def run(self, max_steps: int = 100_000) -> None:
        """Step until every submitted request has finished."""
        for _ in range(max_steps):
            if not self.sched.has_work():
                return
            self.step()
        raise RuntimeError(f"engine did not drain in {max_steps} steps")

    def step(self) -> List[Tuple[int, int]]:
        """One scheduler iteration. Returns [(rid, token), ...] emitted."""
        tr = self.obs.tracer
        events: List[Tuple[int, int]] = []
        with tr.span("engine_step", step=self.steps):
            if self._kv2:
                self.pool.tick()
            with self._m_step_lat.time(phase="schedule"):
                plan = self.sched.schedule()
            if self.slo is not None:
                self.slo.observe("queue_depth", float(len(self.sched.waiting)))
            for req, start, n in plan.prefill:
                with tr.span("prefill_chunk", rid=req.rid, start=start, n=n):
                    with self._m_step_lat.time(phase="prefill"):
                        events.extend(self._run_prefill_chunk(req, start, n))
                self._m_tokens.inc(n, phase="prefill")
            if plan.decode:
                with tr.span("decode_batch", slots=len(plan.decode)):
                    with self._m_step_lat.time(phase="decode"):
                        events.extend(self._run_decode(plan.decode))
            if self._kv2:
                # the cold sweep AFTER the decode writes: a page demoted
                # here is first read, tier-routed, by the next step
                with self._m_step_lat.time(phase="demote"):
                    self.pool.demote_cold()
        if self.mesh is not None:
            self._check_lockstep(events)
        self._m_steps.inc()
        self.steps += 1
        return events

    def _check_lockstep(self, events: List[Tuple[int, int]]) -> None:
        """Raise unless every rank of the mesh emitted the same tokens
        this step (a digest all-gathered over the world)."""
        digest = torch.tensor(
            [[self.steps, len(events), hash(tuple(events)) & (2**62 - 1)]],
            dtype=torch.int64, device=self.device)
        got = all_gather(digest, None)
        if not bool((got == digest).all()):
            raise RuntimeError(f"mesh ranks diverged at step {self.steps}: "
                               f"(step, tokens, digest) by rank "
                               f"{got.tolist()}")

    # -- performance attribution ------------------------------------------

    def attribute_steps(self, hw=None):
        """Count the work of each serving step (prefill chunk, decode; the
        speculative engine adds draft and verify) from its shapes
        (``launch/step_cost.py``, this rank's share under a mesh) and
        register it (``serving_step_attr_*``). Explicit and idempotent:
        call once after construction (``serve.py --attribute`` does).

        ``hw`` (``costmodel.HardwareConfig``) sets the roofline peaks;
        by default the peaks of the engine's card
        (``costmodel.hardware_for``), or the H100 SXM's on the CPU.
        Returns the ``StepAttribution``.
        """
        from repro_torch.obs.attribution import StepAttribution
        if self._attr is None:
            self._attr = StepAttribution(self.obs,
                                         hw=hw or self._card_hardware())
        if "prefill" not in self._attr.phases():
            self._attr.attribute(
                "prefill", lambda: self._step_cost("prefill", self._chunk),
                tokens_per_step=self._chunk,
                predict_seconds=self._phase_predictor("prefill"))
        if "decode" not in self._attr.phases():
            self._attr.attribute(
                "decode", lambda: self._step_cost("decode", self._n_slots),
                tokens_per_step=self._n_slots,
                predict_seconds=self._phase_predictor("decode"))
        return self._attr

    def _card_hardware(self):
        from repro_torch.core import costmodel as CM
        if self.device.type == "cuda":
            return CM.hardware_for(torch.cuda.get_device_name(self.device))
        return CM.HardwareConfig()

    def _step_cost(self, phase: str, rows: int, window: int = 1,
                   kv2_share: float = 0.0):
        from repro_torch.launch.step_cost import step_cost
        lay = self.layout
        return step_cost(
            self.cfg, self.params, phase, rows=rows,
            table_tokens=self._n_page_steps * self.pool.page_size,
            window=window, data_ways=lay.data_ways if lay else 1,
            model_ways=lay.model_ways if lay else 1, kv2_share=kv2_share)

    def kv2_table_share(self) -> float:
        """The share of block-table entries the decode steps so far read
        from KV2 pages (every slot's row at the table's full width, the
        unit the decode's attributed bytes count); 0 before a decode and
        on an engine without the KV2 ladder."""
        return self._table_kv2 / self._table_entries \
            if self._table_entries else 0.0

    def _phase_predictor(self, phase: str):
        """sparsity -> predicted seconds/step closure over
        ``costmodel.phase_cost`` (the paper's §4 accelerator)."""
        from repro_torch.core import costmodel as CM
        shape = CM.lm_shape_of(self.cfg)
        hw = self._attr.hw
        decode = phase != "prefill"
        m_tokens = self._chunk if phase == "prefill" else self._n_slots
        seq_for_attn = self._n_page_steps * self.pool.page_size

        def predict(sparsity: float) -> float:
            layers = CM.lm_linear_layers(
                shape, m_tokens, sparsity, seq_for_attn=seq_for_attn,
                decode=decode)
            cost = CM.phase_cost(layers, hw, sparqle=True)
            return cost.cycles / (hw.freq_ghz * 1e9)
        return predict

    def aggregate_stats(self) -> Dict[str, float]:
        """Pool-level counters to pair with per-request ``req.stats()``."""
        self._refresh_gauges()
        r = self.obs.registry
        out = {
            "steps": int(r.value("serving_engine_steps_total")),
            "pool_pages_free": int(r.value("serving_pool_pages_free")),
            "pool_utilization": float(
                r.value("serving_pool_utilization_ratio")),
            "pool_evictions": int(r.value("serving_pool_evictions_total")),
        }
        if self._kv2:
            out["pool_demotions"] = int(
                r.value("serving_pool_demotions_total"))
            out["pool_promotions"] = int(
                r.value("serving_pool_promotions_total"))
            out["kv_bytes_reclaimed"] = int(
                r.value("serving_pool_kv_bytes_reclaimed_total"))
            out["kv2_pages_used"] = int(self.pool.kv2_used)
            out["kv_bytes_saved"] = int(self.pool.kv_bytes_saved())
        if self.mesh is not None:
            out["mesh"] = f"{self.layout.data_ways}x{self.layout.model_ways}"
            out["step_mode"] = self.step_mode
        if self.layer_wire_bytes is not None and self.wire_tokens:
            wire = float(self.layer_wire_bytes.sum())
            dense = float(self.layer_dense_bytes.sum())
            out["wire_bytes_total"] = wire
            out["wire_compression_pct"] = (1.0 - wire / dense) * 100.0
            out["layer_wire_bytes_per_token"] = (
                self.layer_wire_bytes / self.wire_tokens).tolist()
            out["layer_dense_bytes_per_token"] = (
                self.layer_dense_bytes / self.wire_tokens).tolist()
        return out

    def _refresh_gauges(self) -> None:
        self._g_pool_free.set(self.pool.num_free)
        self._g_pool_util.set(self.pool.utilization())
        self._g_kv2_used.set(self.pool.kv2_used)
        self._g_kv_saved.set(self.pool.kv_bytes_saved())
        if self.layer_wire_bytes is not None and self.wire_tokens:
            per_tok = self.layer_wire_bytes / self.wire_tokens
            spars = self.layer_sparsity_sum / self.wire_tokens
            for i in range(per_tok.shape[0]):
                self._g_layer_wire.set(float(per_tok[i]), layer=str(i))
                self._g_layer_sparsity.set(float(spars[i]), layer=str(i))
        self._join_attribution()

    def _join_attribution(self) -> None:
        """Join the attributed step costs with the measured
        ``serving_step_seconds`` means (every timed phase ends in a host
        read of the step's outputs, so its host time covers the device
        work, CUDA graphs included) into the roofline and drift gauges,
        and the measured wire bytes/token with Eq. 1 per layer. A KV2
        engine's decode is counted again first, at the share of its table
        the decodes so far read from KV2 pages."""
        if self._attr is None:
            return
        mean_sparsity = 0.0
        if self.layer_sparsity_sum is not None and self.wire_tokens:
            mean_sparsity = float(
                self.layer_sparsity_sum.mean() / self.wire_tokens)
        share = self.kv2_table_share()
        if share != self._attr_kv2_share and "decode" in self._attr.phases():
            self._attr.recount("decode", lambda: self._step_cost(
                "decode", self._n_slots, kv2_share=share))
            self._attr_kv2_share = share
        for phase in self._attr.phases():
            if self._m_step_lat.count(phase=phase):
                self._attr.observe_runtime(
                    phase, self._m_step_lat.mean(phase=phase),
                    sparsity=mean_sparsity)
        if self.layer_wire_bytes is not None and self.wire_tokens:
            from repro_torch.core.packing import PBM_WORD_BITS, pad_k
            kp = pad_k(self.cfg.d_model)
            fixed = kp / 2.0 + (kp // PBM_WORD_BITS) * 4.0  # LSB4 + PBM
            spars = self.layer_sparsity_sum / self.wire_tokens
            predicted = float(sum(fixed + (1.0 - s) * kp / 2.0
                                  for s in spars))  # Eq. 1 per layer
            measured = float(self.layer_wire_bytes.sum() / self.wire_tokens)
            self._attr.observe_wire(measured, predicted)

    def metrics_snapshot(self) -> Dict[str, object]:
        self._refresh_gauges()
        return self.obs.registry.snapshot()

    # -- internals ---------------------------------------------------------

    def _account_wire(self, req: Request, layer_wire: np.ndarray,
                      layer_dense: np.ndarray,
                      layer_spars_weighted: np.ndarray,
                      n_tokens: int) -> None:
        wire, dense = float(layer_wire.sum()), float(layer_dense.sum())
        req.wire_bytes_sum += wire
        req.dense_bytes_sum += dense
        req.wire_tokens += n_tokens
        if self.layer_wire_bytes is None:
            n = layer_wire.shape[0]
            self.layer_wire_bytes = np.zeros(n, np.float64)
            self.layer_dense_bytes = np.zeros(n, np.float64)
            self.layer_sparsity_sum = np.zeros(n, np.float64)
        self.layer_wire_bytes += layer_wire
        self.layer_dense_bytes += layer_dense
        self.layer_sparsity_sum += layer_spars_weighted
        self.wire_tokens += n_tokens
        self._m_wire.inc(wire)
        self._m_dense.inc(dense)

    def _block_table_row(self, req: Request) -> np.ndarray:
        row = np.zeros((self._n_page_steps,), np.int32)
        pages = self.pool.pages_of(req.rid)
        row[:len(pages)] = pages
        return row

    def _tier_table_row(self, req: Request) -> np.ndarray:
        """Per-page tier ids parallel to :meth:`_block_table_row` (the
        padded tail is tier 0, matching the KV4 null page it names)."""
        row = np.zeros((self._n_page_steps,), np.int32)
        tiers = self.pool.tiers_of(req.rid)
        row[:len(tiers)] = tiers
        return row

    def _prefill_tables(self, req: Request) -> np.ndarray:
        """(D, Pmax) block table of a prefill chunk: one row a data shard,
        the owner's holding the request's shard-local pages, the others
        all-null (D = 1 without a mesh)."""
        d = 1 if self.layout is None else self.layout.data_ways
        tables = np.zeros((d, self._n_page_steps), np.int32)
        tables[self.pool.shard_of(req.rid)] = self._block_table_row(req)
        return tables

    def _local(self, a: np.ndarray) -> np.ndarray:
        """This data rank's contiguous slice of a per-slot host array."""
        if self.layout is None or self.layout.data_ways == 1:
            return a
        n = self._n_slots // self.layout.data_ways
        lo = self.layout.coords.data_rank * n
        return a[lo:lo + n]

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _scalar(self, v: int) -> torch.Tensor:
        """A (1,) int32 step input on the device (a traced scalar)."""
        return self._to_dev(np.array([v], np.int32))

    @staticmethod
    def _host(tel: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
        return {k: v.double().cpu().numpy() for k, v in tel.items()}

    def _sample(self, req: Request, logits: np.ndarray) -> int:
        t = req.sampling.temperature
        if t <= 0.0:
            return int(np.argmax(logits))
        rng = self._rngs.setdefault(
            req.rid, np.random.default_rng(req.sampling.seed + req.rid))
        z = (logits.astype(np.float64) - logits.max()) / t
        p = np.exp(z)
        p /= p.sum()
        return int(rng.choice(len(p), p=p))

    def _emit(self, req: Request, token: int) -> Optional[Tuple[int, int]]:
        """Hand ``token`` to ``req``; None (and nothing appended) when the
        request has already finished — a speculative window may hold more
        tokens than the request has left."""
        if req.done:
            return None
        now = self._clock()
        if req.t_first is None:
            req.t_first = now
            ttft = now - req.arrival
            self._m_ttft.observe(ttft)
            if self.slo is not None:
                self.slo.observe("ttft", ttft)
        elif req.t_last is not None:
            tpot = now - req.t_last
            self._m_tpot.observe(tpot)
            if self.slo is not None:
                self.slo.observe("tpot", tpot)
        req.t_last = now
        self._m_emitted.inc()
        req.context.append(token)
        req.out_tokens.append(token)
        s = req.sampling
        if (req.n_generated >= s.max_new_tokens or
                (s.stop_token is not None and token == s.stop_token)):
            self.sched.finish(req)
            self._rngs.pop(req.rid, None)
        return (req.rid, token)

    def _run_prefill_chunk(self, req: Request, start: int,
                           n: int) -> List[Tuple[int, int]]:
        toks = np.zeros((1, self._chunk), np.int32)
        toks[0, :n] = req.context[start:start + n]
        logits, self.pool.state, tel = self._prefill_fn(
            self.params, self.pool.state, self._to_dev(toks),
            self._scalar(start), self._scalar(n),
            self._to_dev(self._prefill_tables(req)))
        tel = self._host(tel)
        req.sparsity_sum += float(tel["sparsity"]) * n
        req.sparsity_n += n
        self._account_wire(req, tel["layer_wire_bytes"],
                           tel["layer_dense_bytes"],
                           tel["layer_sparsity"] * n, n)
        if not self.sched.prefill_advanced(req, n):
            return []
        self.sched.to_running(req)
        ev = self._emit(req, self._sample(req,
                                          logits[0].float().cpu().numpy()))
        return [ev] if ev else []

    def _decode_inputs(self, decode: List[Request]):
        """Host arrays of one decode batch: last token, its position and
        the block table of every slot (inactive slots zero)."""
        B = self._n_slots
        token = np.zeros((B,), np.int32)
        pos = np.zeros((B,), np.int32)
        tables = np.zeros((B, self._n_page_steps), np.int32)
        for req in decode:
            token[req.slot] = req.context[-1]
            pos[req.slot] = len(req.context) - 1
            tables[req.slot] = self._block_table_row(req)
        return token, pos, tables

    def _run_decode(self, decode: List[Request]) -> List[Tuple[int, int]]:
        """One full decode step for the decode set (the speculative
        engine overrides this with its draft/verify cycle)."""
        tiers = ()
        if self._kv2:
            # touch BEFORE reading the tables: this step writes K/V at
            # pos, so the page under it must be KV4 (promote on touch),
            # and a promotion changes the page id
            ps = self.pool.page_size
            for req in decode:
                fp = (len(req.context) - 1) // ps
                self.pool.touch(req.rid, fp, fp)
            tier_rows = np.zeros((self._n_slots, self._n_page_steps),
                                 np.int32)
            for req in decode:
                tier_rows[req.slot] = self._tier_table_row(req)
            tiers = (self._to_dev(tier_rows),)
            self._table_kv2 += int(tier_rows.sum())
            self._table_entries += tier_rows.size
        token, pos, tables = (self._local(a)
                              for a in self._decode_inputs(decode))
        logits, self.pool.state, tel = self._decode_fn(
            self.params, self.pool.state, self._to_dev(token),
            self._to_dev(pos), self._to_dev(tables), *tiers)
        logits = logits.float().cpu().numpy()
        tel = self._host(tel)
        events = []
        for req in decode:
            req.sparsity_sum += float(tel["sparsity"][req.slot])
            req.sparsity_n += 1
            self._account_wire(
                req, tel["layer_wire_bytes"][:, req.slot],
                tel["layer_dense_bytes"][:, req.slot],
                tel["layer_sparsity"][:, req.slot], 1)
            ev = self._emit(req, self._sample(req, logits[req.slot]))
            if ev:
                events.append(ev)
        self._m_tokens.inc(len(decode), phase="decode")
        return events
