"""Continuous-batching serving engine over the paged packed-KV4 pool
(torch twin of ``repro.serving.engine``, single device).

Ties together the scheduler, the page pool and the two step functions of
``launch/steps.py``: ``prefill_chunk`` — one (1, prefill_chunk) slice of
one prompt — and ``decode`` — one token for every decode slot at once,
through the paged decode-attention kernel. Inactive decode slots ride
along pointing at the null page. Sampling is host-side numpy, as in the
JAX engine.

    eng = Engine(cfg, qparams)                 # device="cuda" by default
    h = eng.submit([1, 2, 3], SamplingParams(max_new_tokens=8))
    eng.run()
    print(h.out_tokens, h.stats())
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.qlinear import tree_to
from repro_torch.models.model import check_paged_support
from repro_torch.obs import Observability
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
                 device="cuda"):
        """``params`` is the served (quantized) tree; it is moved to
        ``device`` (a no-op for tensors already there). ``obs`` is the
        metrics registry + tracer every layer reports into."""
        from repro_torch.launch import steps as S
        check_paged_support(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self._clock = clock
        self.obs = obs if obs is not None else Observability(clock=clock)
        self._init_metrics()
        self.params = tree_to(params, self.device)
        self.pool = PagedKVPool(cfg, pool_config or PoolConfig(),
                                obs=self.obs, device=self.device)
        self.sched = Scheduler(self.pool, sched_config or SchedulerConfig(),
                               obs=self.obs)
        scfg = self.sched.cfg
        self._chunk = scfg.prefill_chunk
        self._n_slots = scfg.max_decode_batch
        self._n_page_steps = scfg.max_pages_per_seq
        self._prefill_fn = S.make_engine_prefill_chunk(cfg)
        self._decode_fn = S.make_engine_decode(cfg)
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

    # -- public API --------------------------------------------------------

    def submit(self, prompt: List[int],
               sampling: SamplingParams = SamplingParams()) -> Request:
        return self.sched.submit([int(t) for t in prompt], sampling,
                                 self._clock())

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
            with self._m_step_lat.time(phase="schedule"):
                plan = self.sched.schedule()
            for req, start, n in plan.prefill:
                with tr.span("prefill_chunk", rid=req.rid, start=start, n=n):
                    with self._m_step_lat.time(phase="prefill"):
                        events.extend(self._run_prefill_chunk(req, start, n))
                self._m_tokens.inc(n, phase="prefill")
            if plan.decode:
                with tr.span("decode_batch", slots=len(plan.decode)):
                    with self._m_step_lat.time(phase="decode"):
                        events.extend(self._run_decode(plan.decode))
        self._m_steps.inc()
        self.steps += 1
        return events

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
        if self.layer_wire_bytes is not None and self.wire_tokens:
            per_tok = self.layer_wire_bytes / self.wire_tokens
            spars = self.layer_sparsity_sum / self.wire_tokens
            for i in range(per_tok.shape[0]):
                self._g_layer_wire.set(float(per_tok[i]), layer=str(i))
                self._g_layer_sparsity.set(float(spars[i]), layer=str(i))

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

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

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

    def _emit(self, req: Request, token: int) -> Tuple[int, int]:
        now = self._clock()
        if req.t_first is None:
            req.t_first = now
            self._m_ttft.observe(now - req.arrival)
        elif req.t_last is not None:
            self._m_tpot.observe(now - req.t_last)
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
            self.params, self.pool.state, self._to_dev(toks), start, n,
            self._to_dev(self._block_table_row(req)[None]))
        tel = self._host(tel)
        req.sparsity_sum += float(tel["sparsity"]) * n
        req.sparsity_n += n
        self._account_wire(req, tel["layer_wire_bytes"],
                           tel["layer_dense_bytes"],
                           tel["layer_sparsity"] * n, n)
        if not self.sched.prefill_advanced(req, n):
            return []
        self.sched.to_running(req)
        return [self._emit(req, self._sample(
            req, logits[0].float().cpu().numpy()))]

    def _run_decode(self, decode: List[Request]) -> List[Tuple[int, int]]:
        B = self._n_slots
        token = np.zeros((B,), np.int32)
        pos = np.zeros((B,), np.int32)
        tables = np.zeros((B, self._n_page_steps), np.int32)
        for req in decode:
            token[req.slot] = req.context[-1]
            pos[req.slot] = len(req.context) - 1
            tables[req.slot] = self._block_table_row(req)
        logits, self.pool.state, tel = self._decode_fn(
            self.params, self.pool.state, self._to_dev(token),
            self._to_dev(pos), self._to_dev(tables))
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
            events.append(self._emit(req, self._sample(req,
                                                       logits[req.slot])))
        self._m_tokens.inc(len(decode), phase="decode")
        return events
