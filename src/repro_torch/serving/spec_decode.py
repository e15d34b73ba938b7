"""Self-speculative decoding: LSB4-only drafting, batched full verification
(torch twin of ``repro.serving.spec_decode``).

SPARQLe's hybrid format holds a free draft model (paper §3.3): a forward
whose projections run the dense LSB4 pass alone (``qlinear.msb_skip_scope``)
approximates the full model with the same weights and the same KV cache.
Each decode step of this engine is one cycle:

  1. **draft** — γ LSB4-only decode steps
     (``steps.make_engine_decode(msb_skip=True, with_telemetry=False)``),
     each writing the draft's approximate K/V and proposing the next token
     (greedy at temperature 0, sampled from the draft otherwise);
  2. **verify** — one full-precision step over the (γ+1)-token window of
     every decode slot (``steps.make_engine_verify_window``), overwriting
     the draft K/V. Its attention kernel is bit-exact with γ+1 decode
     steps, and its norms and head run at the decode step's shape, so at
     temperature 0 the stream equals the base engine's;
  3. **accept** — greedy exact match at temperature 0, rejection sampling
     otherwise; a cycle emits between 1 and γ+1 tokens;
  4. **rollback** — ``PagedKVPool.truncate`` frees the pages past the
     accepted context; rejected K/V left mid-page lies past the causal
     mask until overwritten.

A speculative slot burns 2γ+1 compute tokens per scheduler step and
writes K/V up to γ positions ahead: ``SchedulerConfig.
decode_tokens_per_slot`` / ``decode_lookahead`` carry both. The draft
steps carry no telemetry, so only the verify window's γ+1 tokens enter
the wire-byte accounting; ``Request.draft_tokens`` counts the drafts.

    eng = SpeculativeEngine(cfg, qparams, spec=SpecConfig(gamma=2))
    h = eng.submit(prompt, SamplingParams(max_new_tokens=32))
    eng.run()
    h.stats()["spec_acceptance_rate"], h.stats()["spec_tokens_per_step"]

With ``mesh=`` the draft and verify steps run the engine's mesh layout
(``serving/engine.py``), so a sharded speculative stream equals the
single-device base engine's.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.obs import Observability
from repro_torch.serving.engine import Engine
from repro_torch.serving.kv_pool import PoolConfig
from repro_torch.serving.scheduler import Request, SchedulerConfig


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    gamma: int = 2                   # draft tokens per verify cycle

    def __post_init__(self):
        if self.gamma < 1:
            raise ValueError(f"gamma must be >= 1, got {self.gamma}")


def _softmax(logits: np.ndarray, temperature: float) -> np.ndarray:
    z = (logits.astype(np.float64) - logits.max()) / temperature
    p = np.exp(z)
    return p / p.sum()


class SpeculativeEngine(Engine):
    """Continuous-batching engine with self-speculative decode steps.

    Drop-in for :class:`Engine`: the same submit/run API, pool and
    chunked prefill; only the decode step becomes γ LSB4-only drafts and
    one batched full-precision verify.
    """

    def __init__(self, cfg: ModelConfig, params,
                 pool_config: Optional[PoolConfig] = None,
                 sched_config: Optional[SchedulerConfig] = None,
                 spec: SpecConfig = SpecConfig(),
                 clock=time.monotonic,
                 obs: Optional[Observability] = None,
                 device="cuda", mesh=None, slos=None):
        from repro_torch.launch import steps as S
        self.spec = spec
        g = spec.gamma
        if pool_config is not None and pool_config.kv2_pages:
            # the draft and verify steps read the pool through tier-
            # unaware kernels, so a demoted page would be read as garbage
            raise NotImplementedError(
                "the KV2 precision ladder (kv2_pages > 0) is not "
                "supported by the speculative engine")
        sched_config = dataclasses.replace(
            sched_config or SchedulerConfig(),
            decode_tokens_per_slot=2 * g + 1,   # γ draft + (γ+1) verify
            decode_lookahead=g)
        super().__init__(cfg, params, pool_config=pool_config,
                         sched_config=sched_config, clock=clock, obs=obs,
                         device=device, mesh=mesh, slos=slos)
        self._draft_fn = self._compiled(S.make_engine_decode(
            cfg, msb_skip=True, with_telemetry=False, mesh=self.mesh))
        self._verify_fn = self._compiled(
            S.make_engine_verify_window(cfg, mesh=self.mesh))
        r = self.obs.registry
        self._m_spec_proposed = r.counter(
            "serving_spec_draft_proposed_total", "draft tokens the "
            "verifier examined", unit="tokens")
        self._m_spec_accepted = r.counter(
            "serving_spec_draft_accepted_total", "examined draft tokens "
            "the full-precision model accepted", unit="tokens")
        self._m_spec_cycles = r.counter(
            "serving_spec_cycles_total", "draft+verify cycles run (one "
            "per decode slot per engine step)", unit="steps")
        self._m_spec_emitted = r.counter(
            "serving_spec_tokens_emitted_total", "tokens emitted by "
            "accept/correct/bonus across all cycles", unit="tokens")

    # -- performance attribution ------------------------------------------

    def attribute_steps(self, hw=None):
        """Extend the base attribution with the speculative steps. The
        timed ``draft`` phase wraps the whole γ-step host loop, so the
        draft is attributed with ``calls_per_step=γ``; ``verify`` is one
        (γ+1)-token window step a phase."""
        attr = super().attribute_steps(hw=hw)
        g = self.spec.gamma
        if "draft" not in attr.phases():
            attr.attribute(
                "draft", lambda: self._step_cost("draft", self._n_slots),
                tokens_per_step=self._n_slots * g, calls_per_step=g,
                predict_seconds=self._spec_predictor("draft"))
        if "verify" not in attr.phases():
            attr.attribute(
                "verify",
                lambda: self._step_cost("verify", self._n_slots, g + 1),
                tokens_per_step=self._n_slots * (g + 1),
                predict_seconds=self._spec_predictor("verify"))
        return attr

    def _spec_predictor(self, phase: str):
        """sparsity -> predicted seconds per TIMED phase: γ LSB4-only
        decode rounds for draft, one (γ+1)-token window for verify."""
        from repro_torch.core import costmodel as CM
        shape = CM.lm_shape_of(self.cfg)
        hw = self._attr.hw
        g = self.spec.gamma
        seq_for_attn = self._n_page_steps * self.pool.page_size
        lsb_only = phase == "draft"
        m_tokens = self._n_slots if lsb_only else self._n_slots * (g + 1)
        calls = g if lsb_only else 1

        def predict(sparsity: float) -> float:
            layers = CM.lm_linear_layers(
                shape, m_tokens, sparsity, seq_for_attn=seq_for_attn,
                decode=True)
            cost = CM.phase_cost(layers, hw, sparqle=True,
                                 lsb_only=lsb_only)
            return calls * cost.cycles / (hw.freq_ghz * 1e9)
        return predict

    # -- decode path -------------------------------------------------------

    def _run_decode(self, decode: List[Request]) -> List[Tuple[int, int]]:
        B, g = self._n_slots, self.spec.gamma
        token, pos, tables = self._decode_inputs(decode)
        pos_d = self._to_dev(self._local(pos))
        tables_d = self._to_dev(self._local(tables))

        # draft: γ LSB4-only steps, each proposal fed forward host-side
        window = np.zeros((B, g + 1), np.int32)
        window[:, 0] = token
        cur = self._to_dev(self._local(token))
        dlogs = []
        with self.obs.tracer.span("spec_draft", slots=len(decode), gamma=g):
            with self._m_step_lat.time(phase="draft"):
                for i in range(g):
                    dlg, self.pool.state, _ = self._draft_fn(
                        self.params, self.pool.state, cur, pos_d + i,
                        tables_d)
                    dlg = dlg.float().cpu().numpy()
                    dlogs.append(dlg)
                    nxt = np.zeros((B,), np.int32)
                    for req in decode:
                        nxt[req.slot] = self._sample(req, dlg[req.slot])
                    window[:, i + 1] = nxt
                    cur = self._to_dev(self._local(nxt))
        draft_logits = np.stack(dlogs, axis=1)              # (B, γ, V)
        self._m_tokens.inc(len(decode) * g, phase="draft")

        # verify: one full-precision step over every slot's window
        with self.obs.tracer.span("spec_verify", slots=len(decode),
                                  window=g + 1):
            with self._m_step_lat.time(phase="verify"):
                vlg, self.pool.state, tel = self._verify_fn(
                    self.params, self.pool.state,
                    self._to_dev(self._local(window)), pos_d, tables_d)
                vlg = vlg.float().cpu().numpy()             # (B, γ+1, V)
        self._m_tokens.inc(len(decode) * (g + 1), phase="verify")
        tel = self._host(tel)

        events: List[Tuple[int, int]] = []
        for req in decode:
            s = req.slot
            req.sparsity_sum += float(tel["sparsity"][s]) * (g + 1)
            req.sparsity_n += g + 1
            req.draft_tokens += g       # telemetry-free: not wire tokens
            self._account_wire(
                req, tel["layer_wire_bytes"][:, s],
                tel["layer_dense_bytes"][:, s],
                tel["layer_sparsity"][:, s] * (g + 1), g + 1)
            events.extend(self._accept_and_emit(req, window[s], vlg[s],
                                                draft_logits[s]))
            if not req.done:
                # rollback: keep the pages of the accepted context (the
                # next cycle writes context[-1]'s slot first)
                self.pool.truncate(req.rid, len(req.context))
        return events

    # -- acceptance --------------------------------------------------------

    def _accept_and_emit(self, req: Request, window: np.ndarray,
                         vlogits: np.ndarray, dlogits: np.ndarray
                         ) -> List[Tuple[int, int]]:
        """Walk one request's verified window, emitting accepted tokens.

        ``window`` (γ+1,): the last accepted token, then the drafts;
        ``vlogits`` (γ+1, V) full-precision logits after each window
        token; ``dlogits`` (γ, V) the draft logits each proposal came
        from."""
        g = self.spec.gamma
        t = req.sampling.temperature
        events: List[Tuple[int, int]] = []
        emitted = accepted = examined = 0

        def emit(token: int) -> None:
            nonlocal emitted
            ev = self._emit(req, token)
            if ev:
                events.append(ev)
            emitted += 1

        if t <= 0.0:
            # emit full-precision argmaxes while the draft guessed them;
            # the first miss emits the correction, a full window the bonus
            for i in range(g + 1):
                if req.done:
                    break
                y = int(np.argmax(vlogits[i]))
                emit(y)
                if i == g:
                    break
                examined += 1
                if int(window[i + 1]) != y:
                    break
                accepted += 1
        else:
            # rejection sampling: emitted tokens follow the full model
            rng = self._rngs.setdefault(
                req.rid, np.random.default_rng(req.sampling.seed + req.rid))
            rejected = False
            for i in range(g):
                if req.done:
                    break
                d = int(window[i + 1])
                p_full = _softmax(vlogits[i], t)
                p_draft = _softmax(dlogits[i], t)
                examined += 1
                if rng.random() < min(1.0, p_full[d] /
                                      max(p_draft[d], 1e-300)):
                    emit(d)
                    accepted += 1
                    continue
                res = np.maximum(p_full - p_draft, 0.0)
                tot = res.sum()
                p = res / tot if tot > 0.0 else p_full
                emit(int(rng.choice(len(p), p=p)))
                rejected = True
                break
            if not rejected and not req.done:
                p_full = _softmax(vlogits[g], t)
                emit(int(rng.choice(len(p_full), p=p_full)))

        # proposed counts only the drafts the verifier examined: a request
        # that finishes mid-window leaves its tail unjudged
        req.draft_proposed += examined
        req.draft_accepted += accepted
        req.spec_steps += 1
        req.spec_emitted += emitted
        self._m_spec_proposed.inc(examined)
        self._m_spec_accepted.inc(accepted)
        self._m_spec_cycles.inc()
        self._m_spec_emitted.inc(emitted)
        return events

    # -- telemetry ---------------------------------------------------------

    def aggregate_stats(self) -> dict:
        out = super().aggregate_stats()
        r = self.obs.registry
        proposed = int(r.value("serving_spec_draft_proposed_total"))
        accepted = int(r.value("serving_spec_draft_accepted_total"))
        cycles = int(r.value("serving_spec_cycles_total"))
        emitted = int(r.value("serving_spec_tokens_emitted_total"))
        out["spec_gamma"] = self.spec.gamma
        if proposed:
            out["spec_acceptance_rate"] = accepted / proposed
        if cycles:
            out["spec_tokens_per_step"] = emitted / cycles
        return out
