"""Analytical energy/latency cost model of the SPARQLe accelerator (paper
§4), torch-free twin of ``repro.core.costmodel`` (pure Python: the same
functions and the same §4 knobs, digit for digit, so that the serve's
cost-model prediction prints the numbers the JAX serve prints at the
same sparsity).

Faithful in *structure* to the paper's methodology:

  * iso-MAC comparison: 256 PEs, Int4xInt4 MACs, 2048 MACs/cycle for both the
    dense baseline and the SPARQLe hybrid accelerator (Table 1);
  * Int8 x Int4 = 2 compute rounds on Int4 MACs, Int8xInt8 = 4, Int4xInt4 /
    Int4xInt2 = 1 (paper §3.3 "compute rounds");
  * SPARQLe executes dense LSB4 pass (1 round) + sparse MSB4 pass
    ((1 - s) rounds, PBM-gated), sequentially on the shared MACs;
  * tiled output-stationary dataflow with load-compute-drain overlap
    (Fig. 5): per-layer latency = max(load, compute, drain) + pipeline fill;
  * activation traffic in SPARQLe format: 0.5 B (LSB4) + 1/8 B (PBM) +
    (1 - s) * 0.5 B (compressed MSB4) per element (Eq. 1); outputs drained
    already re-encoded (drain-path splitters + sparse encoder);
  * activation-activation ops (QK^T, softmax*V) and KV-cache traffic are
    modeled but NOT accelerated by SPARQLe (paper §5.1);
  * DRAM energy/latency excluded (paper §4); SRAM-level traffic only;
  * SPARQLe control overhead: +7 % power, +5.5 % area (paper §5.2).

The paper leaves several constants unspecified (SRAM-level tile reuse
factors, decode batch, per-op energies). These are explicit knobs on
:class:`HardwareConfig`, with the JAX package's fitted defaults.

The system-level peaks on :class:`HardwareConfig` (``peak_flops``,
``hbm_bw``, ``link_bw``) describe the card the port serves on, not the
§4 accelerator: the live attribution (``obs/attribution.py``) divides a
step's achieved rates by them. They are NVIDIA's published dense H100
figures (:data:`H100_PEAKS`, :func:`hardware_for`), which ``chip_smoke.py``
also divides its kernel bounds by.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class HardwareConfig:
    """Table 1 + inferred dataflow/energy knobs (7nm estimates)."""

    n_pes: int = 256
    macs_per_cycle: int = 2048           # Int4xInt4 MACs
    freq_ghz: float = 1.0
    sram_bytes: int = int(1.5 * 2**20)
    load_bw: float = 32.0                # B/cycle SRAM -> circular buffers
    drain_bw: float = 32.0               # B/cycle write-combine -> SRAM
    # SRAM-level tile reuse (inferred; fit by bench_costmodel --calibrate
    # against the paper's 12 reported improvements, RMSE 4.2pp):
    tile_m: int = 128                    # act rows resident -> weight reuse M/tile_m
    tile_n: int = 128                    # out cols resident -> act reuse N/tile_n
    # 7nm energy constants (pJ):
    e_mac_int4: float = 0.08             # per Int4xInt4 MAC
    e_sram_byte: float = 1.3             # per byte SRAM<->buffers
    e_rf_byte: float = 0.08              # per byte buffer<->RF
    leak_pj_per_cycle: float = 400.0     # array leakage+clock (calibrated)
    # SPARQLe overheads (paper §5.2):
    sparqle_power_ovh: float = 1.07
    sparqle_area_ovh: float = 1.055
    pipeline_fill_cycles: int = 64
    # system-level roofline peaks of the serving card (H100 SXM by
    # default; hardware_for(name) gives the card's): the live attribution
    # (obs/attribution.py) normalizes achieved op/s, HBM bytes/s and
    # interconnect bytes/s against these — they describe the card, not
    # the §4 SRAM-level accelerator modeled by the knobs above
    peak_flops: float = 1979e12          # int8 op/s, dense
    hbm_bw: float = 3.35e12              # B/s
    link_bw: float = 900e9               # B/s, NVLink (all links)


# Published dense peaks of the H100 parts (NVIDIA H100 Tensor Core GPU
# data sheet, without sparsity): HBM bytes/s, int8 tensor-core op/s,
# float32 (non-tensor) flop/s and NVLink bytes/s (all links), by the
# part's name as nvidia-smi reports it.
H100_PEAKS: Dict[str, Tuple[float, float, float, float]] = {
    "PCIe": (2.0e12, 1513e12, 51e12, 600e9),
    "NVL": (3.9e12, 1671e12, 60e12, 600e9),
    "SXM": (3.35e12, 1979e12, 67e12, 900e9),
}


def peaks_for(device_name: str) -> Tuple[float, float, float, float]:
    """:data:`H100_PEAKS` of the part ``device_name`` names (the SXM part
    unless the name says PCIe or NVL)."""
    for key in ("PCIe", "NVL"):
        if key in device_name:
            return H100_PEAKS[key]
    return H100_PEAKS["SXM"]


def hardware_for(device_name: str) -> "HardwareConfig":
    """The §4 knobs with the system peaks of the card ``device_name``
    names (``torch.cuda.get_device_name``)."""
    hbm, int8, _, link = peaks_for(device_name)
    return HardwareConfig(peak_flops=int8, hbm_bw=hbm, link_bw=link)


@dataclasses.dataclass
class LinearShape:
    """One matmul A(M,K) @ W(K,N); ``s`` = MSB4 sparsity of its input acts."""

    name: str
    m: int
    k: int
    n: int
    w_bits: int = 4
    s: float = 0.0                      # sub-precision sparsity of input acts
    sparqle_eligible: bool = True       # False for act x act (QK^T, PV)
    a_bits: int = 8                     # activation operand width
    count: int = 1                      # how many identical instances


@dataclasses.dataclass
class PhaseCost:
    cycles: float
    energy_pj: float
    load_bytes: float
    compute_macs: float
    drain_bytes: float

    @property
    def latency_us(self):
        return self.cycles / 1e3  # at 1 GHz, cycles -> ns; /1e3 -> us

    def __add__(self, o: "PhaseCost") -> "PhaseCost":
        return PhaseCost(
            self.cycles + o.cycles,
            self.energy_pj + o.energy_pj,
            self.load_bytes + o.load_bytes,
            self.compute_macs + o.compute_macs,
            self.drain_bytes + o.drain_bytes,
        )


ZERO = PhaseCost(0.0, 0.0, 0.0, 0.0, 0.0)


def _act_bytes_per_elem(sparqle: bool, s: float, a_bits: int,
                        lsb_only: bool = False) -> float:
    if not sparqle:
        return a_bits / 8.0
    half = a_bits / 16.0               # p/2 bits -> bytes
    if lsb_only:
        return half                    # draft streams the LSB plane alone
    return half + 1.0 / 8.0 + (1.0 - s) * half  # LSB + PBM + compressed MSB


def linear_cost(
    shape: LinearShape, hw: HardwareConfig, sparqle: bool,
    lsb_only: bool = False
) -> PhaseCost:
    """Cost of one tiled linear layer execution (one of ``count``).

    ``lsb_only`` models the self-speculative *draft* forward: the sparse
    MSB4 pass is statically elided, so an eligible linear costs exactly
    1 compute round (vs 1 + (1 - s) for the full hybrid pass) and streams
    only the LSB plane (p/2 bits/elem — no PBM, no compacted MSB).
    """
    m, k, n = shape.m, shape.k, shape.n
    macs = m * k * n
    use_sparqle = sparqle and shape.sparqle_eligible and shape.a_bits == 8
    draft = lsb_only and use_sparqle

    # ---- compute rounds on Int4 MACs (paper §3.3) ----
    base_rounds = max(1, shape.a_bits // 4)  # int8 ops take 2 rounds
    if draft:
        rounds = 1.0                         # dense LSB4 pass only
    elif use_sparqle:
        rounds = 1.0 + (1.0 - shape.s)       # dense LSB4 + sparse MSB4
    else:
        rounds = float(base_rounds)
    compute_cycles = rounds * macs / hw.macs_per_cycle

    # ---- SRAM-level traffic with tiled reuse ----
    n_reload = max(1.0, n / hw.tile_n)       # act reloads across N tiles
    m_reload = max(1.0, m / hw.tile_m)       # weight reloads across M tiles
    a_bpe = _act_bytes_per_elem(use_sparqle, shape.s, shape.a_bits, draft)
    act_bytes = m * k * n_reload * a_bpe
    w_bytes = k * n * m_reload * (shape.w_bits / 8.0)
    load_bytes = act_bytes + w_bytes
    # outputs drained re-encoded (SPARQLe) or int8 (baseline); the draft
    # drains LSB-only re-encoded streams too
    out_bpe = _act_bytes_per_elem(use_sparqle, shape.s, 8, draft)
    drain_bytes = m * n * out_bpe

    load_cycles = load_bytes / hw.load_bw
    drain_cycles = drain_bytes / hw.drain_bw
    cycles = max(load_cycles, compute_cycles, drain_cycles) + hw.pipeline_fill_cycles

    # ---- energy ----
    mac_energy = rounds * macs * hw.e_mac_int4
    sram_energy = (load_bytes + drain_bytes) * hw.e_sram_byte
    rf_energy = rounds * macs * 2 * hw.e_rf_byte * 0.5  # two nibble operands/MAC
    energy = mac_energy + sram_energy + rf_energy + cycles * hw.leak_pj_per_cycle
    if use_sparqle:
        energy *= hw.sparqle_power_ovh  # sparsity-logic power overhead

    return PhaseCost(cycles, energy, load_bytes, macs * rounds, drain_bytes)


def phase_cost(
    layers: List[LinearShape], hw: HardwareConfig, sparqle: bool,
    lsb_only: bool = False
) -> PhaseCost:
    """Sequential multi-layer execution (paper §4: 'modeled as sequential')."""
    total = ZERO
    for l in layers:
        c = linear_cost(l, hw, sparqle, lsb_only)
        total = total + PhaseCost(
            c.cycles * l.count, c.energy_pj * l.count,
            c.load_bytes * l.count, c.compute_macs * l.count,
            c.drain_bytes * l.count,
        )
    return total


# ---------------------------------------------------------------------------
# Model descriptions: per-layer linear lists for the paper's three models
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LMShape:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    w_bits: int = 4
    gated_mlp: bool = True               # SwiGLU: gate+up+down


PAPER_MODELS: Dict[str, LMShape] = {
    # BitNet b1.58 3B (paper [15]): 26L, d=3200, ff=8640, W2A8KV4
    "bitnet-3b": LMShape("bitnet-3b", 26, 3200, 32, 32, 8640, 32002, w_bits=2),
    # Llama2-7B (QServe W4A8KV4)
    "llama2-7b": LMShape("llama2-7b", 32, 4096, 32, 32, 11008, 32000, w_bits=4),
    # Llama3-8B (QServe W4A8KV4)
    "llama3-8b": LMShape("llama3-8b", 32, 4096, 32, 8, 14336, 128256, w_bits=4),
}


def lm_shape_of(cfg) -> LMShape:
    """A served model config (``configs.base.ModelConfig``) as the LMShape
    the cost model expands: its dims, an MoE model's expert width when it
    has no dense FFN."""
    return LMShape(cfg.name, cfg.n_layers, cfg.d_model, max(1, cfg.n_heads),
                   max(1, cfg.n_kv_heads), max(1, cfg.d_ff or cfg.moe_d_ff),
                   cfg.vocab, w_bits=cfg.w_bits)


def lm_linear_layers(
    model: LMShape,
    m_tokens: int,
    s_linear: float,
    *,
    seq_for_attn: int,
    decode: bool,
    per_layer_s: Optional[List[Dict[str, float]]] = None,
) -> List[LinearShape]:
    """Expand an LM into its per-decoder-block linears + act-act attention ops.

    ``m_tokens``: rows of every linear (prefill: seq*batch; decode: batch).
    ``seq_for_attn``: KV length for the attention score/value ops.
    ``per_layer_s``: optional per-layer, per-projection sparsity overrides
    (keys: q/k/v/o/gate/up/down), used for the Fig. 8 layerwise benchmark.
    """
    d, h, kvh = model.d_model, model.n_heads, model.n_kv_heads
    hd = d // h
    layers: List[LinearShape] = []
    for li in range(model.n_layers):
        sl = (per_layer_s[li] if per_layer_s is not None else {})
        g = lambda key: sl.get(key, s_linear)  # noqa: E731
        layers += [
            LinearShape(f"L{li}.q_proj", m_tokens, d, d, model.w_bits, g("q")),
            LinearShape(f"L{li}.k_proj", m_tokens, d, kvh * hd, model.w_bits, g("k")),
            LinearShape(f"L{li}.v_proj", m_tokens, d, kvh * hd, model.w_bits, g("v")),
            LinearShape(f"L{li}.o_proj", m_tokens, d, d, model.w_bits, g("o")),
            LinearShape(f"L{li}.gate_proj", m_tokens, d, model.d_ff, model.w_bits, g("gate")),
            LinearShape(f"L{li}.up_proj", m_tokens, d, model.d_ff, model.w_bits, g("up")),
            LinearShape(f"L{li}.down_proj", m_tokens, model.d_ff, d, model.w_bits, g("down")),
        ]
        # act x act attention ops: QK^T and P·V, with int4 KV cache (KV4).
        # Not SPARQLe-eligible (paper §5.1). Weights here *are* the KV cache.
        layers += [
            LinearShape(f"L{li}.qkT", m_tokens * h, hd, seq_for_attn,
                        w_bits=4, s=0.0, sparqle_eligible=False),
            LinearShape(f"L{li}.pv", m_tokens * h, seq_for_attn, hd,
                        w_bits=4, s=0.0, sparqle_eligible=False),
        ]
    layers.append(
        LinearShape("lm_head", m_tokens, d, model.vocab, model.w_bits, s_linear)
    )
    return layers


@dataclasses.dataclass
class InferenceReport:
    model: str
    prefill_base: PhaseCost
    prefill_sparqle: PhaseCost
    decode_base: PhaseCost
    decode_sparqle: PhaseCost

    def improvements(self) -> Dict[str, float]:
        pct = lambda b, s: (1.0 - s / b) * 100.0  # noqa: E731
        return {
            "ttft_latency_pct": pct(self.prefill_base.cycles, self.prefill_sparqle.cycles),
            "tpot_latency_pct": pct(self.decode_base.cycles, self.decode_sparqle.cycles),
            "prefill_energy_pct": pct(self.prefill_base.energy_pj, self.prefill_sparqle.energy_pj),
            "decode_energy_pct": pct(self.decode_base.energy_pj, self.decode_sparqle.energy_pj),
            "prefill_transfer_pct": pct(
                self.prefill_base.load_bytes + self.prefill_base.drain_bytes,
                self.prefill_sparqle.load_bytes + self.prefill_sparqle.drain_bytes),
            "decode_transfer_pct": pct(
                self.decode_base.load_bytes + self.decode_base.drain_bytes,
                self.decode_sparqle.load_bytes + self.decode_sparqle.drain_bytes),
            "prefill_compute_pct": pct(self.prefill_base.compute_macs,
                                       self.prefill_sparqle.compute_macs),
            "decode_compute_pct": pct(self.decode_base.compute_macs,
                                      self.decode_sparqle.compute_macs),
        }


def evaluate_model(
    model: LMShape,
    s_linear: float,
    hw: Optional[HardwareConfig] = None,
    *,
    prefill_tokens: int = 2048,
    decode_batch: int = 16,
    decode_kv_len: int = 2048,
    per_layer_s: Optional[List[Dict[str, float]]] = None,
) -> InferenceReport:
    """TTFT/TPOT + energy for baseline dense accel vs SPARQLe accel."""
    hw = hw or HardwareConfig()
    prefill = lm_linear_layers(model, prefill_tokens, s_linear,
                               seq_for_attn=prefill_tokens, decode=False,
                               per_layer_s=per_layer_s)
    decode = lm_linear_layers(model, decode_batch, s_linear,
                              seq_for_attn=decode_kv_len, decode=True,
                              per_layer_s=per_layer_s)
    return InferenceReport(
        model=model.name,
        prefill_base=phase_cost(prefill, hw, sparqle=False),
        prefill_sparqle=phase_cost(prefill, hw, sparqle=True),
        decode_base=phase_cost(decode, hw, sparqle=False),
        decode_sparqle=phase_cost(decode, hw, sparqle=True),
    )


def area_power_overhead(hw: Optional[HardwareConfig] = None) -> Dict[str, float]:
    """§5.2 accounting: overheads of the hybrid PE vs iso-MAC dense baseline."""
    hw = hw or HardwareConfig()
    return {
        "area_overhead_pct": (hw.sparqle_area_ovh - 1.0) * 100.0,
        "power_overhead_pct": (hw.sparqle_power_ovh - 1.0) * 100.0,
    }


# ---------------------------------------------------------------------------
# Self-speculative decoding (serving/spec_decode.py): analytical win region
# ---------------------------------------------------------------------------

def expected_tokens_per_step(alpha: float, gamma: int) -> float:
    """E[tokens emitted per draft+verify cycle] under per-token acceptance
    probability ``alpha`` with a γ-token greedy draft window:
    sum_{k=0}^{γ} α^k (k accepted drafts + the correction/bonus token)."""
    if not 0.0 <= alpha <= 1.0:
        raise ValueError(alpha)
    return sum(alpha ** k for k in range(gamma + 1))


@dataclasses.dataclass
class SpeculativeReport:
    """Analytical TPOT of γ-draft self-speculative decoding vs sequential.

    One speculative cycle = γ single-token LSB4-only draft steps (1 compute
    round per eligible linear) + one (γ+1)-token batched full-precision
    verify step (1 + (1 - s) rounds), amortized over E[tokens/cycle].
    """

    model: str
    gamma: int
    alpha: float                       # per-token draft acceptance prob
    s: float                           # MSB4 sparsity feeding the costs
    draft_step: PhaseCost              # ONE single-token LSB-only step
    verify_step: PhaseCost             # ONE (γ+1)-token batched full step
    baseline_step: PhaseCost           # ONE non-speculative full step

    @property
    def expected_tokens(self) -> float:
        return expected_tokens_per_step(self.alpha, self.gamma)

    @property
    def spec_cycles_per_token(self) -> float:
        cyc = self.gamma * self.draft_step.cycles + self.verify_step.cycles
        return cyc / self.expected_tokens

    @property
    def baseline_cycles_per_token(self) -> float:
        return self.baseline_step.cycles

    @property
    def tpot_speedup(self) -> float:
        """> 1.0 means γ-drafting wins on decode latency."""
        return self.baseline_cycles_per_token / self.spec_cycles_per_token

    @property
    def spec_energy_per_token(self) -> float:
        e = self.gamma * self.draft_step.energy_pj + self.verify_step.energy_pj
        return e / self.expected_tokens

    def improvements(self) -> Dict[str, float]:
        return {
            "tpot_speedup": self.tpot_speedup,
            "tpot_latency_pct": (1.0 - self.spec_cycles_per_token
                                 / self.baseline_cycles_per_token) * 100.0,
            "decode_energy_pct": (1.0 - self.spec_energy_per_token
                                  / self.baseline_step.energy_pj) * 100.0,
            "expected_tokens_per_step": self.expected_tokens,
        }


def evaluate_speculative(
    model: LMShape,
    s: float,
    gamma: int,
    alpha: float,
    hw: Optional[HardwareConfig] = None,
    *,
    decode_batch: int = 16,
    decode_kv_len: int = 2048,
) -> SpeculativeReport:
    """Speculative vs sequential decode on the SPARQLe accelerator.

    ``s`` is the measured MSB4 sparsity (drives the verify/baseline round
    count 1 + (1 - s) and the wire bytes); ``alpha`` the measured per-token
    draft acceptance rate (``Request.stats()['spec_acceptance_rate']``).
    The verify step batches γ+1 window tokens per sequence, so its linears
    see ``decode_batch * (γ+1)`` rows while attention still walks the same
    KV length.
    """
    if gamma < 1:
        raise ValueError(gamma)
    hw = hw or HardwareConfig()
    one_tok = lm_linear_layers(model, decode_batch, s,
                               seq_for_attn=decode_kv_len, decode=True)
    window = lm_linear_layers(model, decode_batch * (gamma + 1), s,
                              seq_for_attn=decode_kv_len, decode=True)
    return SpeculativeReport(
        model=model.name, gamma=gamma, alpha=alpha, s=s,
        draft_step=phase_cost(one_tok, hw, sparqle=True, lsb_only=True),
        verify_step=phase_cost(window, hw, sparqle=True),
        baseline_step=phase_cost(one_tok, hw, sparqle=True),
    )


def breakeven_acceptance(
    model: LMShape,
    s: float,
    gamma: int,
    hw: Optional[HardwareConfig] = None,
    *,
    decode_batch: int = 16,
    decode_kv_len: int = 2048,
    tol: float = 1e-4,
) -> float:
    """Minimum per-token acceptance rate at which γ-drafting wins.

    Bisects α in [0, 1] for ``tpot_speedup == 1``; returns ``inf`` when
    even α = 1 loses (the draft+verify overhead exceeds the window) and
    0 when α = 0 already wins (possible when batching the verify step is
    itself cheaper per token than sequential decode). This is the
    cost-model answer to "when does LSB4-only drafting pay off?" as a
    function of the measured MSB sparsity ``s``.
    """
    rep = evaluate_speculative(model, s, gamma, 1.0, hw,
                               decode_batch=decode_batch,
                               decode_kv_len=decode_kv_len)
    if rep.tpot_speedup < 1.0:
        return float("inf")
    lo, hi = 0.0, 1.0
    if dataclasses.replace(rep, alpha=0.0).tpot_speedup >= 1.0:
        return 0.0
    while hi - lo > tol:
        mid = (lo + hi) / 2.0
        if dataclasses.replace(rep, alpha=mid).tpot_speedup >= 1.0:
            hi = mid
        else:
            lo = mid
    return hi


# Paper-reported operating points (§5.1), used by calibration & validation.
PAPER_SPARSITY = {"bitnet-3b": 0.618, "llama2-7b": 0.470, "llama3-8b": 0.444}
PAPER_CLAIMS = {
    # model: (ttft%, tpot%, prefill_E%, decode_E%)
    "bitnet-3b": (24.3, 23.4, 26.7, 14.2),
    "llama2-7b": (17.2, 14.6, 18.4, 7.1),
    "llama3-8b": (16.0, 13.5, 17.0, 6.5),
}
