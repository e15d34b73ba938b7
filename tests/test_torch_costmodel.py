"""Port parity, cost model: ``repro_torch.core.costmodel`` against the
JAX package's ``repro.core.costmodel`` float for float — ``linear_cost``,
``phase_cost`` (full and LSB4-only), ``evaluate_model``,
``evaluate_speculative``, ``breakeven_acceptance`` and the helpers over a
grid of sparsities, models and shapes — with the §4 accelerator knobs
equal digit for digit; the card peaks of ``hardware_for`` for the three
H100 parts (the numbers ``chip_smoke.py`` divides its bounds by), and no
TPU peak anywhere in the port."""
import dataclasses
import re
import sys
from pathlib import Path

import pytest

from repro.core import costmodel as J
from repro_torch.core import costmodel as T

ROOT = Path(__file__).resolve().parents[1]
SPARSITIES = (0.0, 0.1, 0.444, 0.47, 0.618, 0.9, 1.0)
SYSTEM_PEAKS = ("peak_flops", "hbm_bw", "link_bw")
CUSTOM = dict(name="granite-8b", n_layers=36, d_model=4096, n_heads=32,
              n_kv_heads=8, d_ff=14336, vocab=49152)


def _models():
    out = [(J.PAPER_MODELS[k], T.PAPER_MODELS[k]) for k in J.PAPER_MODELS]
    out.append((J.LMShape(**CUSTOM), T.LMShape(**CUSTOM)))
    return out


def _asdict(x):
    return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x


def test_accelerator_knobs_equal_digit_for_digit():
    j, t = dataclasses.asdict(J.HardwareConfig()), \
        dataclasses.asdict(T.HardwareConfig())
    assert set(j) == set(t)
    for k in j:
        if k not in SYSTEM_PEAKS:
            assert t[k] == j[k], k
    assert (T.PAPER_SPARSITY, T.PAPER_CLAIMS) == (J.PAPER_SPARSITY,
                                                   J.PAPER_CLAIMS)
    assert {k: dataclasses.asdict(v) for k, v in T.PAPER_MODELS.items()} == \
        {k: dataclasses.asdict(v) for k, v in J.PAPER_MODELS.items()}
    assert T.area_power_overhead() == J.area_power_overhead()


@pytest.mark.parametrize("s", SPARSITIES)
@pytest.mark.parametrize("m,k,n,w_bits,a_bits,eligible", [
    (16, 4096, 4096, 4, 8, True), (2048, 4096, 14336, 4, 8, True),
    (1, 14336, 4096, 2, 8, True), (512, 128, 2048, 4, 8, False),
    (64, 4096, 1024, 4, 4, True)])
def test_linear_and_phase_cost_equal(s, m, k, n, w_bits, a_bits, eligible):
    args = dict(name="x", m=m, k=k, n=n, w_bits=w_bits, s=s,
                sparqle_eligible=eligible, a_bits=a_bits, count=3)
    js, ts = J.LinearShape(**args), T.LinearShape(**args)
    for sparqle in (False, True):
        for lsb in (False, True):
            assert _asdict(T.linear_cost(ts, T.HardwareConfig(), sparqle,
                                         lsb)) == \
                _asdict(J.linear_cost(js, J.HardwareConfig(), sparqle, lsb))
            jp = J.phase_cost([js, js], J.HardwareConfig(), sparqle, lsb)
            tp = T.phase_cost([ts, ts], T.HardwareConfig(), sparqle, lsb)
            assert _asdict(tp) == _asdict(jp)
            assert tp.latency_us == jp.latency_us


@pytest.mark.parametrize("s", SPARSITIES)
def test_evaluate_model_equal(s):
    for jm, tm in _models():
        for kw in (dict(), dict(prefill_tokens=512, decode_batch=8,
                                decode_kv_len=144)):
            jr, tr = J.evaluate_model(jm, s, **kw), T.evaluate_model(tm, s,
                                                                     **kw)
            assert _asdict(tr) == _asdict(jr)
            assert tr.improvements() == jr.improvements()
        per_layer = [{"q": s, "down": 1 - s}] * jm.n_layers
        assert T.evaluate_model(tm, 0.3, per_layer_s=per_layer
                                ).improvements() == \
            J.evaluate_model(jm, 0.3, per_layer_s=per_layer).improvements()


@pytest.mark.parametrize("s", SPARSITIES)
@pytest.mark.parametrize("gamma", [1, 2, 4])
def test_speculative_model_equal(s, gamma):
    for jm, tm in _models():
        for alpha in (0.0, 0.35, 0.8, 1.0):
            jr = J.evaluate_speculative(jm, s, gamma, alpha, decode_batch=8)
            tr = T.evaluate_speculative(tm, s, gamma, alpha, decode_batch=8)
            assert tr.improvements() == jr.improvements()
            assert T.expected_tokens_per_step(alpha, gamma) == \
                J.expected_tokens_per_step(alpha, gamma)
        assert T.breakeven_acceptance(tm, s, gamma, decode_batch=8) == \
            J.breakeven_acceptance(jm, s, gamma, decode_batch=8)
    with pytest.raises(ValueError):
        T.evaluate_speculative(T.PAPER_MODELS["llama3-8b"], s, 0, 0.5)
    with pytest.raises(ValueError):
        T.expected_tokens_per_step(1.5, gamma)


@pytest.mark.parametrize("name,want", [
    ("NVIDIA H100 80GB HBM3", (3.35e12, 1979e12, 67e12, 900e9)),
    ("NVIDIA H100 PCIe", (2.0e12, 1513e12, 51e12, 600e9)),
    ("NVIDIA H100 NVL", (3.9e12, 1671e12, 60e12, 600e9))])
def test_hardware_for_gives_each_part_its_peaks(name, want):
    assert T.peaks_for(name) == want
    hw = T.hardware_for(name)
    assert (hw.hbm_bw, hw.peak_flops, hw.link_bw) == (want[0], want[1],
                                                       want[3])
    # the §4 knobs stay the paper accelerator's
    base = dataclasses.asdict(T.HardwareConfig())
    got = dataclasses.asdict(hw)
    assert {k: v for k, v in got.items() if k not in SYSTEM_PEAKS} == \
        {k: v for k, v in base.items() if k not in SYSTEM_PEAKS}


def test_default_peaks_are_the_sxm_card():
    hw = T.HardwareConfig()
    assert (hw.hbm_bw, hw.peak_flops, hw.link_bw) == (3.35e12, 1979e12,
                                                       900e9)


def test_no_tpu_peak_in_the_port():
    """The reference's TPU system peaks (197e12 FLOP/s, 819e9 B/s, 50e9
    B/s a link) appear nowhere in the port, and the card smoke takes its
    peaks from the port's cost model instead of a table of its own."""
    tpu = re.compile(r"\b(197e12|197\.0e12|819e9|819\.0e9|50e9|"
                     r"1\.97e14|8\.19e11)\b")
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]
    bad = [str(p.relative_to(ROOT)) for p in files
           if tpu.search(p.read_text())]
    assert not bad, bad
    smoke = (ROOT / "chip_smoke.py").read_text()
    assert "from repro_torch.core.costmodel import" in smoke
    assert "PEAKS = {" not in smoke


def test_attention_bound_takes_bf16_products_at_the_tensor_core_rate():
    """``chip_smoke.attn_bound`` at row 7h's timed call (B 8, KVH 1, G 8,
    hd 256, 520 tokens a sequence, bf16 q with ``round_kv``): q.k, bf16
    by bf16, at the bf16 tensor-core rate (half the int8 rate), p.v (p is
    f32) at the f32 rate, so the call is bound by its bytes. Both halves
    at the f32 rate, as for an f32 q, bind it by operations."""
    sys.path.insert(0, str(ROOT))
    from chip_smoke import attn_bound
    peaks = T.peaks_for("NVIDIA H100 80GB HBM3")
    b, g, hd, toks = 8, 8, 256, 8 * 520
    kw = dict(extra=b * 4, kvh=1, g=g, hd=hd, qb=2)
    nbytes = 2 * b * g * hd * 2 + toks * 2 * (hd // 2 + 4) + b * 4
    flops = 4.0 * toks * g * hd
    ms, by = attn_bound(peaks, b, toks, toks, qk_bf16=True, **kw)
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3)
    assert flops / 2 / 67e12 < nbytes / 3.35e12
    ms, by = attn_bound(peaks, b, toks, toks, **kw)
    assert by == "operations"
    assert ms == pytest.approx(flops / 67e12 * 1e3)
