"""On the card: the serve's surface and the core's calibration half.

Marked ``cuda`` and skipped without a card. This file imports neither
JAX nor the JAX package, so it also runs on a GPU machine without them:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest \
        tests/test_torch_attribution_cuda.py

The granite-8b smoke config served on the card by an attributed,
SLO-armed engine: the snapshot's attribution family valid, every phase's
memory and compute utilisation in (0, 1.05] against the card's peaks
(``costmodel.hardware_for``; not the speculative engine's decode row,
which times the whole draft + verify cycle), the tight TPOT objective violated and the
loose TTFT one not; ``Engine.stream`` equal to the request's stream;
``global_calibrate`` over int8 activations on the card equal to the
CPU's candidate by candidate (sparsity equal, MSE within 1e-6
relative); ``learn_clipping_constants`` on the card against the CPU (l
and h within 1e-4).
"""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import SLO_SPECS, UTIL_MAX, algorithm1, calibrate  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode; the "
                    "plain versions are tested against JAX elsewhere)")
    return torch.device("cuda")


def _smoke(cuda):
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_served_params, make_prompts
    cfg = get_config("granite-8b", smoke=True)
    return (cfg, build_served_params(cfg, 0, cuda, tile_k=16),
            make_prompts(cfg, 5, 4, 21))


@pytest.mark.cuda
@pytest.mark.parametrize("gamma", [0, 2])
def test_attributed_serve_on_card(cuda, gamma):
    from repro_torch.core.costmodel import hardware_for
    from repro_torch.launch.serve import make_engine, run_requests
    from repro_torch.obs import parse_slo_list
    from repro_torch.obs.validate import validate_attribution
    cfg, params, prompts = _smoke(cuda)
    eng = make_engine(cfg, params, batch=4, prompt_len=21, gen=9,
                      page_size=8, spec_gamma=gamma, device=cuda,
                      slos=parse_slo_list(SLO_SPECS), attribute=True)
    assert eng._attr.hw == hardware_for(torch.cuda.get_device_name(cuda))
    r = run_requests(eng, prompts, 9)
    assert validate_attribution(eng.metrics_snapshot(), require=True) == []
    phases = {"prefill", "decode"} | ({"draft", "verify"} if gamma else set())
    assert set(r["attribution"]) == phases
    for phase, row in r["attribution"].items():
        if row["steps"] and not row["cycle"]:
            assert 0 < row["memory_util"] <= UTIL_MAX, phase
            assert 0 < row["compute_util"] <= UTIL_MAX, phase
    viol = {x["slo"]: x["violations"] for x in r["slo"]}
    assert viol["ttft:p95<60"] == 0 and viol["tpot:p50<1e-4"] >= 1


@pytest.mark.cuda
def test_engine_stream_on_card(cuda):
    from repro_torch.launch.serve import make_engine, run_requests
    from repro_torch.serving import SamplingParams
    cfg, params, prompts = _smoke(cuda)
    kw = dict(batch=4, prompt_len=21, gen=9, page_size=8, device=cuda)
    want = run_requests(make_engine(cfg, params, **kw), prompts, 9)["streams"]
    eng = make_engine(cfg, params, **kw)
    hs = [eng.submit(p, SamplingParams(max_new_tokens=9)) for p in prompts]
    assert list(eng.stream(hs[2])) == want[2]


@pytest.mark.cuda
def test_global_calibrate_card_equals_cpu(cuda):
    from repro_torch.core.quantize import quantize_activations
    g = torch.Generator(device=cuda).manual_seed(3)
    sites = []
    for k in (64, 256):
        x = torch.randn((48, k), generator=g, device=cuda) * 3
        qt = quantize_activations(x)
        mask = torch.rand((k,), generator=g, device=cuda) < 0.5
        sites.append((qt.q, mask, qt.scale))
    card, card_all = calibrate(sites)
    cpu, cpu_all = calibrate([tuple(t.cpu() for t in s) for s in sites])
    for a, b in zip(card_all, cpu_all):
        assert a[:2] == b[:2] and a[3] == b[3]
        assert abs(a[2] - b[2]) <= 1e-6 * abs(b[2])
    assert (card.l, card.h) == (cpu.l, cpu.h)


@pytest.mark.cuda
def test_learn_clipping_constants_card_equals_cpu(cuda):
    lc, hc, hist_c = algorithm1(cuda)
    lp, hp, hist_p = algorithm1(torch.device("cpu"))
    assert abs(lc - lp) <= 1e-4 and abs(hc - hp) <= 1e-4
    assert lc < -1.0 and hc > 16.0
    for a, b in zip(hist_c, hist_p):
        assert abs(a["loss"] - b["loss"]) <= 1e-4
