"""chip_smoke's phase-10 trace check: which profiled trace is taken again
when the base and dense traces hold different numbers of fill records.

``profile_engine`` needs a card, so it is replaced here by a queue of
traces; each case lists the traces the queue hands out (base retakes and
dense retakes share the one queue, in call order), the base trace the
check starts from, and what ``profile_dense`` must return."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


def trace(fills, matmul=4536):
    return {"drain_fill": [{"kernel": "FillFunctor<float>",
                            "launches": fills}],
            "matmul_rows": [{"kernel": "sparqle_matmul_kernel",
                             "launches": matmul}],
            "kernel_launches": fills + matmul}


# (base fills, traces handed out in order, (kind, fills) of each call,
#  fills of the returned base and dense traces)
CASES = {
    "complete": (4554, [4554], ["dense"], (4554, 4554)),
    "dense_lost_records": (4554, [4495, 4554], ["dense", "dense"],
                           (4554, 4554)),
    "base_lost_records": (4495, [4554, 4554], ["dense", "base"],
                          (4554, 4554)),
    "dense_always_short": (4554, [4495, 4490, 4480],
                           ["dense", "dense", "dense"], (4554, 4480)),
    "dense_adds_fills": (4554, [4600, 4554, 4554],
                         ["dense", "base", "base"], (4554, 4600)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_profile_dense_retakes_the_short_trace(case, monkeypatch):
    base_fills, fills, kinds, want = CASES[case]
    queue = iter(trace(f) for f in fills)
    calls = []

    def fake_profile_engine(cfg, params, dev, seed, spec_gamma=0, tag=""):
        calls.append("dense" if tag == "_dense" else "base")
        return next(queue)

    monkeypatch.setattr(chip_smoke, "profile_engine", fake_profile_engine)
    base, dense = chip_smoke.profile_dense(None, "params", "dense", None, 0,
                                           trace(base_fills))
    assert calls == kinds
    assert (chip_smoke.fill_launches(base),
            chip_smoke.fill_launches(dense)) == want
    assert len(dense["attempts"]) == len(kinds)
    assert dense["attempts"][-1]["fills"] == want[1]
    assert dense["attempts"][-1]["base_fills"] == want[0]
