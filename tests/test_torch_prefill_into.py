"""The fixed-batch prefill over caches made outside it
(``models/model.py`` ``prefill_into``, ``launch/steps.py``
``make_serve_prefill_into``) against the prefill that allocates its own
(``prefill``, ``make_serve_prefill``), on the smoke configs of the seven
families the fixed-batch path prefills: granite-8b, gemma3-27b (sliding
windows), paligemma-3b (image patches in front of the tokens),
deepseek-v3-671b (MLA and MoE), mamba2-2.7b (SSD), jamba-v0.1-52b (SSD,
attention and MoE) and hubert-xlarge (an encoder's frames). CPU plain
versions; the same numpy inputs, drawn from a seed, go to both.

Bit-equality throughout: the last position's logits and greedy token,
and every cache leaf. On a used cache (random bytes in every leaf) the
logits, positions [0, S) of every positional leaf and the whole SSD
state are the fresh cache's, and the decode steps after it give the
fresh cache's logits: what a second ``--legacy`` serve over the same
caches needs. ``legacy_serve`` run again with one ``LegacySteps`` gives
the streams of a serve on fresh caches.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import steps as S
from repro_torch.launch.serve import (LegacySteps, build_served_params,
                                      legacy_serve, make_prompts)
from repro_torch.models import model as M

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import fill_random, trees_equal  # noqa: E402

ARCHS = ("granite-8b", "gemma3-27b", "paligemma-3b", "deepseek-v3-671b",
         "mamba2-2.7b", "jamba-v0.1-52b", "hubert-xlarge")
B, S_TOK, DECODES = 2, 20, 2
CPU = torch.device("cpu")


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg = get_config(request.param, smoke=True)
    rng = np.random.default_rng(11)
    if cfg.family == "encoder":
        inputs = (torch.from_numpy(rng.standard_normal(
            (B, S_TOK, cfg.d_model)).astype(np.float32)).to(cfg.cdtype),)
    else:
        inputs = (torch.from_numpy(rng.integers(
            0, cfg.vocab, (B, S_TOK)).astype(np.int32)),)
    if cfg.family == "vlm":
        inputs += (torch.from_numpy(rng.standard_normal(
            (B, cfg.n_prefix, cfg.d_model)).astype(np.float32)).to(
                cfg.cdtype),)
    keys = ("frames",) if cfg.family == "encoder" else ("tokens", "patches")
    return {"cfg": cfg, "params": build_served_params(cfg, 0, CPU),
            "inputs": inputs, "batch": dict(zip(keys, inputs))}


def _span(m):
    """Positions the prefill writes: the patches and the tokens."""
    return sum(v.shape[1] for v in m["batch"].values())


def _leaves(tree, path=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{path}/{k}")
        else:
            yield f"{path}/{k}", v


def test_prefill_into_fresh_caches_is_prefill(model):
    """``prefill`` = ``init_cache`` + ``prefill_into``: logits and every
    cache leaf bit-equal, and the steps' greedy tokens equal."""
    cfg, params, batch = model["cfg"], model["params"], model["batch"]
    max_len = _span(model) + DECODES + 1
    want, wcache = M.prefill(cfg, params, batch, max_len=max_len)
    cache = M.init_cache(cfg, B, max_len, CPU)
    got = M.prefill_into(cfg, params, cache, batch)
    assert torch.equal(got, want)
    assert trees_equal(cache, wcache)
    tok, _ = S.make_serve_prefill(cfg, max_len)(params, batch)
    step = S.make_serve_prefill_into(cfg)
    assert torch.equal(step(params, M.init_cache(cfg, B, max_len, CPU),
                            *model["inputs"]), tok)


def test_prefill_into_used_caches_serves_as_fresh(model):
    """Random bytes in every leaf first: the same logits, positions
    [0, S) of every positional leaf and every SSD leaf as on fresh
    caches, and (a decoder) the same logits from DECODES decode steps."""
    cfg, params, batch = model["cfg"], model["params"], model["batch"]
    span = _span(model)
    max_len = span + DECODES + 1
    fresh = M.init_cache(cfg, B, max_len, CPU)
    used = fill_random(M.init_cache(cfg, B, max_len, CPU),
                       torch.Generator().manual_seed(5))
    want = M.prefill_into(cfg, params, fresh, batch)
    assert torch.equal(M.prefill_into(cfg, params, used, batch), want)
    for (name, a), (_, b) in zip(_leaves(fresh), _leaves(used)):
        positional = name.rsplit("/", 1)[-1] not in ("h", "conv")
        assert torch.equal(a[:, :, :span] if positional else a,
                           b[:, :, :span] if positional else b), name
    if cfg.family == "encoder":
        return
    tok = want.argmax(-1).to(torch.int32)
    for i in range(DECODES):
        pos = torch.full((B,), span + i, dtype=torch.int32)
        lf, fresh = M.decode_step(cfg, params, fresh, tok, pos)
        lu, used = M.decode_step(cfg, params, used, tok, pos)
        assert torch.equal(lu, lf), i
        tok = lf.argmax(-1).to(torch.int32)


@pytest.mark.parametrize("arch", ["granite-8b", "paligemma-3b",
                                  "mamba2-2.7b"])
def test_second_serve_on_reused_caches(arch):
    """``legacy_serve`` again with one ``LegacySteps``: each later serve
    prefills into the caches of the one before and gives the streams of
    a serve on fresh caches (the first prompts again: the first serve's
    streams); a serve of another shape is refused."""
    cfg = get_config(arch, smoke=True)
    params = build_served_params(cfg, 0, CPU)
    n = 12 + cfg.n_prefix
    patches = None
    if cfg.family == "vlm":
        patches = torch.from_numpy(np.random.default_rng(3).standard_normal(
            (B, cfg.n_prefix, cfg.d_model)).astype(np.float32)).to(
                cfg.cdtype)
    first = make_prompts(cfg, 0, B, n)
    again = make_prompts(cfg, 1, B, n)
    if patches is not None:
        first, again = ([p[:n - cfg.n_prefix] for p in ps]
                        for ps in (first, again))
    steps = LegacySteps(cfg, B, n + 5, CPU)
    r1 = legacy_serve(cfg, params, first, 5, CPU, patches, steps=steps)
    r2 = legacy_serve(cfg, params, again, 5, CPU, patches, steps=steps)
    assert r1["prefill_call"] == r2["prefill_call"] == "eager"
    assert r2["prefill_replay_s"] is None
    assert r1["streams"] == legacy_serve(cfg, params, first, 5, CPU,
                                         patches)["streams"]
    assert r2["streams"] == legacy_serve(cfg, params, again, 5, CPU,
                                         patches)["streams"]
    assert r1["streams"] != r2["streams"]
    assert legacy_serve(cfg, params, first, 5, CPU, patches,
                        steps=steps)["streams"] == r1["streams"]
    with pytest.raises(ValueError, match="legacy steps serve"):
        legacy_serve(cfg, params, first, 4, CPU, patches, steps=steps)
