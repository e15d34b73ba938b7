"""The port's static checks (``repro_torch.analysis``): each AST rule
(SPL001-004) and each traced-step contract (TXP001-005) fires on a
fixture made to break it — a module under ``tmp_path`` or a step
closure written wrong — with exactly its finding, and not on the clean
twin; the port's own tree has no active finding and no stale allowlist
entry; the port's allowlist parsing and matching and its SPL004 verdicts
equal the reference's (``repro.analysis.findings`` and
``repro.analysis.astlint``, the two reference modules that import under
this JAX: ``jaxprcheck`` does not). The real step closures are traced
single-device here; their 1x2 and 2x2 traces run in the worlds of
``tests/test_torch_sharded_engine.py``."""
import json
import shutil
import textwrap
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro.analysis import astlint as ref_astlint
from repro.analysis import findings as ref_findings
from repro_torch.analysis import RULES, VERSION, astlint, ruleset_hash
from repro_torch.analysis import stepcheck as SC
from repro_torch.analysis.__main__ import main as cli
from repro_torch.analysis.findings import (ALLOWLIST_PATH, Allowlist,
                                           Finding, apply_allowlist)
from repro_torch.kernels.ref import sparqle_matmul_ref

REPO_ROOT = Path(__file__).resolve().parent.parent
SRC = str(REPO_ROOT / "src")
DOCS = str(REPO_ROOT / "docs" / "observability.md")
REF_ALLOWLIST = str(REPO_ROOT / "src" / "repro" / "analysis" /
                    "allowlist.txt")


def _tree(tmp_path, files):
    root = tmp_path / "src"
    for rel, text in files.items():
        p = root / "repro_torch" / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text))
    return str(root)


def _rule(findings, rule):
    return [f for f in findings if f.rule_id == rule]


def test_rule_catalog():
    assert sorted(RULES) == [f"SPL00{i}" for i in range(1, 5)] + \
        [f"TXP00{i}" for i in range(1, 6)]
    h = ruleset_hash()
    assert len(h) == 16 and int(h, 16) >= 0 and h == ruleset_hash()
    assert VERSION


# ------------------------------------------------------------ AST rules

STEPS = """
    from repro_torch.models import helper as H

    def make_engine_decode(cfg):
        def engine_decode(params, x):
            return H.body(x)
        return engine_decode
"""


def _helper(line):
    return f"""
    import logging
    import time

    import torch


    def body(x):
        {line}
        return x


    def unreached(x):
        print(x.item())
        return x
"""


@pytest.mark.parametrize("line", [
    "print(x)", "time.perf_counter()", "logging.info('step')",
    "tracer.instant('step')", "registry.counter('a_total').inc()"])
def test_spl001_host_effect_in_a_step(tmp_path, line):
    src = _tree(tmp_path, {"launch/steps.py": STEPS,
                           "models/helper.py": _helper(line)})
    got = _rule(astlint.run(src), "SPL001")
    assert [f.key for f in got] == ["repro_torch/models/helper.py::body"]
    clean = _tree(tmp_path / "c", {"launch/steps.py": STEPS,
                                   "models/helper.py": _helper("y = x + 1")})
    assert astlint.run(clean) == []


def test_spl001_roots_include_compiled_step_targets(tmp_path):
    """A function passed to ``CompiledStep(...)`` is a root; a method
    reached only through an object (``TrainMesh.any``) is not."""
    src = _tree(tmp_path, {"serving/engine.py": """
        import torch

        from repro_torch.launch.graphs import CompiledStep


        def local_step(x):
            print("at capture only")
            return x


        class Mesh:
            def any(self, flag):
                t = torch.tensor([int(flag)])
                return bool(t.item())


        def build(dev, mesh):
            mesh.any(True)
            return CompiledStep(local_step, dev)
    """})
    got = astlint.run(src)
    assert [(f.rule_id, f.key) for f in got] == [
        ("SPL001", "repro_torch/serving/engine.py::local_step")]


@pytest.mark.parametrize("line", [
    "x.item()", "x.tolist()", "x.cpu()", "x.numpy()",
    "n = int(torch.sum(x))", "flag = bool(x.any())",
    "if x.any():\n            x = x + 1",
    "while torch.max(x) > 0:\n            x = x - 1",
    "torch.nonzero(x)", "x.masked_select(x > 0)", "torch.unique(x)"])
def test_spl003_host_sync_in_a_step(tmp_path, line):
    src = _tree(tmp_path, {"launch/steps.py": STEPS,
                           "models/helper.py": _helper(line)})
    got = _rule(astlint.run(src), "SPL003")
    assert [f.key for f in got] == ["repro_torch/models/helper.py::body"]
    clean = _tree(tmp_path / "c", {
        "launch/steps.py": STEPS,
        "models/helper.py": _helper("y = torch.where(x > 0, x, 0)\n"
                                    "        n = int(x.shape[0])")})
    assert astlint.run(clean) == []


@pytest.mark.parametrize("path", ["serving/scheduler.py",
                                  "serving/kv_pool.py", "obs/trace.py"])
@pytest.mark.parametrize("line,what", [
    ("y = torch.zeros(3)", "device op torch.zeros"),
    ("fill = torch.ones", "device op torch.ones"),
    ("y = x.to('cuda')", "device transfer .to()"),
    ("y = x.cuda()", "device transfer .cuda()")])
def test_spl002_device_op_in_a_host_module(tmp_path, path, line, what):
    body = f"""
        import torch


        def book(x):
            {line}
            return x
    """
    src = _tree(tmp_path, {path: body})
    got = astlint.run(src)
    assert [(f.rule_id, f.key) for f in got] == [
        ("SPL002", f"repro_torch/{path}::book")]
    assert got[0].message.startswith(what)
    clean = _tree(tmp_path / "c", {path: """
        import torch


        def book(x: torch.Tensor, dev: torch.device) -> int:
            with torch.profiler.record_function("book"):
                n = torch.finfo(torch.float32).bits
            return n + isinstance(x, torch.Tensor)
    """})
    assert astlint.run(clean) == []


SPL004_SOURCES = {
    "serving/metered.py": """
        def setup(registry):
            registry.counter("serving_engine_steps_total", "ok")
            registry.counter("serving_steps", "no _total")
            registry.gauge("Bad-Name", "bad name")
            registry.histogram("not_in_the_catalog_seconds", "uncatalogued")
    """,
    "obs/metrics.py": """
        def counter(self, name):
            return self.counter(name + "_x")
    """,
}


def test_spl004_metric_discipline_equals_the_reference(tmp_path):
    src = _tree(tmp_path, SPL004_SOURCES)
    mine = _rule(astlint.run(src, docs_path=DOCS), "SPL004")
    ref = _rule(ref_astlint.run(src, docs_path=DOCS), "SPL004")
    assert [f.message for f in mine] == [
        "counter `serving_steps` should end in `_total`",
        "metric `serving_steps` is not cataloged in docs/observability.md",
        "metric name `Bad-Name` violates ^[a-z][a-z0-9_]*$",
        "metric `Bad-Name` is not cataloged in docs/observability.md",
        "metric `not_in_the_catalog_seconds` is not cataloged in "
        "docs/observability.md"]
    as_tuples = lambda fs: [(f.rule_id, f.key, f.provenance,  # noqa: E731
                             f.message) for f in fs]
    assert as_tuples(mine) == as_tuples(ref)


def test_spl004_verdicts_on_the_port_equal_the_reference(tmp_path):
    """The port's sources, copied alone under a source root so that the
    reference's analyzer walks nothing else."""
    shutil.copytree(REPO_ROOT / "src" / "repro_torch",
                    tmp_path / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "*.cu"))
    mine = _rule(astlint.run(str(tmp_path), docs_path=DOCS), "SPL004")
    ref = _rule(ref_astlint.run(str(tmp_path), docs_path=DOCS), "SPL004")
    assert [(f.key, f.message) for f in mine] == \
        [(f.key, f.message) for f in ref] == []


# ------------------------------------------------------ allowlist parity

BAD_ALLOWLIST = "SPL001 only-two-fields\n"
TEXT = """
# a comment
SPL002  */serving/kv_pool.py::init_pool_state*  one-time state
TXP001  *:all_reduce_sum:model:int32     row-parallel reduce
TXP001  decode:*:data:*   anything over data at decode
"""


@pytest.mark.parametrize("which", ["port", "reference", "text"])
def test_allowlist_parses_and_matches_as_the_reference(tmp_path, which):
    path = {"port": ALLOWLIST_PATH, "reference": REF_ALLOWLIST}.get(which)
    if path is None:
        path = str(tmp_path / "allow.txt")
        with open(path, "w") as f:
            f.write(TEXT)
    mine, ref = Allowlist.load(path), ref_findings.Allowlist.load(path)
    fields = lambda al: [(e.rule_id, e.pattern, e.reason,  # noqa: E731
                          e.line_no) for e in al.entries]
    assert fields(mine) == fields(ref) and mine.entries
    keys = [("SPL002", "repro_torch/serving/kv_pool.py::init_pool_state.walk"),
            ("SPL002",
             "repro/serving/kv_pool.py::PagedKVPool.page_msb_sparsity"),
            ("TXP001", "verify:all_reduce_sum:model:int32"),
            ("TXP001", "decode:all_gather:data:float32"),
            ("JXP001", "decode:psum:model:int32"),
            ("SPL001", "repro_torch/launch/steps.py::make_x.y")]
    got = [Finding(r, k, "p", "m") for r, k in keys]
    want = [ref_findings.Finding(r, k, "p", "m") for r, k in keys]
    a_mine, al_mine = apply_allowlist(got, mine)
    a_ref, al_ref = ref_findings.apply_allowlist(want, ref)
    assert [f.key for f in a_mine] == [f.key for f in a_ref]
    assert [(f.key, f.allow_reason) for f in al_mine] == \
        [(f.key, f.allow_reason) for f in al_ref]
    assert [e.hits for e in mine.entries] == [e.hits for e in ref.entries]


def test_allowlist_refuses_an_entry_without_a_reason(tmp_path):
    path = tmp_path / "bad.txt"
    path.write_text(BAD_ALLOWLIST)
    for cls in (Allowlist, ref_findings.Allowlist):
        with pytest.raises(ValueError, match="reason"):
            cls.load(str(path))


# ------------------------------------------------------ traced steps

@pytest.fixture(scope="module")
def tree_steps():
    return SC.trace_steps()


def test_port_tree_has_no_active_finding(tree_steps):
    """AST rules over ``src/repro_torch`` and every single-device step:
    all findings allowlisted; the only entries left unmatched are the
    collectives, which run on a mesh only (matched in the worlds of
    ``test_torch_sharded_engine.py``)."""
    findings = astlint.run(SRC, docs_path=DOCS) + SC.check(tree_steps)
    al = Allowlist.load()
    active, allowed = apply_allowlist(findings, al)
    assert active == [], "\n".join(f.render() for f in active)
    assert {f.rule_id for f in allowed} == {"SPL002", "TXP005"}
    assert {e.rule_id for e in al.stale_entries()} == {"TXP001"}
    assert all(e.reason for e in al.entries)


def test_step_structure(tree_steps):
    """The traces the contracts read: every compiled step kind of both
    families; the full decode's int-plane matmuls (one LSB and one MSB
    product a projection), half of them MSB-fed, the draft's half and
    none MSB-fed; no collective on one device."""
    by = {st.name: st for st in tree_steps}
    kinds = ("prefill", "decode", "draft", "verify", "kv2_decode",
             "legacy_decode", "legacy_prefill", "kv2_demote", "kv2_promote")
    assert sorted(by) == sorted(f"{k}/{fam}/single" for k in kinds
                                for fam in ("transformer", "moe"))
    # transformer: 2 layers x (q, k, v, o, gate, up, down) + the head
    assert SC.count_plane_matmuls(by["decode/transformer/single"].graph) \
        == (30, 15)
    assert SC.count_plane_matmuls(by["draft/transformer/single"].graph) \
        == (15, 0)
    full, draft = (SC.count_plane_matmuls(by[f"{k}/moe/single"].graph)
                   for k in ("decode", "draft"))
    assert full[0] == 2 * draft[0] == 2 * full[1] and draft[1] == 0
    assert not any(st.collectives for st in tree_steps)


def test_txp005_host_read_in_the_legacy_prefill(monkeypatch):
    """The fixed-batch prefill step, traced as ``trace_steps`` traces it,
    with its embedding made to read the prompt's largest token on the
    host: TXP005 names that read in the ``legacy_prefill`` kind; the
    clean step has only the allowlisted clip-constant reads, and the
    re-codecs none."""
    from repro_torch.launch import steps as S
    from repro_torch.launch.serve import build_served_params
    from repro_torch.models import model as M
    cfg = SC.tiny_configs()["transformer"]
    params = build_served_params(cfg, 0, "cpu", tile_k=16)
    embed = M.embed_inputs

    def checked_embed(cfg, params, batch):
        if batch["tokens"].max().item() >= cfg.vocab:
            raise ValueError("token outside the vocabulary")
        return embed(cfg, params, batch)

    def findings():
        step = SC.trace(S.make_serve_prefill_into(cfg),
                        (params, M.init_cache(cfg, 2, 16, "cpu"),
                         torch.zeros((2, 8), dtype=torch.int32)),
                        name="legacy_prefill/transformer/single",
                        kind="legacy_prefill", family="transformer",
                        n_layers=cfg.n_layers)
        out = []
        SC.check_host_sync(step, out)
        return apply_allowlist(out, Allowlist.load())[0]

    assert findings() == []
    monkeypatch.setattr(M, "embed_inputs", checked_embed)
    keys = [f.key for f in findings()]
    assert len(keys) == 1 and keys[0].startswith("legacy_prefill:item:")
    assert keys[0].endswith("::test_txp005_host_read_in_the_legacy_prefill."
                            "<locals>.checked_embed")


def test_reachability_roots():
    """The step closures are roots; ``TrainMesh.any`` (a train-loop
    method), ``layers._exactly`` (run at import) and
    ``SparqleLinear.layer`` (reached through an object) are not
    reached."""
    repo = astlint._Repo(SRC, "repro_torch")
    reach = repo.reachable_from_roots()
    steps = "repro_torch.launch.steps"
    assert (steps, "make_engine_decode.engine_decode") in reach
    assert (steps, "make_serve_decode.serve_decode") in reach
    assert (steps, "make_serve_prefill_into.serve_prefill_into") in reach
    for fn in ("demote_page", "promote_page"):    # CompiledStep targets
        assert ("repro_torch.serving.tiering", fn) in reach
    assert ("repro_torch.kernels.ref", "sparqle_matmul_ref") in reach
    for mod, q in ((steps, "TrainMesh.any"),
                   ("repro_torch.models.layers", "_exactly"),
                   ("repro_torch.core.qlinear", "SparqleLinear.layer")):
        assert (mod, q) not in reach
    assert not repo.modules[steps].functions["TrainMesh.any"].is_root


def _trace(fn, *args, kind="decode", family="transformer", n_layers=1,
           mesh=None, groups=None):
    return SC.trace(fn, ({"state": torch.zeros(2)},) + args,
                    name=f"{kind}/{fn.__name__}", kind=kind, family=family,
                    n_layers=n_layers, mesh=mesh, groups=groups)


def _planes(m=4, k=32, n=8, seed=0):
    """(q, tile populations, packed int4 weight, act scale, w scale): the
    activation stays whole, so a step splits its planes in the trace."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randint(-128, 128, (m, k), generator=g, dtype=torch.int8)
    w = torch.randint(-128, 128, (k // 2, n), generator=g, dtype=torch.int8)
    return (q, torch.ones((1, 1), dtype=torch.int32), w,
            torch.rand(m, 1, generator=g), torch.rand(1, n, generator=g))


def test_txp003_accumulator_meets_a_float_op():
    def drained(state, q, pop, w, asc, wsc):
        acc = sparqle_matmul_ref(q & 0xF, q >> 4, pop, w, asc, wsc,
                                 acc_out=True)
        return acc.float() * asc * wsc            # the one rescale

    def half(state, q, pop, w, asc, wsc):
        acc = sparqle_matmul_ref(q & 0xF, q >> 4, pop, w, asc, wsc,
                                 acc_out=True)
        return acc * 0.5                          # float op on the acc

    def float_accum(state, q, pop, w, asc, wsc):
        wf = w.to(torch.float64)
        return ((q & 0xF).to(torch.float64) @ torch.cat([wf, wf])).float()

    for fn, keys in ((drained, []), (half, ["decode:mul"]),
                     (float_accum, ["decode:float-accum"])):
        out = []
        SC.check_acc_dtype(_trace(fn, *_planes()), out)
        assert [f.key for f in out] == keys, fn.__name__


def _dual(state, q, pop, w, asc, wsc):
    return sparqle_matmul_ref(q & 0xF, q >> 4, pop, w, asc, wsc)


def _lsb_only(state, q, pop, w, asc, wsc):
    return sparqle_matmul_ref(q & 0xF, None, None, w, asc, wsc,
                              msb_skip=True)


def _msb_only(state, q, pop, w, asc, wsc):
    return sparqle_matmul_ref(q >> 4, None, None, w, asc, wsc, msb_skip=True)


def test_txp004_draft_with_the_msb_pass(tree_steps):
    args = _planes()
    full = _trace(_dual, *args)
    cases = ((_lsb_only, []), (_msb_only, ["draft:msb-matmul"]),
             (_dual, ["draft:matmul-halving", "draft:msb-matmul"]))
    for fn, keys in cases:
        out = []
        SC.check_msb_skip(full, _trace(fn, *args, kind="draft"), out)
        assert [f.key for f in out] == keys, fn.__name__
    # the real decode standing in for the draft: the MSB pass runs
    by = {st.name: st for st in tree_steps}
    out = []
    SC.check_msb_skip(by["decode/transformer/single"],
                      by["decode/transformer/single"], out)
    assert [f.key for f in out] == ["decode:matmul-halving",
                                    "decode:msb-matmul"]
    # a "full" step without the MSB pass: the detector reports itself blind
    out = []
    SC.check_msb_skip(_trace(_lsb_only, *args), _trace(_lsb_only, *args,
                                                       kind="draft"), out)
    assert [f.key for f in out] == ["decode:msb-detector",
                                    "draft:matmul-halving"]


def _item(state, x):
    return x * x.sum().item()


def _int(state, x):
    return x * int(x.sum())


def _nonzero(state, x):
    return torch.nonzero(x > 0)


def _mask(state, x):
    return x[x > 0]


def _cpu(state, x):
    return x.cpu() + 1


def _to_cpu(state, x):
    return x.to("cpu") + 1


def _tolist(state, x):
    return x + len(x.tolist())


def _clean(state, x):
    return torch.where(x > 0, x, 0.0) * 2


@pytest.mark.parametrize("fn,key", [
    (_item, "decode:item:"), (_int, "decode:_local_scalar_dense:"),
    (_nonzero, "decode:nonzero"), (_mask, "decode:index"),
    (_cpu, "decode:cpu:"), (_to_cpu, "decode:to_cpu:"),
    (_tolist, "decode:tolist:"), (_clean, None)],
    ids=lambda v: getattr(v, "__name__", str(v)))
def test_txp005_host_sync_in_a_step(fn, key):
    out = []
    SC.check_host_sync(_trace(fn, torch.arange(4.0) - 1), out)
    if key is None:
        assert out == []
        return
    assert len(out) == 1 and out[0].rule_id == "TXP005"
    assert out[0].key.startswith(key)
    if key.endswith(":"):       # a host read names its site
        assert out[0].key.endswith(f"::{fn.__name__}")


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A gloo world of this process alone, for traces with real
    collectives; torn down after the module."""
    store = str(tmp_path_factory.mktemp("gloo") / "store")
    dist.init_process_group("gloo", store=dist.FileStore(store, 1), rank=0,
                            world_size=1)
    try:
        yield dist.new_group([0])
    finally:
        dist.destroy_process_group()


def _row_site(group, sum_dtype, with_max=True, sites=1):
    def step(state, x):
        for _ in range(sites):
            amax = x.abs().amax(-1, keepdim=True)
            if with_max:
                dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
            acc = torch.round(x / amax * 100).to(sum_dtype)
            dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=group)
            x = acc.float() * amax
        return x
    return step


def test_txp001_txp002_collectives(one_rank):
    x = torch.randn(2, 8)
    model = {one_rank.group_name: "model"}
    data = {one_rank.group_name: "data"}
    al = Allowlist.load()

    def run(step, groups, **kw):
        st = _trace(step, x, groups=groups, **kw)
        assert len(st.collectives) == sum(
            1 for n in SC._calls(st.graph) if SC._namespace(n) == "c10d")
        out = []
        SC.check_collectives(st, out)
        SC.check_row_reduce(st, out)
        return out

    clean = run(_row_site(one_rank, torch.int32, sites=2), model,
                mesh=(1, 2))
    assert [f.key for f in clean] == [
        "decode:all_reduce_max:model:float32",
        "decode:all_reduce_sum:model:int32"] * 2
    assert apply_allowlist(clean, al)[0] == []
    f32 = run(_row_site(one_rank, torch.float32), model)
    assert [f.key for f in _rule(f32, "TXP002")] == [
        "decode:all_reduce_sum:model:float32"]
    assert [f.key for f in apply_allowlist(f32, al)[0]] == [
        "decode:all_reduce_sum:model:float32"] * 2
    unpaired = run(_row_site(one_rank, torch.int32, with_max=False), model)
    assert [f.key for f in _rule(unpaired, "TXP002")] == [
        "decode:sum-max-pairing"]
    short = run(_row_site(one_rank, torch.int32), model, mesh=(1, 2))
    assert [f.key for f in _rule(short, "TXP002")] == [
        "decode:row-site-count"]
    over_data = run(_row_site(one_rank, torch.int32), data)
    active = apply_allowlist(_rule(over_data, "TXP001"), al)[0]
    assert [f.key for f in active] == ["decode:all_reduce_max:data:float32",
                                       "decode:all_reduce_sum:data:int32"]
    assert _rule(over_data, "TXP002") == []


# ------------------------------------------------------------------ CLI

def test_cli_check_and_report(tmp_path, capsys, monkeypatch):
    report = tmp_path / "r.json"
    assert cli(["--check", "--no-steps", "--report", str(report)]) == 0
    text = capsys.readouterr().out
    assert "0 finding(s)" in text and "stale" not in text
    r = json.loads(report.read_text())
    assert r["findings"] == [] and r["stale_allowlist_entries"] == []
    assert r["ruleset_hash"] == ruleset_hash()
    assert {f["rule_id"] for f in r["allowlisted"]} == {"SPL002"}
    bad = Finding("SPL003", "repro_torch/x.py::f", "repro_torch/x.py:1", "m")
    monkeypatch.setattr(astlint, "run", lambda *a, **k: [bad])
    assert cli(["--check", "--no-steps"]) == 1
    assert cli(["--no-steps"]) == 0
    assert "warning: stale allowlist entry" in capsys.readouterr().out
