"""The dry-run against the JAX package's: the cell plan, the abstract
inputs and caches, the served tree as a schema, the sharding profiles,
each rank's argument bytes in all 64 cells (32 runnable cells x the two
production meshes) under both profiles, the zero-point linear, the
partial attention's merge (row 7p's plain version), and the tally of a
traced step: the reference's record keys and tuned-below-baseline
contract on a fake 4x16 world, fake tensors against real ones, ranks
symmetric, and each kernel op's fake implementation against its plain
version."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs.base import SHAPES as JSHAPES
from repro.core.quantize import quantize_weights as jquantize_weights
from repro.core.sparse_matmul import quantized_linear_sparqle as jqls
from repro.distributed import sharding as JSH
from repro.launch import steps as JST
from repro.models import registry as JR
from repro.models.schema import ParamSpec as JParamSpec
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.core.quantize import QuantizedTensor
from repro_torch.core.sparse_matmul import quantized_linear_sparqle
from repro_torch.distributed import sharding as TSH
from repro_torch.kernels import _build, kv_attention as KA
from repro_torch.kernels import quant_matmul as QM
from repro_torch.kernels import ref as R
from repro_torch.kernels import sparqle_encode as SE
from repro_torch.kernels import sparqle_matmul as SM
from repro_torch.launch import dryrun as TD
from repro_torch.launch import steps as TST
from repro_torch.launch.mesh import production_mesh
from repro_torch.models import qschema as TQ
from repro_torch.models import registry as TR

ARCHS = tuple(JR.ARCHS)
MESHES = {"16x16": production_mesh(False), "2x16x16": production_mesh(True)}
# leaves a mesh train step places otherwise than ``spec_for``, and so
# the train cells' argument bytes differ from the reference's by them
# alone: the embedding table whole over model (token lookup reads all of
# it), and an SSD mixer's joint projection and conv cut by segment (its
# heads' z, x and dt; B and C whole at one group) where ``spec_for`` cuts
# them contiguously
TRAIN_EXCEPTIONS = ("embed/table", "/w_in", "/conv_w", "/conv_b")


class _Mesh:
    """The reference's ``spec_for`` reads only ``mesh.shape``."""

    def __init__(self, shape):
        self.shape = dict(shape)


def _dtype_name(dt) -> str:
    if isinstance(dt, torch.dtype):
        return str(dt).replace("torch.", "")
    return np.dtype(dt).name


# ---------------------------------------------------------------------------
# the registry, the schema, the profiles
# ---------------------------------------------------------------------------

def test_cell_plan_is_the_references():
    assert TR.runnable_cells() == JR.runnable_cells()
    assert len(TR.runnable_cells()) == 32
    assert sum(not runs for a in TR.ARCHS for _, runs, _ in
               TR.cell_plan(a)) == 8
    for arch in ARCHS:
        assert TR.describe(arch) == JR.describe(arch)


def test_dryrun_list_is_the_references(capsys):
    assert TD.main(["--list"]) == 0
    got = capsys.readouterr().out.splitlines()
    want = [f"{a} {s}" for a, s in JR.runnable_cells()]
    for arch in sorted({a for a, _ in JR.runnable_cells()}):
        want += [f"SKIP {arch} {s}: {why}"
                 for s, runs, why in JR.cell_plan(arch) if not runs]
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_and_cache_schema(arch):
    jc, tc = JR.get_config(arch), TR.get_config(arch)
    for sname, shp in JSHAPES.items():
        for kind in ("train", "prefill", "decode"):
            j = JR.input_specs(jc, shp, kind)
            t = TR.input_specs(tc, SHAPES[sname], kind)
            assert list(j) == list(t)
            for k in j:
                assert tuple(j[k].shape) == tuple(t[k].shape)
                assert _dtype_name(j[k].dtype) == _dtype_name(t[k].dtype)
                assert t[k].device.type == "meta"
    if jc.family == "encoder":
        return
    jl = jax.tree_util.tree_leaves_with_path(
        JR.cache_schema(jc, 4, 64), is_leaf=lambda x: isinstance(
            x, JParamSpec))
    tl: dict = {}
    TQ.map_specs(TR.cache_schema(tc, 4, 64),
                 lambda s, p: tl.__setitem__(p, s))
    assert len(jl) == len(tl)
    for path, js in jl:
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        ts = tl[key]
        assert (ts.shape, ts.axes) == (js.shape, js.axes)
        assert _dtype_name(ts.dtype) == _dtype_name(js.dtype)


def _jspecs(tree) -> dict:
    """path -> (shape, axes, dtype) of a reference quantized schema."""
    out = {}

    def walk(t, prefix):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{prefix}/{k}" if prefix else k)
        elif isinstance(t, JParamSpec):
            out[prefix] = (t.shape, t.axes, _dtype_name(t.dtype))
        else:    # a SparqleLinear of ParamSpecs
            for k in ("q", "scale", "zero"):
                walk(getattr(t.w, k), f"{prefix}/{k}")
            for k in ("col_mask", "l", "h"):
                walk(getattr(t, k), f"{prefix}/{k}")
            out[prefix + "/#"] = (t.packed, t.mode, t.w.bits)
    walk(tree, "")
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_quantized_schema_leaf_for_leaf(arch):
    jc, tc = JR.get_config(arch), TR.get_config(arch)
    want = _jspecs(JST.serve_param_schema(jc))
    got: dict = {}
    tree = TST.serve_param_schema(tc)
    TQ.map_specs(tree, lambda s, p: got.__setitem__(
        p, (s.shape, s.axes, _dtype_name(s.dtype))))

    def flags(t, prefix=""):
        if isinstance(t, dict):
            for k, v in t.items():
                flags(v, f"{prefix}/{k}" if prefix else k)
        elif hasattr(t, "w"):
            got[prefix + "/#"] = (t.packed, t.mode, t.w.bits)
    flags(tree)
    assert got == want


@pytest.mark.parametrize("mesh", MESHES)
def test_profile_rules_are_the_references(mesh):
    shape = MESHES[mesh]
    for arch in ARCHS:
        jc, tc = JR.get_config(arch), TR.get_config(arch)
        for profile in ("baseline", "tuned"):
            for shp in JSHAPES.values():
                assert TSH.profile_rules(
                    profile, tc, shp.kind, shape, shp.global_batch) == \
                    JSH.profile_rules(profile, jc, shp.kind, _Mesh(shape),
                                      global_batch=shp.global_batch)


# ---------------------------------------------------------------------------
# each rank's argument bytes, all 64 cells under both profiles
# ---------------------------------------------------------------------------

def _ref_bytes(tree, shape, rules) -> int:
    total = 0
    for spec in jax.tree_util.tree_leaves(tree, is_leaf=lambda x: isinstance(
            x, (JParamSpec, jax.ShapeDtypeStruct))):
        axes = getattr(spec, "axes", None)
        if axes is None:      # an input: the batch over its dim 0
            axes = ("batch",) + (None,) * (len(spec.shape) - 1)
        entries = JSH.spec_for(axes, spec.shape, _Mesh(shape), rules=rules)
        n = 1
        for i, d in enumerate(spec.shape):
            e = entries[i] if i < len(entries) else None
            for a in ((e,) if isinstance(e, str) else (e or ())):
                d //= shape[a]
            n *= d
        total += n * np.dtype(spec.dtype).itemsize
    return total


def _reference_arguments(arch, sname, shape, profile) -> int:
    """The sum of the reference's per-device shard bytes of a cell's
    arguments (its dry-run's ``in_shardings``)."""
    jc, shp = JR.get_config(arch), JSHAPES[sname]
    rules = dict(JSH.DEFAULT_RULES)
    rules.update(JSH.profile_rules(profile, jc, shp.kind, _Mesh(shape),
                                   global_batch=shp.global_batch))
    inputs = JR.input_specs(jc, shp, shp.kind)
    if shp.kind == "train":
        return _ref_bytes(JST.train_state_schema(jc), shape, rules) + \
            _ref_bytes(inputs, shape, rules)
    total = _ref_bytes(JST.serve_param_schema(jc), shape, rules) + \
        _ref_bytes(inputs, shape, rules)
    if shp.kind == "decode":
        total += _ref_bytes(JR.cache_schema(jc, shp.global_batch,
                                            shp.seq_len), shape, rules)
    return total


def _ref_train_shapes(jc, shape, rules) -> dict:
    """path -> the reference's per-device shape of every float param."""
    out = {}
    for path, spec in jax.tree_util.tree_leaves_with_path(
            JST.train_state_schema(jc).params,
            is_leaf=lambda x: isinstance(x, JParamSpec)):
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        entries = JSH.spec_for(spec.axes, spec.shape, _Mesh(shape),
                               rules=rules)
        dims = []
        for i, d in enumerate(spec.shape):
            e = entries[i] if i < len(entries) else None
            for a in ((e,) if isinstance(e, str) else (e or ())):
                d //= shape[a]
            dims.append(d)
        out[key] = tuple(dims)
    return out


@pytest.mark.parametrize("profile", ("baseline", "tuned"))
@pytest.mark.parametrize("mesh", MESHES)
def test_argument_bytes_are_the_references(mesh, profile):
    """Every serve cell's per-rank argument bytes equal the reference's
    per-device shard bytes. A train cell's do where no leaf of
    TRAIN_EXCEPTIONS is placed otherwise: every other float leaf's shard
    is the reference's, shape for shape, and the bytes differ by those
    leaves alone (each at 8 bytes a value: f32 and two bf16
    moments)."""
    shape = MESHES[mesh]
    for arch, sname in TR.runnable_cells():
        tc, shp = TR.get_config(arch), SHAPES[sname]
        got = TD.argument_bytes(tc, shp, shape, profile)
        want = _reference_arguments(arch, sname, shape, profile)
        if shp.kind != "train":
            assert got == want, (arch, sname, got, want)
            continue
        jc = JR.get_config(arch)
        rules = dict(JSH.DEFAULT_RULES)
        rules.update(JSH.profile_rules(profile, jc, "train", _Mesh(shape),
                                       global_batch=shp.global_batch))
        ref = _ref_train_shapes(jc, shape, rules)
        from repro_torch.checkpoint.store import flatten, leaf_paths
        shapes = TD.train_local_shapes(
            tc, shape.get("pod", 1) * shape["data"], shape["model"],
            TSH.merged_rules(TSH.profile_rules(profile, tc, "train", shape,
                                               shp.global_batch)))
        mine = dict(zip(leaf_paths(shapes), flatten(shapes)))
        assert set(mine) == set(ref)
        extra = 0
        for path, dims in mine.items():
            if any(path.endswith(x) for x in TRAIN_EXCEPTIONS):
                extra += (np.prod(dims) - np.prod(ref[path])) * 8
            else:
                assert dims == ref[path], (arch, path, dims, ref[path])
        assert got - want == extra, (arch, got, want, extra)


# ---------------------------------------------------------------------------
# the zero-point linear and the partial attention's merge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("zero_point", (False, True))
def test_zero_point_linear_is_jaxs(zero_point):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((6, 256)) + (0.6 if zero_point else 0.0)
         ).astype(np.float32)
    w = rng.standard_normal((256, 40)).astype(np.float32)
    mask = rng.random(256) < 0.5
    jw = jquantize_weights(jnp.asarray(w), bits=4, axis=0)
    want = np.asarray(jqls(jnp.asarray(x), jw, col_mask=jnp.asarray(mask),
                           clip_l=jnp.float32(-8), clip_h=jnp.float32(23),
                           zero_point=zero_point))
    tw = QuantizedTensor(*(torch.from_numpy(np.array(a)) for a in (
        jw.q, jw.scale, jw.zero)), 4)
    got = quantized_linear_sparqle(
        torch.from_numpy(x), tw, col_mask=torch.from_numpy(mask),
        clip_l=-8, clip_h=23, zero_point=zero_point).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("window", (0, 7))
@pytest.mark.parametrize("slices", (1, 2, 3, 16))
def test_partial_attention_merges_to_one_call(slices, window):
    """Row 7p's plain version over 1, 2, 3 and 16 slices of the cache (a
    slice wholly past pos among them: lse -inf, out 0), merged, equals
    one plain call of row 7, with and without a window."""
    g = torch.Generator().manual_seed(slices)
    b, s, kvh, grp, hd = 3, 48, 2, 3, 16
    q = torch.randn(b, kvh, grp, hd, generator=g)
    kq, vq = (torch.randint(-128, 128, (b, s, kvh, hd // 2), generator=g,
                            dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand(b, s, kvh, generator=g) for _ in range(2))
    pos = torch.tensor([4, 30, 47], dtype=torch.int32)
    whole = R.kv4_decode_attention_ref(q, kq, ks, vq, vs, pos, window=window)
    n = s // slices
    outs, lses, empty = [], [], False
    for r in range(slices):
        part = [t[:, r * n:(r + 1) * n].contiguous() for t in (kq, ks, vq,
                                                               vs)]
        o, lse = KA.kv4_decode_attention_partial(q, *part, pos,
                                                 start=r * n, window=window)
        dead = torch.isinf(lse)
        assert (o[dead] == 0).all()
        empty |= bool(dead.any())
        outs.append(o)
        lses.append(lse)
    assert empty == (slices > 1)
    got = R.merge_partials(outs, lses)
    assert (got - whole).abs().max() <= 1e-5


# ---------------------------------------------------------------------------
# the tally of a traced step
# ---------------------------------------------------------------------------

REFERENCE_KEYS = {"arch", "shape", "kind", "profile", "mesh", "n_devices",
                  "flops_hlo", "dot_flops_by_dtype", "hbm_bytes_hlo",
                  "collective_bytes", "collective_count", "top_dots",
                  "top_colls", "xla_flops", "xla_bytes_accessed", "memory",
                  "lower_s", "compile_s", "analyze_s"}
MEMORY_KEYS = {"argument_size_b", "output_size_b", "temp_size_b",
               "generated_code_size_b"}


def test_lower_cell_reference_contract():
    """The reference's own test: yi-6b cut to 2 layers, decode_32k, on a
    fake 4x16 world, both profiles: the reference's keys, FLOPs > 0,
    tuned collective bytes below baseline's (serving weights whole over
    data: no FSDP gathers)."""
    cfg = TR.get_config("yi-6b").replace(n_layers=2)
    coll = {}
    for profile in ("baseline", "tuned"):
        rec = TD.lower_cell("yi-6b", "decode_32k", {"data": 4, "model": 16},
                            profile=profile, cfg=cfg)
        assert REFERENCE_KEYS <= set(rec) and set(rec["memory"]) == \
            MEMORY_KEYS
        assert rec["flops_hlo"] > 0 and rec["memory"][
            "generated_code_size_b"] == 0
        assert rec["memory"]["argument_size_b"] == TD.argument_bytes(
            cfg, SHAPES["decode_32k"], {"data": 4, "model": 16}, profile)
        coll[profile] = rec["collective_bytes"]["total"]
    assert coll["tuned"] < coll["baseline"]


SMOKE_CELLS = (("granite-8b", ShapeConfig("p", 32, 4, "prefill")),
               ("granite-8b", ShapeConfig("d", 32, 4, "decode")),
               ("deepseek-moe-16b", ShapeConfig("d", 32, 4, "decode")),
               ("mamba2-2.7b", ShapeConfig("t", 32, 8, "train")))


@pytest.mark.parametrize("arch,shp", SMOKE_CELLS)
def test_fake_trace_is_the_real_runs(arch, shp, monkeypatch):
    """At 1x1 a smoke cell traced on fake tensors (the layer scan's
    extrapolation) gives the FLOPs, the collective bytes, the kernel ops,
    the argument bytes and the peak of the same tally over a real CPU run
    of the whole program whose wrappers go through the kernels' ops (their
    CPU kernels: the plain versions); the arguments are the planned
    ones."""
    monkeypatch.setattr(_build, "on_card", lambda t: True)
    cfg = TR.get_config(arch, smoke=True)
    fake = TD.lower_cell(arch, shp, {"data": 1, "model": 1}, cfg=cfg,
                         microbatch=4)
    real = TD.lower_cell(arch, shp, {"data": 1, "model": 1}, cfg=cfg,
                         fake=False, device="cpu", fill_seed=0,
                         microbatch=4)
    assert fake["layer_scan"] and real["layer_scan"] is None
    for key in ("flops_hlo", "dot_flops_by_dtype", "collective_bytes",
                "peak_b", "memory", "kernel_ops"):
        assert fake[key] == real[key], key
    assert fake["memory"]["argument_size_b"] == TD.argument_bytes(
        TR.get_config(arch, smoke=True), shp, {"data": 1, "model": 1})


@pytest.mark.parametrize("arch,shp", (
    ("jamba-v0.1-52b", ShapeConfig("t", 32, 8, "train")),
    ("starcoder2-3b", ShapeConfig("t", 2048, 4, "train")),
    ("deepseek-v3-671b", ShapeConfig("p", 2048, 2, "prefill")),
    ("gemma3-27b", ShapeConfig("p", 2048, 2, "prefill")),
    ("gemma3-27b", ShapeConfig("d", 32, 2, "decode"))))
def test_layer_scan_is_the_whole_program(arch, shp):
    """On a 2x2 fake world, the scans (each stage at one and two repeats,
    extrapolated; the flash block loops, 4 x 2 blocks at 2,048 tokens, run
    once and counted) equal the trace of the whole program: every count
    and the peak (smoke configs deepened to 3 repeats a stage)."""
    cfg = TR.get_config(arch, smoke=True).replace(**{
        "jamba-v0.1-52b": dict(n_layers=12, attn_every=4),
        "starcoder2-3b": dict(n_layers=3),
        "deepseek-v3-671b": dict(n_layers=5),
        "gemma3-27b": dict(n_layers=9)}[arch])
    kw = dict(cfg=cfg, microbatch=4)
    scan = TD.lower_cell(arch, shp, {"data": 2, "model": 2}, **kw)
    whole = TD.lower_cell(arch, shp, {"data": 2, "model": 2}, scan=False,
                          **kw)
    assert max(scan["layer_scan"]) >= 3
    for key in ("flops_hlo", "dot_flops_by_dtype", "collective_bytes",
                "collective_count", "kernel_ops"):
        assert scan[key] == whole[key], key
    assert scan["memory"]["argument_size_b"] == \
        whole["memory"]["argument_size_b"]
    # AdamW walks a layer-stacked leaf in slices of a fixed size
    # (``optim/adamw.py`` ``_slices``): their count, and so the partial
    # sums' scalars and their bytes, does not grow by whole repeats
    tol = {"hbm_bytes_hlo": 1e-2, "peak_b": 1e-3} if shp.kind == "train" \
        else {"hbm_bytes_hlo": 0.0, "peak_b": 0.0}
    for key, rel in tol.items():
        assert abs(scan[key] - whole[key]) <= rel * whole[key], key


def test_ranks_are_symmetric():
    """granite-8b smoke decode at 2x2, where every dim divides: rank 0's
    int-plane dot FLOPs x 4 are the 1x1 step's."""
    shp = ShapeConfig("d", 32, 4, "decode")
    cfg = TR.get_config("granite-8b", smoke=True)
    one = TD.lower_cell("granite-8b", shp, {"data": 1, "model": 1}, cfg=cfg)
    four = TD.lower_cell("granite-8b", shp, {"data": 2, "model": 2},
                         cfg=cfg)
    assert four["dot_flops_by_dtype"]["s8"] * 4 == \
        one["dot_flops_by_dtype"]["s8"]
    assert four["collective_bytes"]["total"] > 0 == \
        one["collective_bytes"]["total"]


def _shapes(x):
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype)
    return [None if t is None else _shapes(t) for t in x]


def _op_cases():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(5, 64, generator=g)
    xe = torch.randn(2, 5, 64, generator=g)
    scale = torch.rand(5, 1, generator=g) + 0.1
    mask = torch.rand(64, generator=g) < 0.5
    w = torch.randint(-128, 128, (32, 24), generator=g, dtype=torch.int8)
    ws = torch.rand(1, 24, generator=g)
    lsb, msb, _, pop = R.sparqle_encode_ref(x, scale)
    plsb, pmsb, _, ppop = R.sparqle_encode_packed_ref(x, scale)
    q = R.sparqle_quantize_ref(x, scale)
    b, s, kvh, grp, hd = 2, 32, 2, 2, 16
    qa = torch.randn(b, kvh, grp, hd, generator=g)
    kq = torch.randint(-128, 128, (b, s, kvh, hd // 2), generator=g,
                       dtype=torch.int8)
    ks = torch.rand(b, s, kvh, generator=g)
    pos = torch.tensor([3, 30], dtype=torch.int32)
    pages = kq.reshape(b * 2, 16, kvh, hd // 2)
    pscales = ks.reshape(b * 2, 16, kvh)
    tables = torch.arange(b * 2, dtype=torch.int32).reshape(b, 2)
    return {
        "encode": (SE.sparqle_encode, (x, scale, mask, -8, 23)),
        "encode_batched": (SE.sparqle_encode_fused, (xe,)),
        "quantize": (SE.sparqle_quantize, (x, scale)),
        "packed": (SE.sparqle_encode_packed, (x, scale, mask, -8, 23)),
        "fused": (SE.sparqle_encode_fused, (x, mask, -8, 23)),
        "quantize_fused": (SE.sparqle_quantize_fused, (x,)),
        "packed_fused": (SE.sparqle_encode_packed_fused, (x,)),
        "matmul": (SM.sparqle_matmul, (lsb, msb, pop, w, scale, ws)),
        "matmul_packed": (SM.sparqle_matmul_packed,
                          (plsb, pmsb, ppop, w, scale, ws)),
        "quant_matmul": (QM.quant_matmul, (q, w, scale, ws)),
        "paged": (KA.kv4_paged_decode_attention,
                  (qa, pages, pscales, pages, pscales, tables, pos)),
        "verify": (KA.kv4_paged_verify_attention,
                   (qa[:, None].expand(b, 2, kvh, grp, hd).contiguous(),
                    pages, pscales, pages, pscales, tables, pos)),
        "contiguous": (KA.kv4_decode_attention, (qa, kq, ks, kq, ks, pos)),
        "partial": (KA.kv4_decode_attention_partial,
                    (qa, kq, ks, kq, ks, pos)),
    }


@pytest.mark.parametrize("name", list(_op_cases()))
def test_kernel_ops_fake_shapes_are_the_plain_versions(name):
    """Each wrapper's kernel op under a fake mode (meta tensors take the
    kernel's branch) gives its plain version's shapes and dtypes."""
    fn, args = _op_cases()[name]
    want = _shapes(fn(*args))
    with FakeTensorMode(allow_non_fake_inputs=True):
        meta = [a.to("meta") if isinstance(a, torch.Tensor) else a
                for a in args]
        got = _shapes(fn(*meta))
    assert got == want


def test_gather_heads_train_step_is_the_one_device_step():
    """The dry-run's train step where the model ways do not divide the
    heads (starcoder2-3b smoke: 2 KV heads over 4 model ranks, every head
    attended on every rank, q, k and v gathered with their grads
    reduce-scattered): loss within 1e-5 rel and every grad leaf within
    1e-4 of its max of the one-device step's, at 1x4."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from _torch_worlds import gather_heads_world
    from repro_torch.checkpoint import store
    from repro_torch.launch.mesh import spawn_world
    from repro_torch.models.schema import init_params
    from repro_torch.models.schema_builder import build_schema
    from repro_torch.optim.adamw import OptConfig, init_opt_state
    cfg = TR.get_config("starcoder2-3b", smoke=True).replace(
        dtype="float32")
    params = init_params(build_schema(cfg), 0)
    state = TST.TrainState(params, init_opt_state(params, OptConfig()))
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)
             for k in ("tokens", "targets")}
    knobs = TST.TrainKnobs(microbatch=2, ce_chunk=16)
    loss, _, grads = TST.make_accum_grads(cfg, knobs)(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    got = spawn_world(gather_heads_world, 4, dict(
        mesh=(1, 4), cfg=cfg, state=state, batch=batch, knobs=knobs),
        timeout_s=120)[0]
    assert abs(got[0] - float(loss)) <= 1e-5 * abs(float(loss))
    for g, w in zip(got[1], store.flatten(grads)):
        w = w.numpy()
        assert np.abs(g - w).max() <= 1e-4 * max(np.abs(w).max(), 1e-30)
