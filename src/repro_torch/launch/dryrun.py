"""The dry-run: every (arch x shape) cell planned for one rank of the
production meshes (torch twin of ``repro.launch.dryrun``).

For every runnable cell of ``models/registry.py`` and both production
meshes (16x16, and 2x16x16 over two pods), this module traces the step
the cell runs as rank 0 of a fake world (``launch/mesh.py``
``fake_world``: every collective returns at once) on fake tensors: meta
tensors, shapes and dtypes with no storage. The kernel wrappers take
their kernel's branch for a meta tensor as for a CUDA one
(``kernels/_build.py`` ``on_card``), so each kernel appears as its
custom op, whose fake implementation gives its outputs, and no card is
needed. The layer stack and the block loops of flash attention are
scanned as the reference's ``lax.scan``s are (:func:`layer_scan`,
``Tally.loop``). The step is the port's own: a train cell the mesh
train step (``launch/steps.py`` ``TrainMesh``, ``make_sharded_grads``,
AdamW; the reference's knobs: microbatches of 32, of 64 under ``tuned``
for an MoE arch; heads the model ways do not divide attended whole on
every model rank), a prefill or decode cell the ``--legacy`` steps on
the mesh (``make_serve_prefill``/``make_serve_decode`` with a
``ServeMesh``). ``launch/trace_analysis.py`` tallies what that rank
computes, moves and exchanges, and the most bytes it holds at once, into
``runs/dryrun_torch/<mesh>/<arch>__<shape>.json`` with the reference's
keys, so a benchmark can read either tree.

All numbers are PER RANK. ``memory.argument_size_b`` is the rank's
params (or train state), caches and inputs; ``temp_size_b`` the peak of
live bytes less the arguments; ``output_size_b`` the step's outputs;
``generated_code_size_b`` is 0 (no compiled program). ``xla_flops`` and
``xla_bytes_accessed`` are -1: no XLA cost analysis exists here.
``hbm_bytes_hlo`` is eager PyTorch's op-by-op traffic, not XLA's fused
proxy. Each line ends with whether the cell fits the card: the memory
of ``torch.cuda.get_device_properties(0)`` with a card, else the H100's
80 GB, named as such.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --list
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b \\
        --shape decode_32k --mesh singlepod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import multiprocessing
import os
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import SHAPES
from repro_torch.launch.mesh import fake_world, production_mesh
from repro_torch.launch.trace_analysis import Tally
from repro_torch.models.registry import (cell_plan, get_config, input_specs,
                                         runnable_cells)
from repro_torch.models.stages import build_stages, stage_repeats

RUNS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                        "runs", "dryrun_torch")
H100_MEMORY_B = 80 * 10 ** 9          # the H100's 80 GB, without a card
MESHES = {"singlepod": False, "multipod": True}


def card_memory() -> Tuple[int, str]:
    """(bytes, whose): the card's memory, or the H100's 80 GB."""
    if torch.cuda.is_available():
        p = torch.cuda.get_device_properties(0)
        return int(p.total_memory), p.name
    return H100_MEMORY_B, "H100 80 GB (no card here)"


def _local_batch(cfg, shp, kind, mesh_shape, rules, device, real):
    from repro_torch.distributed.sharding import local_dims
    from repro_torch.launch.steps import batch_specs
    abstract = input_specs(cfg, shp, kind)
    specs = batch_specs(abstract, mesh_shape, rules)
    return {k: (torch.zeros if real else torch.empty)(
        local_dims(v.shape, specs[k], mesh_shape), dtype=v.dtype,
        device=device) for k, v in abstract.items()}


def _serve_cell(cfg, shp, world, rules, device, real):
    """The ``ServeMesh`` of a prefill or decode cell under ``rules`` and
    its served tree on ``device`` (``real``: zeros; the clip constants
    real CPU tensors, read on the host)."""
    from repro_torch.launch import steps as S
    from repro_torch.models.qschema import tree_abstract, tree_local_shapes
    sm = S.serve_mesh(cfg, world.layout, world.coords, world.groups,
                      global_batch=shp.global_batch, max_len=shp.seq_len,
                      kind=shp.kind, rules=rules)
    pschema = S.serve_param_schema(cfg)
    return sm, tree_abstract(pschema, device, tree_local_shapes(
        pschema, world.layout, sm.rules),
        make=torch.zeros if real else torch.empty)


def _serve_step(cfg, shp, sm, params, device, real):
    """(step, its arguments) of a prefill or decode cell."""
    from repro_torch.launch import steps as S
    from repro_torch.models import model as M
    if shp.kind == "prefill":
        batch = _local_batch(cfg, shp, "prefill", sm.mesh_shape, sm.rules,
                             device, real)
        return S.make_serve_prefill(cfg, shp.seq_len, mesh=sm), (params,
                                                                  batch)
    tok = _local_batch(cfg, shp, "decode", sm.mesh_shape, sm.rules, device,
                       real)
    cache = M.init_cache_mesh(cfg, sm, shp.seq_len, device)
    return S.make_serve_decode(cfg, mesh=sm), (params, cache, tok["token"],
                                               tok["pos"])


def _data_layout(layout: Dict[str, int], coords: Dict[str, int]):
    """(the data axes, their ways, this rank's index over them): pod and
    data one data group, in global-rank order (pod major)."""
    axes = tuple(a for a in ("pod", "data") if a in layout)
    ways = 1
    for a in axes:
        ways *= layout[a]
    return axes, ways, coords.get("pod", 0) * layout.get("data", 1) + \
        coords.get("data", 0)


def train_local_shapes(cfg, data_ways: int, model_ways: int, rules=None):
    """The shape one rank holds of every leaf of the float param tree
    under the mesh train step's placements (``distributed/sharding.py``
    ``train_placements``, under ``rules``): a tree of the schema's
    structure."""
    from repro_torch.distributed.sharding import train_placements
    from repro_torch.models.schema_builder import build_schema
    schema = build_schema(cfg)

    def local(spec, pl):
        shape = list(spec.shape)
        if pl.data_dim is not None:
            shape[pl.data_dim] //= data_ways
        if pl.segments is not None:
            shape[pl.model_dim] = sum(n for n, _ in pl.local_runs(
                model_ways))
        elif pl.model_dim is not None:
            shape[pl.model_dim] //= model_ways
        return tuple(shape)

    def walk(sch, pls):
        if isinstance(sch, dict):
            return {k: walk(v, pls[k]) for k, v in sch.items()}
        return local(sch, pls)

    return walk(schema, train_placements(schema, data_ways, model_ways,
                                         rules=rules))


def _train_cell(cfg, shp, world, mb, knobs_kw, device, real, rules):
    """(step, its arguments) of a train cell on the mesh train step, pod
    and data one data group (FSDP's shard order (pod, data))."""
    from repro_torch.distributed.sharding import MeshCoords
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import MeshLayout
    from repro_torch.optim.adamw import OptConfig, init_opt_state
    lay = world.layout
    axes, dw, d_rank = _data_layout(lay, world.coords)
    coords = MeshCoords(d_rank, dw, world.coords["model"], lay["model"])
    layout = MeshLayout(coords, world.groups[axes],
                        world.groups[("model",)], "fake")
    tm = S.TrainMesh(cfg, layout, gather_heads=True, rules=rules)
    ocfg = OptConfig()
    make = torch.zeros if real else torch.empty
    shapes = train_local_shapes(cfg, dw, lay["model"], rules)

    def walk(sch):
        if isinstance(sch, dict):
            return {k: walk(v) for k, v in sch.items()}
        return make(sch, dtype=torch.float32, device=device)

    params = walk(shapes)
    state = S.TrainState(params, init_opt_state(params, ocfg))
    batch = _local_batch(cfg, shp, "train", {"data": dw,
                                             "model": lay["model"]},
                         None, device, real)
    knobs = S.TrainKnobs(microbatch=mb, **knobs_kw)
    return S.make_train_step(cfg, ocfg, knobs, mesh=tm), (state, batch)


def _train_rules(cfg, shp, layout, profile: str, extra=None):
    """A train cell's rule table: the profile's (decided on the whole
    mesh's shape, pod included) and ``extra``."""
    from repro_torch.distributed.sharding import merged_rules, profile_rules
    rules = merged_rules(profile_rules(profile, cfg, "train", layout,
                                       shp.global_batch))
    rules.update(extra or {})
    return rules


def argument_bytes(cfg, shp, layout: Dict[str, int],
                   profile: str = "baseline") -> int:
    """The bytes of the arguments one rank holds in a cell, from shapes
    alone (what :func:`lower_cell`'s tally counts as
    ``argument_size_b``): a train cell's f32 params and bf16 moments
    under the mesh train step's placements, its step and its rows of the
    batch; a serve cell's served tree and (decode) caches under
    ``spec_for``'s placements and its inputs."""
    from repro_torch.distributed.sharding import (local_dims, merged_rules,
                                                  profile_rules)
    from repro_torch.launch import steps as S
    from repro_torch.models.qschema import tree_bytes, tree_local_shapes
    from repro_torch.models.registry import cache_schema

    def nbytes(shape, dtype):
        n = 1
        for d in shape:
            n *= d
        return n * torch.empty((), dtype=dtype).element_size()

    rules = merged_rules(profile_rules(profile, cfg, shp.kind, layout,
                                       shp.global_batch))
    if shp.kind == "train":
        _, dw, _ = _data_layout(layout, {})
        shapes = train_local_shapes(cfg, dw, layout["model"], rules)
        flat: List[tuple] = []

        def walk(t):
            if isinstance(t, dict):
                for v in t.values():
                    walk(v)
            else:
                flat.append(t)

        walk(shapes)
        total = sum(nbytes(sh, torch.float32) + 2 * nbytes(sh,
                                                          torch.bfloat16)
                    for sh in flat) + 4
        mesh_in, rules_in = {"data": dw, "model": layout["model"]}, None
    else:
        pschema = S.serve_param_schema(cfg)
        total = tree_bytes(pschema, tree_local_shapes(pschema, layout,
                                                      rules))
        if shp.kind == "decode":
            cs = cache_schema(cfg, shp.global_batch, shp.seq_len)
            total += tree_bytes(cs, tree_local_shapes(cs, layout, rules))
        mesh_in, rules_in = layout, rules
    abstract = input_specs(cfg, shp, shp.kind)
    specs = S.batch_specs(abstract, mesh_in, rules_in)
    return total + sum(nbytes(local_dims(v.shape, specs[k], mesh_in),
                              v.dtype) for k, v in abstract.items())


def fill_random(tree, vocab: int, seed: int) -> None:
    """Random contents, in place, for every tensor of ``tree`` on a
    device: int8 bytes, bools, int32 ids below ``vocab``, floats normal
    (std 0.02)."""
    from repro_torch.launch.trace_analysis import _leaves
    g = None
    for t in _leaves(tree):
        if t.device.type == "cpu":     # the clip constants stay
            continue
        if g is None:
            g = torch.Generator(device=t.device).manual_seed(seed)
        if t.dtype == torch.int8:
            t.random_(-128, 128, generator=g)
        elif t.dtype == torch.bool:
            t.copy_(torch.rand(t.shape, generator=g, device=t.device) < 0.5)
        elif t.dtype in (torch.int32, torch.int64):
            t.random_(0, vocab, generator=g)
        else:
            t.normal_(0.0, 0.02, generator=g)


def _time_step(step, args, n: int, device) -> float:
    """Mean wall seconds of ``n`` calls of the step (outside any tally)."""
    sync = (torch.cuda.synchronize if str(device).startswith("cuda")
            else (lambda: None))
    sync()
    t0 = time.perf_counter()
    for _ in range(n):
        out = step(*args)
        del out
    sync()
    return (time.perf_counter() - t0) / n


def _out_bytes(out) -> int:
    from repro_torch.launch.trace_analysis import _leaves
    seen, total = set(), 0
    for t in _leaves(out):
        key = t.untyped_storage()._cdata
        if key not in seen:
            seen.add(key)
            total += t.untyped_storage().nbytes()
    return total


def _counts(tally: Tally, arg_b: int, out_b: int) -> Dict[str, Any]:
    return {"dot_flops": dict(tally.dot_flops), "hbm": tally.hbm_bytes,
            "coll_bytes": dict(tally.coll_bytes),
            "coll_count": dict(tally.coll_count), "dots": dict(tally.dots),
            "colls": dict(tally.colls), "ops": dict(tally.kernel_ops),
            "peak": tally.peak_b, "args": arg_b, "out": out_b}


def _axpy(total, two, one, n: int):
    """``total`` plus ``n`` times (``two`` - ``one``), through dicts: a
    stage's ``n`` more repeats, each what its second repeat added."""
    if isinstance(total, dict):
        keys = set(total) | set(two) | set(one)
        return {k: _axpy(total.get(k, 0), two.get(k, 0), one.get(k, 0), n)
                for k in keys}
    return total + n * (two - one)


def layer_scan(cfg) -> List[int]:
    """The repeat of each stage of ``cfg``'s layer plan. A fake trace
    runs every stage at one repeat, then each stage of more at two, and
    extrapolates every count linearly to the stage's repeat: the
    reference's layer stack is a ``lax.scan`` whose body its HLO analysis
    counts once times the trip count; here every repeat of a stage runs
    the same program on the same shapes, so its counts (FLOPs, bytes,
    collectives, kernel ops, arguments and the peak of live bytes) grow
    by one repeat's at each repeat (held by the tests against the whole
    program's trace, and on the card against the whole program's
    peak)."""
    return [st.repeat for st in build_stages(cfg)]


def _trace(cfg, shp, layout, serve_rules, train_rules, mb, kn,
           device, real, fill_seed, scan, tally_run, timed):
    """One run of the cell's step under a tally (with ``scan``, its block
    loops scanned: ``Tally.loop``; none without ``tally_run``): (its
    counts, the mean wall time of ``timed`` more runs or None)."""
    with fake_world(layout) as world:
        if shp.kind == "train":
            step, args = _train_cell(cfg, shp, world, mb, kn, device, real,
                                     train_rules)
        else:
            sm, params = _serve_cell(cfg, shp, world, serve_rules, device,
                                     real)
            step, args = _serve_step(cfg, shp, sm, params, device, real)
        tally = Tally()
        if fill_seed is not None and real:
            fill_random(args, cfg.vocab, fill_seed)
            if shp.kind == "decode":     # every cached position live
                args[3].fill_(shp.seq_len - 1)
        arg_b = tally.arguments(args)
        out_b = 0
        if tally_run:
            with tally, tally.saving(), (tally.scanning() if scan else
                                         contextlib.nullcontext()):
                out = step(*args)
            out_b = _out_bytes(out)
            del out
        step_s = _time_step(step, args, timed, device) if timed else None
        del args, step
    return _counts(tally, arg_b, out_b), step_s


def lower_cell(arch: str, shape_name: str, mesh, *,
               microbatch: Optional[int] = None, profile: str = "baseline",
               knob_overrides: Optional[Dict[str, Any]] = None,
               fake: bool = True, device: str = "meta",
               fill_seed: Optional[int] = None,
               timed: int = 0, cfg=None, scan: Optional[bool] = None,
               tally_run: bool = True):
    """Trace one cell as rank 0 of ``mesh`` (a layout dict or
    'singlepod'/'multipod'). Returns its record.

    ``fake`` (the default): on meta tensors (shapes and dtypes, no
    storage; the kernel wrappers take their kernel's branch for them,
    ``kernels/_build.py`` ``on_card``, each kernel a custom op whose fake
    implementation gives its outputs), with the layer scan
    (:func:`layer_scan`). ``fake=False``: the whole program once on real
    tensors on ``device``, zeros or random ones drawn from ``fill_seed``
    (:func:`fill_random`), then ``timed`` more calls of the step outside
    the tally, their mean wall time in the record's ``step_s`` (a card
    synchronised around each); ``tally_run=False`` runs only those (the
    record's counts then empty). ``scan`` overrides whether the scans are
    used. ``cfg`` traces a config of its own in place of the arch's."""
    from repro_torch.distributed.sharding import merged_rules, profile_rules
    cfg = cfg or get_config(arch)
    shp = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    layout = (production_mesh(MESHES[mesh]) if isinstance(mesh, str)
              else dict(mesh))
    kn: Dict[str, Any] = dict(knob_overrides or {})
    rules_extra = kn.pop("rules", {})
    mb = microbatch if microbatch is not None else kn.pop(
        "microbatch", 64 if (profile == "tuned" and cfg.n_experts) else 32)
    # the profile decides on the whole model, before any scan
    serve_rules = merged_rules(profile_rules(profile, cfg, shp.kind, layout,
                                             shp.global_batch))
    serve_rules.update(rules_extra)
    train_rules = _train_rules(cfg, shp, layout, profile, rules_extra)
    device = "meta" if fake else device
    scan = fake if scan is None else scan
    t0 = time.time()
    run = functools.partial(_trace, cfg, shp, layout, serve_rules,
                            train_rules, mb, kn, device, not fake,
                            fill_seed, scan, tally_run)
    repeats = layer_scan(cfg)
    if scan and max(repeats) > 1:
        ones = {i: 1 for i in range(len(repeats))}
        with stage_repeats(ones):
            one, _ = run(0)
        c = one
        for i, r in enumerate(repeats):
            if r > 1:
                with stage_repeats({**ones, i: 2}):
                    two, _ = run(0)
                c = _axpy(c, two, one, r - 1)
        step_s = None
    else:
        c, step_s = run(timed)
    t_trace = time.time() - t0
    mem_b, whose = card_memory()
    n_dev = 1
    for v in layout.values():
        n_dev *= v
    peak = int(c["peak"])
    coll_b = dict(c["coll_bytes"], total=float(sum(c["coll_bytes"].values())))
    coll_n = dict(c["coll_count"], total=int(sum(c["coll_count"].values())))
    top = lambda t: sorted(((v, k) for k, v in t.items()),  # noqa: E731
                           reverse=True)[:10]
    return {
        "arch": arch, "shape": shp.name, "kind": shp.kind,
        "profile": profile,
        "mesh": "x".join(str(layout[a]) for a in ("pod", "data", "model")
                         if a in layout),
        "n_devices": n_dev,
        "flops_hlo": float(sum(c["dot_flops"].values())),
        "dot_flops_by_dtype": c["dot_flops"],
        "hbm_bytes_hlo": float(c["hbm"]),
        "collective_bytes": coll_b,
        "collective_count": coll_n,
        "top_dots": [[v, k] for v, k in top(c["dots"])],
        "top_colls": [[v, k] for v, k in top(c["colls"])],
        "xla_flops": -1.0,
        "xla_bytes_accessed": -1.0,
        "memory": {
            "argument_size_b": int(c["args"]),
            "output_size_b": int(c["out"]),
            "temp_size_b": peak - int(c["args"]),
            "generated_code_size_b": 0,
        },
        "lower_s": round(t_trace, 1),
        "compile_s": 0.0,
        "analyze_s": 0.0,
        "peak_b": peak,
        "kernel_ops": {k: int(v) for k, v in c["ops"].items() if v},
        "microbatch": mb if shp.kind == "train" else None,
        "layer_scan": repeats if scan and max(repeats) > 1 else None,
        "device_memory_b": mem_b,
        "device_memory_of": whose,
        "fits": bool(peak <= mem_b),
        "step_s": step_s,
    }


def _cell_job(job):
    arch, shape_name, mesh_kind, profile, knobs, path = job
    try:
        rec = lower_cell(arch, shape_name, mesh_kind, profile=profile,
                         knob_overrides=knobs)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        return arch, shape_name, rec, None
    except Exception as e:  # noqa: BLE001 — report, continue, fail at end
        return arch, shape_name, None, f"{e}\n{traceback.format_exc()}"


def run_cells(cells, mesh_kind: str, out_dir: str, knob_overrides=None,
              profile: str = "baseline", jobs: int = 1) -> Dict[str, Any]:
    """Trace ``cells`` on one production mesh, ``jobs`` processes at a
    time; print one line a cell (the failures with their reason) and
    write each record. Returns {arch__shape: record or {"error": ...}}."""
    os.makedirs(out_dir, exist_ok=True)
    work = [(a, s, mesh_kind, profile, knob_overrides,
             os.path.join(out_dir, f"{a}__{s}.json")) for a, s in cells]
    if jobs > 1:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(jobs, maxtasksperchild=1) as pool:
            done = pool.imap(_cell_job, work)
            results = _report(done, mesh_kind)
    else:
        results = _report(map(_cell_job, work), mesh_kind)
    return results


def _report(done, mesh_kind: str) -> Dict[str, Any]:
    results = {}
    for arch, shape_name, rec, err in done:
        key = f"{arch}__{shape_name}"
        if err is not None:
            print(f"FAIL {mesh_kind:9s} {key}: {err.splitlines()[0]}",
                  flush=True)
            print(err, flush=True)
            results[key] = {"error": err.splitlines()[0]}
            continue
        m = rec["memory"]
        print(f"OK   {mesh_kind:9s} {key:42s} "
              f"flops/dev={rec['flops_hlo']:.3e} "
              f"coll/dev={rec['collective_bytes'].get('total', 0):.3e}B "
              f"mem/dev={(m['argument_size_b'] + m['temp_size_b']) / 2**30:.2f}GiB "
              f"trace={rec['lower_s']}s "
              f"fits {rec['device_memory_of']}: "
              f"{'yes' if rec['fits'] else 'NO'}", flush=True)
        results[key] = rec
    return results


def summary(out_dir: str) -> List[str]:
    """A markdown table of the records under ``out_dir`` (its
    ``singlepod``, ``multipod`` and ``*-tuned`` trees): one row a cell,
    for each tree the rank's peak in GiB, whether it fits, its TFLOP and
    its collective GB."""
    trees = [t for t in ("singlepod", "multipod", "singlepod-tuned",
                         "multipod-tuned")
             if os.path.isdir(os.path.join(out_dir, t))]
    head = ["cell"] + [f"{t}: peak GiB / fits / TFLOP / coll GB"
                       for t in trees]
    lines = ["| " + " | ".join(head) + " |",
             "|" + "---|" * len(head)]
    for arch, sname in runnable_cells():
        row = [f"{arch} {sname}"]
        for t in trees:
            path = os.path.join(out_dir, t, f"{arch}__{sname}.json")
            if not os.path.exists(path):
                row.append("—")
                continue
            with open(path) as f:
                r = json.load(f)
            row.append(f"{r['peak_b'] / 2**30:.2f} / "
                       f"{'yes' if r['fits'] else 'NO'} / "
                       f"{r['flops_hlo'] / 1e12:.3g} / "
                       f"{r['collective_bytes']['total'] / 1e9:.2f}")
        lines.append("| " + " | ".join(row) + " |")
    return lines


def list_cells(cells) -> List[str]:
    lines = [f"{a} {s}" for a, s in cells]
    for arch in sorted({a for a, _ in runnable_cells()}):
        for sname, runs, why in cell_plan(arch):
            if not runs:
                lines.append(f"SKIP {arch} {sname}: {why}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["singlepod", "multipod", "both"])
    ap.add_argument("--profile", default="baseline",
                    choices=["baseline", "tuned"])
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--out", default=RUNS_DIR)
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, a process each")
    ap.add_argument("--summary", action="store_true",
                    help="print a table of the records under --out")
    args = ap.parse_args(argv)
    if args.summary:
        for line in summary(args.out):
            print(line)
        return 0

    cells = runnable_cells()
    if args.arch:
        cells = [c for c in cells if c[0] == args.arch]
    if args.shape:
        cells = [c for c in cells if c[1] == args.shape]
    if args.list:
        for line in list_cells(cells):
            print(line)
        return 0
    meshes = (["singlepod", "multipod"] if args.mesh == "both"
              else [args.mesh])
    n_fail = 0
    for mk in meshes:
        sub = mk if args.profile == "baseline" else f"{mk}-{args.profile}"
        res = run_cells(cells, mk, os.path.join(args.out, sub),
                        profile=args.profile, jobs=args.jobs)
        n_fail += sum(1 for r in res.values() if "error" in r)
    print(f"\ndry-run complete; {n_fail} failures")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
