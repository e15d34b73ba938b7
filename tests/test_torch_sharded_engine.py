"""Port parity, tensor-parallel serving: the port's ``Engine`` and
``SpeculativeEngine`` (gamma 2) on a ("data", "model") mesh of gloo
ranks give the greedy streams, steps and evictions of the JAX package's
single-device ``Engine`` on the configs and meshes of
``tests/test_sharded_engine.py`` (2x4 left out: eight CPU processes); one
sharded decode step reproduces the port's single-device logits,
telemetry and page writes bit for bit (and JAX's telemetry, its logits
within the port's stated 1e-4); the data-sharded pool gives JAX's page ids and
free lists under one random operation sequence; the engine's mesh
validation and its divergence check; each step's attributed collective
bytes (``launch/step_cost.py``) equal the bytes the step passes to
``torch.distributed``; the static checker's mesh traces
(``repro_torch.analysis.stepcheck``: every engine step kind of its tiny
transformer config at 1x2 and 2x2; ``python -m repro_torch.analysis``
adds the MoE config) meet TXP001-005, every collective allowlisted and
every collective entry of the allowlist matched. Each world of
processes is spawned once for the module (two ranks for the 1x2
meshes, four for 2x2 and 1x4), with a time limit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import ModelConfig as JConfig
from repro.core.qlinear import quantize_model_params as jquantize
from repro.launch import steps as JS
from repro.models.schema import init_params as jinit
from repro.models.schema_builder import build_schema as jschema
from repro.serving import Engine as JEngine
from repro.serving import PagedKVPool as JPool
from repro.serving import PoolConfig as JPoolConfig
from repro.serving import SamplingParams as JSampling
from repro.serving import SchedulerConfig as JSched
from repro_torch.analysis.findings import Allowlist, apply_allowlist
from repro_torch.analysis.stepcheck import MESHES, mesh_rank
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import convert_tree
from repro_torch.launch import steps as TS
from repro_torch.launch.mesh import spawn_world
from repro_torch.serving import PagedKVPool, PoolConfig, SchedulerConfig
from repro_torch.serving.kv_pool import pool_schema

from _torch_worlds import (attribution_world, calls_world, decode_world,
                           engine_world, lockstep_world)

TIMEOUT_S = 240
CFG = JConfig(name="tiny-serve", family="transformer", n_layers=2,
              d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
              d_ff=64, vocab=128, dtype="float32")
CFG_TP4 = JConfig(name="tiny-serve-tp4", family="transformer",
                  n_layers=2, d_model=32, n_heads=8, n_kv_heads=4,
                  head_dim=4, d_ff=64, vocab=128, dtype="float32")
CFG_MOE = JConfig(name="tiny-moe-serve", family="moe", n_layers=4,
                  d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
                  d_ff=64, vocab=64, dtype="float32", n_experts=4,
                  top_k=2, moe_every=2, moe_d_ff=32,
                  router_type="softmax")
POOL = dict(n_pages=32, page_size=4)
SCHED = dict(max_decode_batch=4, token_budget=64, prefill_chunk=8,
             max_pages_per_seq=8)
GEN = 5
ENGINES = [("tf-1x2", CFG, (1, 2), 0, 0), ("tf-2x2", CFG, (2, 2), 0, 0),
           ("tf-1x4", CFG_TP4, (1, 4), 0, 0),
           ("moe-1x2", CFG_MOE, (1, 2), 0, 0),
           ("moe-2x2", CFG_MOE, (2, 2), 0, 0),
           ("spec-tf-1x2", CFG, (1, 2), 2, 0),
           ("spec-tf-2x2", CFG, (2, 2), 2, 0),
           ("spec-moe-2x2", CFG_MOE, (2, 2), 2, 1)]
# attributed collective bytes against the bytes counted in one call of
# each step kind: (id, cfg, mesh, gamma)
ATTRIBUTED = [("tf-1x2", CFG, (1, 2), 0), ("tf-2x2", CFG, (2, 2), 0),
              ("moe-2x2", CFG_MOE, (2, 2), 0),
              ("spec-tf-2x2", CFG, (2, 2), 2)]


def _tcfg(cfg):
    return ModelConfig(**dataclasses.asdict(cfg))


def _qparams(cfg, seed=0):
    fp = jinit(jschema(cfg), jax.random.PRNGKey(seed))
    return jquantize(fp, w_bits=4, k_percent=50.0, clip_l=-8.0, clip_h=23.0,
                     mode="sparqle", enable_clipping=True, tile_k=16)


def _prompts(cfg, seed=0, lens=(9, 13, 7, 11)):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg.vocab, size=n).tolist() for n in lens]


def _jax_run(cfg, qp, prompts):
    eng = JEngine(cfg, qp, pool_config=JPoolConfig(**POOL),
                  sched_config=JSched(**SCHED))
    hs = [eng.submit(p, JSampling(max_new_tokens=GEN)) for p in prompts]
    eng.run()
    return [list(h.out_tokens) for h in hs], eng.steps, eng.pool.evictions


def _decode_inputs():
    """JAX's step-level check widened to four slots (two live), in the
    single-device pool's page ids: the first data shard of two owns pages
    0-3 and the second 4-7, each with its null page (0 and 4), so that
    every slot reads and writes the same pages unsharded and on a 2x2
    mesh. Returns the whole batch and its tables in shard-local ids."""
    token = np.asarray([3, 0, 7, 0], np.int32)
    pos = np.asarray([4, 0, 2, 0], np.int32)
    tables = np.asarray([[1, 2], [0, 0], [5, 4], [4, 4]], np.int32)
    local = tables - np.asarray([[0], [0], [4], [4]], np.int32)
    return (token, pos, tables), (token, pos, local)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """JAX's single-device references, then every sharded job run by one
    world of two and one of four ranks."""
    refs, jobs, trees = {}, [], {}
    for cid, cfg, shape, gamma, seed in ENGINES:
        key = (cfg.name, seed)
        if key not in trees:
            qp = _qparams(cfg, seed)
            trees[key] = convert_tree(jax.tree_util.tree_map(np.asarray, qp))
            refs[key] = _jax_run(cfg, qp, _prompts(cfg, seed))
        jobs.append(dict(id=cid, mesh=shape, cfg=_tcfg(cfg),
                         params=trees[key], prompts=_prompts(cfg, seed),
                         gen=GEN, gamma=gamma, pool=PoolConfig(**POOL),
                         sched=SchedulerConfig(**SCHED)))
    tcfg, tree = _tcfg(CFG), trees[(CFG.name, 0)]
    # the mesh validation probes
    jobs += [dict(id="bad-kv-heads", mesh=(1, 4), cfg=tcfg, params=tree,
                  prompts=[], gen=1, pool=PoolConfig(**POOL),
                  sched=SchedulerConfig(**SCHED)),
             dict(id="bad-batch", mesh=(2, 1), cfg=tcfg, params=tree,
                  prompts=[], gen=1, pool=PoolConfig(n_pages=8, page_size=4),
                  sched=SchedulerConfig(max_decode_batch=3)),
             dict(id="kv2", mesh=(1, 2), cfg=tcfg, params=tree, prompts=[],
                  gen=1, pool=PoolConfig(n_pages=8, page_size=4,
                                         kv2_pages=4),
                  sched=SchedulerConfig(**SCHED))]
    # one decode step: JAX single device on pages written by a prefill
    qp = _qparams(CFG)
    jpool = JPool(CFG, JPoolConfig(n_pages=8, page_size=4))
    state = jax.tree_util.tree_map(
        lambda a: jax.random.randint(jax.random.PRNGKey(3), a.shape, -100,
                                     100).astype(a.dtype)
        if a.dtype == jnp.int8 else a, jpool.state)
    whole, local = _decode_inputs()
    ref_step = JS.make_engine_decode(CFG)(qp, state,
                                          *map(jnp.asarray, whole))
    tstate = convert_tree(jax.tree_util.tree_map(np.asarray, state))
    mine = convert_tree(jax.tree_util.tree_map(np.asarray, state))
    single = TS.make_engine_decode(tcfg)(
        tree, mine, *(convert_tree(a) for a in whole))
    schema = pool_schema(tcfg, PoolConfig(n_pages=8, page_size=4))
    dec = (decode_world, (tcfg, tree, tstate, schema, {
        (1, 2): tuple(convert_tree(a) for a in whole),
        (2, 2): tuple(convert_tree(a) for a in local)}))
    attributed = [dict(id=aid, mesh=shape, cfg=_tcfg(cfg),
                       params=trees[(cfg.name, 0)], prompts=_prompts(cfg)[:3],
                       gen=3, gamma=gamma, pool=PoolConfig(**POOL),
                       sched=SchedulerConfig(**SCHED))
                  for aid, cfg, shape, gamma in ATTRIBUTED]
    out = {}
    for world in (2, 4):
        res = spawn_world(calls_world, world,
                          [(engine_world, (jobs,)), dec, (lockstep_world, ()),
                           (attribution_world, (attributed,)),
                           (mesh_rank, (MESHES, ("transformer",)))],
                          timeout_s=TIMEOUT_S, deadline_s=TIMEOUT_S,
                          store_dir=str(tmp_path_factory.mktemp("world")))
        out[world] = res
    return refs, out, (ref_step, single), schema


def _ranks(setup, shape):
    _, out, _, _ = setup
    return out[shape[0] * shape[1]]


@pytest.mark.parametrize("cid,cfg,shape,gamma,seed", ENGINES,
                         ids=[e[0] for e in ENGINES])
def test_sharded_engine_matches_jax_single_device(setup, cid, cfg, shape,
                                                  gamma, seed):
    """Every rank emits JAX's single-device greedy streams; the base
    engine also its steps and evictions (the speculative engine runs
    fewer steps: JAX's sharded one is held to the streams alone)."""
    refs = setup[0]
    streams, steps, evictions = refs[(cfg.name, seed)]
    for r, res in enumerate(_ranks(setup, shape)):
        got = res[0][cid]
        assert got[0] == streams, f"rank {r}"
        agg = got[3]
        assert agg["mesh"] == f"{shape[0]}x{shape[1]}"
        assert agg["step_mode"] == "eager"
        if gamma:
            assert agg["spec_gamma"] == gamma and agg["steps"] > 0
        else:
            assert (got[1], got[2]) == (steps, evictions), f"rank {r}"


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_decode_step_sharded_bitexact(setup, shape):
    """One sharded decode step (KV heads over model, the four slots over
    data) gives the port's single-device logits and telemetry bit for
    bit on every rank, and each rank's pool slice equals the same slice
    of the single-device pool after the step; against JAX's step the
    telemetry is equal and the logits within 1e-4 (its attention sums in
    another order, ``tests/test_torch_model.py``)."""
    from repro_torch.distributed.sharding import MeshCoords, shard_pool_state
    _, _, ((jlogits, _, jtel), (ref_logits, ref_pool, ref_tel)), schema = \
        setup
    d_ways, m_ways = shape
    for r, res in enumerate(_ranks(setup, shape)):
        logits, tel, pool = res[1][shape]
        np.testing.assert_array_equal(logits, ref_logits.numpy())
        np.testing.assert_allclose(logits, np.asarray(jlogits), atol=1e-4,
                                   rtol=1e-4)
        for k in ref_tel:
            np.testing.assert_array_equal(tel[k], ref_tel[k].numpy())
            np.testing.assert_array_equal(tel[k], np.asarray(jtel[k]))
        coords = MeshCoords(r // m_ways, d_ways, r % m_ways, m_ways)
        want = shard_pool_state(ref_pool, schema, coords)
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_array_equal(a, b.numpy()),
            pool, want)


def test_engine_mesh_validation(setup):
    """An indivisible dim, an indivisible decode batch and the KV2 ladder
    are refused under a mesh, naming the cause."""
    four = _ranks(setup, (1, 4))[0][0]
    two = _ranks(setup, (1, 2))[0][0]
    assert four["bad-kv-heads"][0] == "ValueError"
    assert "n_kv_heads=2 % model=4" in four["bad-kv-heads"][1]
    assert two["bad-batch"][0] == "ValueError"
    assert "max_decode_batch" in two["bad-batch"][1]
    assert two["kv2"][0] == "NotImplementedError"


@pytest.mark.parametrize("aid,cfg,shape,gamma", ATTRIBUTED,
                         ids=[a[0] for a in ATTRIBUTED])
def test_attributed_collective_bytes_equal_counted(setup, aid, cfg, shape,
                                                   gamma):
    """On every rank, for each step kind the engine ran (prefill, decode;
    draft and verify at gamma 2): the collective bytes ``attribute_steps``
    counts from the step's shapes, per call, equal the bytes a wrapper of
    ``dist.all_reduce``/``dist.all_gather`` sees in the step's first
    call, kind by kind."""
    phases = {"prefill", "decode"} | ({"draft", "verify"} if gamma else set())
    if gamma:
        phases.discard("decode")
    for r, res in enumerate(_ranks(setup, shape)):
        got = res[3][aid]
        assert set(got) == phases, f"rank {r}"
        for phase, (counted, attributed, calls) in got.items():
            per_call = {k: v / calls for k, v in attributed.items()}
            for kind in ("all-reduce", "all-gather"):
                assert per_call[kind] == counted.get(kind, 0), \
                    (r, phase, kind, per_call, counted)
            assert per_call["total"] == sum(counted.values())
            if shape[1] > 1:
                assert counted["all-reduce"] > 0


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_that_diverge_raise(setup, world):
    """A step whose ranks emitted different tokens raises on every rank
    (the next collective would otherwise wait forever)."""
    for res in setup[1][world]:
        assert res[2] is not None and "diverged" in res[2]


# ---------------------------------------------------------------------------
# the data-sharded pool (host only)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_pool_shard_consistency_matches_jax(n_shards):
    """JAX's and the port's pools through one random allocate / truncate
    / evict / release sequence: the same page ids from every operation,
    the same free lists, every shard's local ids disjoint and complete,
    owners pinned to one shard."""
    tcfg = _tcfg(CFG)
    for seed in range(5):
        rng = np.random.RandomState(seed)
        cfgp = dict(n_pages=16, page_size=4)
        jp = JPool(CFG, JPoolConfig(**cfgp), n_shards=n_shards)
        tp = PagedKVPool(tcfg, PoolConfig(**cfgp), n_shards=n_shards)
        owners: dict = {}
        for _ in range(40):
            op = rng.randint(4)
            owner = int(rng.randint(6))
            if op == 0:
                shard = owners.get(owner, int(rng.randint(n_shards)))
                n = int(rng.randint(1, 4))
                got = [p.allocate(n, owner, shard=shard) for p in (jp, tp)]
                if got[0]:
                    owners[owner] = shard
            elif op == 1:
                tok = int(rng.randint(0, 20))
                got = [p.truncate(owner, tok) for p in (jp, tp)]
                if not tp.pages_of(owner):
                    owners.pop(owner, None)
            else:
                got = [(p.evict if op == 2 else p.release)(owner)
                       for p in (jp, tp)]
                owners.pop(owner, None)
            assert got[0] == got[1]
            assert [list(f) for f in jp._free] == \
                [list(f) for f in tp._shard_free]
            seen = [set() for _ in range(n_shards)]
            for o in list(tp._owned):
                s = tp.shard_of(o)
                assert owners[o] == s == jp.shard_of(o)
                pages = set(tp.pages_of(o))
                assert not pages & seen[s] and 0 not in pages
                seen[s] |= pages
            for s in range(n_shards):
                assert set(tp._shard_free[s]) | seen[s] == \
                    set(range(1, tp.pages_per_shard))
            assert tp.num_free == jp.num_free
            assert tp.evictions == jp.evictions


def test_pool_shard_capacity_and_validation():
    tcfg = _tcfg(CFG)
    pool = PagedKVPool(tcfg, PoolConfig(n_pages=8, page_size=4), n_shards=2)
    assert pool.pages_per_shard == 4
    assert pool.n_usable_pages == 6          # one null page a shard
    assert pool.usable_pages_per_shard == 3
    assert pool.allocate(3, "a", shard=0) is not None
    assert pool.allocate(1, "x", shard=0) is None
    assert pool.allocate(1, "b", shard=1) is not None
    assert pool.free_in_shard(0) == 0 and pool.free_in_shard(1) == 2
    with pytest.raises(ValueError):          # owners pin to one shard
        pool.allocate(1, "a", shard=1)
    with pytest.raises(ValueError):          # n_pages must divide
        PagedKVPool(tcfg, PoolConfig(n_pages=9, page_size=4), n_shards=2)
    with pytest.raises(ValueError):          # >= 2 pages a shard
        PagedKVPool(tcfg, PoolConfig(n_pages=4, page_size=4), n_shards=4)
    with pytest.raises(NotImplementedError):  # KV2 runs unsharded
        PagedKVPool(tcfg, PoolConfig(n_pages=8, page_size=4, kv2_pages=4),
                    n_shards=2)


# ---------------------------------------------------------------------------
# the static checker's mesh traces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_mesh_step_contracts(setup, shape):
    """Rank 0's findings of every step kind traced at this mesh: all
    allowlisted (collectives, the host clipping constants), none of
    TXP002-004 (one int32 SUM and one f32 MAX over model a row-parallel
    linear, 2 a transformer decode layer; the accumulator's dtype; the
    draft's MSB elision)."""
    ranks = _ranks(setup, shape)
    found = ranks[0][4]
    assert all(r[4] is None for r in ranks[1:])
    active, _ = apply_allowlist(found, Allowlist.load())
    assert active == [], "\n".join(f.render() for f in active)
    assert {f.rule_id for f in found} == {"TXP001", "TXP005"}
    keys = {f.key for f in found if f.rule_id == "TXP001"}
    assert {"decode:all_reduce_sum:model:int32",
            "decode:all_reduce_max:model:float32"} <= keys
    assert any(":data:" in k for k in keys) == (shape[0] > 1)


def test_mesh_traces_match_every_collective_entry(setup):
    """Over both worlds every TXP001 entry of the allowlist matches a
    collective (none is stale)."""
    al = Allowlist.load()
    for shape in ((1, 2), (2, 2)):
        apply_allowlist(_ranks(setup, shape)[0][4], al)
    assert [e.pattern for e in al.stale_entries()
            if e.rule_id == "TXP001"] == []


# ---------------------------------------------------------------------------
# serve --mesh
# ---------------------------------------------------------------------------

def test_serve_mesh_streams_equal_single_device(tmp_path):
    """``serve --mesh 2,2`` (four gloo ranks on the CPU) prints rank 0's
    run, whose streams are the single-device serve's; ``--mesh`` with
    ``--legacy`` is refused."""
    from repro_torch.launch import serve
    args = ["--arch", "granite-8b", "--smoke", "--device", "cpu", "--batch",
            "4", "--prompt-len", "13", "--gen", "5", "--page-size", "8"]
    single = serve.main(args)
    sharded = serve.main(args + ["--mesh", "2,2"])
    assert sharded["streams"] == single["streams"]
    assert sharded["step_mode"] == "eager"
    assert sharded["aggregate"]["mesh"] == "2x2"
    with pytest.raises(SystemExit, match="--legacy"):
        serve.main(args + ["--mesh", "1,2", "--legacy"])
