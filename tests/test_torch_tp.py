"""Port parity, tensor parallelism at the op level: the sharded linears of
``repro_torch`` (``qlinear.linear``/``expert_linear`` with ``tp="row"``
and column shards, ``ops.sparqle_linear_sharded``), run by the ranks of
one gloo world of four processes (meshes 2x2 for two model ways, 1x4
for four), are ``torch.equal`` to the JAX package's single-device
``linear`` on the same quantized tree; a row-parallel linear makes
exactly one MAX (f32) and one int32 SUM all-reduce. Also: paged decode
and verify attention on KV-head slices equal the unsharded call's head
slice; the partition table against JAX's ``param_pspecs``; the config
validation against JAX's; the backend choice never switches on its own.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.core import qlinear as jq
from repro.distributed import tp as jtp
from repro.models.schema import init_params as jinit
from repro.models.schema_builder import build_schema as jschema
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import convert_tree
from repro_torch.core.quantize import QuantizedTensor
from repro_torch.distributed import tp
from repro_torch.kernels.kv_attention import (kv4_paged_decode_attention,
                                              kv4_paged_verify_attention)
from repro_torch.launch.mesh import pick_backend, spawn_world

from _torch_worlds import linear_world

WORLD = 4
MESH = {2: (2, 2), 4: (1, 4)}          # model ways -> the mesh giving them
TIMEOUT_S = 240
M_ROWS, K, N = 8, 128, 64
E, C, KE, NE = 4, 3, 64, 32
CLIP = (-8.0, 23.0)


def _x(shape, seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape) * rng.uniform(0.2, 4.0, shape[:-1] + (1,))
    return x.astype(dtype)


def _leaf(shape, seed, **kw):
    """A JAX quantized projection (tile-aligned clip mask, K tiles 16)."""
    w = jnp.asarray(np.random.RandomState(seed).randn(*shape)
                    .astype(np.float32))
    return jq.quantize_leaf(w, tile_k=16, **kw)


def _specs():
    """(id, what the case runs): cheap, so that collection in every
    worker computes nothing; the fixture builds the operands."""
    out = []
    for ways in (2, 4):
        for wf in ("unpacked", "packed"):
            for skip in (False, True):
                for part in ("col", "row"):
                    tag = f"{ways}-{wf}-{'draft' if skip else 'full'}-{part}"
                    for fn in ("linear", "sharded"):
                        out.append((f"{fn}-{tag}", dict(
                            fn=fn, ways=ways, part=part, wf=wf, skip=skip,
                            kind="base")))
        # bf16 activations (the serving dtype) and the dense mode
        for kind in ("bf16", "dense"):
            for part in ("col", "row"):
                out.append((f"linear-{ways}-{kind}-{part}", dict(
                    fn="linear", ways=ways, part=part, kind=kind)))
        # routed experts (E, C, K) @ (E, K, N): one batched launch a rank
        for wf in ("unpacked", "packed", "dense"):
            for part in ("col", "row"):
                out.append((f"expert-{ways}-{wf}-{part}", dict(
                    fn="expert", ways=ways, part=part, wf=wf,
                    kind="expert")))
    # no clipping constants: the row path without a mask
    out.append(("linear-2-noclip-row", dict(fn="linear", ways=2, part="row",
                                            kind="noclip")))
    return out


SPECS = _specs()


def _case(cid, spec):
    """(the case the ranks run, JAX's single-device output)."""
    base = dict(id=cid, fn=spec["fn"], mesh=MESH[spec["ways"]],
                partition=spec["part"], msb_skip=spec.get("skip", False))
    kind = spec["kind"]
    if kind == "base":
        jsl = _leaf((K, N), 1, wire_format=spec["wf"])
        x = _x((M_ROWS, K), 2)
        with jq.msb_skip_scope(spec["skip"]):
            ref = np.asarray(jq.linear(jnp.asarray(x), jsl))
        sl = convert_tree(jsl)
        if spec["fn"] == "sharded":
            w = QuantizedTensor(convert_tree(jsl.unpacked_q()), sl.w.scale,
                                sl.w.zero, 4)
            return dict(base, x=torch.from_numpy(x), w=w,
                        col_mask=sl.col_mask, clip=CLIP,
                        wire_format=spec["wf"]), ref
        return dict(base, x=torch.from_numpy(x), sl=sl), ref
    if kind in ("bf16", "dense"):
        jsl = _leaf((K, N), 3, **({"mode": "dense"} if kind == "dense"
                                  else {}))
        x = jnp.asarray(_x((M_ROWS, K), 4)).astype(
            jnp.bfloat16 if kind == "bf16" else jnp.float32)
        ref = np.asarray(jq.linear(x, jsl).astype(jnp.float32))
        return dict(base, x=convert_tree(x), sl=convert_tree(jsl)), ref
    if kind == "expert":
        kw = {"packed": {"wire_format": "packed"},
              "dense": {"mode": "dense"}}.get(spec["wf"], {})
        jsl = _leaf((E, KE, NE), 5, **kw)
        x = _x((E, C, KE), 6)
        ref = np.asarray(jq.expert_linear(jnp.asarray(x), jsl))
        return dict(base, x=torch.from_numpy(x), sl=convert_tree(jsl)), ref
    jsl = _leaf((K, N), 7, enable_clipping=False)
    x = _x((M_ROWS, K), 8)
    return (dict(base, x=torch.from_numpy(x), sl=convert_tree(jsl)),
            np.asarray(jq.linear(jnp.asarray(x), jsl)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """JAX's references, then every case run once by each rank of one
    world of WORLD processes (the time limit fails the test rather than
    hanging it). Returns ({id: reference}, [each rank's results])."""
    built = {cid: _case(cid, spec) for cid, spec in SPECS}
    res = spawn_world(linear_world, WORLD, [c for c, _ in built.values()],
                      timeout_s=TIMEOUT_S, deadline_s=TIMEOUT_S,
                      store_dir=str(tmp_path_factory.mktemp("world")))
    return {cid: ref for cid, (_, ref) in built.items()}, res


@pytest.mark.parametrize("cid,spec", SPECS, ids=[c for c, _ in SPECS])
def test_sharded_linear_equals_jax_single_device(ranks, cid, spec):
    """Bit-equal to JAX's unsharded linear on every rank (the output is
    replicated); a row-parallel linear makes one MAX and one int32 SUM
    all-reduce, a column-parallel one none (the test's column sites
    gather their output channels once)."""
    refs, results = ranks
    ref = refs[cid]
    for r, res in enumerate(results):
        got, counts = res[cid]
        assert got.dtype == ref.dtype and got.shape == ref.shape, r
        assert torch.equal(torch.from_numpy(np.array(got)),
                           torch.from_numpy(np.array(ref))), \
            f"rank {r}: max |diff| {np.abs(got - ref).max()}"
        reduces = {k: v for k, v in counts.items() if k[0] == "all_reduce"}
        if spec["part"] == "row":
            assert reduces == {("all_reduce", "MAX", "torch.float32"): 1,
                               ("all_reduce", "SUM", "torch.int32"): 1}, \
                counts
        else:
            assert not reduces and sum(counts.values()) == 1, counts


# ---------------------------------------------------------------------------
# attention on KV-head slices (per-head independent: no collective)
# ---------------------------------------------------------------------------

def _paged(seed, b, kvh, hd, npages, ps, nsteps):
    rng = np.random.RandomState(seed)
    t = lambda a, dt: torch.from_numpy(np.asarray(a, dt))  # noqa: E731
    kq = t(rng.randint(-128, 128, (npages, ps, kvh, hd // 2)), np.int8)
    ks = t(np.abs(rng.randn(npages, ps, kvh)) + 0.1, np.float32)
    vq = t(rng.randint(-128, 128, (npages, ps, kvh, hd // 2)), np.int8)
    vs = t(np.abs(rng.randn(npages, ps, kvh)) + 0.1, np.float32)
    bt = t(rng.randint(0, npages, (b, nsteps)), np.int32)
    return rng, kq, ks, vq, vs, bt


@pytest.mark.parametrize("ways", [2, 4])
def test_paged_decode_attention_kv_head_sharded(ways):
    b, kvh, g, hd = 2, 4, 2, 8
    rng, kq, ks, vq, vs, bt = _paged(0, b, kvh, hd, 6, 4, 3)
    q = torch.from_numpy(rng.randn(b, kvh, g, hd).astype(np.float32))
    pos = torch.tensor([5, 9], dtype=torch.int32)
    ref = kv4_paged_decode_attention(q, kq, ks, vq, vs, bt, pos)
    for r in range(ways):
        cut = lambda t, d: tp.slice_for_rank(t, d, r, ways)  # noqa: E731
        got = kv4_paged_decode_attention(
            cut(q, 1), cut(kq, 2), cut(ks, 2), cut(vq, 2), cut(vs, 2), bt,
            pos)
        assert torch.equal(got, cut(ref, 1))


@pytest.mark.parametrize("ways", [2, 4])
def test_paged_verify_attention_kv_head_sharded(ways):
    b, t, kvh, g, hd = 2, 3, 4, 2, 8
    rng, kq, ks, vq, vs, bt = _paged(4, b, kvh, hd, 6, 4, 3)
    q = torch.from_numpy(rng.randn(b, t, kvh, g, hd).astype(np.float32))
    pos = torch.tensor([4, 7], dtype=torch.int32)
    ref = kv4_paged_verify_attention(q, kq, ks, vq, vs, bt, pos)
    for r in range(ways):
        cut = lambda x, d: tp.slice_for_rank(x, d, r, ways)  # noqa: E731
        got = kv4_paged_verify_attention(
            cut(q, 2), cut(kq, 2), cut(ks, 2), cut(vq, 2), cut(vs, 2), bt,
            pos)
        assert torch.equal(got, cut(ref, 2))


# ---------------------------------------------------------------------------
# the partition table, the config checks, the backend choice
# ---------------------------------------------------------------------------

MOE = JConfig(name="tiny-moe-serve", family="moe", n_layers=4, d_model=32,
              n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64, vocab=64,
              dtype="float32", n_experts=4, top_k=2, moe_every=2,
              moe_d_ff=32, router_type="softmax", n_shared_experts=1,
              tie_embeddings=False)


@pytest.mark.parametrize("ways", [2, 4])
def test_shard_params_follows_jax_partition_specs(ways):
    """Every leaf of a quantized MoE tree (stacked layers, routed and
    shared experts, untied head) is cut on the dim JAX's param_pspecs
    names ("model"), by 1/ways, and nowhere else."""
    cfg = dataclasses.replace(MOE, n_heads=8, n_kv_heads=4) if ways == 4 \
        else MOE
    jtree = jq.quantize_model_params(jinit(jschema(cfg), jax.random.PRNGKey(0)),
                                     tile_k=16)
    specs = jtp.param_pspecs(jtree)
    full = convert_tree(jax.tree_util.tree_map(np.asarray, jtree))
    mine = tp.shard_params(full, 1, ways)

    def leaves(tree, spec, path=""):
        if isinstance(tree, dict):
            for k in tree:
                yield from leaves(tree[k], spec[k], f"{path}/{k}")
        elif isinstance(tree, jq.SparqleLinear):
            yield from ((f"{path}.q", tree.w.q, spec.w.q),
                        (f"{path}.scale", tree.w.scale, spec.w.scale),
                        (f"{path}.mask", tree.col_mask, spec.col_mask))
        else:
            yield path, tree, spec

    def torch_leaf(tree, path):
        node = tree
        name, _, field = path.partition(".")
        for k in name.strip("/").split("/"):
            node = node[k]
        return {"": node, "q": getattr(node, "w", None) and node.w.q,
                "scale": getattr(node, "w", None) and node.w.scale,
                "mask": getattr(node, "col_mask", None)}[field]

    n_cut = 0
    for path, jleaf, spec in leaves(jtree, specs):
        if jleaf is None:
            continue
        got = torch_leaf(mine, path)
        want = list(np.shape(jleaf))
        for d, ax in enumerate(tuple(spec)):
            if ax == "model":
                want[d] //= ways
                n_cut += 1
        assert list(got.shape) == want, path
    assert n_cut > 20


@pytest.mark.parametrize("ways", [2, 3, 4, 8])
@pytest.mark.parametrize("cfg", [MOE, dataclasses.replace(
    MOE, name="tied", family="transformer", tie_embeddings=True, d_ff=96)],
    ids=["moe-untied", "tied"])
def test_validate_and_shard_config_match_jax(cfg, ways):
    tcfg = ModelConfig(**dataclasses.asdict(cfg))
    try:
        want = jtp.shard_model_config(cfg, ways)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tp.shard_model_config(tcfg, ways)
        assert str(got.value) == str(e)
        return
    assert dataclasses.asdict(tp.shard_model_config(tcfg, ways)) == \
        dataclasses.asdict(want)


def test_backend_never_switches_on_its_own():
    """More ranks than cards under NCCL raises naming the gloo flag; the
    CPU runs gloo and refuses NCCL."""
    if torch.cuda.device_count() < 64:
        with pytest.raises(RuntimeError, match="--dist-backend gloo"):
            pick_backend(torch.device("cuda"), 64)
    assert pick_backend(torch.device("cuda"), 64, "gloo") == "gloo"
    assert pick_backend(torch.device("cpu"), 4) == "gloo"
    with pytest.raises(ValueError):
        pick_backend(torch.device("cpu"), 4, "nccl")
