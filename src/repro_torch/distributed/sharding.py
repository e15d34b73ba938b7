"""Logical-axis sharding over a ``("data", "model")`` mesh (torch twin of
``repro.distributed.sharding``): the paged pool state of serving, and the
float train state of mesh training.

Serving. The paged pool state shards by the serving part of the rule
table (``spec_for`` with ``pages -> data`` and ``kv_heads -> model``).

A pool leaf is declared with logical axes (``serving/kv_pool.py``
``pool_schema``: ``("layers", "pages", None, "kv_heads", None)``). A rank
at mesh coordinates (data rank, model rank) holds the contiguous slice
of each dim whose logical axis the table maps onto a mesh axis: its data
shard's pages and its model shard's KV heads. A dim the mesh axis does
not divide raises (the reference leaves it replicated; the serving path
validates before it gets here, and a silent replication would break the
shard-local page ids).

The dry-run and the ``--legacy`` steps on a mesh place a served tree,
its caches and the inputs by :func:`spec_for` too, under a profile's
rules (:func:`profile_rules`: ``tuned`` keeps weights whole over data
where they fit); :func:`local_dims` is a leaf's shape on one rank.

Training. :data:`DEFAULT_RULES` and :func:`spec_for` are the reference's
rule table and its placement, divisibility fallback to replication and
each mesh axis claimed once (by the first dim that asks) included.
:func:`train_placements` places every leaf of a float train tree by its
schema's logical axes: over ``data`` on the dim the table maps there
(``embed``/``fsdp``: the reference's baseline profile, FSDP everywhere),
over ``model`` in the Megatron column/row pattern (``heads_flat``,
``mlp``, ``vocab`` -> model) with routed experts on the expert axis. The
embedding table is the one exception: token lookup reads all of it, so it
stays whole over model (its ``embed`` dim keeps its ``data`` placement).
An SSD mixer's packed leaves take a *segmented* model cut instead of the
table's contiguous one: ``w_in``'s columns ``[z | x | B | C | dt]`` and
the conv's channels ``[x | B | C]`` are cut segment by segment, each rank
taking its heads' slice of z, x and dt, and of B and C its groups' slice
when the model ways divide the groups, else B and C whole (one group:
every rank computes them). Master params and both moments share the
placement. :class:`TrainShards`
cuts a rank's slice of a whole tree, draws a rank's slice of the init
leaf by leaf, and gathers a sharded tree whole onto rank 0.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.checkpoint.store import flatten, leaf_paths, unflatten
from repro_torch.distributed.tp import slice_for_rank

RULES: Dict[str, str] = {"pages": "data", "kv_heads": "model"}

# the reference's logical-axis rule table (repro.distributed.sharding)
DEFAULT_RULES: Dict[Optional[str], Tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "seq": (),
    "kv_seq": ("data", "model"),
    "embed": ("data", "pod"),
    "heads": ("model",),
    "heads_flat": ("model",),
    "kv_heads": ("model",),
    "pages": ("data",),
    "qk_dim": (),
    "mlp": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "capacity": ("data",),
    "layers": (),
    "fsdp": ("data",),
    "conv": (),
    "state": (),
    None: (),
}


@dataclasses.dataclass(frozen=True)
class MeshCoords:
    """A rank's place on the mesh: (rank, ways) along each axis."""
    data_rank: int = 0
    data_ways: int = 1
    model_rank: int = 0
    model_ways: int = 1

    def along(self, axis: str) -> Tuple[int, int]:
        return ((self.data_rank, self.data_ways) if axis == "data"
                else (self.model_rank, self.model_ways))


def local_shape(shape: Sequence[int], axes: Sequence, coords: MeshCoords
                ) -> Tuple[int, ...]:
    """``shape`` of a leaf with logical ``axes`` as one rank holds it."""
    out = []
    for n, ax in zip(shape, axes):
        _, ways = coords.along(RULES[ax]) if ax in RULES else (0, 1)
        if n % ways:
            raise ValueError(f"{ax} dim {n} does not divide {ways} ways")
        out.append(n // ways)
    return tuple(out)


def shard_tensor(t: torch.Tensor, axes: Sequence, coords: MeshCoords
                 ) -> torch.Tensor:
    """The rank's contiguous slice of a whole leaf ``t``."""
    for dim, ax in enumerate(axes):
        if ax in RULES:
            t = slice_for_rank(t, dim, *coords.along(RULES[ax]))
    return t


def shard_pool_state(state, schema, coords: MeshCoords):
    """A rank's slice of a whole pool state (the tree of
    ``init_pool_state``) after its ParamSpec tree ``schema``."""
    if isinstance(state, dict):
        return {k: shard_pool_state(v, schema[k], coords)
                for k, v in state.items()}
    return shard_tensor(state, schema.axes, coords)


# ---------------------------------------------------------------------------
# training: the rule table, the placement of a float train tree
# ---------------------------------------------------------------------------

def _axes_for(logical: Optional[str], dim: int, mesh_shape: Dict[str, int],
              rules: Dict, used: set) -> Optional[Tuple[str, ...]]:
    """Mesh axes for one dim, or None if unmapped or indivisible: axes an
    earlier dim claimed are skipped, divisibility falls back over the
    prefixes of the rule's axes."""
    names = tuple(n for n in rules.get(logical, ())
                  if n in mesh_shape and n not in used)
    for cut in range(len(names), 0, -1):
        sub = names[:cut]
        t = 1
        for n in sub:
            t *= mesh_shape[n]
        if dim % t == 0 and t > 1:
            return sub
    return None


def spec_for(logical_axes: Sequence[Optional[str]], shape: Sequence[int],
             mesh_shape: Dict[str, int],
             rules: Optional[Dict] = None) -> Tuple:
    """The reference's ``spec_for`` on a mesh of ``mesh_shape`` ({axis:
    size}): per dim a mesh axis name, a tuple of them, or None, trailing
    Nones dropped (the entries of its ``PartitionSpec``)."""
    rules = DEFAULT_RULES if rules is None else rules
    used: set = set()
    entries: List[Any] = []
    for logical, dim in zip(logical_axes, shape):
        axes = _axes_for(logical, dim, mesh_shape, rules, used)
        if axes:
            used.update(axes)
            entries.append(axes if len(axes) > 1 else axes[0])
        else:
            entries.append(None)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def merged_rules(overrides: Optional[Dict] = None) -> Dict:
    """The rule table with a profile's ``overrides`` on top (the
    reference's ``mesh_context(mesh, rules=...)``)."""
    rules = dict(DEFAULT_RULES)
    rules.update(overrides or {})
    return rules


def axis_ways(entry, mesh_shape: Dict[str, int]) -> int:
    """Ranks a dim is cut over: the product of its spec entry's axes."""
    if entry is None:
        return 1
    names = (entry,) if isinstance(entry, str) else entry
    n = 1
    for a in names:
        n *= mesh_shape[a]
    return n


def local_dims(shape: Sequence[int], spec: Sequence, mesh_shape: Dict[str, int]
               ) -> Tuple[int, ...]:
    """``shape`` as one rank holds it under the ``spec_for`` entries
    ``spec`` (trailing dims whole)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(n // axis_ways(e, mesh_shape) for n, e in zip(shape, spec))


def profile_rules(profile: str, cfg, kind: str, mesh_shape: Dict[str, int],
                  global_batch: int = 0) -> Dict:
    """Rule overrides a performance profile makes (the reference's).

    ``baseline``: FSDP everywhere (no override). ``tuned``: params whole
    over the data axes (``embed: ()``) when the resident state a rank
    would hold over the model axis alone is below 8 GB: 8 bytes a param
    training (f32 master and two bf16 moments), 1.2 serving (int4 weights
    and their scales), except a decode whose batch is smaller than the
    data ways (``long_500k``: one token a step, weights stay sharded)."""
    if profile == "baseline":
        return {}
    if profile != "tuned":
        raise ValueError(f"unknown profile {profile!r}: baseline or tuned")
    data_ways = 1
    for a in ("pod", "data"):
        data_ways *= mesh_shape.get(a, 1)
    if kind == "decode" and 0 < global_batch < data_ways:
        return {}
    from repro_torch.models.registry import model_schema, param_count
    n = param_count(model_schema(cfg))
    model_ways = mesh_shape.get("model", 1)
    resident = n * (8.0 if kind == "train" else 1.2) / model_ways
    return {"embed": ()} if resident < 8e9 else {}


Segments = Tuple[Tuple[int, bool], ...]


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a leaf is cut: the dim sharded over ``data`` and the dim
    sharded over ``model`` (None: whole over that axis). ``segments``
    (a segmented model cut, module docstring): the model dim's runs in
    order, each (its whole width, whether it is cut); a rank holds each
    cut run's slice and each uncut run whole, in that order."""
    data_dim: Optional[int] = None
    model_dim: Optional[int] = None
    segments: Optional[Segments] = None

    def local_runs(self, ways: int) -> List[Tuple[int, bool]]:
        """(width a rank holds, cut) of each segment."""
        return [(n // ways if cut else n, cut) for n, cut in self.segments]


REPLICATED = Placement()
# the leaf that stays whole over model whatever the table says
WHOLE_OVER_MODEL = frozenset({"embed/table"})


def _ssd_segments(layer, model_ways: int) -> Dict[str, Segments]:
    """The segmented cuts of an SSD layer's schema (its widths read from
    the leaves: ``gn`` is d_inner wide, ``a_log`` (.., G, H/G),
    ``dt_bias`` H, the conv ``d_inner + 2 G N``)."""
    din, g = layer["gn"].shape[-1], layer["a_log"].shape[-2]
    nh = layer["dt_bias"].shape[-1]
    gn = (layer["conv_b"].shape[-1] - din) // 2
    bc_cut = g % model_ways == 0
    xbc = ((din, True), (gn, bc_cut), (gn, bc_cut))
    return {"w_in": ((din, True),) + xbc + ((nh, True),),
            "conv_w": xbc, "conv_b": xbc}


def train_placements(schema, data_ways: int, model_ways: int,
                     prefix: str = "", segments: Optional[Segments] = None,
                     rules: Optional[Dict] = None):
    """The :class:`Placement` of every leaf of a ParamSpec tree (module
    docstring), under ``rules`` (a profile's table, ``merged_rules``;
    the default table without)."""
    if isinstance(schema, dict):
        segs = (_ssd_segments(schema, model_ways)
                if model_ways > 1 and "w_in" in schema else {})
        return {k: train_placements(v, data_ways, model_ways,
                                    f"{prefix}/{k}" if prefix else k,
                                    segs.get(k), rules)
                for k, v in schema.items()}
    spec = spec_for(schema.axes, schema.shape,
                    {"data": data_ways, "model": model_ways}, rules)
    dims = {ax: i for i, ax in enumerate(spec) if ax is not None}
    if any(not isinstance(ax, str) for ax in dims):
        raise ValueError(f"{prefix}: {spec} cuts a dim over two axes")
    if segments is not None:
        for n, cut in segments:
            if cut and n % model_ways:
                raise ValueError(f"{prefix}: a segment of {n} does not "
                                 f"divide {model_ways} ways")
        return Placement(dims.get("data"), len(schema.shape) - 1, segments)
    model_dim = None if prefix in WHOLE_OVER_MODEL else dims.get("model")
    return Placement(dims.get("data"), model_dim)


class TrainShards:
    """One rank's view of a float train tree sharded by its placements
    (a tree of :class:`Placement` of the same structure as the trees
    given): its coordinates and the groups of its data column, its model
    row and the world."""

    def __init__(self, placements, coords: MeshCoords, data_group=None,
                 model_group=None):
        self.placements = placements
        self.coords = coords
        self.data_group = data_group
        self.model_group = model_group

    def _leaves(self, tree, placements=None):
        return flatten(tree), flatten(placements or self.placements)

    def cut(self, t: torch.Tensor, pl: Placement) -> torch.Tensor:
        """This rank's slice of a whole leaf ``t`` placed ``pl``."""
        c = self.coords
        if pl.data_dim is not None:
            t = slice_for_rank(t, pl.data_dim, c.data_rank, c.data_ways)
        if pl.segments is not None:
            runs = t.split([n for n, _ in pl.segments], pl.model_dim)
            t = torch.cat([slice_for_rank(r, pl.model_dim, c.model_rank,
                                          c.model_ways) if cut else r
                           for r, (_, cut) in zip(runs, pl.segments)],
                          pl.model_dim)
        elif pl.model_dim is not None:
            t = slice_for_rank(t, pl.model_dim, c.model_rank, c.model_ways)
        return t

    def join_model(self, pieces: List[torch.Tensor], pl: Placement
                   ) -> torch.Tensor:
        """The leaf whole over model from the model ranks' pieces in
        model-rank order (inverse of :meth:`cut` along model)."""
        if pl.model_dim is None:
            return pieces[0]
        if pl.segments is None:
            return torch.cat(pieces, pl.model_dim)
        widths = [n for n, _ in pl.local_runs(self.coords.model_ways)]
        runs = [p.split(widths, pl.model_dim) for p in pieces]
        return torch.cat([
            torch.cat([r[i] for r in runs], pl.model_dim) if cut
            else runs[0][i] for i, (_, cut) in enumerate(pl.segments)],
            pl.model_dim)

    def runs(self, pl: Placement, cut: bool) -> List[Tuple[int, int]]:
        """(offset, width) along the model dim of the runs of a segmented
        piece that are cut (``cut``) or whole over model; none for a
        leaf cut otherwise."""
        if pl.segments is None:
            return []
        out, lo = [], 0
        for n, c in pl.local_runs(self.coords.model_ways):
            if c == cut:
                out.append((lo, n))
            lo += n
        return out

    def local(self, tree, placements=None):
        """This rank's slice of every leaf of a whole tree, in storage of
        its own (an in-place update of it leaves ``tree`` as it was)."""
        leaves, pls = self._leaves(tree, placements)
        return unflatten(tree, [self.cut(t, pl).clone()
                                for t, pl in zip(leaves, pls)])

    def counts_norm(self, pl: Placement):
        """Whether this rank adds the leaf's piece into a sum over the
        world (a global norm): every piece once, a replica at coordinate
        0 of the axis it is whole over. A segmented piece off model rank
        0 counts only its cut runs: (the model dim, [(offset, width)])."""
        c = self.coords
        if not ((pl.data_dim is not None or c.data_rank == 0)
                and (pl.model_dim is not None or c.model_rank == 0)):
            return False
        if pl.segments is None or c.model_rank == 0:
            return True
        return pl.model_dim, self.runs(pl, cut=True)

    def gather_data(self, t: torch.Tensor, pl: Placement) -> torch.Tensor:
        """A leaf whole over data (its model slice), from this rank's."""
        if pl.data_dim is None or self.coords.data_ways == 1:
            return t
        parts = [torch.empty_like(t) for _ in range(self.coords.data_ways)]
        dist.all_gather(parts, t.contiguous(), group=self.data_group)
        return torch.cat(parts, pl.data_dim)

    def gather_root(self, tree, placements=None, device="cpu"):
        """The whole tree on world rank 0 (on ``device``), None elsewhere;
        every rank calls it. A leaf at a time, rank r's piece at (r //
        model, r % model): under gloo gathered onto rank 0 through host
        memory (the card holds no more than the piece), else all-gathered
        over the world on the device."""
        c = self.coords
        world = c.data_ways * c.model_ways
        root = dist.get_rank() == 0
        host = dist.get_backend() == "gloo"
        leaves, pls = self._leaves(tree, placements)
        out = []
        for t, pl in zip(leaves, pls):
            piece = t.detach().to("cpu" if host else t.device).contiguous()
            parts = ([torch.empty_like(piece) for _ in range(world)]
                     if root or not host else None)
            if host:
                dist.gather(piece, parts, dst=0)
            else:
                dist.all_gather(parts, piece)
            if not root:
                continue
            parts = [p.to(device) for p in parts]
            rows = [self.join_model(
                parts[d * c.model_ways:(d + 1) * c.model_ways], pl)
                for d in range(c.data_ways)]
            out.append(rows[0] if pl.data_dim is None
                       else torch.cat(rows, pl.data_dim))
            del parts, rows
        return unflatten(tree, out) if root else None

    def init_params(self, schema, seed: int, device):
        """This rank's slice of ``models.schema.init_params(schema, seed,
        device)``: every leaf drawn whole from the one generator in its
        order (so the bits are the one-device init's), cut, and the rest
        freed before the next draw."""
        from repro_torch.models.schema import (_init_leaf, _map_schema,
                                               _sorted_paths)
        gen = torch.Generator(device=device).manual_seed(seed)
        specs: Dict[str, Any] = {}
        _map_schema(schema, lambda p, s: specs.__setitem__(p, s))
        pls = dict(zip(leaf_paths(self.placements),
                       flatten(self.placements)))
        leaves = {}
        for path in _sorted_paths(schema):
            whole = _init_leaf(gen, specs[path], device)
            leaves[path] = self.cut(whole, pls[path]).clone()
            del whole
        return _map_schema(schema, lambda p, s: leaves[p])
