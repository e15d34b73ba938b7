"""How the paged pool state shards over a ``("data", "model")`` mesh: the
serving part of ``repro.distributed.sharding``'s logical-axis rule table
(``spec_for`` with ``pages -> data`` and ``kv_heads -> model``).

A pool leaf is declared with logical axes (``serving/kv_pool.py``
``pool_schema``: ``("layers", "pages", None, "kv_heads", None)``). A rank
at mesh coordinates (data rank, model rank) holds the contiguous slice
of each dim whose logical axis the table maps onto a mesh axis: its data
shard's pages and its model shard's KV heads. A dim the mesh axis does
not divide raises (the reference leaves it replicated; the serving path
validates before it gets here, and a silent replication would break the
shard-local page ids).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import torch

from repro_torch.distributed.tp import slice_for_rank

RULES: Dict[str, str] = {"pages": "data", "kv_heads": "model"}


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
