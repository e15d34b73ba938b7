"""Device-side KV tier transitions: KV4 <-> KV2 page re-codecs (torch
twin of ``repro.serving.tiering``).

``serving/kv_pool.py`` owns the host policy of the precision ladder;
this module moves one page between the packed-int4 slab (``k_q``/``v_q``,
two nibbles per byte) and the packed-int2 slab (``k2_q``/``v2_q``, four
two-bit fields per byte, present only when ``PoolConfig.kv2_pages > 0``),
in every layer.

**Demotion** (KV4 -> KV2) clamps each signed int4 nibble to the signed
int2 band ``[KV2_LOW, KV2_HIGH] = [-2, 1]`` and repacks four per byte
(``core.packing.pack_plane(width=2)``); the f32 scales are copied. An
in-band nibble survives exactly; an out-of-band one lands on the nearest
band edge (integer error at most 6). **Promotion** (KV2 -> KV4)
sign-extends each field back to a nibble: always exact.

The JAX package jits both with traced ``src``/``dst``, one compile
serving every page. Here both take the page ids as 0-d int32 device
tensors (or host ints) and index the page dimension with
``index_select``/``index_copy_``, static shapes whatever the page, so
:class:`PageRecodecs` runs each as a compiled step (``launch/graphs.py``)
bound to the pool's state: one CUDA graph serves every page, the ids
copied into its static inputs. They write the destination page in
place (the JAX ops return a new state), so no copy of the pool is made.
The vacated source page is left as it is: its id returns to a free list
and is rewritten before it is read again.
"""
from __future__ import annotations

import torch

from repro_torch.core.packing import pack_plane, unpack_plane
from repro_torch.launch.graphs import CompiledStep

# signed int2 band of a cached int4 nibble
KV2_LOW = -2
KV2_HIGH = 1

_PAIRS = (("k_q", "k_s", "k2_q", "k2_s"),
          ("v_q", "v_s", "v2_q", "v2_s"))


def _layer_groups(state):
    """Every per-layer leaf dict (the dicts holding ``k_q``/``v_q``) of
    the nested pool-state tree."""
    if "k_q" in state:
        yield state
        return
    for v in state.values():
        if isinstance(v, dict):
            yield from _layer_groups(v)


def _page_index(page, like: torch.Tensor) -> torch.Tensor:
    """A page id (0-d int tensor on ``like``'s device, or a host int) as
    the (1,) int64 index of a leaf's page dimension."""
    if isinstance(page, torch.Tensor):
        return page.reshape(1).long()
    return torch.tensor([page], dtype=torch.long, device=like.device)


@torch.no_grad()
def demote_page(state, src, dst):
    """Re-encode KV4 page ``src`` into KV2 page ``dst`` in every layer
    (in place; returns ``state``)."""
    for lp in _layer_groups(state):
        s, d = _page_index(src, lp["k_q"]), _page_index(dst, lp["k_q"])
        for q4, s4, q2, s2 in _PAIRS:
            nib = unpack_plane(lp[q4].index_select(1, s), width=4,
                               signed=True)
            lp[q2].index_copy_(1, d, pack_plane(
                nib.clamp(KV2_LOW, KV2_HIGH), width=2))
            lp[s2].index_copy_(1, d, lp[s4].index_select(1, s))
    return state


@torch.no_grad()
def promote_page(state, src, dst):
    """Re-encode KV2 page ``src`` back into KV4 page ``dst`` (exact, in
    place; returns ``state``)."""
    for lp in _layer_groups(state):
        s, d = _page_index(src, lp["k_q"]), _page_index(dst, lp["k_q"])
        for q4, s4, q2, s2 in _PAIRS:
            nib = unpack_plane(lp[q2].index_select(1, s), width=2,
                               signed=True)
            lp[q4].index_copy_(1, d, pack_plane(nib, width=4))
            lp[s4].index_copy_(1, d, lp[s2].index_select(1, s))
    return state


class PageRecodecs:
    """:func:`demote_page` and :func:`promote_page` as compiled steps on
    ``device`` (``mempool``: the engine's graph memory pool, shared with
    its steps), bound to the pool state they are called with: on a card
    each is captured at its second call and replayed for every later
    page. The two ids go into a device buffer that the steps take as
    their inputs."""

    def __init__(self, device, mempool=None):
        self._ids = torch.zeros((2,), dtype=torch.int32, device=device)
        self.demote_step = CompiledStep(demote_page, device, mempool=mempool)
        self.promote_step = CompiledStep(promote_page, device,
                                         mempool=mempool)

    def _run(self, step, state, src: int, dst: int):
        self._ids[0], self._ids[1] = src, dst
        return step(state, self._ids[0], self._ids[1])

    def demote(self, state, src: int, dst: int):
        return self._run(self.demote_step, state, src, dst)

    def promote(self, state, src: int, dst: int):
        return self._run(self.promote_step, state, src, dst)
