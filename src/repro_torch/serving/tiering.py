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
sign-extends each field back to a nibble: always exact. The JAX package
runs these as jitted jnp ops returning a new state; here they are plain
torch ops that write the destination page in place, so no copy of the
pool is made. The vacated source page is left as it is: its id returns
to a free list and is rewritten before it is read again.
"""
from __future__ import annotations

import torch

from repro_torch.core.packing import pack_plane, unpack_plane

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


@torch.no_grad()
def demote_page(state, src: int, dst: int):
    """Re-encode KV4 page ``src`` into KV2 page ``dst`` in every layer
    (in place; returns ``state``)."""
    for lp in _layer_groups(state):
        for q4, s4, q2, s2 in _PAIRS:
            nib = unpack_plane(lp[q4][:, src], width=4, signed=True)
            lp[q2][:, dst] = pack_plane(nib.clamp(KV2_LOW, KV2_HIGH),
                                        width=2)
            lp[s2][:, dst] = lp[s4][:, src]
    return state


@torch.no_grad()
def promote_page(state, src: int, dst: int):
    """Re-encode KV2 page ``src`` back into KV4 page ``dst`` (exact, in
    place; returns ``state``)."""
    for lp in _layer_groups(state):
        for q4, s4, q2, s2 in _PAIRS:
            nib = unpack_plane(lp[q2][:, src], width=2, signed=True)
            lp[q4][:, dst] = pack_plane(nib, width=4)
            lp[s4][:, dst] = lp[s2][:, src]
    return state
