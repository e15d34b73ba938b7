"""SPARQLe dual-pass W4A8 matmul with PBM tile skipping.

Replaces the Pallas kernel ``repro/kernels/sparqle_matmul.py``
``sparqle_matmul`` (``_kernel``/``_tile_body``/``_drain``) with the CUDA
kernel in ``csrc/sparqle_matmul.cu``, one launch a call. Bound on the H100
by bytes at the serving shapes (M <= 32 rows): the packed int4 weight
stream (K*N/2 bytes) dominates. So the kernel takes the ``pack_int4``
weight as it is, streams it through a ring of shared-memory stages fed by
TMA (``cp.async`` where a row stride is not a multiple of 16 bytes),
unpacks it in registers into int8 tensor-core operands (``mma.sync``
m16n8k32, the weight as 16 w so no sign extension is spent), skips the
MSB pass of every (TILE_M, TILE_K) tile whose PBM population is 0, reads
the weight once per 64 rows, and splits K (:func:`launch_plan`) until the
grid holds two blocks per SM; split partial sums meet in a workspace that
the last block of each output tile sums and drains. From 64 rows up int8
operations bound it. Ragged M/N/K and unaligned rows are masked in the
kernel, so no operand is padded; K is at most MAX_K.

``msb_skip=True`` is the LSB4-only draft of self-speculative decoding
and replaces the Pallas ``_kernel_draft``: the same CUDA kernel
instantiated without its MSB pass (``sparqle_matmul_draft_launch``),
whose entry takes neither the MSB plane nor the tile populations, so
only the LSB plane and the weight are read.

:func:`sparqle_matmul_packed` replaces the Pallas
``sparqle_matmul_packed`` (``_kernel_packed``, and ``_kernel_packed_draft``
with ``msb_skip``): the activation planes arrive in the wire layout,
(M, pad_k(K)/2) two nibbles per byte, and the kernel instance with
``PACKED`` splits their nibbles while it builds the tensor-core operand;
the rest of the kernel is one source, so the two layouts give equal
accumulators.

The launch plan and the fragment order inside a tile have plain-Python
mirrors here (:func:`launch_plan`, :func:`block_tiles`, :func:`k_order`,
:func:`n_order`, :func:`w_off`, :func:`a_off`), tested on the CPU.

Every entry also takes the expert-batched operands of a routed MoE
projection: planes (E, M, K), populations (E, ceil(M/TILE_M),
ceil(K/TILE_K)), the packed weight (E, K/2, N), scales (E, M, 1) and (E,
1, N). One launch of the entry's ``*_batched`` instance computes every
expert (the expert index joins the grid's rows; each expert reads its own
rows, weight and scales), so a routed projection is one launch, not E.
Their plain versions run the 2-D ones expert by expert
(``ref.batched``). A batched call may pass ``rows``, an (E,) int32
tensor on the operands' device: expert e's rows at and past ``rows[e]``
are taken as zero, whatever the planes hold, and come out as the drain
of a zero accumulator; the kernel's blocks that hold no live row stream
no weight (an expert the MoE dispatch left empty costs no weight bytes).
``rows=None`` takes every row as live. The 2-D entries refuse ``rows``.

A CUDA tensor goes to the kernel (or raises); a CPU tensor goes to the
plain version ``kernels.ref.sparqle_matmul_ref`` /
``sparqle_matmul_packed_ref``.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.packing import pad_k
from repro_torch.kernels import _build
from repro_torch.kernels.ref import (TILE_K, TILE_M, _cdiv, check_rows,
                                     plain_for, sparqle_matmul_packed_ref,
                                     sparqle_matmul_ref)

_ENTRY = [_build.P] * 10 + [_build.I] * 4 + [_build.P]
_DRAFT = [_build.P] * 8 + [_build.I] * 4 + [_build.P]
KERNEL = _build.register(_build.Kernel(
    "sparqle_matmul.cu", "sparqle_matmul_launch", _ENTRY))
DRAFT_KERNEL = _build.register(_build.Kernel(
    "sparqle_matmul.cu", "sparqle_matmul_draft_launch", _DRAFT,
    name="sparqle_matmul_draft"))
PACKED_KERNEL = _build.register(_build.Kernel(
    "sparqle_matmul.cu", "sparqle_matmul_packed_launch",
    _ENTRY[:-1] + [_build.I, _build.P], name="sparqle_matmul_packed"))
PACKED_DRAFT_KERNEL = _build.register(_build.Kernel(
    "sparqle_matmul.cu", "sparqle_matmul_packed_draft_launch",
    _DRAFT[:-1] + [_build.I, _build.P], name="sparqle_matmul_packed_draft"))
# The expert-batched instances: the same entries with E after K and the
# live rows an expert (a pointer or null) after the K tiles a split, one
# launch for every expert (the grid's rows count E x an expert's row
# blocks).
_BENTRY = [_build.P] * 10 + [_build.I] * 5 + [_build.P] * 2
_BDRAFT = [_build.P] * 8 + [_build.I] * 5 + [_build.P] * 2
BATCHED_KERNEL = _build.register(_build.Kernel(
    "sparqle_matmul.cu", "sparqle_matmul_batched_launch", _BENTRY,
    name="sparqle_matmul_batched"))
DRAFT_BATCHED_KERNEL = _build.register(_build.Kernel(
    "sparqle_matmul.cu", "sparqle_matmul_draft_batched_launch", _BDRAFT,
    name="sparqle_matmul_draft_batched"))
PACKED_BATCHED_KERNEL = _build.register(_build.Kernel(
    "sparqle_matmul.cu", "sparqle_matmul_packed_batched_launch",
    _BENTRY[:-2] + [_build.I] + _BENTRY[-2:],
    name="sparqle_matmul_packed_batched"))
PACKED_DRAFT_BATCHED_KERNEL = _build.register(_build.Kernel(
    "sparqle_matmul.cu", "sparqle_matmul_packed_draft_batched_launch",
    _BDRAFT[:-2] + [_build.I] + _BDRAFT[-2:],
    name="sparqle_matmul_packed_draft_batched"))

# csrc/sparqle_matmul.cu's tiling
MT = 4                  # m16 tiles a block: the weight is read once per 64 rows
BLOCK_M = MT * TILE_M   # (a batched call of <= 16 rows an expert runs the
                        # kernel's one-m16-tile instance: the same grid)
BLOCK_N = 64            # output columns a block (2 warps x 32)
TARGET_BLOCKS = 264     # two blocks per SM on the H100's 132 SMs
# The kernel sums 16 x the product in int32 (its weight operand is 16 w):
# |16 acc| <= 16 x K x (15 + 128) x 8 stays below 2^31 up to K = 117,323
# on the planes, and |16 acc| <= K x 128 x 128 up to K = 131,071 on the
# dense wrapper's full-range q.
MAX_K = 65536


class Plan(NamedTuple):
    """One call's grid: ``col_blocks`` x ``row_blocks`` output tiles of
    BLOCK_M x BLOCK_N for each of ``experts`` experts (1 unbatched),
    each K range of ``per`` K tiles a split."""
    col_blocks: int
    row_blocks: int
    n_kt: int
    per: int
    splits: int
    experts: int = 1

    @property
    def tiles(self) -> int:
        return self.col_blocks * self.row_blocks * self.experts

    @property
    def blocks(self) -> int:
        return self.tiles * self.splits

    @property
    def counters(self) -> int:
        """Arrival counters the split meet needs (one an output tile)."""
        return self.tiles if self.splits > 1 else 0

    def workspace(self, m: int, n: int) -> int:
        """int32 elements of the split partials (one (M, N) slice each
        split and expert)."""
        return self.splits * self.experts * m * n if self.splits > 1 else 0


def launch_plan(m: int, n: int, k: int, e: int = 1) -> Plan:
    """Split K until the grid holds TARGET_BLOCKS blocks where K allows:
    the fewest K tiles a split that still reach it, balanced over the
    splits. With the output tiles alone (of all ``e`` experts) at
    TARGET_BLOCKS, one split; so a split plan has fewer than
    TARGET_BLOCKS output tiles, and the counter buffer holds them."""
    n_kt = _cdiv(k, TILE_K)
    cols, rows = _cdiv(n, BLOCK_N), _cdiv(m, BLOCK_M)
    want = max(1, min(n_kt, _cdiv(TARGET_BLOCKS, cols * rows * e)))
    per = max(1, n_kt // want)
    per = _cdiv(n_kt, _cdiv(n_kt, per))
    return Plan(cols, rows, n_kt, per, _cdiv(n_kt, per), e)


def block_tiles(plan: Plan, m: int, n: int, bx: int, by: int,
                bz: int) -> Iterator[Tuple[int, int, int, int]]:
    """(m16 tile, first column, end column, K tile) of each tile that
    block (bx, by, bz) computes, as the kernel derives them."""
    m0, n0, kt_lo = by * BLOCK_M, bx * BLOCK_N, bz * plan.per
    for j in range(_cdiv(min(BLOCK_M, m - m0), TILE_M)):
        for kt in range(kt_lo, min(plan.n_kt, kt_lo + plan.per)):
            yield m0 // TILE_M + j, n0, min(n, n0 + BLOCK_N), kt


def k_order() -> List[int]:
    """Real k inside a 128-wide K tile of the mma's logical k, step s
    (0..3) x 32 + L: lane t's L = 4t + i is the low nibble of packed row
    16s + 2t + (i & 1) + 8(i >> 1) (k = 2 x row), L = 16 + 4t + i the high
    nibble of the same row (k = 2 x row + 1)."""
    return [32 * s + 2 * (2 * (lk % 16 // 4) + lk % 2 + 8 * (lk % 4 // 2))
            + lk // 16 for s in range(4) for lk in range(32)]


def n_order() -> List[int]:
    """Real column inside a warp's 32 of the weight operand's m16 tile u,
    row R, at index 16u + R: 16u + 2(R % 8) + R // 8 (so lane (g, t)
    holds columns 16u + 2g and 16u + 2g + 1)."""
    return [16 * u + 2 * (rr % 8) + rr // 8 for u in range(2)
            for rr in range(16)]


# the shared-memory swizzles (byte offsets inside one stage's tile)
def w_off(r: int, c: int) -> int:
    """64-byte rows (packed weight row r, byte column c of the block's
    64; the wire-layout planes): chunk XOR bits 1-2 of the row."""
    return r * 64 + (((c >> 4) ^ ((r >> 1) & 3)) << 4) + (c & 15)


def a_off(r: int, c: int) -> int:
    """128-byte rows (unpacked planes): chunk XOR the row's low 3 bits."""
    return r * 128 + (((c >> 4) ^ (r & 7)) << 4) + (c & 15)


_COUNTERS: Dict[torch.device, torch.Tensor] = {}


def _counters(dev: torch.device) -> torch.Tensor:
    """The device's arrival counters, zeroed once and left zeroed by
    every launch. Allocated at the first call on the device, so that a
    CUDA graph captured later replays against this buffer."""
    buf = _COUNTERS.get(dev)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "call the matmul once on this device before capturing it "
                "into a CUDA graph: the first, eager call of a compiled "
                "step (the warm-up of launch/graphs.py) allocates these "
                "counters")
        buf = torch.zeros(TARGET_BLOCKS, dtype=torch.int32, device=dev)
        _COUNTERS[dev] = buf
    return buf


def _result(lsb4, w_packed, m, acc_out: bool) -> torch.Tensor:
    """The (lead..., M, N) output: int32 ``acc`` or the f32 drain."""
    return torch.empty(tuple(w_packed.shape[:-2]) + (m, w_packed.shape[-1]),
                       dtype=torch.int32 if acc_out else torch.float32,
                       device=lsb4.device)


def _matmul_fake(lsb4: torch.Tensor, msb4: Optional[torch.Tensor],
                 tile_pop: Optional[torch.Tensor], w_packed: torch.Tensor,
                 act_scale: torch.Tensor, w_scale: torch.Tensor,
                 acc_out: bool, msb_skip: bool,
                 rows: Optional[torch.Tensor]) -> torch.Tensor:
    return _result(lsb4, w_packed, lsb4.shape[-2], acc_out)


def _plain_op(ref):
    """A matmul entry's plain version in the op's calling convention."""
    def cpu(lsb4: torch.Tensor, msb4: Optional[torch.Tensor],
            tile_pop: Optional[torch.Tensor], w_packed: torch.Tensor,
            act_scale: torch.Tensor, w_scale: torch.Tensor, acc_out: bool,
            msb_skip: bool, rows: Optional[torch.Tensor]) -> torch.Tensor:
        return plain_for(ref, w_packed.ndim == 3, rows, acts=2)(
            lsb4, msb4, tile_pop, w_packed, act_scale, w_scale,
            acc_out=acc_out, msb_skip=msb_skip)
    return cpu


@_build.kernel_op("sparqle_matmul", _matmul_fake,
                  _plain_op(sparqle_matmul_ref))
def MATMUL_OP(lsb4: torch.Tensor, msb4: Optional[torch.Tensor],
              tile_pop: Optional[torch.Tensor], w_packed: torch.Tensor,
              act_scale: torch.Tensor, w_scale: torch.Tensor,
              acc_out: bool, msb_skip: bool,
              rows: Optional[torch.Tensor]) -> torch.Tensor:
    """The unpacked entry (its draft with ``msb_skip``): operands checked
    by the wrapper."""
    m = lsb4.shape[-2]
    res, tail = _launch_args(lsb4, w_packed, act_scale, w_scale, m,
                             acc_out, rows)
    if tail is not None:
        one = w_packed.ndim == 2
        if msb_skip:
            (DRAFT_KERNEL if one else DRAFT_BATCHED_KERNEL).launch(
                lsb4.data_ptr(), w_packed.data_ptr(), *tail)
        else:
            (KERNEL if one else BATCHED_KERNEL).launch(
                lsb4.data_ptr(), msb4.data_ptr(), tile_pop.data_ptr(),
                w_packed.data_ptr(), *tail)
    return res


@_build.kernel_op("sparqle_matmul_packed", _matmul_fake,
                  _plain_op(sparqle_matmul_packed_ref))
def PACKED_OP(lsb4: torch.Tensor, msb4: Optional[torch.Tensor],
              tile_pop: Optional[torch.Tensor], w_packed: torch.Tensor,
              act_scale: torch.Tensor, w_scale: torch.Tensor,
              acc_out: bool, msb_skip: bool,
              rows: Optional[torch.Tensor]) -> torch.Tensor:
    """The wire-layout entry (its draft with ``msb_skip``)."""
    m = lsb4.shape[-2]
    ldp = pad_k(2 * w_packed.shape[-2]) // 2
    res, tail = _launch_args(lsb4, w_packed, act_scale, w_scale, m,
                             acc_out, rows, ldp=ldp)
    if tail is not None:
        one = w_packed.ndim == 2
        if msb_skip:
            (PACKED_DRAFT_KERNEL if one else PACKED_DRAFT_BATCHED_KERNEL
             ).launch(lsb4.data_ptr(), w_packed.data_ptr(), *tail)
        else:
            (PACKED_KERNEL if one else PACKED_BATCHED_KERNEL).launch(
                lsb4.data_ptr(), msb4.data_ptr(), tile_pop.data_ptr(),
                w_packed.data_ptr(), *tail)
    return res


def sparqle_matmul(
    lsb4: torch.Tensor,                 # (M, K) int8 in [0, 15]
    msb4: Optional[torch.Tensor],       # (M, K) int8 in [-8, 7]
    tile_pop: Optional[torch.Tensor],   # (ceil(M/TILE_M), ceil(K/TILE_K)) int32
    w_packed: torch.Tensor,             # (K/2, N) int8, int4 packed along K
    act_scale: torch.Tensor,            # (M, 1) f32
    w_scale: torch.Tensor,              # (1, N) f32
    *,
    acc_out: bool = False,
    msb_skip: bool = False,
    rows: Optional[torch.Tensor] = None,   # (E,) int32, batched only
) -> torch.Tensor:
    """(M, N) f32 ``acc * act_scale * w_scale``, or the int32 ``acc``.
    With ``msb_skip`` acc is the LSB pass alone and ``msb4``/``tile_pop``
    may be None (they are not read). ``rows``: the live rows of each
    expert of a batched call (module docstring)."""
    _check_rows(rows, w_packed, lsb4)
    if not _build.on_card(lsb4):
        return plain_for(sparqle_matmul_ref, w_packed.ndim == 3, rows,
                         acts=2)(
            lsb4, msb4, tile_pop, w_packed, act_scale, w_scale,
            acc_out=acc_out, msb_skip=msb_skip)
    m, k = lsb4.shape[-2:]
    k2, n = w_packed.shape[-2:]
    if k != 2 * k2:
        raise ValueError(f"K mismatch: planes {tuple(lsb4.shape)}, packed "
                         f"weight {tuple(w_packed.shape)}")
    _operands(lsb4, msb4, tile_pop, w_packed, act_scale, w_scale, (m, k),
              msb_skip=msb_skip)
    return MATMUL_OP(lsb4, None if msb_skip else msb4,
                     None if msb_skip else tile_pop, w_packed, act_scale,
                     w_scale, acc_out, msb_skip, rows)


def sparqle_matmul_packed(
    lsb4_packed: torch.Tensor,             # (M, pad_k(K)/2) int8
    msb4_packed: Optional[torch.Tensor],   # (M, pad_k(K)/2) int8
    tile_pop: Optional[torch.Tensor],      # (ceil(M/TILE_M), ceil(K/TILE_K))
    w_packed: torch.Tensor,                # (K/2, N) int8, int4 along K
    act_scale: torch.Tensor,               # (M, 1) f32
    w_scale: torch.Tensor,                 # (1, N) f32
    *,
    acc_out: bool = False,
    msb_skip: bool = False,
    rows: Optional[torch.Tensor] = None,   # (E,) int32, batched only
) -> torch.Tensor:
    """:func:`sparqle_matmul` on wire-layout planes (two nibbles per byte,
    K padded to a multiple of 32; K is the weight's). With ``msb_skip``
    the LSB4-only draft: ``msb4_packed``/``tile_pop`` may be None."""
    _check_rows(rows, w_packed, lsb4_packed)
    if not _build.on_card(lsb4_packed):
        return plain_for(sparqle_matmul_packed_ref,
                         w_packed.ndim == 3, rows, acts=2)(
            lsb4_packed, msb4_packed, tile_pop, w_packed, act_scale,
            w_scale, acc_out=acc_out, msb_skip=msb_skip)
    m = lsb4_packed.shape[-2]
    ldp = pad_k(2 * w_packed.shape[-2]) // 2
    _operands(lsb4_packed, msb4_packed, tile_pop, w_packed, act_scale,
              w_scale, (m, ldp), msb_skip=msb_skip)
    return PACKED_OP(lsb4_packed, None if msb_skip else msb4_packed,
                     None if msb_skip else tile_pop, w_packed, act_scale,
                     w_scale, acc_out, msb_skip, rows)


def _operands(lsb4, msb4, tile_pop, w_packed, act_scale, w_scale,
              plane_shape, *, msb_skip: bool, plane: str = "lsb4") -> None:
    """Raise unless the operands are what the kernels take (planes of
    ``plane_shape``; ``plane`` names the first in errors: the dense
    wrapper passes its q there). A weight (E, K/2, N) makes it the
    expert-batched form: every operand then carries the leading E
    axis."""
    if w_packed.ndim not in (2, 3):
        raise ValueError(f"w_packed must be (K/2, N) or (E, K/2, N), got "
                         f"{tuple(w_packed.shape)}")
    lead = tuple(w_packed.shape[:-2])
    m = plane_shape[0]
    k2, n = w_packed.shape[-2:]
    k = 2 * k2
    dev = lsb4.device
    operands = [(plane, lsb4, lead + plane_shape, torch.int8),
                ("w_packed", w_packed, lead + (k2, n), torch.int8),
                ("act_scale", act_scale, lead + (m, 1), torch.float32),
                ("w_scale", w_scale, lead + (1, n), torch.float32)]
    if not msb_skip:
        operands += [("msb4", msb4, lead + plane_shape, torch.int8),
                     ("tile_pop", tile_pop,
                      lead + (_cdiv(m, TILE_M), _cdiv(k, TILE_K)),
                      torch.int32)]
    if k > MAX_K:
        raise ValueError(f"K={k} > {MAX_K}: the kernel's int32 accumulator "
                         f"holds 16 x the sum")
    for name, t, shape, dt in operands:
        if t is None:
            raise ValueError(f"{name} is required unless msb_skip")
        if tuple(t.shape) != shape or t.dtype != dt or t.device != dev:
            raise ValueError(f"{name}: expected {dt} {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_rows(rows: Optional[torch.Tensor], w_packed: torch.Tensor,
                plane: torch.Tensor) -> None:
    """``ref.check_rows`` for a call whose weight (E, K/2, N) makes it
    batched."""
    check_rows(rows, w_packed.shape[0] if w_packed.ndim == 3 else None,
               plane.device)


def _launch_args(lsb4, w_packed, act_scale, w_scale, m: int,
                 acc_out: bool, rows: Optional[torch.Tensor] = None,
                 ldp: Optional[int] = None):
    """The result tensor and the entry's arguments after the weight
    pointer (None when there is nothing to launch): (..., M, N, K,
    [E,] [ldp,] K tiles a split[, rows]); a batched entry takes the rows
    pointer (null for all rows), a packed one its plane stride ``ldp``."""
    lead = tuple(w_packed.shape[:-2])
    e = lead[0] if lead else 1
    k2, n = w_packed.shape[-2:]
    k = 2 * k2
    dev = lsb4.device
    res = _result(lsb4, w_packed, m, acc_out)
    counters = _counters(dev)
    if not (m and n and k and e):
        return res, None
    plan = launch_plan(m, n, k, e)
    if plan.counters > counters.numel():
        raise RuntimeError(f"{plan} needs {plan.counters} arrival counters, "
                           f"the device has {counters.numel()}")
    ws = (torch.empty(plan.workspace(m, n), dtype=torch.int32, device=dev)
          if plan.splits > 1 else None)
    tail = (act_scale.data_ptr(), w_scale.data_ptr(),
            None if acc_out else res.data_ptr(),
            res.data_ptr() if acc_out else None,
            None if ws is None else ws.data_ptr(), counters.data_ptr(),
            m, n, k, *lead, *(() if ldp is None else (ldp,)), plan.per)
    if lead:
        tail += (None if rows is None else rows.data_ptr(),)
    return res, tail
