"""The ``("data", "model")`` process mesh of tensor-parallel serving
(torch twin of ``repro.launch.mesh.make_smoke_mesh``), and the worlds of
processes it spans.

JAX runs one program over every device of a mesh; here each rank is a
process. :func:`spawn_world` starts ``world`` processes with
``torch.multiprocessing`` (spawn), each joining one process group
through a ``FileStore`` rendezvous under a temporary directory (no TCP
port), with a timeout, so that a rank stuck in a collective fails
instead of hanging. Each rank then builds the mesh with
:func:`make_mesh`: rank r sits at (data r // model, model r % model);
the model groups are the mesh's rows, the data groups its columns, each
created with the backend asked for (checked, never another).

Backends. NCCL takes one card a rank. On one card several ranks share
it, which NCCL refuses: their collectives then run over gloo on the CUDA
tensors (a host round trip each), and gloo collectives cannot be
captured in a CUDA graph, so the engine runs its steps eagerly there and
says so (``Engine.step_mode``). :func:`pick_backend` never switches
backend on its own: asking for more ranks than cards without naming
gloo raises.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.distributed.sharding import MeshCoords
from repro_torch.distributed.tp import TPContext

AXES = ("data", "model")
# a collective that waits longer than this fails the world
DEFAULT_TIMEOUT_S = 300.0


def pick_backend(device: torch.device, ranks: int,
                 backend: Optional[str] = None) -> str:
    """The process-group backend for ``ranks`` ranks on ``device``:
    ``backend`` if given (checked), else NCCL on CUDA and gloo on the
    CPU. NCCL needs a card a rank: with fewer cards it raises and names
    ``--dist-backend gloo`` rather than switching."""
    if device.type != "cuda":
        if backend not in (None, "gloo"):
            raise ValueError(f"backend {backend!r} on {device.type}: the "
                             f"CPU runs gloo")
        return "gloo"
    backend = backend or "nccl"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}: nccl or gloo")
    have = torch.cuda.device_count()
    if backend == "nccl" and have < ranks:
        raise RuntimeError(
            f"a mesh of {ranks} ranks needs {ranks} cards under NCCL, this "
            f"machine has {have}; pass --dist-backend gloo (dist_backend="
            f"'gloo') to share the cards, with the steps run eagerly")
    return backend


def make_mesh(data: int = 1, model: int = 1, device_type: str = "cpu"):
    """A ``DeviceMesh`` of shape (data, model) named ("data", "model")
    over the initialised world (of data * model ranks), whose groups use
    the world's backend (checked)."""
    from torch.distributed.device_mesh import DeviceMesh
    world = dist.get_world_size()
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} over a world of {world}")
    backend = dist.get_backend()
    grid = torch.arange(world).reshape(data, model)
    rank = dist.get_rank()
    # every rank creates every group, in one order
    model_groups = [dist.new_group(grid[d].tolist(), backend=backend)
                    for d in range(data)]
    data_groups = [dist.new_group(grid[:, m].tolist(), backend=backend)
                   for m in range(model)]
    mine = (data_groups[rank % model], model_groups[rank // model])
    for name, g in zip(AXES, mine):
        got = dist.get_backend(g)
        if got != backend:
            raise RuntimeError(f"the {name} group runs {got}, not {backend}")
    return DeviceMesh.from_group(list(mine), device_type, mesh=grid,
                                 mesh_dim_names=AXES)


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """This rank's view of a ("data", "model") mesh."""
    coords: MeshCoords
    data_group: Any
    model_group: Any
    backend: str

    @property
    def data_ways(self) -> int:
        return self.coords.data_ways

    @property
    def model_ways(self) -> int:
        return self.coords.model_ways

    def context(self, local_rows: Optional[int] = None) -> TPContext:
        """The step context: the model group always; the data group too
        when the step's batch is sharded (``local_rows`` rows a rank)."""
        batch = local_rows is not None and self.data_ways > 1
        return TPContext(
            ways=self.model_ways, group=self.model_group,
            batch_group=self.data_group if batch else None,
            batch_ways=self.data_ways if batch else 1,
            batch_rank=self.coords.data_rank if batch else 0,
            local_rows=local_rows or 0)


def mesh_layout(mesh) -> MeshLayout:
    d_group, m_group = mesh.get_group("data"), mesh.get_group("model")
    return MeshLayout(
        MeshCoords(data_rank=mesh.get_local_rank("data"),
                   data_ways=mesh.size(AXES.index("data")),
                   model_rank=mesh.get_local_rank("model"),
                   model_ways=mesh.size(AXES.index("model"))),
        d_group, m_group, dist.get_backend(m_group))


# ---------------------------------------------------------------------------
# worlds of processes
# ---------------------------------------------------------------------------

def _rank_main(fn, rank: int, world: int, store: str, backend: str,
               device_type: str, timeout_s: float, results, args) -> None:
    try:
        if device_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        else:   # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        dist.init_process_group(
            backend, store=dist.FileStore(store, world), rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn_world(fn: Callable, world: int, *args, backend: str = "gloo",
                device_type: str = "cpu",
                timeout_s: float = DEFAULT_TIMEOUT_S,
                deadline_s: Optional[float] = None,
                store_dir: Optional[str] = None) -> List[Any]:
    """Run ``fn(rank, *args)`` in ``world`` spawned processes joined in
    one process group; returns their results in rank order. On
    ``device_type`` 'cuda' rank r's current card is r modulo the cards
    (all share card 0 on a one-card machine); on the CPU each rank takes
    its share of the cores. Tensors in
    ``args`` reach the ranks through ``torch.multiprocessing`` (shared
    memory; CUDA IPC for a card's tensors, which the caller keeps alive
    until this returns). The rendezvous file lives in a new temporary
    directory (under ``store_dir`` if given). A collective that waits
    ``timeout_s`` fails its rank; ``deadline_s`` (None: none) bounds the
    whole world. Raises with the first failing rank's traceback, when a
    rank dies without a result, or at the deadline; every process is
    ended before it returns."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="repro_torch_world_",
                                     dir=store_dir) as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world, store, backend,
                                   device_type, timeout_s, results, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        got: dict = {}
        deadline = (None if deadline_s is None
                    else time.monotonic() + deadline_s)
        try:
            while len(got) < world:
                try:
                    rank, ok, out = results.get(timeout=1.0)
                except queue_mod.Empty:
                    late = deadline is not None and time.monotonic() > deadline
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode is not None and r not in got]
                    if late or dead:
                        raise RuntimeError(
                            f"world of {world}: ranks "
                            f"{sorted(set(range(world)) - set(got))} gave no "
                            f"result (exit codes "
                            f"{[p.exitcode for p in procs]})")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world} failed:\n"
                                       f"{out}")
                got[rank] = out
            for p in procs:
                p.join(timeout_s)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
    return [got[r] for r in range(world)]
