"""Checkpoints as npz shards + a manifest, in the JAX package's format
(torch twin of ``repro.checkpoint.store``)::

    <dir>/step_000123/
        manifest.json      # step, leaf shapes/dtypes, shards, status
        shard_<i>.npz      # leaf_<i> arrays, ~512 MB a shard

A checkpoint counts once its manifest says ``"status": "complete"``
(written last; the directory is published by one rename). Leaves are
stored in JAX's flatten order of the tree: dict keys sorted, a
NamedTuple's fields (a ``TrainState``, an ``OptState``) in field order,
depth first. So the JAX package restores what :func:`save` writes and
:func:`restore` reads what JAX's ``store.save`` wrote; a tree's layout
comes from the ``like`` tree the caller passes, never from the
manifest's ``treedef`` string (which :func:`save` writes for JAX's
readers of the manifest and nothing here parses).

A mesh run's checkpoint is the same whole tree: :func:`save_sharded`
gathers a sharded state onto rank 0, which writes it while the others
wait at a barrier, and :func:`restore_sharded` reads it on every rank and
cuts each rank's slice, so a checkpoint restores at any mesh shape (the
mesh object is ``launch/steps.TrainMesh``).

bf16 leaves are stored as their uint16 bit patterns (npz has no bf16)
and come back through an int16 view into ``torch.bfloat16``, so neither
side needs ``ml_dtypes``. :class:`AsyncWriter` writes from a background
thread (a one-deep pipeline: the train loop blocks only on the previous
write) and :func:`prune` keeps the newest few checkpoints.
"""
from __future__ import annotations

import json
import os
import queue
import re
import shutil
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def flatten(tree: Any) -> List[Any]:
    """Leaves in JAX's flatten order: dict keys sorted, NamedTuple fields
    in field order, depth first."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in flatten(tree[k])]
    if _is_namedtuple(tree):
        return [leaf for child in tree for leaf in flatten(child)]
    return [tree]


def leaf_paths(tree: Dict[str, Any], prefix: str = "") -> List[str]:
    """'a/b/c' paths of a nested dict's leaves, in :func:`flatten`'s
    order."""
    out: List[str] = []
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else k
        out += (leaf_paths(tree[k], path) if isinstance(tree[k], dict)
                else [path])
    return out


def unflatten(like: Any, leaves: List[Any]) -> Any:
    """``like``'s structure filled with ``leaves`` (JAX's order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if _is_namedtuple(node):
            return type(node)(*[build(child) for child in node])
        return next(it)
    return build(like)


def _encode(t: torch.Tensor) -> tuple:
    """(numpy array npz can hold, the manifest's dtype name)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, a.dtype.name


def _decode(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, dtype=np.dtype(dtype_name)))


def to_host(tree: Any) -> Any:
    """``tree`` with each tensor leaf as (numpy array, dtype name), the
    bytes a checkpoint stores: picklable to another process, which
    :func:`from_host` turns back into CPU tensors bit for bit."""
    return unflatten(tree, [_encode(t) for t in flatten(tree)])


def from_host(tree: Any) -> Any:
    return unflatten(tree, [_decode(*leaf) for leaf in flatten(tree)])


def save(path: str, tree: Any, step: int,
         shard_bytes: int = 512 * 2**20) -> str:
    """Write ``tree`` (nested dicts and NamedTuples of tensors) as
    checkpoint ``step`` under ``path``; returns the checkpoint
    directory."""
    ckdir = os.path.join(path, f"step_{step:09d}")
    tmp = ckdir + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves = [_encode(t) for t in flatten(tree)]
    manifest: Dict[str, Any] = {
        "step": step,
        "treedef": f"sorted-key nested dicts and NamedTuples, "
                   f"{len(leaves)} leaves",
        "n_leaves": len(leaves),
        "leaves": [{"shape": list(a.shape), "dtype": name}
                   for a, name in leaves],
        "shards": [],
        "status": "writing",
    }
    shard: Dict[str, np.ndarray] = {}
    size = 0

    def flush():
        nonlocal shard, size
        if shard:
            name = f"shard_{len(manifest['shards'])}.npz"
            np.savez(os.path.join(tmp, name), **shard)
            manifest["shards"].append({"file": name, "keys": sorted(shard)})
            shard, size = {}, 0

    for i, (a, _) in enumerate(leaves):
        shard[f"leaf_{i}"] = a
        size += a.nbytes
        if size >= shard_bytes:
            flush()
    flush()
    manifest["status"] = "complete"
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(ckdir):
        shutil.rmtree(ckdir)
    os.rename(tmp, ckdir)
    return ckdir


def latest_step(path: str) -> Optional[int]:
    """Largest step with a complete manifest, or None."""
    if not os.path.isdir(path):
        return None
    best = None
    for name in os.listdir(path):
        m = re.fullmatch(r"step_(\d+)", name)
        if not m:
            continue
        try:
            with open(os.path.join(path, name, "manifest.json")) as f:
                if json.load(f).get("status") != "complete":
                    continue
        except (OSError, json.JSONDecodeError):
            continue
        best = max(int(m.group(1)), best if best is not None else -1)
    return best


def restore(path: str, step: int, like: Any) -> Any:
    """Checkpoint ``step`` as ``like``'s structure: CPU tensors of each
    ``like`` leaf's dtype (any object with ``shape`` and ``dtype``: a
    tensor, a meta tensor). Raises unless the leaf count and every
    shape match the manifest."""
    ckdir = os.path.join(path, f"step_{step:09d}")
    with open(os.path.join(ckdir, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest["status"] != "complete":
        raise ValueError(f"{ckdir}: incomplete checkpoint")
    refs = flatten(like)
    if len(refs) != manifest["n_leaves"]:
        raise ValueError(f"{ckdir}: {manifest['n_leaves']} leaves, the "
                         f"tree has {len(refs)}")
    arrays: Dict[str, np.ndarray] = {}
    for sh in manifest["shards"]:
        with np.load(os.path.join(ckdir, sh["file"])) as z:
            for k in sh["keys"]:
                arrays[k] = z[k]
    out = []
    for i, (ref, meta) in enumerate(zip(refs, manifest["leaves"])):
        t = _decode(arrays[f"leaf_{i}"], meta["dtype"])
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"{ckdir}: leaf {i} has shape "
                             f"{tuple(t.shape)}, the tree "
                             f"{tuple(ref.shape)}")
        out.append(t.to(ref.dtype))
    return unflatten(like, out)


def save_sharded(path: str, state: Any, step: int, mesh,
                 writer: Optional["AsyncWriter"] = None) -> None:
    """Checkpoint ``step`` of a sharded ``state``: the whole tree gathered
    onto rank 0 and written there (through ``writer`` if given: only the
    write is asynchronous), then a barrier. Every rank calls it."""
    whole = mesh.gather(state)
    if whole is not None:
        if writer is not None:
            writer.submit(whole, step)
        else:
            save(path, whole, step)
    mesh.barrier()


def restore_sharded(path: str, step: int, like: Any, mesh) -> Any:
    """Checkpoint ``step`` (any mesh's, or a one-device save) cut to this
    rank's slices of ``like``'s leaves, on their devices."""
    return mesh.local(restore(path, step, mesh.whole_like(like)), like)


def prune(path: str, keep: int = 3) -> None:
    """Delete all but the newest ``keep`` checkpoints (all with 0)."""
    if not os.path.isdir(path):
        return
    steps = sorted(
        int(m.group(1)) for m in
        (re.fullmatch(r"step_(\d+)", n) for n in os.listdir(path)) if m)
    for s in steps[:-keep] if keep else steps:
        shutil.rmtree(os.path.join(path, f"step_{s:09d}"), ignore_errors=True)


def place_like(tree: Any, like: Any) -> Any:
    """``tree``'s leaves moved to the devices of ``like``'s (a restored
    state onto the devices of the state it replaces)."""
    return unflatten(like, [t.to(ref.device) for t, ref in zip(
        flatten(tree), flatten(like))])


class AsyncWriter:
    """Background checkpoint writer: the step loop blocks only to bound
    the pipeline at one write in flight. ``submit`` copies the tree to
    host tensors before it returns, so the loop may update the state in
    place at once; a write's error surfaces at the next submit or at
    close. Each write prunes to the newest ``keep``."""

    def __init__(self, path: str, keep: int = 3):
        self.path = path
        self.keep = keep
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            tree, step = item
            try:
                save(self.path, tree, step)
                prune(self.path, self.keep)
            except BaseException as e:   # surfaced on next submit/close
                self._err = e
            finally:
                self._q.task_done()

    def submit(self, tree: Any, step: int) -> None:
        if self._err:
            raise RuntimeError("async checkpoint write failed") from self._err
        # a new host copy of every leaf (a CPU leaf's too): the loop may
        # update the state in place as soon as this returns
        self._q.put((unflatten(tree, [t.detach().to("cpu", copy=True)
                                      for t in flatten(tree)]), step))

    def flush(self) -> None:
        """Wait until every submitted write has ended."""
        self._q.join()
        if self._err:
            raise RuntimeError("async checkpoint write failed") from self._err

    def close(self) -> None:
        self._q.join()
        self._q.put(None)
        self._thread.join()
        if self._err:
            raise RuntimeError("async checkpoint write failed") from self._err
