"""Checkpoints as npz shards + a manifest, in the JAX package's format
(torch twin of the synchronous half of ``repro.checkpoint.store``)::

    <dir>/step_000123/
        manifest.json      # step, leaf shapes/dtypes, shards, status
        shard_<i>.npz      # leaf_<i> arrays, ~512 MB a shard

A checkpoint counts once its manifest says ``"status": "complete"``
(written last; the directory is published by one rename). Leaves are
stored in JAX's flatten order of the tree: dict keys sorted, depth
first. So the JAX package restores what :func:`save` writes and
:func:`restore` reads what JAX's ``store.save`` wrote; a tree's layout
comes from the ``like`` tree the caller passes, never from the
manifest's ``treedef`` string (which :func:`save` writes for JAX's
readers of the manifest and nothing here parses).

bf16 leaves are stored as their uint16 bit patterns (npz has no bf16)
and come back through an int16 view into ``torch.bfloat16``, so neither
side needs ``ml_dtypes``. The async writer and pruning are training
infrastructure and are not ported.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, List, Optional

import numpy as np
import torch

def flatten(tree: Any) -> List[Any]:
    """Leaves in JAX's flatten order: dict keys sorted, depth first."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in flatten(tree[k])]
    return [tree]


def unflatten(like: Any, leaves: List[Any]) -> Any:
    """``like``'s structure filled with ``leaves`` (JAX's order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
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
    return torch.from_numpy(np.ascontiguousarray(a).astype(
        np.dtype(dtype_name), copy=False).copy())


def save(path: str, tree: Any, step: int,
         shard_bytes: int = 512 * 2**20) -> str:
    """Write ``tree`` (nested dicts of tensors) as checkpoint ``step``
    under ``path``; returns the checkpoint directory."""
    ckdir = os.path.join(path, f"step_{step:09d}")
    tmp = ckdir + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves = [_encode(t) for t in flatten(tree)]
    manifest: Dict[str, Any] = {
        "step": step,
        "treedef": f"sorted-key nested dicts, {len(leaves)} leaves",
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
