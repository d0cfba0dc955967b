"""Checkpointing: atomic, async, and readable by the reference (the
reference's ``checkpoint/manager.py`` in PyTorch).

  * the layout is the reference's: writes go to ``<dir>/tmp-<step>``,
    then ``os.replace`` to ``step-<step>``, holding ``shards.npz`` and a
    ``manifest.json`` (step, keys, shapes, dtypes) with the sha256 of
    its sorted JSON -- a torn write can never shadow a good checkpoint,
    and ``latest_step`` skips one whose manifest does not verify;
  * the keys are the reference's ``_flatten`` paths (dict keys sorted,
    ``0``, ``1`` for tuple items, ``.m`` for a named tuple's fields, a
    ``None`` holding nothing), so a checkpoint written by one package
    restores in the other;
  * bfloat16 (and float8) tensors are stored as their bit patterns
    (uint16, uint8) with their type recorded in the manifest, without
    ``ml_dtypes``;
  * ``AsyncCheckpointer`` copies the tensors to the host, then writes on
    a background thread (a bounded queue of 1: a save waits only while
    the previous one is still in flight);
  * DTensor leaves are gathered whole on every rank of their mesh (a
    collective: every rank saves), and rank 0 of the default process
    group writes; ``restore(..., shardings=)`` places each leaf on a
    mesh by ``distribute_tensor`` -- the elastic path: a checkpoint
    written on one mesh loads onto another.
"""
from __future__ import annotations

import hashlib
import json
import os
import queue
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.sharding import is_dtensor

# types numpy cannot hold: stored as bit patterns of the same width
# (stored, signed numpy, signed torch, logical type)
_VIEW_AS = {"bfloat16": (np.uint16, np.int16, torch.int16, torch.bfloat16),
            "float8_e4m3fn": (np.uint8, np.int8, torch.int8,
                              torch.float8_e4m3fn)}


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _leaves(tree: Any, path: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """``(key, leaf)`` in the reference's order and naming
    (``jax.tree_util.tree_flatten_with_path``)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _leaves(tree[k], path + (str(k),))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for f in tree._fields
                for kv in _leaves(getattr(tree, f), path + (f".{f}",))]
    if isinstance(tree, (tuple, list)):
        return [kv for i, t in enumerate(tree)
                for kv in _leaves(t, path + (str(i),))]
    return [("/".join(path), tree)]


def _writes() -> bool:
    """Whether this process writes checkpoints: rank 0 of the default
    process group, or a process without one."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def _to_numpy(leaf: Any) -> np.ndarray:
    """A leaf as the host array stored for it (bit patterns for the
    types ``_VIEW_AS`` names); a DTensor whole (``full_tensor``)."""
    if isinstance(leaf, torch.Tensor):
        if is_dtensor(leaf):
            leaf = leaf.full_tensor()
        # a copy on the host: the caller may overwrite the tensor next
        t = leaf.detach().to("cpu", copy=True)
        name = _dtype_name(t)
        if name in _VIEW_AS:
            stored, _, signed, _ = _VIEW_AS[name]
            return t.view(signed).numpy().view(stored)
        return t.numpy()
    return np.array(leaf)


def _flatten(tree: Any) -> Dict[str, Tuple[np.ndarray, str]]:
    """key -> (host array as stored, logical type name)."""
    out = {}
    for key, leaf in _leaves(tree):
        name = _dtype_name(leaf) if isinstance(leaf, torch.Tensor) \
            else str(np.asarray(leaf).dtype)
        out[key] = (_to_numpy(leaf), name)
    return out


def _save_host(directory: str, step: int,
               arrays: Dict[str, Tuple[np.ndarray, str]]) -> str:
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"tmp-{step}")
    final = os.path.join(directory, f"step-{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "shards.npz"),
             **{k: a for k, (a, _) in arrays.items()})
    manifest = {
        "step": step,
        "keys": sorted(arrays.keys()),
        "shapes": {k: list(a.shape) for k, (a, _) in arrays.items()},
        "dtypes": {k: name for k, (_, name) in arrays.items()},
    }
    blob = json.dumps(manifest, sort_keys=True).encode()
    manifest["hash"] = hashlib.sha256(blob).hexdigest()
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def save(directory: str, step: int, tree: Any) -> str:
    """Atomic synchronous save of ``tree`` (tensors, numpy arrays and
    Python numbers in dicts, tuples and named tuples); returns the final
    path.  With a default process group every rank calls it (DTensor
    leaves are gathered by all), rank 0 writes and all wait for it."""
    import torch.distributed as dist

    arrays = _flatten(tree)
    final = os.path.join(directory, f"step-{step}")
    if _writes():
        final = _save_host(directory, step, arrays)
    if dist.is_initialized():
        dist.barrier()
    return final


def _verify(path: str) -> Optional[Dict]:
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        h = manifest.pop("hash")
        blob = json.dumps(manifest, sort_keys=True).encode()
        if hashlib.sha256(blob).hexdigest() != h:
            return None
        return manifest
    except Exception:
        return None


def latest_step(directory: str) -> Optional[int]:
    """The newest step whose manifest verifies, or None."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step-"):
            if _verify(os.path.join(directory, name)) is not None:
                steps.append(int(name.split("-", 1)[1]))
    return max(steps) if steps else None


def _restore_leaf(arr: np.ndarray, logical: str, like: Any, key: str,
                  on_like: bool = True):
    """One leaf from its stored array: a tensor of ``like``'s shape and
    type, on ``like``'s device where ``on_like`` (else on the host)."""
    if not isinstance(like, torch.Tensor):
        return arr.item() if isinstance(like, (int, float)) else arr
    if logical in _VIEW_AS:
        _, signed, _, logical_t = _VIEW_AS[logical]
        t = torch.from_numpy(np.ascontiguousarray(arr).view(signed)) \
            .view(logical_t)
    else:
        t = torch.from_numpy(np.array(arr))
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"{key}: checkpoint shape {tuple(t.shape)} != "
                         f"{tuple(like.shape)}")
    return t.to(device=like.device if on_like else "cpu", dtype=like.dtype)


def _unflatten(like: Any, leaves: Dict[str, Any],
               path: Tuple[str, ...] = ()) -> Any:
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves, path + (str(k),))
                for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(getattr(like, f), leaves,
                                       path + (f".{f}",))
                            for f in like._fields))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(t, leaves, path + (str(i),))
                          for i, t in enumerate(like))
    return leaves["/".join(path)]


def _place(t: torch.Tensor, like: Any, sharding: Any) -> torch.Tensor:
    """``t`` (whole) placed by ``sharding`` (a ``shard_rules.Sharding``),
    else as the DTensor ``like`` is."""
    from torch.distributed.tensor import distribute_tensor

    if sharding is None:
        mesh, place = like.device_mesh, like.placements
    else:
        mesh, place = sharding.mesh, sharding.placements
    return distribute_tensor(t.to(mesh.device_type), mesh, list(place))


def restore(directory: str, step: int, like: Any,
            shardings: Optional[Any] = None) -> Any:
    """Restore into new tensors of the structure of ``like``: each
    tensor leaf takes its shape, type and device from ``like``'s, each
    Python number leaf comes back as a Python number.  ``shardings``
    (a tree of ``shard_rules.Sharding`` like ``like``) places each
    tensor on its mesh by ``distribute_tensor`` (every rank of the mesh
    restores); a DTensor leaf of ``like`` without one is placed as that
    leaf is.  Raises ``IOError`` for a torn or missing checkpoint."""
    path = os.path.join(directory, f"step-{step}")
    manifest = _verify(path)
    if manifest is None:
        raise IOError(f"checkpoint {path} is torn or missing")
    with np.load(os.path.join(path, "shards.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    where = dict(_leaves(shardings)) if shardings is not None else {}
    leaves = {}
    for key, leaf in _leaves(like):
        sh = where.get(key)
        placed = sh is not None or is_dtensor(leaf)
        t = _restore_leaf(arrays[key], manifest["dtypes"][key], leaf, key,
                          on_like=not placed)
        leaves[key] = _place(t, leaf, sh) if placed else t
    return _unflatten(like, leaves)


class AsyncCheckpointer:
    """Bounded-queue background writer (overlap save with compute)."""

    def __init__(self, directory: str):
        self.directory = directory
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, arrays = item
            try:
                _save_host(self.directory, step, arrays)
            except BaseException as e:  # surfaced on next save/close
                self._err = e

    def save_async(self, step: int, tree: Any) -> None:
        """Copy ``tree`` to the host now (the caller may overwrite its
        tensors in the next step), write it in the background."""
        if self._err:
            raise self._err
        arrays = _flatten(tree)
        if _writes():
            self._q.put((step, arrays))  # blocks if previous in flight

    def close(self) -> None:
        self._q.put(None)
        self._thread.join()
        if self._err:
            raise self._err
