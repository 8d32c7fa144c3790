"""Fault-tolerant checkpoints (port of ``repro/train/checkpoint.py``): the
leaves in one ``leaves.npz`` (``leaf_0``, ``leaf_1``, ...) plus a JSON
manifest (``step``, ``paths``, ``dtypes``, ``shapes``), written to a
``.tmp`` directory and published by an atomic rename, so a crashed writer
never corrupts the latest checkpoint. ``AsyncCheckpointer`` writes on a
background thread, so the train loop does not wait on the disk.

The format is the reference's: a path is the ``/``-joined dict keys (and
tuple or list indices) of a leaf, leaves in sorted key order (JAX's
flatten order), so a checkpoint of float32 and int32 leaves written by
either package restores in the other bit for bit. numpy has no bfloat16
(the card's machine has no ``ml_dtypes``), so a bfloat16 leaf raises,
naming it; training saves float32 parameters and AdamW state.

Restore is mesh-agnostic: leaves are stored whole (a ``DTensor`` is
gathered first), and each goes to the device and dtype of its ``like``
leaf, or, given ``shardings`` (placements from
``distributed/sharding.tree_shardings``) and their ``mesh``, onto that
mesh: elastic re-mesh resume is a placement, as in the reference.
"""
from __future__ import annotations

import json
import os
import queue
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Placement, distribute_tensor

_MANIFEST = "manifest.json"
_LEAVES = "leaves.npz"


def _is_placements(x) -> bool:
    return isinstance(x, tuple) and bool(x) and all(
        isinstance(p, Placement) for p in x)


def _flatten(tree, is_leaf=None, prefix=()):
    """(path, leaf) pairs in JAX's flatten order; ``None`` holds no leaf."""
    if tree is None:
        return []
    if is_leaf is not None and is_leaf(tree):
        return [("/".join(prefix), tree)]
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in _flatten(tree[k], is_leaf, prefix + (str(k),))]
    if isinstance(tree, (tuple, list)):
        return [pl for i, x in enumerate(tree)
                for pl in _flatten(x, is_leaf, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def _unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` (flatten order)."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (tuple, list)):
            return type(node)(build(x) for x in node)
        return next(it)
    return build(like)


def _host(path: str, leaf, copy: bool = False) -> np.ndarray:
    """A leaf as a numpy array on the host (a DTensor gathered whole); with
    ``copy`` one of its own, never sharing a CPU tensor's memory."""
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        _refuse_bfloat16(path, leaf.dtype)
        return leaf.detach().to("cpu", copy=copy).numpy()
    arr = np.array(leaf) if copy else np.asarray(leaf)
    _refuse_bfloat16(path, arr.dtype)
    return arr


def _refuse_bfloat16(path: str, dtype) -> None:
    if str(dtype) in ("torch.bfloat16", "bfloat16"):
        raise TypeError(
            f"checkpoint leaf {path!r} is bfloat16, which numpy has no dtype "
            f"for; save it as float32")


def _host_copy(tree):
    """The tree with every leaf copied to the host (what a save writes
    while the caller's tensors change)."""
    pairs = _flatten(tree)
    return _unflatten(tree, [_host(p, leaf, copy=True) for p, leaf in pairs])


def save_checkpoint(directory: str, step: int, tree: Any) -> str:
    """Blocking save. Returns the final checkpoint path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    pairs = _flatten(tree)
    arrays = {f"leaf_{i}": _host(p, leaf) for i, (p, leaf) in enumerate(pairs)}
    np.savez(os.path.join(tmp, _LEAVES), **arrays)
    manifest = {"step": step,
                "paths": [p for p, _ in pairs],
                "dtypes": [str(a.dtype) for a in arrays.values()],
                "shapes": [list(a.shape) for a in arrays.values()]}
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)          # atomic publish
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for d in os.listdir(directory)
             if (m := re.fullmatch(r"step_(\d+)", d))]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, like: Any, step: Optional[int] = None,
                       shardings: Any = None, *, mesh=None) -> tuple[Any, int]:
    """Restore into the structure of ``like``: each leaf on its ``like``
    leaf's device and in its dtype, or, given ``shardings`` (a tree
    matching ``like``, or a flat list, of DTensor placements), placed on
    ``mesh`` with them."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    pairs = _flatten(like)
    paths = [p for p, _ in pairs]
    if paths != manifest["paths"]:
        raise ValueError(
            "checkpoint structure mismatch:\n saved=%s\n want=%s" %
            (manifest["paths"][:5], paths[:5]))
    if shardings is None:
        shard_list = [None] * len(pairs)
    else:
        if mesh is None:
            raise ValueError("restoring with shardings needs their mesh")
        shard_list = [s for _, s in _flatten(shardings, _is_placements)]
    out = []
    with np.load(os.path.join(path, _LEAVES)) as data:
        for i, ((_, leaf), sh) in enumerate(zip(pairs, shard_list)):
            t = torch.from_numpy(data[f"leaf_{i}"])
            if isinstance(leaf, torch.Tensor):
                t = t.to(device=leaf.device, dtype=leaf.dtype)
            if sh is not None:
                t = distribute_tensor(t.to(mesh.device_type), mesh, sh)
            out.append(t)
    return _unflatten(like, out), step


class AsyncCheckpointer:
    """Background-thread checkpoint writer with a bounded queue (depth 1: a
    newer pending save supersedes an older one, like orbax's behaviour).
    The copy to the host is made by the caller of :meth:`save`, so the
    caller may change its tensors as soon as ``save`` returns; a failed
    write is raised by the next ``save`` or ``close``."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._err_lock = threading.Lock()
        self._err: Optional[BaseException] = None
        self._t = threading.Thread(target=self._worker, daemon=True,
                                   name="checkpoint-writer")
        self._t.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, host_tree = item
            del item
            try:
                save_checkpoint(self.directory, step, host_tree)
                self._gc()
            except Exception as e:  # surfaced on next save()/close()
                with self._err_lock:
                    self._err = e
            del host_tree           # the host copy goes once it is written

    def _raise_pending(self):
        with self._err_lock:
            err = self._err
        if err is not None:
            raise err

    def _gc(self):
        steps = sorted(int(m.group(1)) for d in os.listdir(self.directory)
                       if (m := re.fullmatch(r"step_(\d+)", d)))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory,
                                       f"step_{s:010d}"), ignore_errors=True)

    def save(self, step: int, tree: Any):
        self._raise_pending()
        host_tree = _host_copy(tree)
        try:
            self._q.put_nowait((step, host_tree))
        except queue.Full:
            # drop the superseded pending save, enqueue the newer one
            try:
                self._q.get_nowait()
            except queue.Empty:
                pass
            self._q.put_nowait((step, host_tree))

    def close(self):
        self._q.put(None)
        self._t.join()
        self._raise_pending()
