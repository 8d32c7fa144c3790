"""Logical-axis sharding rules (port of ``repro/distributed/sharding.py``).

Models annotate every parameter dim with a logical name; the rules below
map names to mesh axes, so changing the parallelism layout never touches
model code. The tables are the reference's, entry for entry.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose
``mesh_dim_names`` are the reference's axis names (``("data", "model")``,
or ``("pod", "data", "model")`` across pods). :func:`logical_to_spec`
returns the reference's ``PartitionSpec`` entries as a plain tuple (one
entry per tensor dim: a mesh axis name, a tuple of them, or ``None``);
:func:`tree_shardings` turns each entry into the DTensor placements of the
mesh's dims (``Shard(tensor_dim)`` or ``Replicate()``).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
from torch.distributed.tensor import Replicate, Shard
from torch.utils import _pytree as pytree

# logical axis -> mesh axis (None = replicate). Tuples shard one logical
# axis over multiple mesh axes.
LM_RULES = {
    "layers": None,
    "embed": "data",              # ZeRO dimension
    "embed_noshard": None,
    "qkv_features": "model",      # Megatron TP
    "kv_features": "model",
    "ffn": "model",
    "experts": None,
    "experts_noshard": None,
    "vocab": "model",
    # activations / batch
    "batch": ("pod", "data"),
    "seq": None,
    "seq_sharded": "data",        # sequence parallelism
    "heads": "model",
    "kv_heads": "model",
    "cache_batch": ("pod", "data"),
}

RECSYS_RULES = {
    "table_rows": "model",        # row-sharded embedding tables
    "table_dim": None,
    "mlp_in": None,
    "mlp_out": "model",
    "batch": ("pod", "data"),
    "candidates": "model",
    "cross": None,
    "small": None,
}

GNN_RULES = {
    "nodes": ("data", "model"),   # node/edge arrays over the whole grid
    "edges": ("data", "model"),
    "queries": ("data", "model"),  # WindTunnel QRel table, query-partitioned
    "feat": None,
    "param": None,
    "batch": ("pod", "data"),
}

RETRIEVAL_RULES = {
    "corpus": ("data", "model"),  # corpus vectors / LSH codes, row-sharded
    "lists": ("data", "model"),   # ivfflat inverted lists, list-sharded
    "queries": None,              # query batches replicate
    "feat": None,
}


def _mesh_axes_for(mesh, axis):
    """Filter rule target axes to those present in the mesh (so the same
    rules serve single-pod, multi-pod and 1-rank meshes)."""
    if axis is None:
        return None
    axes = axis if isinstance(axis, tuple) else (axis,)
    present = tuple(a for a in axes if a in mesh.mesh_dim_names)
    if not present:
        return None
    return present if len(present) > 1 else present[0]


def partition_axes(mesh, logical_name: str, rules: dict) -> tuple:
    """Mesh axes (present in ``mesh``) that a logical dimension partitions
    over, as a tuple; the sharded pipeline treats the tuple as one
    flattened process group (``collectives.axis_group``)."""
    axes = _mesh_axes_for(mesh, rules.get(logical_name))
    if axes is None:
        return ()
    return axes if isinstance(axes, tuple) else (axes,)


def logical_to_spec(mesh, logical_axes: Optional[tuple], rules: dict) -> tuple:
    """The reference's ``PartitionSpec`` entries for ``logical_axes``."""
    if logical_axes is None:
        return ()
    return tuple(_mesh_axes_for(mesh, rules.get(name))
                 for name in logical_axes)


def placements(mesh, spec: tuple) -> tuple:
    """DTensor placements, one per mesh dim, of a ``logical_to_spec``
    entry tuple: ``Shard(i)`` where tensor dim i names the mesh dim."""
    out = []
    for dim in mesh.mesh_dim_names:
        shard = [i for i, entry in enumerate(spec)
                 if entry == dim or (isinstance(entry, tuple) and dim in entry)]
        out.append(Shard(shard[0]) if shard else Replicate())
    return tuple(out)


def _is_axes_leaf(x) -> bool:
    return x is None or (isinstance(x, tuple)
                         and all(isinstance(a, str) for a in x))


def tree_shardings(mesh, logical_tree: Any, rules: dict):
    """Map a pytree of logical-axis tuples to DTensor placements."""
    return pytree.tree_map(
        lambda axes: placements(mesh, logical_to_spec(mesh, axes, rules)),
        logical_tree, is_leaf=_is_axes_leaf)


class Shaped(NamedTuple):
    """Shape, type and placements of a sharded input (the reference's
    ``ShapeDtypeStruct`` carrying its ``NamedSharding``)."""

    shape: tuple
    dtype: torch.dtype
    placements: tuple


def shaped(shape, dtype, mesh, logical_axes, rules) -> Shaped:
    return Shaped(tuple(shape), dtype,
                  placements(mesh, logical_to_spec(mesh, logical_axes, rules)))
