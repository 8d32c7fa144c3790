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

A tree placed on a mesh (:func:`place_tree`) holds ``DTensor`` leaves,
each rank only its shard, cut from the whole leaf every rank holds alike
(no collective: on a gloo group shared by ranks on one card, a
collective on a CUDA tensor goes through the host). Two mesh dims that
shard one tensor dim nest, the first the outer (the reference's
``PartitionSpec(("pod", "data"))``). :func:`full_tensor` gathers a leaf
whole on every rank through ``collectives.all_gather``.

:class:`GridRanks` is what one rank holds of tensors split on their
leading dim over the grid (``data`` and ``model``): the recsys tables'
rows and MACE's nodes and edges, which the models read through it.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils import _pytree as pytree

from repro_torch.distributed import collectives as coll

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


# ---------------------------------------------------------------------------
# trees placed on a mesh
# ---------------------------------------------------------------------------

def _shards(mesh, placements_: tuple):
    """(mesh dim name, tensor dim) of each ``Shard`` placement, mesh dims
    in order (outer first)."""
    return [(name, p.dim) for name, p in zip(mesh.mesh_dim_names,
                                             placements_)
            if isinstance(p, Shard)]


def local_slices(shape, mesh, placements_: tuple) -> tuple:
    """This rank's shard of a ``shape``-shaped leaf as one slice a dim.
    Every sharded dim must divide by its mesh dims (the reference's
    layouts do; an uneven shard raises)."""
    bounds = [[0, n] for n in shape]
    for name, d in _shards(mesh, placements_):
        n = coll.axis_size(mesh, name)
        lo, hi = bounds[d]
        if (hi - lo) % n:
            raise ValueError(
                f"dim {d} of a {tuple(shape)} leaf ({hi - lo} here) does not "
                f"divide over mesh axis {name!r} of {n}")
        step = (hi - lo) // n
        lo += coll.flat_axis_index(mesh, name) * step
        bounds[d] = [lo, lo + step]
    return tuple(slice(lo, hi) for lo, hi in bounds)


def local_shape(shape, mesh, placements_: tuple) -> tuple:
    return tuple(s.stop - s.start
                 for s in local_slices(shape, mesh, placements_))


def as_placed(local: torch.Tensor, mesh, placements_: tuple,
              shape=None) -> DTensor:
    """``local`` as this rank's shard of a DTensor of ``shape`` (no
    collective, no copy)."""
    shape = torch.Size(shape if shape is not None else local.shape)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, placements_, run_check=False,
                              shape=shape, stride=stride)


def place(full: torch.Tensor, mesh, placements_: tuple) -> DTensor:
    """The whole leaf ``full`` (the same on every rank) placed: this
    rank keeps a copy of its shard only."""
    local = full[local_slices(full.shape, mesh, placements_)]
    return as_placed(local.clone(), mesh, placements_, full.shape)


def place_tree(tree, mesh, shardings):
    """:func:`place` over a tree and its placements (``tree_shardings``'),
    dicts and lists as ``train/optimizer.tree_map`` walks them."""
    if isinstance(tree, dict):
        return {k: place_tree(v, mesh, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [place_tree(v, mesh, s) for v, s in zip(tree, shardings)]
    return place(tree, mesh, shardings)


def full_tensor(x) -> torch.Tensor:
    """A placed leaf gathered whole on every rank (collective over its
    sharded mesh dims, inner first); a plain tensor, or a leaf replicated
    on every mesh dim, as it is (its own storage, not a copy)."""
    if not isinstance(x, DTensor):
        return x
    out = x.to_local()
    for name, d in reversed(_shards(x.device_mesh, x.placements)):
        out = coll.all_gather(out, x.device_mesh, name, dim=d)
    return out


def to_local(x):
    """A placed leaf's own shard (its storage: in-place writes reach the
    DTensor); a plain tensor as it is."""
    return x.to_local() if isinstance(x, DTensor) else x


class GridRanks:
    """What one rank of ``mesh`` holds of a tensor whose leading dim is
    split over the grid, ``data`` and ``model`` in the mesh's order (the
    chunk :func:`local_slices` gives a leaf placed ``Shard(0)`` on both:
    chunk ``s`` of ``g``), and the collectives the models call over it.
    Axes of size 1 take no part. ``n_all`` counts the mesh's ranks;
    ``copies`` the ranks that hold the same chunk (the ``pod`` replicas),
    so a loss term every rank holds alike has the share 1 / ``n_all`` and
    a sum over chunks the share 1 / ``copies`` (the shares of the ranks
    sum to the loss, as ``models/transformer.Ranks``')."""

    def __init__(self, mesh):
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        self.mesh = mesh
        self.sizes = sizes
        self.grid = tuple(n for n in mesh.mesh_dim_names
                          if n in ("data", "model") and sizes[n] > 1)
        self.g = math.prod(sizes[n] for n in self.grid)
        self.s = coll.flat_axis_index(mesh, self.grid) if self.grid else 0
        self.n_all = math.prod(mesh.shape)
        self.copies = self.n_all // self.g

    def axes(self, names) -> tuple:
        """``names`` that split the grid, in the mesh's order."""
        return tuple(n for n in self.grid if n in names)

    def gather(self, x: torch.Tensor, names=None) -> torch.Tensor:
        """The chunks of ``x`` over ``names`` (the whole grid by default)
        in chunk order; the gradient is reduce-scattered."""
        axes = self.grid if names is None else self.axes(names)
        return coll.grad_all_gather(x, self.mesh, axes) if axes else x

    def scatter(self, x: torch.Tensor, names=None) -> torch.Tensor:
        """This rank's chunk of ``x`` summed over ``names`` (the whole
        grid by default); the gradient is all-gathered."""
        axes = self.grid if names is None else self.axes(names)
        return coll.grad_reduce_scatter(x, self.mesh, axes) if axes else x

    def sum(self, x: torch.Tensor, names=None) -> torch.Tensor:
        """``x`` summed over ``names`` (the whole grid by default); the
        gradient is summed too."""
        axes = self.grid if names is None else self.axes(names)
        return coll.grad_all_reduce(x, self.mesh, axes) if axes else x

    def total(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over every rank of the mesh (no gradient): a
        loss from its shares."""
        names = tuple(n for n, k in self.sizes.items() if k > 1)
        return coll.all_reduce(x, self.mesh, names) if names else x
