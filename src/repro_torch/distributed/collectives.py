"""Collective helpers over a ``DeviceMesh`` (port of
``repro/distributed/collectives.py``).

The reference runs one program over a mesh of devices, its collectives
naming mesh axes inside a ``shard_map`` body. The port runs one process
per device: the body is the code each rank runs on its own shard, and a
collective over a tuple of mesh axes runs over the process group of those
axes, flattened with the first name most significant (:func:`axis_group`,
``DeviceMesh._flatten``), so a gather concatenates the shards in the order
of :func:`flat_axis_index`, as ``lax.all_gather`` over the tuple does.

A gloo group takes no CUDA tensor for its gathers: a collective on a CUDA
tensor over a gloo group goes through a host copy. Only that case copies;
an NCCL group reads the card's tensors in place (and refuses CPU ones).

* ``psum_scatter_then_gather`` / ``gather_after_update`` — an all-reduce as
  reduce-scatter + all-gather, so an update can run on 1/axis_size of each
  gradient between the two halves;
* ``flat_axis_index`` / ``all_concat`` — the gather and merge primitives of
  the sharded WindTunnel pipeline (core/sharded_pipeline.py);
* ``pvary_compat`` / ``unvary_compat`` — ``pvary_compat`` is JAX's
  varying-axes annotation and has no counterpart here (the identity);
  ``unvary_compat`` collapses equal per-rank values with an all-reduce MAX;
* ``microbatch_grads`` — gradient accumulation over leading-dim
  microbatches;
* ``new_axis_group`` — a second communicator for a tuple of axes, for a
  worker thread that runs collectives while the main thread runs its own
  (the serving tier's background compaction, serve/ingest.py), so the two
  threads' collectives cannot interleave in another order on another
  rank;
* ``all_to_all`` — tiled all-to-all along the leading dim, even or by
  split sizes (the MoE's expert exchange, the GLU columns' regrouping);
* ``grad_all_reduce`` / ``grad_all_gather`` / ``grad_reduce_scatter`` /
  ``grad_all_to_all`` — the same collectives under autograd, for the code
  each rank runs of a model split over the mesh (``models/transformer.py``
  with ``ranks=``). Their backward is the adjoint of the forward (an
  all-reduce's is an all-reduce, an all-gather's a reduce-scatter, an
  all-to-all's the reverse all-to-all), which is exact when the objective
  is the SUM of the ranks' losses: a rank's loss is its share of the
  global one, and a value every rank holds alike is a sum of per-rank
  copies whose gradients add. Each backward is itself the autograd
  collective of its adjoint, so a gradient taken with ``create_graph``
  (MACE's forces) keeps its graph across ranks and has a second-order
  gradient.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

AxisNames = Union[str, Sequence[str]]

# the collectives' newer names, where the installed torch has them
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def _as_tuple(axis_names: AxisNames) -> tuple:
    return (axis_names,) if isinstance(axis_names, str) else tuple(axis_names)


def axis_size(mesh, axis_names: AxisNames) -> int:
    """Number of shards over ``axis_names`` (the product of their sizes)."""
    d = 1
    for name in _as_tuple(axis_names):
        d *= mesh.size(mesh.mesh_dim_names.index(name))
    return d


def flat_axis_index(mesh, axis_names: AxisNames) -> int:
    """This rank's row-major index over a tuple of mesh axes (first name
    most significant): the shard a leading dim partitioned over the tuple
    gives this rank."""
    idx = 0
    for name in _as_tuple(axis_names):
        idx = (idx * mesh.size(mesh.mesh_dim_names.index(name))
               + mesh.get_local_rank(name))
    return idx


def new_axis_group(mesh, axis_names: AxisNames):
    """A new process group over this rank's ``axis_names`` of ``mesh``
    (flattened, first name most significant), separate from the mesh's
    own. Collective: every rank of the default group must call it, in the
    same order, since each rank makes every subgroup."""
    axes = _as_tuple(axis_names)
    names = list(mesh.mesh_dim_names)
    dims = [names.index(a) for a in axes]
    rest = [i for i in range(len(names)) if i not in dims]
    rows = mesh.mesh.permute(rest + dims).reshape(-1, axis_size(mesh, axes))
    me, mine = dist.get_rank(), None
    for ranks in rows.tolist():
        group = dist.new_group(ranks=ranks)
        if me in ranks:
            mine = group
    if dist.get_rank(mine) != flat_axis_index(mesh, axes):
        raise RuntimeError(
            f"new group of {axes} puts this rank at {dist.get_rank(mine)}, "
            f"the mesh at {flat_axis_index(mesh, axes)}: build the mesh "
            f"from ranks in ascending order")
    return mine


def axis_group(mesh, axis_names: AxisNames):
    """The process group of ``axis_names`` flattened into one dimension
    (cached on the mesh). Its ranks run in :func:`flat_axis_index` order,
    which is checked."""
    axes = _as_tuple(axis_names)
    cache = mesh.__dict__.setdefault("_axis_groups", {})
    group = cache.get(axes)
    if group is None:
        sub = mesh[axes]
        group = (sub._flatten() if len(axes) > 1 else sub).get_group()
        if dist.get_rank(group) != flat_axis_index(mesh, axes):
            raise RuntimeError(
                f"process group of {axes} puts this rank at "
                f"{dist.get_rank(group)}, the mesh at "
                f"{flat_axis_index(mesh, axes)}: build the mesh from ranks "
                f"in ascending order")
        cache[axes] = group
    return group


def _staged(group, x: torch.Tensor) -> bool:
    """True where ``x`` must cross ``group`` through a host copy (a CUDA
    tensor over gloo); raises for a CPU tensor over NCCL."""
    backend = dist.get_backend(group)
    if backend == "nccl" and x.device.type != "cuda":
        raise ValueError(f"an NCCL group needs CUDA tensors; got a tensor "
                         f"on {x.device}")
    return x.device.type == "cuda" and backend == "gloo"


def all_gather(x: torch.Tensor, mesh, axis_names: AxisNames, *,
               dim: int = 0) -> torch.Tensor:
    """Tiled all-gather: the per-rank ``x`` concatenated along ``dim`` in
    shard order. Booleans travel as bytes."""
    group = axis_group(mesh, axis_names)
    d = dist.get_world_size(group)
    src = x.movedim(dim, 0).contiguous()
    as_bool = src.dtype == torch.bool
    if as_bool:
        src = src.to(torch.uint8)
    staged = _staged(group, src)
    send = src.cpu() if staged else src
    out = torch.empty((d * send.shape[0],) + tuple(send.shape[1:]),
                      dtype=send.dtype, device=send.device)
    _ALL_GATHER(out, send, group=group)
    if staged:
        out = out.to(x.device)
    if as_bool:
        out = out.to(torch.bool)
    return out.movedim(0, dim)


def all_reduce(x: torch.Tensor, mesh, axis_names: AxisNames,
               op: str = "sum") -> torch.Tensor:
    """All-reduce (``"sum"`` or ``"max"``) of ``x`` over ``axis_names``; a
    new tensor, ``x`` is left as it was."""
    group = axis_group(mesh, axis_names)
    staged = _staged(group, x)
    buf = x.cpu() if staged else x.clone()
    dist.all_reduce(buf, op={"sum": dist.ReduceOp.SUM,
                             "max": dist.ReduceOp.MAX}[op], group=group)
    return buf.to(x.device) if staged else buf


def all_concat(tree, mesh, axis_names: AxisNames):
    """All-gather every tensor leaf along its leading dim (tiled): the
    per-shard tables concatenated into the replicated global table."""
    return pytree.tree_map(lambda x: all_gather(x, mesh, axis_names), tree)


def pvary_compat(x, axis_names: AxisNames):
    """The identity: JAX marks a replicated ``shard_map`` carry as varying
    over ``axis_names``; a process holds its own copy and needs no mark."""
    del axis_names
    return x


def unvary_compat(x, mesh, axis_names: AxisNames):
    """Collapse a per-rank-but-equal value back to one (all-reduce MAX)."""
    return all_reduce(x, mesh, axis_names, "max")


def psum_scatter_then_gather(x: torch.Tensor, mesh, axis_name: str,
                             scatter_dim: int = 0) -> torch.Tensor:
    """The reduce-scatter half of all_reduce(x) = all_gather(psum_scatter
    (x)): this rank's 1/axis_size piece of the summed ``x`` along
    ``scatter_dim``; the caller updates it, then :func:`gather_after_update`
    reassembles the whole."""
    return _reduce_scatter(x, mesh, axis_name, scatter_dim)


def gather_after_update(pieces: torch.Tensor, mesh, axis_name: str,
                        gather_dim: int = 0) -> torch.Tensor:
    return all_gather(pieces, mesh, axis_name, dim=gather_dim)


def all_to_all(x: torch.Tensor, mesh, axis_names: AxisNames,
               in_splits=None, out_splits=None) -> torch.Tensor:
    """All-to-all along dim 0: piece ``j`` of ``x`` (``in_splits[j]``
    rows, or an even share) goes to the ``j``-th rank of the group, and
    the result stacks the pieces received, in rank order (``out_splits``
    rows from each, or an even share)."""
    group = axis_group(mesh, axis_names)
    src = x.contiguous()
    staged = _staged(group, src)
    send = src.cpu() if staged else src
    rows = (sum(out_splits) if out_splits is not None else send.shape[0])
    out = torch.empty((rows,) + tuple(send.shape[1:]), dtype=send.dtype,
                      device=send.device)
    dist.all_to_all_single(out, send, output_split_sizes=out_splits,
                           input_split_sizes=in_splits, group=group)
    return out.to(x.device) if staged else out


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return grad_all_reduce(g, ctx.mesh, ctx.axes), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return all_gather(x, mesh, axes, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return (grad_reduce_scatter(g, ctx.mesh, ctx.axes, ctx.dim), None,
                None, None)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _reduce_scatter(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return (grad_all_gather(g, ctx.mesh, ctx.axes, ctx.dim), None, None,
                None)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, in_splits, out_splits):
        ctx.mesh, ctx.axes = mesh, axes
        ctx.splits = (in_splits, out_splits)
        return all_to_all(x, mesh, axes, in_splits, out_splits)

    @staticmethod
    def backward(ctx, g):
        in_splits, out_splits = ctx.splits
        return (grad_all_to_all(g, ctx.mesh, ctx.axes, out_splits,
                                in_splits), None, None, None, None)


def _reduce_scatter(x: torch.Tensor, mesh, axis_names: AxisNames,
                    dim: int) -> torch.Tensor:
    """This rank's piece along ``dim`` of ``x`` summed over the group."""
    group = axis_group(mesh, axis_names)
    d = dist.get_world_size(group)
    src = x.movedim(dim, 0).contiguous()
    staged = _staged(group, src)
    send = src.cpu() if staged else src
    out = torch.empty((send.shape[0] // d,) + tuple(send.shape[1:]),
                      dtype=send.dtype, device=send.device)
    _REDUCE_SCATTER(out, send, group=group)
    out = out.to(x.device) if staged else out
    return out.movedim(0, dim)


def grad_all_reduce(x: torch.Tensor, mesh, axis_names: AxisNames):
    """Sum over the group; the gradient is summed over it too."""
    return _AllReduce.apply(x, mesh, _as_tuple(axis_names))


def grad_all_gather(x: torch.Tensor, mesh, axis_names: AxisNames,
                    dim: int = 0):
    """Tiled all-gather along ``dim``; the gradient is reduce-scattered."""
    return _AllGather.apply(x, mesh, _as_tuple(axis_names), dim % x.dim())


def grad_reduce_scatter(x: torch.Tensor, mesh, axis_names: AxisNames,
                        dim: int = 0):
    """This rank's piece along ``dim`` of the group's sum; the gradient is
    all-gathered."""
    return _ReduceScatter.apply(x, mesh, _as_tuple(axis_names), dim % x.dim())


def grad_all_to_all(x: torch.Tensor, mesh, axis_names: AxisNames,
                    in_splits=None, out_splits=None):
    """:func:`all_to_all`; the gradient goes back by the reverse one."""
    return _AllToAll.apply(x, mesh, _as_tuple(axis_names), in_splits,
                           out_splits)


def microbatch_grads(loss_fn, params, batches, *,
                     accum_dtype=torch.float32):
    """Mean gradient over leading-dim microbatches: ``loss_fn(params,
    mb)`` for each slice ``mb`` of ``batches``, gradients of the tensor
    leaves of ``params`` accumulated in ``accum_dtype``."""
    leaves, spec = pytree.tree_flatten(params)
    n = pytree.tree_leaves(batches)[0].shape[0]
    total = [torch.zeros(p.shape, dtype=accum_dtype, device=p.device)
             for p in leaves]
    for i in range(n):
        mb = pytree.tree_map(lambda b: b[i], batches)
        live = [p.detach().requires_grad_(True) for p in leaves]
        loss = loss_fn(pytree.tree_unflatten(live, spec), mb)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        for acc, g in zip(total, grads):
            if g is not None:
                acc.add_(g.to(accum_dtype))
    return pytree.tree_unflatten([g / n for g in total], spec)
