"""Multi-device WindTunnel core: node-partitioned label propagation (port
of ``repro/core/distributed.py``).

Node-sharded ELL layout: each rank owns N/d rows of the (N, K) adjacency;
labels are the replicated carry. One round = the local LP round over the
rank's rows (``kernels/label_prop/ops.label_prop_round`` with the block's
``row0``: the CUDA kernel on a CUDA tensor, ``ell_round`` on a CPU one) +
an all-gather of the new local labels: one collective per round.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import collectives as coll


def distributed_propagate_ell(mesh, nbr: torch.Tensor, wgt: torch.Tensor, *,
                              rounds: int, axis: str = "data"):
    """nbr (N, K) i32 / wgt (N, K) f32, N divisible by the size of mesh
    axis ``axis``; this rank runs the rows of its shard. Returns the final
    labels (N,) i32 (replicated)."""
    from repro_torch.kernels.label_prop.ops import label_prop_round
    n = nbr.shape[0]
    d = coll.axis_size(mesh, axis)
    if n % d:
        raise ValueError(f"{n} nodes do not split over {d} shards")
    rows = n // d
    row0 = coll.flat_axis_index(mesh, axis) * rows
    nbr_l = nbr[row0:row0 + rows].contiguous()
    wgt_l = wgt[row0:row0 + rows].contiguous()
    labels = coll.pvary_compat(
        torch.arange(n, dtype=torch.int32, device=nbr.device), axis)
    for _ in range(rounds):
        new_local = label_prop_round(labels, nbr_l, wgt_l, row0)
        labels = coll.all_gather(new_local, mesh, axis)
    return coll.unvary_compat(labels, mesh, axis)


def verify_against_single_device(mesh, nbr, wgt, rounds=3) -> bool:
    """Test helper: distributed result == single-device ELL result."""
    from repro_torch.core.label_prop import propagate_ell
    dist_labels = distributed_propagate_ell(mesh, nbr, wgt, rounds=rounds)
    ref = propagate_ell(nbr, wgt, rounds=rounds).labels
    return bool(torch.equal(dist_labels, ref))
