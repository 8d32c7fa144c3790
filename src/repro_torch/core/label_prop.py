"""GraphSampler steps 1-3 — weighted label propagation (Algorithm 2), port
of ``repro/core/label_prop.py``.

Paper semantics (Raghavan et al. [9], weighted variant):
  init:   L(v) = v
  round:  for each node v, over incident edges (v, u, w) aggregate
          S(L) = sum of w over neighbours u with label L;
          assign L*(v) = argmax_L S(L).
  stop:   after a fixed number of rounds.

Ties are broken toward the smaller label id. ``sort_round`` is one round as
reduce-by-(dst, label) + reduce-by-dst argmax over a sorted edge list;
``ell_round`` is the dense degree-capped formulation and the plain version
of the CUDA kernel, kept beside it (kernels/label_prop/ref.py) and
re-exported here. The multi-round loops (the
reference's ``lax.scan``) are Python loops: ``propagate`` and
``propagate_ell`` here, and ``engines.run_engine`` behind the engine
registry.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import segment_utils as su
# the LP kernel's plain version lives beside the kernel; core re-exports it
from repro_torch.kernels.label_prop.ref import ell_round


class LabelPropResult(NamedTuple):
    labels: torch.Tensor             # i32[num_nodes] final community labels
    changes_per_round: torch.Tensor  # i32[rounds] nodes that changed label


def sort_round(labels, src, dst, w, valid, num_nodes):
    """One LP round over a directed edge list via sort + segment reduce —
    the round the ``sort`` engine executes."""
    e = src.shape[0]
    lab_src = labels[torch.where(valid, src, 0).to(torch.int64)]
    dst_k = torch.where(valid, dst, num_nodes)        # sentinel sorts last
    lab_k = torch.where(valid, lab_src, su.I32_MAX)
    w_m = torch.where(valid, w, 0.0)

    # reduce-by-(dst, label): sum of affinities per candidate label
    (dsts, labs), (ws,) = su.sort_by((dst_k, lab_k), (w_m,))
    seg = su.run_segment_ids(su.run_starts(dsts, labs))
    sums = su.segment_sum(ws, seg, num_segments=e)[seg]

    # reduce-by-dst: argmax_L sum, tie -> min label
    dseg = su.run_segment_ids(su.run_starts(dsts))
    smax = su.segment_max(sums, dseg, num_segments=e)[dseg]
    cand = torch.where(sums == smax, labs, su.I32_MAX)
    best = su.segment_min(cand, dseg, num_segments=e)

    # one representative row per dst-run; scatter back. Runs made only of
    # sentinel rows (or empty segments, whose min is I32_MAX) fall outside
    # [0, num_nodes) and are dropped, as mode="drop" drops them.
    dst_of_seg = su.segment_min(dsts, dseg, num_segments=e)
    keep = su.in_range_rows(dst_of_seg, num_nodes)
    new_labels = labels.clone()
    new_labels[dst_of_seg[keep].to(torch.int64)] = torch.minimum(
        best, torch.tensor(su.I32_MAX - 1, dtype=best.dtype,
                           device=best.device))[keep].to(labels.dtype)
    return new_labels


def propagate(src, dst, w, valid, *, num_nodes: int,
              rounds: int) -> LabelPropResult:
    """Run ``rounds`` of weighted label propagation over a directed edge
    list (``graph_builder.symmetrize`` first for undirected graphs)."""
    labels = torch.arange(num_nodes, dtype=torch.int32, device=src.device)
    changes = torch.zeros(rounds, dtype=torch.int32, device=src.device)
    for r in range(rounds):
        new = sort_round(labels, src, dst, w, valid, num_nodes)
        changes[r] = (new != labels).sum()
        labels = new
    return LabelPropResult(labels, changes)


# ---------------------------------------------------------------------------
# Dense ELL formulation (the plain version of the CUDA kernel)
# ---------------------------------------------------------------------------

def edges_to_ell(src, dst, w, valid, *, num_nodes: int, max_degree: int):
    """Pack a directed edge list into ELL adjacency:
    nbr i32[num_nodes, max_degree] (pad -1), wgt f32[num_nodes, max_degree].

    Edges beyond ``max_degree`` per dst are dropped deterministically
    (highest-weight edges kept), mirroring the fanout cap of Alg. 1.
    """
    dev = src.device
    dst_k = torch.where(valid, dst, num_nodes)
    negw = torch.where(valid, -w, torch.inf)
    (dsts, _), (srcs, ws) = su.sort_by((dst_k, negw), (src, w))
    rank = su.group_rank(su.run_starts(dsts))
    ok = (dsts < num_nodes) & (rank < max_degree)
    row, col = dsts[ok].to(torch.int64), rank[ok]
    nbr = torch.full((num_nodes, max_degree), -1, dtype=torch.int32,
                     device=dev)
    nbr[row, col] = srcs[ok].to(torch.int32)
    wgt = torch.zeros((num_nodes, max_degree), dtype=torch.float32,
                      device=dev)
    wgt[row, col] = ws[ok]
    return nbr, wgt


def propagate_ell(nbr, wgt, *, rounds: int) -> LabelPropResult:
    """Run ``rounds`` of label propagation over ELL adjacency, each round
    through ``kernels/label_prop/ops.label_prop_round``: the CUDA kernel
    ``lp_round`` on CUDA tensors, ``ell_round`` on CPU tensors."""
    from repro_torch.kernels.label_prop.ops import label_prop_round
    labels = torch.arange(nbr.shape[0], dtype=torch.int32, device=nbr.device)
    changes = torch.zeros(rounds, dtype=torch.int32, device=nbr.device)
    for r in range(rounds):
        new = label_prop_round(labels, nbr, wgt)
        changes[r] = (new != labels).sum()
        labels = new
    return LabelPropResult(labels, changes)
