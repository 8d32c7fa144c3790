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
of the CUDA kernel (kernels/label_prop). The multi-round loop (the
reference's ``lax.scan``) is ``engines.run_engine``, a Python loop.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import segment_utils as su


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


def ell_round(labels, nbr, wgt):
    """One LP round over ELL adjacency — the plain version of the CUDA
    kernel ``lp_round`` (csrc/lp_round.cu).

    For node n with neighbour labels l_k and weights w_k:
      S(l_j) = sum_k w_k [l_k == l_j];  L* = argmax_j (S, -l_j).
    Nodes with no neighbours keep their label.

    S is accumulated over k = 0..K-1 in order, adding exactly w_k or 0 per
    term, as the kernel does, so the two agree bit for bit. Memory stays
    O(N K): the reference's (N, K, K) same-label tensor is never built.
    """
    if nbr.shape[1] == 0:
        return labels.clone()
    mask = nbr >= 0                                             # (N, K)
    lab = torch.where(mask, labels[nbr.clamp(min=0).to(torch.int64)], -1)
    w = torch.where(mask, wgt, 0.0)
    scores = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
    zero = torch.zeros((), dtype=torch.float32, device=w.device)
    for k in range(nbr.shape[1]):
        scores = scores + torch.where(lab == lab[:, k:k + 1], w[:, k:k + 1],
                                      zero)
    scores = torch.where(mask, scores, -torch.inf)
    # argmax with tie -> smaller label: exact two-pass (max score, min label)
    smax = scores.amax(dim=1, keepdim=True)
    cand = torch.where((scores == smax) & mask, lab, su.I32_MAX)
    new = cand.amin(dim=1)
    return torch.where(mask.any(dim=1), new, labels).to(labels.dtype)

