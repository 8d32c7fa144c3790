"""Plain PyTorch version of the label-propagation round kernel (its
counterpart in the reference is ``repro/core/label_prop.py::ell_round``,
which ``repro/kernels/label_prop/ref.py`` is held to). The port keeps it
beside the kernel, so the kernel's package needs nothing of ``core``;
``repro_torch.core.label_prop`` re-exports it."""
from __future__ import annotations

import torch

I32_MAX = 2 ** 31 - 1       # int32's largest value, as core/segment_utils


def ell_round(labels, nbr, wgt, row0: int = 0):
    """One LP round over ELL adjacency — the plain version of the CUDA
    kernel ``lp_round`` (csrc/lp_round.cu).

    For node n with neighbour labels l_k and weights w_k:
      S(l_j) = sum_k w_k [l_k == l_j];  L* = argmax_j (S, -l_j).
    Nodes with no neighbours keep their label. The table may be the rows
    row0 .. row0 + N of a larger graph (neighbour ids global): row n is
    node row0 + n, and the result has the table's N rows.

    S is accumulated over k = 0..K-1 in order, adding exactly w_k or 0 per
    term, as the kernel does, so the two agree bit for bit. Memory stays
    O(N K): the reference's (N, K, K) same-label tensor is never built.
    """
    own = labels[row0:row0 + nbr.shape[0]]
    if nbr.shape[1] == 0:
        return own.clone()
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
    cand = torch.where((scores == smax) & mask, lab, I32_MAX)
    new = cand.amin(dim=1)
    return torch.where(mask.any(dim=1), new, own).to(labels.dtype)
