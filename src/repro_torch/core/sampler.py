"""GraphSampler step 4 — cluster sampling of communities (Algorithm 2),
port of ``repro/core/sampler.py``.

Paper semantics: after label propagation, 'Emit L with probability |L|/N'
where |L| is the community size and N the total entity count. A kept label
brings ALL of its entities into the sample (cluster sampling).

``target_size`` calibration (beyond the paper): keep-probabilities
p_L = min(1, c*|L|/N), with c found by bisection so E[size] hits the
target; c = 1 recovers the paper exactly.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import prng
from repro_torch.core import segment_utils as su


class ClusterSample(NamedTuple):
    entity_mask: torch.Tensor      # bool[num_nodes] kept entities
    label_kept: torch.Tensor       # bool[num_nodes] per-label keep decision
    community_sizes: torch.Tensor  # i32[num_nodes] |L| per label id
    keep_prob: torch.Tensor        # f32[num_nodes] p_L actually used


def _calibrate_scale(sizes: torch.Tensor, n_total: torch.Tensor,
                     target, iters: int = 40) -> torch.Tensor:
    """Bisection for c with sum_L min(1, c*|L|/N) * |L| == target, in f32
    as the reference runs it. The f32 sum's reduction order differs from
    XLA's, so c may differ in its last bits; a mask difference that follows
    is a fault to diagnose, not a tolerance."""
    sizes_f = sizes.to(torch.float32)
    target = torch.as_tensor(target, dtype=torch.float32,
                             device=sizes.device)
    lo = torch.zeros((), dtype=torch.float32, device=sizes.device)
    hi = n_total.to(torch.float32).clone()
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        p = torch.clamp(mid * sizes_f / n_total, max=1.0)
        too_small = (p * sizes_f).sum() < target
        lo = torch.where(too_small, mid, lo)
        hi = torch.where(too_small, hi, mid)
    return 0.5 * (lo + hi)


def cluster_sample(labels: torch.Tensor, key: prng.Key, *, num_nodes: int,
                   target_size=None,
                   eligible: Optional[torch.Tensor] = None) -> ClusterSample:
    """Sample communities. ``labels`` from label propagation.

    The Bernoulli draw is keyed per label id, so the decision for a
    community is a pure function of (key, label). ``eligible`` restricts the
    sampling universe to nodes that appear in the affinity graph.
    """
    if eligible is None:
        eligible = torch.ones_like(labels, dtype=torch.bool)
    lab_e = torch.where(eligible, labels, num_nodes)
    sizes = su.segment_sum(torch.ones_like(labels), lab_e,
                           num_nodes + 1)[:num_nodes]
    n_total = torch.clamp(eligible.to(torch.float32).sum(), min=1.0)
    p = sizes.to(torch.float32) / n_total          # the paper's |L|/N
    if target_size is not None:
        c = _calibrate_scale(sizes, n_total, target_size)
        p = torch.clamp(c * p, max=1.0)
    unif = prng.uniform(key, (num_nodes,), labels.device)
    label_kept = (unif < p) & (sizes > 0)
    entity_mask = label_kept[labels.to(torch.int64)] & eligible
    return ClusterSample(entity_mask, label_kept, sizes, p)

