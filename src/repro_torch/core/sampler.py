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


def xla_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of a 1-d f32 tensor in the order XLA:CPU sums ``jnp.sum`` (as
    installed: jax 0.9). XLA rewrites a long reduction into windows of 32:
    the vector is padded with zeros to a multiple of 32, half the padding
    in front (the odd one at the back), each window is summed left to
    right, and the window sums are reduced the same way until at most 32
    remain, which are summed left to right. Each step here is an f32 add,
    so the result is the reference's bit for bit on either device."""
    while x.numel() > 32:
        pad = -x.numel() % 32
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
        win = x.reshape(-1, 32)
        acc = torch.zeros(win.shape[0], dtype=x.dtype, device=x.device)
        for j in range(32):
            acc = acc + win[:, j]
        x = acc
    acc = torch.zeros((), dtype=x.dtype, device=x.device)
    for j in range(x.numel()):
        acc = acc + x[j]
    return acc


def _calibrate_scale(sizes: torch.Tensor, n_total: torch.Tensor,
                     target, iters: int = 40) -> torch.Tensor:
    """Bisection for c with sum_L min(1, c*|L|/N) * |L| == target, in f32
    as the reference runs it, its sum in the reference's order
    (:func:`xla_sum`), so c is the reference's bit for bit."""
    sizes_f = sizes.to(torch.float32)
    target = torch.as_tensor(target, dtype=torch.float32,
                             device=sizes.device)
    lo = torch.zeros((), dtype=torch.float32, device=sizes.device)
    hi = n_total.to(torch.float32).clone()
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        p = torch.clamp(mid * sizes_f / n_total, max=1.0)
        too_small = xla_sum(p * sizes_f) < target
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

