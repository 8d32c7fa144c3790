"""Sort/segment primitives shared by the WindTunnel core (port of
``repro/core/segment_utils.py``).

Every MapReduce stage of Alg. 1 and 2 is a sort by key plus a reduce over
runs. Tables are fixed-length tensor bundles with a ``valid`` mask; masked
rows carry sentinel keys that sort last and are dropped on scatter.

Two JAX semantics are reproduced exactly:

* ``lax.sort(num_keys=..., is_stable=True)`` puts NaN last and, as the
  installed JAX runs it, keeps -0.0 and +0.0 as equal keys (stable order).
  Float keys are mapped to int64 keys with that order, and the
  lexicographic sort is a chain of stable sorts from the last key to the
  first.
* ``segment_max``/``segment_min`` return the reduction's identity (-inf,
  or the int32 min/max) for an empty segment; ``label_prop.sort_round``
  depends on the ``I32_MAX`` of an empty run.

``index_add_`` on a CUDA tensor uses atomics, so float sums there change
from run to run; :func:`segment_sum` on a CUDA float tensor instead
reduces over sorted runs with ``segment_reduce``, which has no atomics.
"""
from __future__ import annotations

import torch

I32_MAX = 2 ** 31 - 1
I32_MIN = -2 ** 31


def _order_key(k: torch.Tensor) -> torch.Tensor:
    """An int64 key whose ascending order is ``lax.sort``'s order of ``k``."""
    if k.dtype == torch.bool:
        return k.to(torch.int64)
    if k.is_floating_point():
        k = torch.where(k == 0, 0.0, k.to(torch.float32))   # -0.0 == +0.0
        bits = k.contiguous().view(torch.int32)
        bits = bits.to(torch.int64)
        # negative floats: flip the 31 value bits so larger magnitude sorts
        # first; the sign bit keeps them below every non-negative float
        return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return k.to(torch.int64)


def sort_by(keys: tuple, payloads: tuple = ()):
    """Lexicographic ascending stable sort by ``keys``, carrying
    ``payloads``. Returns (sorted_keys, sorted_payloads)."""
    n = keys[0].shape[0]
    perm = torch.arange(n, device=keys[0].device)
    for k in reversed(keys):
        _, idx = torch.sort(_order_key(k)[perm], stable=True)
        perm = perm[idx]
    return (tuple(k[perm] for k in keys), tuple(p[perm] for p in payloads))


def run_starts(*keys) -> torch.Tensor:
    """Boolean mask marking the first element of each run of equal keys
    (``keys`` already sorted lexicographically)."""
    n = keys[0].shape[0]
    changed = torch.zeros(max(n - 1, 0), dtype=torch.bool,
                          device=keys[0].device)
    for k in keys:
        changed = changed | (k[1:] != k[:-1])
    return torch.cat([torch.ones(min(n, 1), dtype=torch.bool,
                                 device=keys[0].device), changed])


def run_segment_ids(starts: torch.Tensor) -> torch.Tensor:
    """Map each position to the index of the run it belongs to (int64)."""
    return torch.cumsum(starts.to(torch.int64), 0) - 1


def group_rank(starts: torch.Tensor) -> torch.Tensor:
    """Rank of each element within its run (0-based, int64)."""
    iota = torch.arange(starts.shape[0], device=starts.device)
    if starts.shape[0] == 0:
        return iota
    group_start = torch.cummax(torch.where(starts, iota, 0), 0).values
    return iota - group_start


def in_range_rows(idx: torch.Tensor, n: int) -> torch.Tensor:
    """The rows of a scatter that ``mode="drop"`` keeps: 0 <= idx < n."""
    return (idx >= 0) & (idx < n)


def segment_sum(data, segment_ids, num_segments: int):
    """Sum of ``data`` per segment (0 for an empty segment).

    Sequential in index order on the CPU (XLA's scatter-add order there).
    On a CUDA float tensor the ids must be sorted, as every caller's are;
    the sum then runs over the runs without atomics."""
    ids = segment_ids.to(torch.int64)
    if data.is_cuda and data.is_floating_point():
        lengths = torch.bincount(ids, minlength=num_segments)[:num_segments]
        return torch.segment_reduce(data, "sum", lengths=lengths,
                                    unsafe=True, initial=0.0)
    out = torch.zeros(num_segments, dtype=data.dtype, device=data.device)
    return out.index_add_(0, ids, data)


def _identity(dtype, reduce: str):
    if dtype.is_floating_point:
        return float("-inf") if reduce == "amax" else float("inf")
    return I32_MIN if reduce == "amax" else I32_MAX


def _segment_reduce(data, segment_ids, num_segments, reduce):
    out = torch.full((num_segments,), _identity(data.dtype, reduce),
                     dtype=data.dtype, device=data.device)
    return out.scatter_reduce_(0, segment_ids.to(torch.int64), data, reduce,
                               include_self=False)


def segment_max(data, segment_ids, num_segments: int):
    return _segment_reduce(data, segment_ids, num_segments, "amax")


def segment_min(data, segment_ids, num_segments: int):
    return _segment_reduce(data, segment_ids, num_segments, "amin")
