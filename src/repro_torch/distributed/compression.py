"""Error-feedback gradient compression for the cross-pod all-reduce (port
of ``repro/distributed/compression.py``).

Grads are quantised per leaf to int8 with a per-leaf f32 scale; the
quantisation residual is carried in the error buffer and added back next
step. :func:`compressed_grad_allreduce` sums the dequantised leaves over
the mesh's ``pod`` process group. ``quantize_int8`` is also the int8
scoring backend's corpus and query quantizer (retrieval/backends.py).
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils import _pytree as pytree

from repro_torch.distributed.collectives import all_reduce, axis_size


def ef_init(grads_like: Any):
    return pytree.tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads_like)


def quantize_int8(x: torch.Tensor):
    """Symmetric per-tensor int8 quantization: codes in [-127, 127] and
    the f32 scale max|x| / 127 + 1e-30 (round half to even, as
    ``jnp.round``)."""
    scale = x.abs().max() / 127.0 + 1e-30
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_leaf(g: torch.Tensor, err: torch.Tensor):
    """Error-feedback int8 compression of one gradient leaf.
    Returns (q, scale, new_err)."""
    corrected = g.to(torch.float32) + err
    q, scale = quantize_int8(corrected)
    new_err = corrected - dequantize_int8(q, scale)
    return q, scale, new_err


def compressed_grad_allreduce(grads: Any, err: Any, mesh,
                              axis_name: str = "pod"):
    """All-reduce grads over the ``axis_name`` group in int8 with error
    feedback. Returns (mean grads, new err)."""
    n = float(axis_size(mesh, axis_name))

    def leaf(g, e):
        q, scale, new_e = compress_leaf(g, e)
        summed = all_reduce(dequantize_int8(q, scale), mesh, axis_name)
        return (summed / n).to(g.dtype), new_e

    flat_g, spec = pytree.tree_flatten(grads)
    out = [leaf(g, e) for g, e in zip(flat_g, pytree.tree_leaves(err))]
    return (pytree.tree_unflatten([t[0] for t in out], spec),
            pytree.tree_unflatten([t[1] for t in out], spec))


def topk_sparsify(g: torch.Tensor, err: torch.Tensor, frac: float = 0.01):
    """Top-k sparsification with error feedback (deep gradient
    compression): returns (sent, new_err)."""
    corrected = g.to(torch.float32) + err
    flat = corrected.reshape(-1)
    k = max(1, int(frac * flat.shape[0]))
    thresh = torch.sort(flat.abs()).values[-k]
    mask = corrected.abs() >= thresh
    sent = torch.where(mask, corrected, 0.0)
    return sent, corrected - sent
