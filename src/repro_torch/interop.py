"""Carry state across from the JAX package as numpy arrays.

Plain functions that build the port's structures from any array-likes —
the reference's ``QRelTable`` / ``EdgeList`` / ``IVFFlatIndex`` /
``LSHIndex`` fields, labels, entity and query vectors — via
``np.asarray``, so the port never imports the reference. The parity tests
use them to feed both packages the same state; the synthetic corpus needs
none of this, being numpy in both packages and identical from the same
seed.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.graph_builder import EdgeList, QRelTable
from repro_torch.retrieval.ivfflat import IVFFlatIndex
from repro_torch.retrieval.lsh import LSHIndex


def tensor(x, dtype: torch.dtype, device="cpu") -> torch.Tensor:
    """An array-like as a contiguous tensor of ``dtype`` on ``device``."""
    return torch.from_numpy(np.array(x)).to(device=device, dtype=dtype)


def qrel_table(table, device="cpu") -> QRelTable:
    """(query_ids, entity_ids, scores, valid) -> the port's QRelTable."""
    q, e, s, v = table
    return QRelTable(tensor(q, torch.int32, device),
                     tensor(e, torch.int32, device),
                     tensor(s, torch.float32, device),
                     tensor(v, torch.bool, device))


def edge_list(edges, device="cpu") -> EdgeList:
    """(u, v, w, valid) -> the port's EdgeList."""
    u, v, w, valid = edges
    return EdgeList(tensor(u, torch.int32, device),
                    tensor(v, torch.int32, device),
                    tensor(w, torch.float32, device),
                    tensor(valid, torch.bool, device))


def labels(x, device="cpu") -> torch.Tensor:
    """Community labels / node ids as int32."""
    return tensor(x, torch.int32, device)


def vectors(x, device="cpu") -> torch.Tensor:
    """Entity or query vectors as float32 (N, D)."""
    return tensor(x, torch.float32, device)


def ivfflat_index(index, device="cpu") -> IVFFlatIndex:
    """(centroids, vecs, ids, mask) -> the port's IVFFlatIndex."""
    cent, vecs, ids, mask = index
    return IVFFlatIndex(tensor(cent, torch.float32, device),
                        tensor(vecs, torch.float32, device),
                        tensor(ids, torch.int32, device),
                        tensor(mask, torch.bool, device))


def lsh_index(index, device="cpu") -> LSHIndex:
    """(proj, codes, vecs) -> the port's LSHIndex."""
    proj, codes, vecs = index
    return LSHIndex(tensor(proj, torch.float32, device),
                    tensor(codes, torch.int32, device),
                    tensor(vecs, torch.float32, device))


def to_numpy(x) -> np.ndarray:
    """A tensor (any device) or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
