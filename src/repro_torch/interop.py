"""Carry state across from the JAX package as numpy arrays.

Plain functions that build the port's structures from any array-likes —
the reference's ``QRelTable`` / ``EdgeList`` / ``IVFFlatIndex`` /
``LSHIndex`` fields, labels, entity and query vectors, model parameter
trees (transformer, recsys, MACE), KV caches and AdamW state — via
``np.asarray``, so the port never
imports the reference. The parity tests use them to feed both packages
the same state; the synthetic corpus needs none of this, being numpy in
both packages and identical from the same seed.
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


def model_params(tree, device="cpu"):
    """The reference's parameter tree (nested dicts with str or int keys,
    lists, array leaves: a transformer's, a recsys ranker's, MACE's) as
    the port's tree of tensors, leaf for leaf."""
    if isinstance(tree, dict):
        return {k: model_params(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [model_params(v, device) for v in tree]
    leaf = np.array(tree)
    if leaf.dtype.name == "bfloat16":     # ml_dtypes': torch reads its bits
        return torch.from_numpy(leaf.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(leaf).to(device)


#: the transformer's tree (``embed``, ``layers`` stacked ``(L, ...)``,
#: ``ln_f``, maybe ``lm_head``) is one such tree
transformer_params = model_params


def kv_cache(cache, device="cpu"):
    """The reference's KV cache ``{"k", "v": (L, B, S, Hkv, Dh), "pos":
    (B,)}`` as the port's (``k``/``v`` in their own dtype, ``pos``
    int32)."""
    return {"k": model_params(cache["k"], device),
            "v": model_params(cache["v"], device),
            "pos": tensor(cache["pos"], torch.int32, device)}


def adamw_state(state, device="cpu"):
    """The reference's AdamW state ``{"m", "v", "step"}`` as the port's."""
    return {"m": model_params(state["m"], device),
            "v": model_params(state["v"], device),
            "step": tensor(state["step"], torch.int32, device)}


def to_numpy(x) -> np.ndarray:
    """A tensor (any device) or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
