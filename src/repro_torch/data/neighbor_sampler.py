"""Real neighbour sampler for sampled-training GNN shapes (port of
``repro/data/neighbor_sampler.py``; minibatch_lg: fanout 15-10 over a
233k-node / 115M-edge graph).

Host-side CSR + per-layer uniform fanout sampling (GraphSAGE style), emitting
statically-shaped, locally-indexed subgraph blocks that the model consumes
once they are moved to its device. Padding uses self-loops on node 0 with
zero mask. It is the reference's numpy code: the same seed gives the same
blocks, bit for bit; a batch holding one of the graph's last nodes with no
in-edge, where the reference's index runs past the edge list and raises,
gets that node's slots masked as any degree-0 node's.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np


class SubgraphBlock(NamedTuple):
    """One message-passing layer block (dst nodes aggregate from src)."""
    src_nodes: np.ndarray   # i32[n_src] global ids (dst nodes come first)
    edge_src: np.ndarray    # i32[n_edges] local index into src_nodes
    edge_dst: np.ndarray    # i32[n_edges] local index into dst (0..n_dst-1)
    edge_mask: np.ndarray   # bool[n_edges]
    n_dst: int


class NeighborSampler:
    def __init__(self, src: np.ndarray, dst: np.ndarray, num_nodes: int,
                 seed: int = 0):
        order = np.argsort(dst, kind="stable")
        self._src = src[order].astype(np.int64)
        dsts = dst[order]
        self._indptr = np.zeros(num_nodes + 1, np.int64)
        np.add.at(self._indptr, dsts + 1, 1)
        self._indptr = np.cumsum(self._indptr)
        self.num_nodes = num_nodes
        self._rng = np.random.default_rng(seed)

    def _sample_layer(self, dst_nodes: np.ndarray, fanout: int) -> SubgraphBlock:
        n_dst = dst_nodes.shape[0]
        starts = self._indptr[dst_nodes]
        degs = self._indptr[dst_nodes + 1] - starts
        # uniform with replacement up to fanout; mask out degree-0 nodes
        offs = (self._rng.random((n_dst, fanout)) *
                np.maximum(degs, 1)[:, None]).astype(np.int64)
        # a degree-0 node's start may be the edge count (the last nodes'):
        # its masked slots read the last edge, where the reference's index
        # runs past the end and raises
        nbrs = self._src[np.minimum(starts[:, None] + offs,
                                    max(self._src.shape[0] - 1, 0))]
        mask = np.repeat(degs > 0, fanout)
        # local re-indexing: dst nodes first, then new unique srcs
        uniq, inv = np.unique(np.concatenate([dst_nodes, nbrs.ravel()]),
                              return_inverse=True)
        # remap so dst nodes occupy 0..n_dst-1
        lut = np.full(uniq.shape[0], -1, np.int64)
        lut[inv[:n_dst]] = np.arange(n_dst)
        extra = np.setdiff1d(np.arange(uniq.shape[0]), inv[:n_dst],
                             assume_unique=False)
        lut[extra] = n_dst + np.arange(extra.shape[0])
        src_nodes = np.empty(uniq.shape[0], np.int64)
        src_nodes[lut] = uniq
        edge_src = lut[inv[n_dst:]]
        edge_dst = np.repeat(np.arange(n_dst), fanout)
        return SubgraphBlock(src_nodes.astype(np.int32),
                             edge_src.astype(np.int32),
                             edge_dst.astype(np.int32),
                             mask, n_dst)

    def sample(self, batch_nodes: np.ndarray,
               fanouts: Sequence[int]) -> list[SubgraphBlock]:
        """Multi-layer blocks, outermost layer last (message flow order)."""
        blocks = []
        frontier = batch_nodes.astype(np.int64)
        for f in fanouts:
            blk = self._sample_layer(frontier, f)
            blocks.append(blk)
            frontier = blk.src_nodes.astype(np.int64)
        return list(reversed(blocks))
