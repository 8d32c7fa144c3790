"""Data on PyTorch and numpy (port of ``repro.data``): synthetic corpora
and QRel generation, token batching and neighbour sampling."""
from repro_torch.data.synthetic import (SyntheticCorpus, generate_corpus,
                                        generate_qrels)
from repro_torch.data.batching import TokenBatcher
from repro_torch.data.neighbor_sampler import NeighborSampler

__all__ = ["SyntheticCorpus", "generate_qrels", "generate_corpus",
           "TokenBatcher", "NeighborSampler"]
