"""Data on PyTorch and numpy (port of ``repro.data``): synthetic corpora
and QRel generation, and token batching. ``NeighborSampler`` waits for
ROADMAP.md queue 1 item 15."""
from repro_torch.data.synthetic import (SyntheticCorpus, generate_corpus,
                                        generate_qrels)
from repro_torch.data.batching import TokenBatcher

__all__ = ["SyntheticCorpus", "generate_qrels", "generate_corpus",
           "TokenBatcher"]
