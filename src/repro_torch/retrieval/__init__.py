"""Retrieval on PyTorch (port of ``repro.retrieval``): the scoring-backend
registry, the exact and tf-idf engines, the search-core front door, the
tf-idf embedder and the IR metrics. ivfflat and lsh are still to be ported
(ROADMAP queue 1 items 8-9)."""
