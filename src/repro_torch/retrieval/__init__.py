"""Retrieval on PyTorch (port of ``repro.retrieval``): the scoring-backend
registry, the exact, ivfflat, lsh and tf-idf engines, the search-core front
door, the tf-idf embedder and the IR metrics."""
