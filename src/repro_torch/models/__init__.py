"""Models on PyTorch (port of ``repro.models``): the dense transformer's
forward path, which the retrieval encoder runs."""
