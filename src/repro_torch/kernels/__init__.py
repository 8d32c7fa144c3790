"""Hand-written CUDA kernels of the port (sources in ``../csrc``), each
beside its plain PyTorch version. Nothing is built or loaded at import."""
