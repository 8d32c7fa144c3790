from repro_torch.kernels.lsh_hamming import ref
from repro_torch.kernels.lsh_hamming.ops import HAMMING_TOPK, hamming_topk

__all__ = ["HAMMING_TOPK", "hamming_topk", "ref"]
