from repro_torch.kernels.lsh_hamming import ref
from repro_torch.kernels.lsh_hamming.ops import HAMMING_PARTIAL, hamming_topk

__all__ = ["HAMMING_PARTIAL", "hamming_topk", "ref"]
