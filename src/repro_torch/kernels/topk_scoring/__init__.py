from repro_torch.kernels.topk_scoring import ref
from repro_torch.kernels.topk_scoring.ops import (TOPK_INT8_PARTIAL,
                                                  TOPK_MERGE, TOPK_PARTIAL,
                                                  topk_scores,
                                                  topk_scores_int8)

__all__ = ["TOPK_INT8_PARTIAL", "TOPK_MERGE", "TOPK_PARTIAL", "ref",
           "topk_scores", "topk_scores_int8"]
