from repro_torch.kernels.topk_scoring import ref
from repro_torch.kernels.topk_scoring.ops import (GATHERED_PARTIAL,
                                                  TOPK_INT8_PARTIAL,
                                                  TOPK_MERGE, TOPK_PARTIAL,
                                                  gathered_topk, topk_scores,
                                                  topk_scores_int8)

__all__ = ["GATHERED_PARTIAL", "TOPK_INT8_PARTIAL", "TOPK_MERGE",
           "TOPK_PARTIAL", "gathered_topk", "ref", "topk_scores",
           "topk_scores_int8"]
