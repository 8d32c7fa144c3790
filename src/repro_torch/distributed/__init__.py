"""Distributed runtime on ``torch.distributed`` (port of
``repro.distributed``): logical-axis sharding rules (DP/TP/EP/SP) over a
``DeviceMesh``, error-feedback gradient compression for the cross-pod
all-reduce, collective helpers and sharded-from-birth corpora."""
from repro_torch.distributed.sharding import (GNN_RULES, LM_RULES,
                                              RECSYS_RULES, logical_to_spec,
                                              tree_shardings)

__all__ = ["tree_shardings", "logical_to_spec", "LM_RULES", "RECSYS_RULES",
           "GNN_RULES"]
