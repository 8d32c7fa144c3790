"""Architecture registry (port of ``repro.configs``): one module per
assigned architecture (exact public-literature configs) + the paper's own
experiment config.

``get_arch(arch_id)`` returns the ArchSpec; each config module builds the
port's config class (``TransformerConfig``, ``MACEConfig``,
``RecsysConfig``) with torch dtypes, field for field the reference's.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Dict, Optional

ARCH_IDS = [
    "llama4-scout-17b-a16e",
    "mixtral-8x22b",
    "starcoder2-7b",
    "gemma-2b",
    "yi-9b",
    "mace",
    "autoint",
    "dcn-v2",
    "dien",
    "dlrm-mlperf",
]

_MODULES = {
    "llama4-scout-17b-a16e": "llama4_scout",
    "mixtral-8x22b": "mixtral_8x22b",
    "starcoder2-7b": "starcoder2_7b",
    "gemma-2b": "gemma_2b",
    "yi-9b": "yi_9b",
    "mace": "mace",
    "autoint": "autoint",
    "dcn-v2": "dcn_v2",
    "dien": "dien",
    "dlrm-mlperf": "dlrm_mlperf",
}

@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                       # lm | gnn | recsys
    make_config: Callable[[], Any]    # full published config
    make_reduced: Callable[[], Any]   # smoke-test config
    shapes: Dict[str, dict]           # shape name -> shape params
    skip_shapes: tuple = ()           # e.g. long_500k for full-attention
    notes: str = ""
    rules_override: Optional[dict] = None  # per-arch sharding-rule deltas


def get_arch(arch_id: str) -> ArchSpec:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.SPEC


def list_archs():
    return list(ARCH_IDS)


def iter_cells(include_skipped: bool = False):
    """All (arch_id, shape_name) dry-run cells."""
    for a in ARCH_IDS:
        spec = get_arch(a)
        for s in spec.shapes:
            if not include_skipped and s in spec.skip_shapes:
                continue
            yield a, s


# LM-family shared input shapes (seq_len x global_batch)
LM_SHAPES = {
    "train_4k": {"kind": "train", "seq_len": 4096, "global_batch": 256},
    "prefill_32k": {"kind": "prefill", "seq_len": 32768, "global_batch": 32},
    "decode_32k": {"kind": "decode", "seq_len": 32768, "global_batch": 128},
    "long_500k": {"kind": "decode", "seq_len": 524288, "global_batch": 1},
}

RECSYS_SHAPES = {
    "train_batch": {"kind": "train", "batch": 65536},
    "serve_p99": {"kind": "serve", "batch": 512},
    "serve_bulk": {"kind": "serve", "batch": 262144},
    "retrieval_cand": {"kind": "retrieval", "batch": 1,
                       "n_candidates": 1_000_000},
}

GNN_SHAPES = {
    # citation/product graphs are node-prediction benchmarks -> node loss;
    # the molecular cell trains the physical objective (energy + forces)
    "full_graph_sm": {"kind": "train_node", "n_nodes": 2708, "n_edges": 10556,
                      "d_feat": 1433, "n_graphs": 1},
    "minibatch_lg": {"kind": "train_sampled", "n_nodes": 232965,
                     "n_edges": 114615892, "batch_nodes": 1024,
                     "fanouts": (15, 10)},
    "ogb_products": {"kind": "train_node", "n_nodes": 2449029,
                     "n_edges": 61859140, "d_feat": 100, "n_graphs": 1},
    "molecule": {"kind": "train", "n_nodes": 30, "n_edges": 64,
                 "batch": 128},
}
