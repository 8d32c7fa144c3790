"""Embedding model of the semantic-search pipeline (port of
``repro/retrieval/encoder.py``, paper Fig. 5).

A bidirectional transformer encoder (``models/transformer`` with
``causal=False``) trained with an in-batch InfoNCE contrastive loss on
(query, passage) pairs. Training runs the plain attention under autograd,
as the reference does. ``embed_corpus`` runs without gradients and, on a
CUDA device, routes attention through the flash-attention kernel (the
reference's own ``use_flash_kernel=True`` route); on the CPU it runs the
plain attention.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import prng
from repro_torch.device import resolve_device
from repro_torch.models.transformer import (TransformerConfig, encode,
                                            init_transformer, tree_to)


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 4096
    d_model: int = 128
    n_layers: int = 4
    n_heads: int = 4
    d_ff: int = 512
    dtype: Any = torch.float32

    def transformer(self) -> TransformerConfig:
        return TransformerConfig(
            vocab_size=self.vocab_size, d_model=self.d_model,
            n_layers=self.n_layers, n_heads=self.n_heads,
            n_kv_heads=self.n_heads, d_ff=self.d_ff, causal=False,
            tie_embeddings=True, activation="geglu", dtype=self.dtype)


def init_encoder(key: prng.Key, cfg: EncoderConfig, device="cuda"):
    """The reference's initial parameters from the same key, on
    ``device``."""
    return init_transformer(key, cfg.transformer(), resolve_device(device))


def embed_tokens(params, tokens, cfg: EncoderConfig):
    """tokens (B, S) -> L2-normalised embeddings (B, D), plain attention."""
    return encode(params, tokens, cfg.transformer())


def contrastive_loss(params, batch, cfg: EncoderConfig,
                     temperature: float = 0.05):
    """InfoNCE with in-batch negatives + optional mined same-community hard
    negatives (``negative_tokens``); the second term is the diagonal of
    the column log-softmax, as in the reference."""
    q = embed_tokens(params, batch["query_tokens"], cfg)     # (B, D)
    p = embed_tokens(params, batch["passage_tokens"], cfg)   # (B, D)
    logits = (q @ p.T) / temperature                          # (B, B)
    if "negative_tokens" in batch:
        n = embed_tokens(params, batch["negative_tokens"], cfg)
        hard = torch.sum(q * n, dim=-1, keepdim=True) / temperature
        logits_q = torch.cat([logits, hard], dim=1)           # (B, B+1)
    else:
        logits_q = logits
    diag = torch.arange(q.shape[0], device=q.device)
    logq = F.log_softmax(logits_q, dim=-1)
    logp = F.log_softmax(logits, dim=0)
    return -(logq[diag, diag].mean() + logp[diag, diag].mean()) / 2


def embed_corpus(params, tokens: np.ndarray, cfg: EncoderConfig,
                 batch_size: int = 256, device="cuda") -> np.ndarray:
    """Batched embedding of a full corpus (the offline indexing stage of
    Fig. 5) on ``device``: the tokens go to the device once, each batch of
    ``batch_size`` rows is encoded without gradients, and the embeddings
    come back to the host once, as f32 (N, d_model) numpy. Attention takes
    the flash-attention kernel on a CUDA device and the plain version on
    the CPU."""
    dev = resolve_device(device)
    tcfg = dataclasses.replace(cfg.transformer(),
                               use_flash_kernel=dev.type == "cuda")
    params = tree_to(params, dev)
    toks = torch.as_tensor(np.asarray(tokens)).to(dev)
    n = toks.shape[0]
    with torch.no_grad():
        out = [encode(params, toks[i:i + batch_size], tcfg)
               for i in range(0, n, batch_size)]
    if not out:
        return np.zeros((0, cfg.d_model), np.float32)
    return torch.cat(out).cpu().numpy()
