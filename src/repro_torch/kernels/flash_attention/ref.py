"""Plain PyTorch version of the flash-attention kernel (port of
``repro/kernels/flash_attention/ref.py``): naive GQA softmax attention
with causal and window masks, masked logits at -1e30 as the reference sets
them."""
from __future__ import annotations

import math

import torch


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window=None) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, Skv, Hkv, D) with H % Hkv == 0 ->
    (B, Sq, H, D) in v's type. Scores and the softmax are f32; the
    probabilities are cast to v's type before the second product, as in
    the reference."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qh = q.reshape(b, sq, hkv, g, d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qh, k).to(torch.float32)
    s = s / math.sqrt(d)
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= kp > qp - window
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype), v)
    return out.reshape(b, sq, h, d)
