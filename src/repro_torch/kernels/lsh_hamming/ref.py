"""Plain PyTorch version of the Hamming top-k kernel (port of
``repro/kernels/lsh_hamming/ref.py``)."""
from __future__ import annotations

import torch

from repro_torch.kernels.topk_scoring.ref import blocked_topk

_M32 = 0xFFFFFFFF


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word (as uint32), branch-free, as int64."""
    x = x.to(torch.int64) & _M32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _M32) >> 24


def _neg_hamming(q_codes: torch.Tensor, c_codes: torch.Tensor):
    """-distance f32 [Q, B] between packed codes (Q, W) and (B, W), a word
    at a time so no (Q, B, W) tensor exists."""
    dist = torch.zeros((q_codes.shape[0], c_codes.shape[0]),
                       dtype=torch.int64, device=q_codes.device)
    for w in range(q_codes.shape[1]):
        dist += popcount32(q_codes[:, w, None] ^ c_codes[None, :, w])
    return -dist.to(torch.float32)


def hamming_topk_ref(q_codes: torch.Tensor, c_codes: torch.Tensor, *, k: int,
                     block: int = 4096):
    """Packed codes i32 (Q, W) x (N, W) -> top-k of -Hamming distance
    (scores f32[Q, k], ids i32[Q, k]), over blocks of the corpus; ties (the
    rule, distances being small integers) go to the lowest id, as
    ``lax.top_k`` gives them. A k beyond N leaves -inf / -1 in the tail."""
    return blocked_topk(_neg_hamming, q_codes, c_codes, k=k, block=block)
