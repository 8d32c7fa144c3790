"""Dispatch wrapper for the flash-attention kernel (port of
``repro/kernels/flash_attention/ops.py``).

On CPU tensors the wrapper runs the plain version (ref.py); on CUDA tensors
it launches ``flash_attention`` of csrc/flash_attention.cu or raises. It
pads nothing: the kernel masks query rows past Sq and keys past Skv itself,
where the reference pads both to its block sizes and, when bidirectional,
hides the padded keys behind a sentinel dimension. It reads the (B, S, H,
D) layout through strides, so no transposed copy is made, and reads GQA's
kv head ``h // (H / Hkv)`` in place.

The TPU kernel has no gradient, and neither has this one: asking for one
raises rather than detaching in silence.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.build import Kernel
from repro_torch.kernels.flash_attention import ref

FLASH_ATTENTION = Kernel("flash_attention", "flash_attention.cu",
                         (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 18
                         + (ctypes.c_float,))
HEAD_DIMS = (16, 32, 64, 128)
# flash_short_tc's reach (kRDim, kRMaxKeys in csrc/flash_attention.cu,
# pinned by tests/test_torch_flash_tiles.py): f32 rows of TC_HEAD_DIM
# values against 1 to TC_MAX_KEYS keys
TC_HEAD_DIM = 32
TC_MAX_KEYS = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _no_grad_asked(*ts: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError(
            "flash_attention has no gradient (nor has the TPU kernel it "
            "ports); call it under torch.no_grad() or use the model's "
            "plain attention for training")


def _bad_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """Why q, k and v cannot go to the kernel, or '' if they can."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4 or t.dtype != q.dtype or t.device != q.device:
            return (f"{name} must be a 4-d {q.dtype} tensor on {q.device}, "
                    f"got {t.dim()}-d {t.dtype} on {t.device}")
        if t.stride(3) != 1:
            return f"{name} needs unit stride along D, got {t.stride()}"
    return ""


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, window=None) -> torch.Tensor:
    """Launch the kernel: q (B, Sq, H, D), k/v (B, Skv, Hkv, D) CUDA
    tensors of one type (f32 or bf16), unit stride along D, D in
    ``HEAD_DIMS`` -> a new contiguous (B, Sq, H, D) tensor.

    The checks run once a launch (the embedding path launches 8712 times),
    so the common case takes one test per property; the loop that names
    the fault runs only when one fails."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got {dev}")
    dtype = _DTYPES.get(q.dtype)
    if dtype is None:
        raise ValueError(f"flash_attention: type {q.dtype} is not one of "
                         f"{tuple(_DTYPES)}")
    qs, ks, vs = q.stride(), k.stride(), v.stride()
    if not (k.dtype == v.dtype == q.dtype and k.device == v.device == dev
            and q.dim() == k.dim() == v.dim() == 4
            and qs[3] == ks[3] == vs[3] == 1):
        raise ValueError(f"flash_attention: {_bad_operands(q, k, v)}")
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if hkv == 0 or h % hkv:
        raise ValueError(f"flash_attention: {h} heads over {hkv} kv heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: D={d} is not one of {HEAD_DIMS}")
    if max(b * h, sq, skv, *qs, *ks, *vs) >= 2 ** 31:
        raise ValueError("flash_attention: sizes or strides exceed the "
                         "kernel's int arguments")
    if window is not None and window < 0:
        raise ValueError(f"flash_attention: window={window} is negative")
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        FLASH_ATTENTION(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), b, sq, skv, h, hkv, d, qs[0], qs[1],
                        qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
                        int(bool(causal)),
                        -1 if window is None else int(window), dtype,
                        1.0 / math.sqrt(d))
    return out


def kernel_name(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel of csrc/flash_attention.cu that a launch on these
    operands runs, as its dispatch (``launch_d``) picks it: what a profile
    of the call shows. The C entry point alone decides; this restates its
    rule for the card's checks."""
    skv = k.shape[1]
    vw = 16 // q.element_size()
    ts = (q, k, v)
    vec = all(t.data_ptr() % 16 == 0 and all(s % vw == 0
                                              for s in t.stride()[:3])
              for t in ts)
    if skv > 128:
        return ("flash_long_tc" if q.dtype == torch.bfloat16 and vec
                else "flash_long")
    if (q.dtype == torch.float32 and q.shape[3] == TC_HEAD_DIM and vec
            and 1 <= skv <= TC_MAX_KEYS
            and all(s > 0 for t in ts for s in t.stride()[:3])):
        return "flash_short_tc"
    return "flash_short"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos=None, k_pos=None, *, causal: bool = True,
                    window=None) -> torch.Tensor:
    """Drop-in for ``models.transformer.attention`` (self-attention:
    ``q_pos == k_pos == arange``, so the positions are not read, as in the
    reference). The kernel on CUDA tensors, the plain version on CPU
    tensors."""
    del q_pos, k_pos
    _no_grad_asked(q, k, v)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    return flash_attention_cuda(q, k, v, causal=causal, window=window)
