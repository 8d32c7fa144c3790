"""The dense transformer's forward path (port of
``repro/models/transformer.py``).

Parameters are a dict of tensors with the reference's names and stacked
``(L, ...)`` layers, so carrying weights across from the JAX package is a
1:1 map (``interop.transformer_params``). Matrices keep JAX's ``x @ w``
orientation. The layer stack is a Python loop in place of ``lax.scan``.

Attention has the reference's three routes: the naive reference, the
blocked online-softmax version above ``block_q`` tokens, and, with
``use_flash_kernel=True``, the flash-attention wrapper (the hand-written
CUDA kernel on CUDA tensors, its plain version on CPU tensors). The kernel
has no gradient, so that route serves inference only: the retrieval
encoder takes it when it embeds a corpus on the card, and trains on the
plain routes under autograd, as the reference does.

Not ported here: ``prefill``, ``decode_step`` and the KV cache,
``moe_ffn``, ``remat="full"``, the activation sharding constraints and
``lm_loss`` (ROADMAP queue 1 item 15, with model-parallel training). A
config that needs one of them raises.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import prng
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import ops as flash_ops


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    d_head: Optional[int] = None          # default d_model // n_heads
    activation: str = "swiglu"            # swiglu | geglu | gelu
    moe: Optional[MoEConfig] = None       # not ported: raises
    rope_theta: float = 10_000.0
    window: Optional[int] = None          # sliding-window attention size
    attention_chunk: Optional[int] = None  # llama4-style chunked attention
    causal: bool = True                   # False -> bidirectional encoder
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    embed_scale: bool = False             # gemma scales embeds by sqrt(d)
    dtype: Any = torch.bfloat16           # activation/compute dtype
    param_dtype: Any = torch.float32
    remat: str = "none"                   # only "none" is ported
    block_q: int = 1024                   # blocked-attention thresholds
    block_kv: int = 1024
    vocab_chunks: int = 1                 # lm_loss's blocked CE: raise if > 1
    use_flash_kernel: bool = False        # route attention to the kernel
    act_batch_axes: Optional[tuple] = None  # sharding constraints: raise
    act_model_axis: Optional[str] = None    # unless left at their defaults
    attn_shard: str = "heads"
    seq_parallel: bool = False

    @property
    def head_dim(self) -> int:
        if self.d_head is not None:
            return self.d_head
        return self.d_model // self.n_heads


def check_ported(cfg: TransformerConfig) -> None:
    """Raise if ``cfg`` needs what this port leaves out."""
    if cfg.moe is not None:
        raise NotImplementedError(
            "the MoE FFN is not ported to PyTorch yet (ROADMAP.md queue 1 "
            "item 15); use a dense config")
    if cfg.remat != "none":
        raise NotImplementedError(
            f"remat={cfg.remat!r} is not ported to PyTorch; use 'none'")
    if (cfg.act_batch_axes is not None or cfg.act_model_axis is not None
            or cfg.attn_shard != "heads" or cfg.seq_parallel):
        raise NotImplementedError(
            "activation sharding constraints are not ported to PyTorch yet "
            "(ROADMAP.md queue 1 item 15); leave act_batch_axes and "
            "act_model_axis None, attn_shard 'heads' and seq_parallel False")
    if cfg.vocab_chunks != 1:
        raise NotImplementedError(
            "the blocked cross-entropy of lm_loss is not ported to PyTorch "
            "yet (ROADMAP.md queue 1 item 15); leave vocab_chunks 1")


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def _dense_init(key, shape, in_axis, dtype):
    fan_in = np.prod([shape[a] for a in np.atleast_1d(in_axis)])
    return (prng.normal(key, shape) / float(np.sqrt(fan_in))).to(dtype)


def init_transformer(key: prng.Key, cfg: TransformerConfig, device="cuda"):
    """The reference's parameter tree from the same key, drawn on the CPU
    (so every device starts from the same values) and moved to ``device``,
    the card unless ``device="cpu"``."""
    check_ported(cfg)
    device = resolve_device(device)
    dh, h, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    L, D, F_, V = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
    pd = cfg.param_dtype
    keys = prng.split(key, 12)
    glu = cfg.activation in ("swiglu", "geglu")
    wi_cols = 2 * F_ if glu else F_

    layers = {
        "ln1": torch.ones((L, D), dtype=pd),
        "ln2": torch.ones((L, D), dtype=pd),
        "wq": _dense_init(keys[0], (L, D, h * dh), 1, pd),
        "wk": _dense_init(keys[1], (L, D, hkv * dh), 1, pd),
        "wv": _dense_init(keys[2], (L, D, hkv * dh), 1, pd),
        "wo": _dense_init(keys[3], (L, h * dh, D), 1, pd),
        "wi": _dense_init(keys[4], (L, D, wi_cols), 1, pd),
        "wo_ff": _dense_init(keys[5], (L, F_, D), 1, pd),
    }
    params = {
        "embed": _dense_init(keys[9], (V, D), 1, pd),
        "layers": layers,
        "ln_f": torch.ones((D,), dtype=pd),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _dense_init(keys[10], (D, V), 0, pd)
    return tree_to(params, device)


def tree_to(tree, device):
    """A parameter tree (nested dicts of tensors) moved to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (B, S) absolute token positions."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs          # (B,S,half)
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


# ---------------------------------------------------------------------------
# Attention (naive reference + blocked online-softmax + the kernel)
# ---------------------------------------------------------------------------

def _mask_fn(cfg: TransformerConfig):
    """(q_pos, k_pos) -> allowed (bool), broadcasting over tensors."""
    def allowed(qp, kp):
        m = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                       dtype=torch.bool, device=qp.device)
        if cfg.causal:
            m &= kp <= qp
        if cfg.window is not None:
            m &= kp > qp - cfg.window
        if cfg.attention_chunk is not None:
            m &= (kp // cfg.attention_chunk) == (qp // cfg.attention_chunk)
        return m
    return allowed


def expand_kv(k, n_heads):
    """GQA kv (B,S,Hkv,Dh) -> flat (B,S,H,Dh)."""
    g = n_heads // k.shape[2]
    return torch.repeat_interleave(k, g, dim=2) if g > 1 else k


def attention_naive(q, k, v, q_pos, k_pos, cfg, k_valid=None):
    """q, k, v: (B,S,H,Dh) (kv pre-expanded). Returns (B,Sq,H,Dh)."""
    dh = q.shape[-1]
    logits = torch.einsum("bqhd,bshd->bhqs", q, k).to(torch.float32)
    logits = logits * (1.0 / np.sqrt(dh))
    mask = _mask_fn(cfg)(q_pos[:, None, :, None], k_pos[:, None, None, :])
    if k_valid is not None:
        mask &= k_valid[:, None, None, :]
    logits = torch.where(mask, logits, -1e30)
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqs,bshd->bqhd", p, v)


def attention_blocked(q, k, v, q_pos, k_pos, cfg, k_valid=None):
    """Online-softmax attention over KV blocks, never materialising the
    (Sq, Sk) score matrix. q, k, v: (B,S,H,Dh) flat-H (kv pre-expanded)."""
    b, sq, h, dh = q.shape
    sk = k.shape[1]
    bk = min(cfg.block_kv, sk)
    n_blocks = (sk + bk - 1) // bk
    pad = n_blocks * bk - sk
    kv_ok = (torch.ones((b, sk), dtype=torch.bool, device=q.device)
             if k_valid is None else k_valid)
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=-1)
        kv_ok = torch.cat([kv_ok, kv_ok.new_zeros((b, pad))], 1)

    qh = (q * (1.0 / np.sqrt(dh))).to(q.dtype)
    allowed = _mask_fn(cfg)
    m = torch.full((b, h, sq), -math.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, dh), dtype=torch.float32, device=q.device)
    for i in range(n_blocks):
        blk = slice(i * bk, (i + 1) * bk)
        s = torch.einsum("bqhd,bshd->bhqs", qh, k[:, blk]).to(torch.float32)
        mask = allowed(q_pos[:, None, :, None], k_pos[:, None, None, blk])
        mask &= kv_ok[:, None, None, blk]
        s = torch.where(mask, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqs,bshd->bhqd", p.to(q.dtype), v[:, blk]).to(torch.float32)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def attention(q, k, v, q_pos, k_pos, cfg, k_valid=None):
    if (cfg.use_flash_kernel and k_valid is None
            and cfg.attention_chunk is None):
        return flash_ops.flash_attention(
            q, k, v, q_pos, k_pos, causal=cfg.causal, window=cfg.window)
    if q.shape[1] >= cfg.block_q or k.shape[1] > 4 * cfg.block_kv:
        return attention_blocked(q, k, v, q_pos, k_pos, cfg, k_valid)
    return attention_naive(q, k, v, q_pos, k_pos, cfg, k_valid)


# ---------------------------------------------------------------------------
# FFN: dense GLU
# ---------------------------------------------------------------------------

def _act(x, kind):
    if kind == "swiglu" or kind == "silu":
        return F.silu(x)
    if kind == "geglu" or kind == "gelu":
        return F.gelu(x, approximate="tanh")   # jax.nn.gelu's default
    raise ValueError(kind)


def dense_ffn(x, wi, wo, cfg):
    glu = cfg.activation in ("swiglu", "geglu")
    h = x @ wi
    if glu:
        gate, up = torch.chunk(h, 2, dim=-1)
        h = _act(gate, cfg.activation) * up
    else:
        h = _act(h, cfg.activation)
    return h @ wo


# ---------------------------------------------------------------------------
# Blocks / full model
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, eps):
    var = torch.mean(torch.square(x.to(torch.float32)), -1, keepdim=True)
    return (x.to(torch.float32) * torch.rsqrt(var + eps)).to(x.dtype) * scale


def _layer(x, lp, cfg, q_pos, k_pos, k_valid=None):
    """One transformer block (training/prefill path). Returns (x, aux)."""
    b, s, _ = x.shape
    dh, h, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    dt = cfg.dtype

    hx = rmsnorm(x, lp["ln1"].to(dt), cfg.norm_eps)
    q = (hx @ lp["wq"].to(dt)).reshape(b, s, h, dh)
    kk = (hx @ lp["wk"].to(dt)).reshape(b, s, hkv, dh)
    vv = (hx @ lp["wv"].to(dt)).reshape(b, s, hkv, dh)
    q = rope(q, q_pos, cfg.rope_theta)
    kk = rope(kk, q_pos, cfg.rope_theta)
    kk = expand_kv(kk, h)
    vv = expand_kv(vv, h)
    att = attention(q, kk, vv, q_pos, k_pos, cfg, k_valid)
    x = x + (att.reshape(b, s, h * dh) @ lp["wo"].to(dt))

    hx = rmsnorm(x, lp["ln2"].to(dt), cfg.norm_eps)
    y = dense_ffn(hx, lp["wi"].to(dt), lp["wo_ff"].to(dt), cfg)
    return x + y, torch.zeros((), dtype=torch.float32, device=x.device)


def transformer_forward(params, tokens, cfg: TransformerConfig, *,
                        positions=None, k_valid=None, return_hidden=False):
    """tokens (B, S) -> logits (B, S, V) [or hidden (B, S, D)], plus the
    summed auxiliary loss (0 for the dense FFN)."""
    check_ported(cfg)
    b, s = tokens.shape
    dt = cfg.dtype
    x = params["embed"].to(dt)[tokens.long()]
    if cfg.embed_scale:
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=dt, device=x.device)
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None].expand(b, s)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layers = params["layers"]
    for i in range(cfg.n_layers):
        lp = {name: w[i] for name, w in layers.items()}
        x, a = _layer(x, lp, cfg, positions, positions, k_valid)
        aux = aux + a
    x = rmsnorm(x, params["ln_f"].to(dt), cfg.norm_eps)
    if return_hidden:
        return x, aux
    head = (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"]).to(dt)
    return x @ head, aux


def encode(params, tokens, cfg: TransformerConfig, valid=None):
    """Mean-pooled L2-normalised sentence embedding (retrieval encoder)."""
    hidden, _ = transformer_forward(params, tokens, cfg, k_valid=valid,
                                    return_hidden=True)
    if valid is None:
        pooled = hidden.mean(1)
    else:
        w = valid[..., None].to(hidden.dtype)
        pooled = (hidden * w).sum(1) / torch.clamp(w.sum(1), min=1.0)
    pooled = pooled.to(torch.float32)
    norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
    return pooled / torch.clamp(norm, min=1e-9)
