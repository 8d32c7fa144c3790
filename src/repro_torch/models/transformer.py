"""One composable transformer covering the five LM architectures (port
of ``repro/models/transformer.py``).

Dense or MoE FFN, GQA/MQA, RoPE, full / sliding-window / chunked-causal
attention, GeGLU/SwiGLU/GELU, tied or untied embeddings, ``remat="full"``,
the blocked cross-entropy of ``lm_loss``, and a KV-cache decode path
(``prefill``, ``init_kv_cache``, ``decode_step``; a rolling buffer for the
windowed and chunked archs).

Parameters are a dict of tensors with the reference's names and stacked
``(L, ...)`` layers, so carrying weights across from the JAX package is a
1:1 map (``interop.transformer_params``). Matrices keep JAX's ``x @ w``
orientation. The layer stack is a Python loop in place of ``lax.scan``;
``remat="full"`` checkpoints each layer (and the blocked attention inside
it) with ``torch.utils.checkpoint`` under autograd, and is the identity
without it. The MoE FFN routes as the reference does (group-local top-k,
k-major queue slots, capacity dropping, the Switch auxiliary loss); its
one-hot dispatch and combine einsums are index writes and gathers here,
which compute the same values (each slot holds one token).

Attention has the reference's three routes: the naive reference, the
blocked online-softmax version above ``block_q`` tokens, and, with
``use_flash_kernel=True``, the flash-attention wrapper (the hand-written
CUDA kernel on CUDA tensors, its plain version on CPU tensors). The kernel
has no gradient, so that route serves inference only: the retrieval
encoder takes it when it embeds a corpus on the card, and trains on the
plain routes under autograd, as the reference does. ``decode_step``
attends through the naive route, as the reference does.

The activation sharding options (``act_batch_axes``, ``act_model_axis``,
``attn_shard="dh"``, ``seq_parallel``) are accepted and leave every value
as it is: in the reference they are ``with_sharding_constraint``s, which
change where a value lives, never the value, and the port runs a model on
one rank (``launch/cells.build_lm_cell`` refuses a mesh of more, ROADMAP
queue 1 item 15(d)).

The layer loop takes each stacked ``(L, ...)`` leaf apart with one
``unbind``, so under autograd a leaf's gradient is stacked once from the
layers' slices (a slice by index would add a zeroed full-size gradient a
layer).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core import prng, xla_f32
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
    moe: Optional[MoEConfig] = None
    rope_theta: float = 10_000.0
    window: Optional[int] = None          # sliding-window attention size
    attention_chunk: Optional[int] = None  # llama4-style chunked attention
    causal: bool = True                   # False -> bidirectional encoder
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    embed_scale: bool = False             # gemma scales embeds by sqrt(d)
    dtype: Any = torch.bfloat16           # activation/compute dtype
    param_dtype: Any = torch.float32
    remat: str = "none"                   # none | full
    block_q: int = 1024                   # blocked-attention thresholds
    block_kv: int = 1024
    vocab_chunks: int = 1                 # >1 -> blocked cross-entropy
    use_flash_kernel: bool = False        # route attention to the kernel
    act_batch_axes: Optional[tuple] = None  # sharding constraints: where
    act_model_axis: Optional[str] = None    # a value lives (on one rank,
    attn_shard: str = "heads"               # no value changes)
    seq_parallel: bool = False

    @property
    def head_dim(self) -> int:
        if self.d_head is not None:
            return self.d_head
        return self.d_model // self.n_heads


# ---------------------------------------------------------------------------
# Parameter init + logical axes
# ---------------------------------------------------------------------------

#: elements of a leaf drawn at once: bounds the draw's int64 intermediates
#: (tens of bytes an element) whatever the leaf's size
DRAW_CHUNK = 1 << 23


def _dense_init(key, shape, in_axis, dtype, device):
    """``normal(key, shape) / sqrt(fan_in)`` in ``dtype`` on ``device``,
    drawn ``DRAW_CHUNK`` flat positions at a time (bit-equal to the whole
    draw); the division correctly rounded on any device, as XLA's is. On
    the ``meta`` device: the shape alone, nothing drawn."""
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.device.type == "meta":
        return out
    fan_in = np.prod([shape[a] for a in np.atleast_1d(in_axis)])
    scale = torch.tensor(np.float32(np.sqrt(fan_in)), device=device)
    flat = out.view(-1)
    for start in range(0, flat.numel(), DRAW_CHUNK):
        n = min(DRAW_CHUNK, flat.numel() - start)
        draw = prng.normal(key, (n,), device, start=start)
        flat[start:start + n] = xla_f32.div(draw, scale).to(dtype)
    return out


def _param_layout(cfg: TransformerConfig):
    """Each parameter's shape and draw: ``None`` for ones, else ``(key
    index, fan-in axis)`` of its ``normal / sqrt(fan_in)`` draw."""
    dh, h, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    L, D, F_, V = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
    glu = cfg.activation in ("swiglu", "geglu")
    wi_cols = 2 * F_ if glu else F_
    layers = {
        "ln1": ((L, D), None),
        "ln2": ((L, D), None),
        "wq": ((L, D, h * dh), (0, 1)),
        "wk": ((L, D, hkv * dh), (1, 1)),
        "wv": ((L, D, hkv * dh), (2, 1)),
        "wo": ((L, h * dh, D), (3, 1)),
    }
    if cfg.moe is None:
        layers["wi"] = ((L, D, wi_cols), (4, 1))
        layers["wo_ff"] = ((L, F_, D), (5, 1))
    else:
        E = cfg.moe.num_experts
        layers["router"] = ((L, D, E), (6, 1))
        layers["wi"] = ((L, E, D, wi_cols), (7, 2))
        layers["wo_ff"] = ((L, E, F_, D), (8, 2))
    out = {"embed": ((V, D), (9, 1)), "layers": layers, "ln_f": ((D,), None)}
    if not cfg.tie_embeddings:
        out["lm_head"] = ((D, V), (10, 0))
    return out


def _map_layout(fn, layout):
    if isinstance(layout, dict):
        return {k: _map_layout(fn, v) for k, v in layout.items()}
    return fn(*layout)


def param_shapes(cfg: TransformerConfig):
    """The parameter tree's shapes (tuples), with nothing allocated."""
    return _map_layout(lambda shape, draw: shape, _param_layout(cfg))


def init_transformer(key: prng.Key, cfg: TransformerConfig, device="cuda"):
    """The reference's parameter tree from the same key, bit for bit,
    drawn on ``device`` (the card unless ``device="cpu"``)."""
    device = resolve_device(device)
    keys = prng.split(key, 12)

    def leaf(shape, draw):
        if draw is None:
            return torch.ones(shape, dtype=cfg.param_dtype, device=device)
        i, in_axis = draw
        return _dense_init(keys[i], shape, in_axis, cfg.param_dtype, device)
    return _map_layout(leaf, _param_layout(cfg))


def param_logical_axes(cfg: TransformerConfig):
    """Logical axis names per parameter dim (sharding rules map these)."""
    glu_cols = "ffn"
    layers = {
        "ln1": ("layers", "embed_noshard"),
        "ln2": ("layers", "embed_noshard"),
        "wq": ("layers", "embed", "qkv_features"),
        "wk": ("layers", "embed", "kv_features"),
        "wv": ("layers", "embed", "kv_features"),
        "wo": ("layers", "qkv_features", "embed"),
    }
    if cfg.moe is None:
        layers["wi"] = ("layers", "embed", glu_cols)
        layers["wo_ff"] = ("layers", "ffn", "embed")
    else:
        layers["router"] = ("layers", "embed", "experts_noshard")
        layers["wi"] = ("layers", "experts", "embed", glu_cols)
        layers["wo_ff"] = ("layers", "experts", "ffn", "embed")
    out = {
        "embed": ("vocab", "embed"),
        "layers": layers,
        "ln_f": ("embed_noshard",),
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = ("embed", "vocab")
    return out


def tree_to(tree, to):
    """A parameter tree (nested dicts of tensors) moved to a device or
    cast to a dtype (``to`` as ``Tensor.to`` takes it)."""
    if isinstance(tree, dict):
        return {k: tree_to(v, to) for k, v in tree.items()}
    return tree.to(to)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def _rope_cos_sin(positions: torch.Tensor, dh: int, theta: float, dtype):
    """RoPE's (cos, sin), each (B, S, 1, Dh/2) in ``dtype``, for (B, S)
    absolute positions: the same for every layer, so a pass computes them
    once."""
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs          # (B,S,half)
    return (torch.cos(ang)[:, :, None, :].to(dtype),
            torch.sin(ang)[:, :, None, :].to(dtype))


def _rotate(x: torch.Tensor, tables) -> torch.Tensor:
    """x: (B, S, H, Dh) rotated by :func:`_rope_cos_sin`'s (cos, sin)."""
    cos, sin = tables
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (B, S) absolute token positions."""
    return _rotate(x, _rope_cos_sin(positions, x.shape[-1], theta, x.dtype))


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


def _naive_mask(q_pos, k_pos, cfg, k_valid=None):
    """attention_naive's (B, 1, Sq, Sk) mask of allowed keys."""
    mask = _mask_fn(cfg)(q_pos[:, None, :, None], k_pos[:, None, None, :])
    if k_valid is not None:
        mask &= k_valid[:, None, None, :]
    return mask


def attention_naive(q, k, v, q_pos, k_pos, cfg, k_valid=None, *,
                    mask=None):
    """q, k, v: (B,S,H,Dh) (kv pre-expanded). Returns (B,Sq,H,Dh).
    ``mask``: :func:`_naive_mask` of the same arguments, computed once
    where many layers share it."""
    dh = q.shape[-1]
    logits = torch.einsum("bqhd,bshd->bhqs", q, k).to(torch.float32)
    logits = logits * (1.0 / np.sqrt(dh))
    if mask is None:
        mask = _naive_mask(q_pos, k_pos, cfg, k_valid)
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


def _remat(cfg: TransformerConfig) -> bool:
    """Checkpoint here: ``remat="full"`` under autograd (without a graph
    there is nothing to save, and the reference's recompute is moot)."""
    return cfg.remat == "full" and torch.is_grad_enabled()


def attention(q, k, v, q_pos, k_pos, cfg, k_valid=None):
    if (cfg.use_flash_kernel and k_valid is None
            and cfg.attention_chunk is None):
        return flash_ops.flash_attention(
            q, k, v, q_pos, k_pos, causal=cfg.causal, window=cfg.window)
    if q.shape[1] >= cfg.block_q or k.shape[1] > 4 * cfg.block_kv:
        if _remat(cfg):
            return checkpoint(attention_blocked, q, k, v, q_pos, k_pos, cfg,
                              k_valid, use_reentrant=False)
        return attention_blocked(q, k, v, q_pos, k_pos, cfg, k_valid)
    return attention_naive(q, k, v, q_pos, k_pos, cfg, k_valid)


# ---------------------------------------------------------------------------
# FFN: dense GLU / MoE
# ---------------------------------------------------------------------------

def _act(x, kind):
    if kind == "swiglu" or kind == "silu":
        return F.silu(x)
    if kind == "geglu" or kind == "gelu":
        return F.gelu(x, approximate="tanh")   # jax.nn.gelu's default
    raise ValueError(kind)


def _glu(h, cfg):
    if cfg.activation in ("swiglu", "geglu"):
        gate, up = torch.chunk(h, 2, dim=-1)
        return _act(gate, cfg.activation) * up
    return _act(h, cfg.activation)


def dense_ffn(x, wi, wo, cfg):
    return _glu(x @ wi, cfg) @ wo


def moe_ffn(x, router_w, wi, wo, cfg):
    """x: (B, T, D). Group = batch row; top-k routing with capacity drop.

    Each assignment (token, choice) takes the next queue slot of its
    expert, choices k-major (every token's first choice queues before any
    second choice); an assignment at or past the capacity is dropped. The
    kept ones are written to their (expert, slot) rows, each expert runs
    its FFN over its rows, and each token sums its choices' outputs by
    their normalised weights, choice 0 first, as the reference's one-hot
    einsums do. Returns (B, T, D) plus the Switch load-balancing auxiliary
    loss.
    """
    b, t, d = x.shape
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    cap = max(1, int(t * k * cfg.moe.capacity_factor / e))

    logits = (x @ router_w).to(torch.float32)              # (B,T,E)
    probs = torch.softmax(logits, -1)
    # lax.top_k: the largest first, ties to the lower expert
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = top.values[..., :k], top.indices[..., :k]  # (B,T,k)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)

    # queue slot per assignment, k-major priority (k=0 fills first)
    expert = topi.transpose(1, 2).reshape(b, k * t)        # (B,k*t)
    oh = F.one_hot(expert, e)                              # (B,k*t,E)
    slot = ((oh.cumsum(1) - 1) * oh).sum(-1)               # (B,k*t)
    # a dropped assignment goes to a spare slot ``cap``, never read
    slot = torch.where(slot < cap, slot, cap)
    rows = torch.arange(b, device=x.device)[:, None].expand(b, k * t)
    token = torch.arange(t, device=x.device).repeat(k)[None].expand(b, -1)

    xb = x.new_zeros((b, e, cap + 1, d))
    xb = xb.index_put((rows, expert, slot), x[rows, token])[:, :, :cap]
    h = _glu(torch.einsum("becd,edf->becf", xb, wi), cfg)
    yb = torch.einsum("becf,efd->becd", h, wo)             # (B,E,C,D)
    yb = F.pad(yb, (0, 0, 0, 1))                           # the spare slot: 0
    w = topw.transpose(1, 2).reshape(b, k * t).to(x.dtype)
    out = (yb[rows, expert, slot] * w[..., None]).reshape(b, k, t, d)
    y = torch.zeros_like(x)
    for kk in range(k):
        y = y + out[:, kk]

    # Switch aux loss: E * sum_e f_e * P_e
    me = probs.mean(dim=(0, 1))
    counts = F.one_hot(topi, e).sum((1, 2)).to(torch.float32)
    fe = (counts / float(t * k)).mean(0)
    aux = e * torch.sum(fe * me)
    return y, aux


# ---------------------------------------------------------------------------
# Blocks / full model
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, eps):
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), -1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def _embed(params, tokens, cfg):
    dt = cfg.dtype
    x = params["embed"].to(dt)[tokens.long()]
    if cfg.embed_scale:
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=dt, device=x.device)
    return x


def _head(params, x, cfg):
    head = (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"]).to(cfg.dtype)
    return x @ head


def _ffn(x, lp, cfg):
    """The block's second half on the normed ``x``: (y, aux)."""
    dt = cfg.dtype
    if cfg.moe is None:
        return dense_ffn(x, lp["wi"].to(dt), lp["wo_ff"].to(dt), cfg), 0.0
    return moe_ffn(x, lp["router"].to(dt), lp["wi"].to(dt),
                   lp["wo_ff"].to(dt), cfg)


def _rope_tables(cfg, positions):
    return _rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta, cfg.dtype)


def _qkv(x, lp, cfg, tables):
    """The normed ``x``'s queries, keys and values, RoPE (``tables`` of
    the positions) applied to q and k: (B,S,H,Dh), (B,S,Hkv,Dh) twice."""
    b, s, _ = x.shape
    dh, h, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    dt = cfg.dtype
    hx = rmsnorm(x, lp["ln1"].to(dt), cfg.norm_eps)
    q = (hx @ lp["wq"].to(dt)).reshape(b, s, h, dh)
    kk = (hx @ lp["wk"].to(dt)).reshape(b, s, hkv, dh)
    vv = (hx @ lp["wv"].to(dt)).reshape(b, s, hkv, dh)
    return _rotate(q, tables), _rotate(kk, tables), vv


def _layer(x, lp, cfg, q_pos, k_pos, k_valid, tables):
    """One transformer block (training path). Returns (x, aux).
    ``tables``: RoPE's of ``q_pos``, computed once for every layer."""
    b, s, _ = x.shape
    dt = cfg.dtype
    q, kk, vv = _qkv(x, lp, cfg, tables)
    att = attention(q, expand_kv(kk, cfg.n_heads),
                    expand_kv(vv, cfg.n_heads), q_pos, k_pos, cfg, k_valid)
    x = x + (att.reshape(b, s, -1) @ lp["wo"].to(dt))
    y, aux = _ffn(rmsnorm(x, lp["ln2"].to(dt), cfg.norm_eps), lp, cfg)
    return x + y, aux


def _layer_views(params) -> list:
    """Layer i's parameters as views of the stacked leaves, for every i
    (one ``unbind`` a leaf)."""
    names = list(params["layers"])
    per_leaf = [params["layers"][n].unbind(0) for n in names]
    return [dict(zip(names, ws)) for ws in zip(*per_leaf)]


def transformer_forward(params, tokens, cfg: TransformerConfig, *,
                        positions=None, k_valid=None, return_hidden=False):
    """tokens (B, S) -> logits (B, S, V) [or hidden (B, S, D)], plus the
    summed auxiliary loss (0 for the dense FFN)."""
    b, s = tokens.shape
    x = _embed(params, tokens, cfg)
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None].expand(b, s)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    tables = _rope_tables(cfg, positions)
    for lp in _layer_views(params):
        if _remat(cfg):
            x, a = checkpoint(_layer, x, lp, cfg, positions, positions,
                              k_valid, tables, use_reentrant=False)
        else:
            x, a = _layer(x, lp, cfg, positions, positions, k_valid, tables)
        aux = aux + a
    x = rmsnorm(x, params["ln_f"].to(cfg.dtype), cfg.norm_eps)
    if return_hidden:
        return x, aux
    return _head(params, x, cfg), aux


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


def lm_loss(params, tokens, cfg: TransformerConfig, aux_weight=0.01):
    """Next-token cross-entropy; optional blocked (chunked-vocab)
    logsumexp."""
    logits, aux = transformer_forward(params, tokens[:, :-1], cfg)
    targets = tokens[:, 1:].long()
    logits = logits.to(torch.float32)
    if cfg.vocab_chunks > 1:
        v = logits.shape[-1]
        csz = -(-v // cfg.vocab_chunks)
        padv = cfg.vocab_chunks * csz - v
        lp = F.pad(logits, (0, padv), value=-1e30)
        chunks = lp.reshape(*lp.shape[:2], cfg.vocab_chunks, csz)
        lse = torch.logsumexp(torch.logsumexp(chunks, -1), -1)
    else:
        lse = torch.logsumexp(logits, -1)
    tgt_logit = torch.gather(logits, -1, targets[..., None])[..., 0]
    nll = (lse - tgt_logit).mean()
    return nll + aux_weight * aux


def prefill(params, tokens, cfg: TransformerConfig):
    """Prefill pass for serving: tokens (B, S) -> (last-token logits (B, V),
    cache {k, v: (L, B, S_cache, Hkv, Dh), pos}). Windowed archs emit only
    the rolling tail of the KV stream (cache_length)."""
    b, s = tokens.shape
    dt = cfg.dtype
    s_cache = cache_length(cfg, s)
    x = _embed(params, tokens, cfg)
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None].expand(b, s)
    ks, vs = [], []
    tables = _rope_tables(cfg, positions)
    for lp in _layer_views(params):
        q, kk, vv = _qkv(x, lp, cfg, tables)
        att = attention(q, expand_kv(kk, cfg.n_heads),
                        expand_kv(vv, cfg.n_heads), positions, positions,
                        cfg)
        x = x + (att.reshape(b, s, -1) @ lp["wo"].to(dt))
        y, _ = _ffn(rmsnorm(x, lp["ln2"].to(dt), cfg.norm_eps), lp, cfg)
        x = x + y
        # rolling tail goes to the cache; roll so slot = pos % s_cache
        ks.append(torch.roll(kk[:, -s_cache:], s % s_cache, dims=1))
        vs.append(torch.roll(vv[:, -s_cache:], s % s_cache, dims=1))
    x = rmsnorm(x[:, -1], params["ln_f"].to(dt), cfg.norm_eps)
    cache = {"k": torch.stack(ks), "v": torch.stack(vs),
             "pos": torch.full((b,), s, dtype=torch.int32, device=x.device)}
    return _head(params, x, cfg), cache


# ---------------------------------------------------------------------------
# KV-cache serving
# ---------------------------------------------------------------------------

def cache_length(cfg: TransformerConfig, max_seq: int) -> int:
    """Windowed/chunked archs keep a rolling buffer: what makes their long
    decode sub-quadratic."""
    if cfg.window is not None:
        return min(max_seq, cfg.window)
    if cfg.attention_chunk is not None:
        return min(max_seq, cfg.attention_chunk)
    return max_seq


def init_kv_cache(cfg: TransformerConfig, batch: int, max_seq: int,
                  dtype=None, device="cuda"):
    """An empty cache {k, v: (L, batch, S_cache, Hkv, Dh), pos: (batch,)}
    on ``device`` (the card unless ``device="cpu"``)."""
    device = resolve_device(device)
    s = cache_length(cfg, max_seq)
    dt = dtype or cfg.dtype
    shape = (cfg.n_layers, batch, s, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
        # next absolute position
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def decode_step(params, cache, tokens, cfg: TransformerConfig):
    """One-token decode: tokens (B, 1) -> (logits (B, 1, V), new cache).

    The given cache is left as it was (the new one is a copy with this
    step's keys and values written), and every row's ``pos`` advances,
    idle rows included, as the reference's does."""
    b = tokens.shape[0]
    s_cache = cache["k"].shape[2]
    dt = cfg.dtype
    pos = cache["pos"]                               # (B,)
    q_pos = pos[:, None]                             # (B,1)
    slot = (pos % s_cache).long()                    # rolling buffer slot
    rows = torch.arange(b, device=pos.device)

    x = _embed(params, tokens, cfg)
    # absolute position of each rolling-buffer slot after this step's write:
    # largest a = slot (mod S) with a <= pos  ->  a = pos - ((pos - slot) mod S)
    slots = torch.arange(s_cache, dtype=torch.int32, device=pos.device)[None]
    k_pos = pos[:, None] - torch.remainder(pos[:, None] - slots, s_cache)
    k_valid = k_pos >= 0
    # what every layer shares, computed once a step
    tables = _rope_tables(cfg, q_pos)
    mask = _naive_mask(q_pos, k_pos, cfg, k_valid)

    new_k, new_v = cache["k"].clone(), cache["v"].clone()
    for i, lp in enumerate(_layer_views(params)):
        q, kk, vv = _qkv(x, lp, cfg, tables)
        new_k[i, rows, slot] = kk[:, 0]
        new_v[i, rows, slot] = vv[:, 0]
        att = attention_naive(q, expand_kv(new_k[i], cfg.n_heads),
                              expand_kv(new_v[i], cfg.n_heads), q_pos,
                              k_pos, cfg, k_valid, mask=mask)
        x = x + att.reshape(b, 1, -1) @ lp["wo"].to(dt)
        y, _ = _ffn(rmsnorm(x, lp["ln2"].to(dt), cfg.norm_eps), lp, cfg)
        x = x + y
    x = rmsnorm(x, params["ln_f"].to(dt), cfg.norm_eps)
    new_cache = {"k": new_k, "v": new_v, "pos": pos + 1}
    return _head(params, x, cfg), new_cache


# ---------------------------------------------------------------------------
# Accounting
# ---------------------------------------------------------------------------

def count_params(cfg: TransformerConfig) -> int:
    dh, h, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    L, D, F_, V = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
    glu = cfg.activation in ("swiglu", "geglu")
    attn = D * h * dh + 2 * D * hkv * dh + h * dh * D
    if cfg.moe is None:
        ffn = D * F_ * (3 if glu else 2)
    else:
        ffn = (cfg.moe.num_experts * D * F_ * (3 if glu else 2)
               + D * cfg.moe.num_experts)
    total = L * (attn + ffn + 2 * D) + V * D + D
    if not cfg.tie_embeddings:
        total += D * V
    return total


def active_params(cfg: TransformerConfig) -> int:
    """Params touched per token (MoE: top-k experts only) — the N in the
    MODEL_FLOPS = 6*N*D roofline term."""
    dh, h, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    L, D, F_, V = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
    glu = cfg.activation in ("swiglu", "geglu")
    attn = D * h * dh + 2 * D * hkv * dh + h * dh * D
    k = cfg.moe.top_k if cfg.moe else 1
    ffn = k * D * F_ * (3 if glu else 2)
    total = L * (attn + ffn) + V * D
    if not cfg.tie_embeddings:
        total += D * V
    return total
