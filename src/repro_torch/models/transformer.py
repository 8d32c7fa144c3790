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

On one rank (``ranks=None``, the default) the activation sharding options
(``act_batch_axes``, ``act_model_axis``, ``attn_shard``, ``seq_parallel``)
leave every value as it is: in the reference they are
``with_sharding_constraint``s, which change where a value lives, never the
value. Across ranks (``ranks=Ranks(mesh, cfg, rules)``, what
``launch/cells.build_lm_cell`` passes on a mesh of more than one rank)
each function is the code ONE rank runs on its shards, the reference's
GSPMD program written out, and the options place values as its ``_sc``
sites do:

* parameters are the rank's shards as the rules place them: each layer's
  ``embed`` dim (ZeRO, over ``data``) is all-gathered for its use, in the
  compute type, and its gradient reduce-scattered (:meth:`Ranks.weight`);
  ``qkv_features``,
  ``kv_features``, ``ffn`` and ``vocab`` stay split over ``model``
  (Megatron TP: column-parallel in, row-parallel out, one all-reduce of
  the block's output over ``model``);
* the batch is split over ``act_batch_axes``; the residual stream is
  whole over ``model`` (``_res_axes``' ``("b", None, None)``), or split on
  the sequence with ``seq_parallel`` (an all-gather before each block half,
  a reduce-scatter after);
* attention runs this rank's heads (``_attn_axes``' heads over ``model``)
  where ``n_heads`` divides by it, the kv heads they read gathered when
  ``n_kv_heads`` does not; where the heads do not divide, every model
  rank gathers q, k and v and keeps its slice of the output features; a
  decode cache split on ``head_dim`` (``_cache_specs``' layout where the
  kv heads do not divide: gemma's single kv head) attends split on it,
  its partial scores summed over ``model`` (``attn_shard`` picks no route
  of its own);
* the embedding is a vocab-parallel lookup (ids outside the rank's rows
  read zeros, then a sum over ``model``), the logits stay split on the
  vocab, and ``lm_loss`` is a vocab-parallel cross-entropy;
* the MoE routes each rank's own rows (a row is its routing group) and
  sums the auxiliary loss's means over the batch axes; experts over
  ``data`` (llama4-scout's rules) exchange their slots by all-to-all.

Collectives go through ``distributed/collectives.py`` (their gradient by
autograd, the adjoint of each); a loss under ``ranks`` is the rank's
share, the global loss being the sum of the shares.

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
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.sharding import logical_to_spec
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
    attn_shard: str = "heads"               # no value changes; across
    seq_parallel: bool = False              # ranks, see Ranks)

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
# Across ranks: the per-rank view of a mesh
# ---------------------------------------------------------------------------

#: logical dims that Megatron TP splits over ``model`` (each rank keeps its
#: slice); ``embed`` is ZeRO's (gathered for use), ``experts`` expert
#: parallelism's (slots exchanged by all-to-all)
_TP_DIMS = ("qkv_features", "kv_features", "ffn", "vocab")


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _flat_axes(tree, prefix=()):
    if isinstance(tree, dict):
        return [pa for k in tree for pa in _flat_axes(tree[k], prefix + (k,))]
    return [("/".join(prefix), tree)]


class Ranks:
    """What one rank of ``mesh`` holds and runs of a transformer whose
    parameters are placed by ``rules`` (``LM_RULES`` with the arch's
    override): built by ``launch/cells.build_lm_cell``, passed as
    ``ranks=`` to the functions of this module, which then take this
    rank's shards (plain tensors: a ``DTensor``'s ``to_local()``) and run
    its part of the step. Raises on a layout it has no code for."""

    def __init__(self, mesh, cfg: TransformerConfig, rules: dict):
        self.mesh = mesh
        names = tuple(mesh.mesh_dim_names)
        sizes = dict(zip(names, mesh.shape))
        self.sizes = sizes
        self.m = sizes.get("model", 1)
        self.model = "model" if self.m > 1 else None
        self.mr = mesh.get_local_rank("model") if self.model else 0
        #: axes that split the batch (those of size 1 need no collective)
        self.batch = tuple(a for a in (cfg.act_batch_axes or ())
                           if sizes[a] > 1)
        self.nb = math.prod(sizes[a] for a in self.batch)
        #: every data-parallel rank (a rank's loss is 1 / (n_data m) of it)
        self.n_data = math.prod(sizes[a] for a in ("pod", "data")
                                if a in sizes)
        self.sp = bool(cfg.seq_parallel) and self.model is not None
        self.glu = cfg.activation in ("swiglu", "geglu")
        self.cfg = cfg
        self.leaves = {}
        for path, logical in _flat_axes(param_logical_axes(cfg)):
            spec = logical_to_spec(mesh, logical, rules)
            if path.startswith("layers/"):
                path, logical, spec = path[7:], logical[1:], spec[1:]
            for lg, entry in zip(logical, spec):
                ax = tuple(a for a in _axes(entry) if sizes[a] > 1)
                ok = (not ax or (lg == "embed" and "model" not in ax)
                      or (lg in _TP_DIMS and ax == ("model",))
                      or (lg == "experts" and ax == ("data",)))
                if not ok:
                    raise NotImplementedError(
                        f"{path}'s {lg!r} dim placed over {ax}: the port "
                        f"splits a transformer over ranks as ZeRO on "
                        f"'embed', Megatron TP on {_TP_DIMS} over 'model' "
                        f"and experts over 'data'")
            self.leaves[path] = tuple(zip(logical, spec))
        experts = dict(self.leaves.get("wi", ())).get("experts")
        self.ep = bool(cfg.moe) and bool(
            [a for a in _axes(experts) if sizes[a] > 1])
        if self.model:
            for need, n in (("n_kv_heads * head_dim",
                             cfg.n_kv_heads * cfg.head_dim),
                            ("n_heads * head_dim", cfg.n_heads * cfg.head_dim),
                            ("d_ff", cfg.d_ff), ("vocab_size",
                                                 cfg.vocab_size)):
                if n % self.m:
                    raise ValueError(f"{need} = {n} does not divide over "
                                     f"'model' of {self.m}")

    # -- parameters ---------------------------------------------------------

    def weight(self, name: str, local: torch.Tensor,
               dtype) -> torch.Tensor:
        """This rank's shard of parameter ``name`` (a layer's, the stacked
        dim gone) as its products use it, in ``dtype``: the ``embed``
        dims all-gathered (ZeRO; the gradient reduce-scattered), a GLU
        ``wi``'s columns regrouped so the rank's gate and up columns pair.
        The cast comes first, so the collectives move the compute type
        (and the gradient comes back in it, as the reference's does)."""
        out = local.to(dtype)
        dims = self.leaves[name]
        if (name == "wi" and self.glu and self.model
                and dims[-1][1] is not None):
            out = self._glu_columns(out)
        for d, (lg, entry) in enumerate(dims):
            ax = tuple(a for a in _axes(entry) if self.sizes[a] > 1)
            if ax and lg == "embed":
                out = coll.grad_all_gather(out, self.mesh, ax, dim=d)
        return out

    def _glu_columns(self, w: torch.Tensor) -> torch.Tensor:
        """``wi``'s ``[gate | up]`` columns are split over ``model`` in
        contiguous pieces, so one rank may hold gates and another their
        ups. Piece p of F / m columns (p < m a gate piece, else an up
        piece) goes to rank p mod m, which then holds ``[gate_r | up_r]``
        of its slice r of ``d_ff`` (``wo_ff``'s rows). An all-to-all."""
        m, half = self.m, w.shape[-1] // 2
        x = w.movedim(-1, 0)
        pieces = sorted(((p % m, x[(p - 2 * self.mr) * half:
                                   (p - 2 * self.mr + 1) * half])
                         for p in (2 * self.mr, 2 * self.mr + 1)),
                        key=lambda t: t[0])
        in_splits = [0] * m
        for dest, _ in pieces:
            in_splits[dest] += half
        out_splits = [0] * m
        for p in (self.mr, m + self.mr):
            out_splits[p // 2] += half
        x = coll.grad_all_to_all(torch.cat([t for _, t in pieces]),
                                 self.mesh, "model", in_splits, out_splits)
        return x.movedim(0, -1)

    # -- activations --------------------------------------------------------

    def block_in(self, x: torch.Tensor) -> torch.Tensor:
        """The residual stream as a block half reads it: whole (the
        sequence gathered over ``model`` with ``seq_parallel``)."""
        if self.sp:
            return coll.grad_all_gather(x, self.mesh, "model", dim=1)
        return x

    def block_out(self, y: torch.Tensor) -> torch.Tensor:
        """A row-parallel output summed over ``model`` (reduce-scattered
        on the sequence with ``seq_parallel``)."""
        if self.model is None:
            return y
        if self.sp:
            return coll.grad_reduce_scatter(y, self.mesh, "model", dim=1)
        return coll.grad_all_reduce(y, self.mesh, "model")

    def gather_model(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        if self.model is None:
            return x
        return coll.grad_all_gather(x, self.mesh, "model", dim=dim)

    def sum_model(self, x: torch.Tensor) -> torch.Tensor:
        if self.model is None:
            return x
        return coll.grad_all_reduce(x, self.mesh, "model")

    def sum_batch(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the ranks that split the batch."""
        if not self.batch:
            return x
        return coll.grad_all_reduce(x, self.mesh, self.batch)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the last dim (whole on every model rank)."""
        if self.model is None:
            return x
        n = x.shape[-1] // self.m
        return x[..., self.mr * n:(self.mr + 1) * n]

    # -- layouts ------------------------------------------------------------

    def q_heads(self) -> tuple:
        """(first head, heads, gathered) of this rank's attention: its
        own heads where ``n_heads`` divides over ``model``, else all of
        them (q, k and v gathered). ``attn_shard`` picks no other route:
        the heads' count decides, and a decode cache split on
        ``head_dim`` attends split on it."""
        h = self.cfg.n_heads
        if self.model is None:
            return 0, h, False
        if h % self.m:
            return 0, h, True
        return self.mr * (h // self.m), h // self.m, False

    def kv_local(self) -> bool:
        """True where this rank's kv projection holds whole kv heads
        (then its heads' kv heads are among them)."""
        return self.model is None or self.cfg.n_kv_heads % self.m == 0

    def cache_layout(self) -> Optional[str]:
        """How the decode cache splits over ``model`` (the cells'
        ``_cache_specs``): ``"heads"``, ``"dh"`` or ``None`` (whole)."""
        if self.model is None:
            return None
        if self.cfg.n_kv_heads % self.m == 0:
            return "heads"
        if self.cfg.head_dim % self.m == 0:
            return "dh"
        return None

    def vocab_start(self) -> int:
        return self.mr * (self.cfg.vocab_size // self.m)


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


def moe_ffn(x, router_w, wi, wo, cfg, ranks=None):
    """x: (B, T, D). Group = batch row; top-k routing with capacity drop.

    Each assignment (token, choice) takes the next queue slot of its
    expert, choices k-major (every token's first choice queues before any
    second choice); an assignment at or past the capacity is dropped. The
    kept ones are written to their (expert, slot) rows, each expert runs
    its FFN over its rows, and each token sums its choices' outputs by
    their normalised weights, choice 0 first, as the reference's one-hot
    einsums do. Returns (B, T, D) plus the Switch load-balancing auxiliary
    loss. Under ``ranks``: this rank's rows and its slice of ``d_ff`` (the
    output a partial sum over ``model``), the auxiliary loss's means over
    the whole batch.
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
    if ranks is not None and ranks.ep:
        yb = _experts_exchanged(xb, wi, wo, cfg, ranks)
    else:
        h = _glu(torch.einsum("becd,edf->becf", xb, wi), cfg)
        yb = torch.einsum("becf,efd->becd", h, wo)         # (B,E,C,D)
    yb = F.pad(yb, (0, 0, 0, 1))                           # the spare slot: 0
    w = topw.transpose(1, 2).reshape(b, k * t).to(x.dtype)
    out = (yb[rows, expert, slot] * w[..., None]).reshape(b, k, t, d)
    y = torch.zeros_like(x)
    for kk in range(k):
        y = y + out[:, kk]

    # Switch aux loss: E * sum_e f_e * P_e
    counts = F.one_hot(topi, e).sum((1, 2)).to(torch.float32)
    if ranks is None:
        me = probs.mean(dim=(0, 1))
        fe = (counts / float(t * k)).mean(0)
    else:       # the means over the whole batch, summed over its ranks
        n = b * ranks.nb
        me = ranks.sum_batch(probs.sum(dim=(0, 1))) / float(n * t)
        fe = ranks.sum_batch((counts / float(t * k)).sum(0)) / float(n)
    aux = e * torch.sum(fe * me)
    return y, aux


def _experts_exchanged(xb, wi, wo, cfg, ranks):
    """The expert FFN with the experts split over ``data`` (expert
    parallelism): every rank's (B, E, C, D) slots go to the rank holding
    their expert, which runs its experts over all of them, and the
    outputs come back, both ways by all-to-all over ``data``."""
    b, e, c, d = xb.shape
    n = ranks.sizes["data"]
    el = e // n
    send = xb.transpose(0, 1).reshape(n, el, b, c, d)       # by owner
    got = coll.grad_all_to_all(send.reshape(n * el, b, c, d), ranks.mesh,
                               "data")
    got = got.reshape(n, el, b, c, d).transpose(0, 1).reshape(el, n * b, c, d)
    h = _glu(torch.einsum("ebcd,edf->ebcf", got, wi), cfg)
    yb = torch.einsum("ebcf,efd->ebcd", h, wo)              # (E/n, nB, C, D)
    back = yb.reshape(el, n, b, c, d).transpose(0, 1).reshape(n * el, b, c, d)
    yb = coll.grad_all_to_all(back, ranks.mesh, "data")
    return yb.reshape(e, b, c, d).transpose(0, 1)


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


def lm_loss(params, tokens, cfg: TransformerConfig, aux_weight=0.01, *,
            ranks=None):
    """Next-token cross-entropy; optional blocked (chunked-vocab)
    logsumexp. Under ``ranks``: this rank's share of it."""
    if ranks is not None:
        return _lm_loss_ranks(params, tokens, cfg, aux_weight, ranks)
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


def prefill(params, tokens, cfg: TransformerConfig, *, ranks=None):
    """Prefill pass for serving: tokens (B, S) -> (last-token logits (B, V),
    cache {k, v: (L, B, S_cache, Hkv, Dh), pos}). Windowed archs emit only
    the rolling tail of the KV stream (cache_length). Under ``ranks``:
    this rank's vocab slice of its rows' logits and its cache shards."""
    if ranks is not None:
        return _prefill_ranks(params, tokens, cfg, ranks)
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


def decode_step(params, cache, tokens, cfg: TransformerConfig, *,
                ranks=None):
    """One-token decode: tokens (B, 1) -> (logits (B, 1, V), new cache).

    The given cache is left as it was (the new one is a copy with this
    step's keys and values written), and every row's ``pos`` advances,
    idle rows included, as the reference's does. Under ``ranks``: this
    rank's shards, its cache's written in place."""
    if ranks is not None:
        return _decode_ranks(params, cache, tokens, cfg, ranks)
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
# Across ranks (``ranks=``): one rank's part of each pass
# ---------------------------------------------------------------------------

def _embed_ranks(table, tokens, cfg, ranks):
    """Vocab-parallel lookup: the rank's rows of ``table`` (its vocab
    slice, ``embed`` whole) for the ids it holds, zeros for the rest,
    summed over ``model``."""
    dt = cfg.dtype
    local = tokens.long() - ranks.vocab_start()
    ok = (local >= 0) & (local < table.shape[0])
    rows = table[torch.where(ok, local, 0)]
    x = ranks.block_out(torch.where(ok[..., None], rows, rows.new_zeros(())))
    if cfg.embed_scale:
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=dt, device=x.device)
    return x


def _head_ranks(params, table, x, cfg, ranks):
    """The rank's vocab slice of the logits."""
    head = (table.T if cfg.tie_embeddings
            else ranks.weight("lm_head", params["lm_head"], cfg.dtype))
    return x @ head


def _qkv_ranks(x, lp, cfg, tables, ranks):
    """The rank's queries (B,S,h,Dh) and the keys and values those heads
    read, both (B,S,Hk,Dh) with the index (h,) of each head's kv head
    among them; RoPE applied. ``x`` is normed and whole."""
    b, s, _ = x.shape
    dh, dt = cfg.head_dim, cfg.dtype
    h0, hl, gathered = ranks.q_heads()
    q = x @ ranks.weight("wq", lp["wq"], dt)
    kk = x @ ranks.weight("wk", lp["wk"], dt)
    vv = x @ ranks.weight("wv", lp["wv"], dt)
    if gathered:
        q = ranks.gather_model(q)
    kv0 = 0
    if ranks.kv_local():
        kv0 = ranks.mr * (cfg.n_kv_heads // ranks.m)
    else:
        kk, vv = ranks.gather_model(kk), ranks.gather_model(vv)
    q = _rotate(q.reshape(b, s, -1, dh), tables)
    kk = _rotate(kk.reshape(b, s, -1, dh), tables)
    vv = vv.reshape(b, s, -1, dh)
    g = cfg.n_heads // cfg.n_kv_heads
    idx = torch.arange(h0, h0 + hl, device=x.device) // g - kv0
    return q, kk, vv, idx


def _attn_out(att, ranks):
    """(B,S,h,Dh) attention of the rank's heads -> its slice of the
    output features (a gathered attention keeps its own slice)."""
    att = att.reshape(*att.shape[:2], -1)
    return ranks.features(att) if ranks.q_heads()[2] else att


def _ffn_ranks(x, lp, cfg, ranks):
    """The block's second half on the normed, whole ``x``: (partial y
    over ``model``, aux)."""
    dt = cfg.dtype
    wi = ranks.weight("wi", lp["wi"], dt)
    wo = ranks.weight("wo_ff", lp["wo_ff"], dt)
    if cfg.moe is None:
        return dense_ffn(x, wi, wo, cfg), 0.0
    return moe_ffn(x, ranks.weight("router", lp["router"], dt), wi, wo,
                   cfg, ranks)


def _layer_ranks(x, lp, cfg, pos, k_valid, tables, ranks):
    """One block on this rank: ``x`` its rows (and sequence slice with
    ``seq_parallel``), whole over ``d_model``. Returns (x, aux)."""
    dt = cfg.dtype
    hx = ranks.block_in(rmsnorm(x, ranks.weight("ln1", lp["ln1"], dt),
                                cfg.norm_eps))
    q, kk, vv, idx = _qkv_ranks(hx, lp, cfg, tables, ranks)
    att = attention(q, kk[:, :, idx], vv[:, :, idx], pos, pos, cfg, k_valid)
    x = x + ranks.block_out(_attn_out(att, ranks)
                            @ ranks.weight("wo", lp["wo"], dt))
    hx = ranks.block_in(rmsnorm(x, ranks.weight("ln2", lp["ln2"], dt),
                                cfg.norm_eps))
    y, aux = _ffn_ranks(hx, lp, cfg, ranks)
    return x + ranks.block_out(y), aux


def _forward_ranks(params, tokens, cfg, ranks):
    """transformer_forward on this rank: (its vocab slice of the logits
    of its rows, aux)."""
    b, s = tokens.shape
    table = ranks.weight("embed", params["embed"], cfg.dtype)
    x = _embed_ranks(table, tokens, cfg, ranks)
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None].expand(b, s)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    tables = _rope_tables(cfg, positions)
    for lp in _layer_views(params):
        if _remat(cfg):
            x, a = checkpoint(_layer_ranks, x, lp, cfg, positions, None,
                              tables, ranks, use_reentrant=False)
        else:
            x, a = _layer_ranks(x, lp, cfg, positions, None, tables, ranks)
        aux = aux + a
    x = ranks.block_in(rmsnorm(x, ranks.weight("ln_f", params["ln_f"],
                                                cfg.dtype), cfg.norm_eps))
    return _head_ranks(params, table, x, cfg, ranks), aux


def _lm_loss_ranks(params, tokens, cfg, aux_weight, ranks):
    """This rank's share of ``lm_loss`` (the shares sum to it over the
    mesh): a vocab-parallel cross-entropy of its rows, the logsumexp and
    the target logit summed over ``model``."""
    logits, aux = _forward_ranks(params, tokens[:, :-1], cfg, ranks)
    logits = logits.to(torch.float32)
    if cfg.vocab_chunks > 1:
        v = logits.shape[-1]
        csz = -(-v // cfg.vocab_chunks)
        lp = F.pad(logits, (0, cfg.vocab_chunks * csz - v), value=-1e30)
        chunks = lp.reshape(*lp.shape[:2], cfg.vocab_chunks, csz)
        lse = torch.logsumexp(torch.logsumexp(chunks, -1), -1)
    else:
        lse = torch.logsumexp(logits, -1)
    if ranks.model is not None:
        top = coll.all_reduce(lse.detach(), ranks.mesh, "model", "max")
        lse = top + torch.log(ranks.sum_model(torch.exp(lse - top)))
    local = tokens[:, 1:].long() - ranks.vocab_start()
    ok = (local >= 0) & (local < logits.shape[-1])
    tgt = torch.gather(logits, -1, torch.where(ok, local, 0)[..., None])
    tgt = ranks.sum_model(torch.where(ok, tgt[..., 0], 0.0))
    nll = (lse - tgt).mean()
    return (nll + aux_weight * aux) / float(ranks.n_data * ranks.m)


def _cache_tail(kv, ranks):
    """A (B,S,Hk,Dh) key or value stream in the cache's layout on this
    rank (``Ranks.cache_layout``)."""
    if ranks.cache_layout() == "dh":         # kv heads gathered, whole
        n = kv.shape[-1] // ranks.m
        return kv[..., ranks.mr * n:(ranks.mr + 1) * n]
    return kv


def _prefill_ranks(params, tokens, cfg, ranks):
    b, s = tokens.shape
    dt = cfg.dtype
    s_cache = cache_length(cfg, s)
    table = ranks.weight("embed", params["embed"], cfg.dtype)
    x = _embed_ranks(table, tokens, cfg, ranks)
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None].expand(b, s)
    ks, vs = [], []
    tables = _rope_tables(cfg, positions)
    for lp in _layer_views(params):
        hx = ranks.block_in(rmsnorm(x, ranks.weight("ln1", lp["ln1"], dt),
                                    cfg.norm_eps))
        q, kk, vv, idx = _qkv_ranks(hx, lp, cfg, tables, ranks)
        att = attention(q, kk[:, :, idx], vv[:, :, idx], positions,
                        positions, cfg)
        x = x + ranks.block_out(_attn_out(att, ranks)
                                @ ranks.weight("wo", lp["wo"], dt))
        hx = ranks.block_in(rmsnorm(x, ranks.weight("ln2", lp["ln2"], dt),
                                    cfg.norm_eps))
        y, _ = _ffn_ranks(hx, lp, cfg, ranks)
        x = x + ranks.block_out(y)
        kk, vv = _cache_tail(kk, ranks), _cache_tail(vv, ranks)
        ks.append(torch.roll(kk[:, -s_cache:], s % s_cache, dims=1))
        vs.append(torch.roll(vv[:, -s_cache:], s % s_cache, dims=1))
    x = ranks.block_in(x)
    x = rmsnorm(x[:, -1], ranks.weight("ln_f", params["ln_f"], dt),
                cfg.norm_eps)
    cache = {"k": torch.stack(ks), "v": torch.stack(vs),
             "pos": torch.full((b,), s, dtype=torch.int32, device=x.device)}
    return _head_ranks(params, table, x, cfg, ranks), cache


def _decode_attend_ranks(hx, lp, cfg, ck, cv, rows, slot, tables, q_pos,
                         k_pos, k_valid, mask, ranks):
    """One layer's decode attention on this rank, writing this step's key
    and value into its cache shard ``ck``/``cv`` (B,S,Hk,Dh): the
    output features' slice it feeds ``wo``."""
    b, dh, dt = hx.shape[0], cfg.head_dim, cfg.dtype
    layout = ranks.cache_layout()
    q = hx @ ranks.weight("wq", lp["wq"], dt)
    kk = hx @ ranks.weight("wk", lp["wk"], dt)
    vv = hx @ ranks.weight("wv", lp["wv"], dt)
    g = cfg.n_heads // cfg.n_kv_heads
    if layout == "heads":       # whole kv heads, so whole q heads too
        h0, hl, _ = ranks.q_heads()
        q = _rotate(q.reshape(b, 1, hl, dh), tables)
        ck[rows, slot] = _rotate(kk.reshape(b, 1, -1, dh), tables)[:, 0]
        cv[rows, slot] = vv.reshape(b, 1, -1, dh)[:, 0]
        kv0 = ranks.mr * (cfg.n_kv_heads // ranks.m)
        idx = torch.arange(h0, h0 + hl, device=hx.device) // g - kv0
        att = attention_naive(q, ck[:, :, idx], cv[:, :, idx], q_pos, k_pos,
                              cfg, k_valid, mask=mask)
        return att.reshape(b, 1, -1)
    q = _rotate(ranks.gather_model(q).reshape(b, 1, -1, dh), tables)
    kk = _rotate(ranks.gather_model(kk).reshape(b, 1, -1, dh), tables)
    vv = ranks.gather_model(vv).reshape(b, 1, -1, dh)
    idx = torch.arange(cfg.n_heads, device=hx.device) // g
    if layout != "dh":          # the cache whole on every model rank
        ck[rows, slot], cv[rows, slot] = kk[:, 0], vv[:, 0]
        att = attention_naive(q, ck[:, :, idx], cv[:, :, idx], q_pos, k_pos,
                              cfg, k_valid, mask=mask)
        return ranks.features(att.reshape(b, 1, -1))
    # the cache split on head_dim: partial scores summed over model
    n = dh // ranks.m
    lo = ranks.mr * n
    ck[rows, slot] = kk[:, 0, :, lo:lo + n]
    cv[rows, slot] = vv[:, 0, :, lo:lo + n]
    logits = torch.einsum("bqhd,bshd->bhqs", q[..., lo:lo + n],
                          ck[:, :, idx]).to(torch.float32)
    logits = ranks.sum_model(logits) * (1.0 / np.sqrt(dh))
    logits = torch.where(mask, logits, -1e30)
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    att = torch.einsum("bhqs,bshd->bqhd", p, cv[:, :, idx])   # (B,1,H,Dh/m)
    att = ranks.gather_model(att, -1)
    return ranks.features(att.reshape(b, 1, -1))


def _decode_ranks(params, cache, tokens, cfg, ranks):
    """decode_step on this rank; its cache shards (``cache``'s ``k`` and
    ``v``) are written in place (the decode cell donates them)."""
    b = tokens.shape[0]
    s_cache = cache["k"].shape[2]
    dt = cfg.dtype
    pos = cache["pos"]
    q_pos = pos[:, None]
    slot = (pos % s_cache).long()
    rows = torch.arange(b, device=pos.device)
    table = ranks.weight("embed", params["embed"], cfg.dtype)
    x = _embed_ranks(table, tokens, cfg, ranks)
    slots = torch.arange(s_cache, dtype=torch.int32, device=pos.device)[None]
    k_pos = pos[:, None] - torch.remainder(pos[:, None] - slots, s_cache)
    k_valid = k_pos >= 0
    tables = _rope_tables(cfg, q_pos)
    mask = _naive_mask(q_pos, k_pos, cfg, k_valid)
    for i, lp in enumerate(_layer_views(params)):
        hx = rmsnorm(x, ranks.weight("ln1", lp["ln1"], dt), cfg.norm_eps)
        att = _decode_attend_ranks(hx, lp, cfg, cache["k"][i], cache["v"][i],
                                   rows, slot, tables, q_pos, k_pos, k_valid,
                                   mask, ranks)
        x = x + ranks.block_out(att @ ranks.weight("wo", lp["wo"], dt))
        hx = rmsnorm(x, ranks.weight("ln2", lp["ln2"], dt), cfg.norm_eps)
        y, _ = _ffn_ranks(hx, lp, cfg, ranks)
        x = x + ranks.block_out(y)
    x = rmsnorm(x, ranks.weight("ln_f", params["ln_f"], dt), cfg.norm_eps)
    new_cache = {"k": cache["k"], "v": cache["v"], "pos": pos + 1}
    return _head_ranks(params, table, x, cfg, ranks), new_cache


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
