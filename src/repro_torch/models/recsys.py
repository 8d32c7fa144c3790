"""RecSys ranking models: AutoInt, DCN-v2, DIEN (AUGRU), DLRM (MLPerf)
(port of ``repro/models/recsys.py``).

Shared substrate: an EmbeddingBag written from plain tensor ops, as in the
reference: single-hot lookups are row gathers and multi-hot bags are a
gather plus a segment reduction (an accumulating ``index_put_``, or
``scatter_reduce`` for the max).
Tables are per-field tensors, as the reference's per-field arrays.

A lookup keeps ``jnp.take``'s result in the reference: an id of -1 (any
id in [-rows, 0)) wraps to the end, and an id past either end gives a row
of NaN (its ``mode="fill"``). The index is clamped, the rows gathered and
NaN written where the id was out of range, with no read back to the host.

The ``retrieval_cand`` shape (1 query x 1M candidates) is served by the
cells' retrieval step: the user vector against the gathered candidate
rows through the dense top-k kernel (``kernels/topk_scoring``).

Across ranks (``ranks=``, a :class:`Ranks`): every ``table`` leaf's rows
lie over the grid (``data`` and ``model``), each rank holding the chunk
``sharding.local_slices`` gives it, and everything else is replicated.
The single-hot lookups the models make are then masked partial lookups
summed over the grid: the ids are gathered over the grid axes that split
them, each rank reads the rows it holds and writes zeros elsewhere, and
one reduce-scatter over those axes and one all-reduce over the others
give each rank its rows (their shapes do not depend on the data, so a
dry run traces them, and nothing is read back to the host). ``jnp.take``'s
result holds on the global padded row count: an id in [-R, 0) wraps, and
NaN is written after the sum where the global id is out of range. A
loss under ``ranks`` is the rank's share (the shares sum to the loss).
``embedding_bag`` and ``masked_bag`` stay one-rank functions: no cell
reaches them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence

import torch

from repro_torch.core import prng
from repro_torch.device import resolve_device
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.sharding import GridRanks
from repro_torch.models.transformer import _dense_init

# Criteo cardinalities: Kaggle display-advertising (AutoInt/DCN-family) and
# Terabyte (MLPerf DLRM). Public values from the respective benchmarks.
CRITEO_KAGGLE_CARDS = (
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683,
    8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18, 15,
    286181, 105, 142572)
CRITEO_TB_CARDS = (
    45833188, 36746, 17245, 7413, 20243, 3, 7114, 1441, 62, 29275261,
    1572176, 345138, 10, 2209, 11267, 128, 4, 974, 14, 48937457, 11316796,
    40094537, 452104, 12606, 104, 35)


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    arch: str                      # autoint | dcn_v2 | dien | dlrm
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 16
    vocab_sizes: Sequence[int] = CRITEO_KAGGLE_CARDS
    # autoint
    n_attn_layers: int = 3
    n_heads: int = 2
    d_attn: int = 32
    # dcn-v2
    n_cross_layers: int = 3
    mlp_dims: Sequence[int] = (1024, 1024, 512)
    # dlrm
    bot_mlp: Sequence[int] = (512, 256, 128)
    top_mlp: Sequence[int] = (1024, 1024, 512, 256, 1)
    # dien
    seq_len: int = 100
    gru_dim: int = 108
    dien_mlp: Sequence[int] = (200, 80)
    item_vocab: int = 1_000_000
    cat_vocab: int = 10_000
    dtype: Any = torch.float32


# ---------------------------------------------------------------------------
# EmbeddingBag substrate
# ---------------------------------------------------------------------------

def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Single-hot lookup: a row gather with ``jnp.take``'s result (ids in
    [-rows, 0) wrap, ids past either end give NaN rows)."""
    n = table.shape[0]
    ids = ids.long()
    idx = torch.where(ids < 0, ids + n, ids)
    valid = (idx >= 0) & (idx < n)
    rows = table[idx.clamp(0, max(n - 1, 0))]
    return torch.where(valid[..., None], rows, torch.nan)


class Ranks(GridRanks):
    """What one rank of ``mesh`` holds and runs of a recsys model whose
    tables are row-sharded over the grid: built by
    ``launch/cells.build_recsys_cell``, passed as ``ranks=``. ``batch``
    are the mesh axes the batch's rows lie over (those of size 1 left
    out)."""

    def __init__(self, mesh, batch_axes=()):
        super().__init__(mesh)
        self.batch = tuple(a for a in batch_axes if self.sizes[a] > 1)

    def lookup(self, pairs, split=None) -> list:
        """``embedding_lookup`` of each (local table, ids) pair, the
        tables row-sharded over the grid and the ids' leading dim split
        over the grid axes ``split`` (the batch's by default): the ids
        gathered over ``split``, each rank's partial rows (zeros where it
        does not hold the row), one reduce-scatter over ``split`` and one
        all-reduce over the rest of the grid for all pairs together, then
        NaN where the global id is out of range. The gradient of each
        table stays on its shard."""
        split = self.axes(self.batch if split is None else split)
        rest = tuple(a for a in self.grid if a not in split)
        parts, valid = [], []
        for table, ids in pairs:
            n_l = table.shape[0]
            rows = n_l * self.g
            ids = ids.long()
            idx = torch.where(ids < 0, ids + rows, ids)
            valid.append((idx >= 0) & (idx < rows))
            if split:
                idx = coll.all_gather(idx, self.mesh, split)
            loc = idx - self.s * n_l
            own = (loc >= 0) & (loc < n_l)
            got = table[loc.clamp(0, max(n_l - 1, 0))]
            got = torch.where(own[..., None], got, 0.0)
            parts.append(got.reshape(got.shape[0], -1))
        flat = self.sum(self.scatter(torch.cat(parts, 1), split), rest)
        out, off = [], 0
        for (table, ids), ok in zip(pairs, valid):
            width = math.prod(ids.shape[1:]) * table.shape[1]
            piece = flat[:, off:off + width].reshape(*ids.shape,
                                                     table.shape[1])
            off += width
            out.append(torch.where(ok[..., None], piece, torch.nan))
        return out


def _lookups(pairs, ranks: Optional[Ranks] = None, split=None) -> list:
    """Single-hot lookups of (table, ids) pairs: one rank's
    ``embedding_lookup`` each, or :meth:`Ranks.lookup` under ``ranks``."""
    if ranks is None:
        return [embedding_lookup(t, i) for t, i in pairs]
    return ranks.lookup(pairs, split)


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  offsets: torch.Tensor, *, num_bags: int,
                  weights: Optional[torch.Tensor] = None,
                  mode: str = "sum") -> torch.Tensor:
    """torch.nn.EmbeddingBag semantics with (ids, offsets) layout.

    ids i32[nnz], offsets i32[num_bags] (bag b spans ids[offsets[b]:offsets[b+1]]).
    Gather + segment reduction, as the reference's ``segment_sum`` /
    ``segment_max``: an empty bag sums to 0, and its max is -inf; ids
    before ``offsets[0]`` belong to no bag.
    """
    nnz = ids.shape[0]
    seg = torch.searchsorted(offsets.long(), torch.arange(
        nnz, dtype=torch.int64, device=ids.device), right=True) - 1
    # ids outside every bag go to a spare row, dropped at the end
    seg = torch.where((seg >= 0) & (seg < num_bags), seg, num_bags)
    rows = embedding_lookup(table, ids)
    if weights is not None:
        rows = rows * weights[:, None]
    shape = (num_bags + 1, rows.shape[1])
    if mode in ("sum", "mean"):
        # an accumulating index_put_: sort-based on the card, the same
        # sums from run to run
        s = torch.zeros(shape, dtype=rows.dtype, device=rows.device
                        ).index_put_((seg,), rows, accumulate=True)
        if mode == "sum":
            return s[:num_bags]
        c = torch.zeros((num_bags + 1, 1), dtype=rows.dtype,
                        device=rows.device).index_put_(
            (seg,), torch.ones((nnz, 1), dtype=rows.dtype,
                               device=rows.device), accumulate=True)
        return (s / torch.clamp(c, min=1.0))[:num_bags]
    if mode == "max":
        out = torch.full(shape, -torch.inf, dtype=rows.dtype,
                         device=rows.device)
        idx = seg[:, None].expand(-1, rows.shape[1])
        return out.scatter_reduce(0, idx, rows, "amax")[:num_bags]
    raise ValueError(mode)


def masked_bag(table: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor,
               mode: str = "sum") -> torch.Tensor:
    """Dense (B, nnz) multi-hot bag with mask — the padded-batch layout."""
    rows = embedding_lookup(table, torch.clamp(ids, min=0))
    rows = rows * mask[..., None].to(rows.dtype)
    if mode == "sum":
        return rows.sum(1)
    if mode == "mean":
        return rows.sum(1) / torch.clamp(
            mask.sum(1, keepdim=True).to(rows.dtype), min=1.0)
    raise ValueError(mode)


def _pad_rows(v: int, multiple: int = 256) -> int:
    """Embedding tables are row-sharded over the mesh 'model' axis; rows are
    padded to a 256 multiple (covers any axis size up to a full 256-chip
    pod). Padding rows are never indexed."""
    return ((v + multiple - 1) // multiple) * multiple


def _field_tables(key, cfg: RecsysConfig, dim: int, cards, device) -> dict:
    keys = prng.split(key, len(cards))
    return {f"table_{i}": _dense_init(keys[i], (_pad_rows(v), dim), 1,
                                      cfg.dtype, device)
            for i, v in enumerate(cards)}


def field_embeddings(tables: dict, sparse_ids: torch.Tensor,
                     ranks: Optional[Ranks] = None) -> torch.Tensor:
    """(B, n_fields) ids -> (B, n_fields, D), one table per field."""
    return torch.stack(_lookups(
        [(tables[f"table_{i}"], sparse_ids[:, i])
         for i in range(sparse_ids.shape[1])], ranks), dim=1)


def _zeros(n, cfg, device):
    return torch.zeros((n,), dtype=cfg.dtype, device=device)


def _mlp_init(key, dims, cfg, in_dim, device):
    params = []
    for d in dims:
        key, k1 = prng.split(key)
        params.append({"w": _dense_init(k1, (in_dim, d), 0, cfg.dtype,
                                        device),
                       "b": _zeros(d, cfg, device)})
        in_dim = d
    return params


def _mlp_apply(params, x, final_act=False):
    for i, lyr in enumerate(params):
        x = x @ lyr["w"] + lyr["b"]
        if i < len(params) - 1 or final_act:
            x = torch.relu(x)
    return x


def _head_init(key, head_in, cfg, device):
    return {"w": _dense_init(key, (head_in, 1), 0, cfg.dtype, device),
            "b": _zeros(1, cfg, device)}


# ---------------------------------------------------------------------------
# DLRM (MLPerf config)
# ---------------------------------------------------------------------------

def init_dlrm(key, cfg: RecsysConfig, device="cuda"):
    device = resolve_device(device)
    k1, k2, k3 = prng.split(key, 3)
    d = cfg.embed_dim
    n_f = cfg.n_sparse + 1
    n_inter = n_f * (n_f - 1) // 2
    return {
        "tables": _field_tables(k1, cfg, d, cfg.vocab_sizes, device),
        "bot": _mlp_init(k2, cfg.bot_mlp, cfg, cfg.n_dense, device),
        "top": _mlp_init(k3, cfg.top_mlp, cfg, n_inter + d, device),
    }


def dlrm_forward(params, batch, cfg: RecsysConfig, ranks=None):
    dense = _mlp_apply(params["bot"], batch["dense"], final_act=True)  # (B,D)
    emb = field_embeddings(params["tables"], batch["sparse"], ranks)   # (B,F,D)
    feats = torch.cat([dense[:, None, :], emb], dim=1)                 # (B,F+1,D)
    inter = torch.einsum("bfd,bgd->bfg", feats, feats)
    f = feats.shape[1]
    iu, ju = torch.triu_indices(f, f, offset=1, device=feats.device)
    flat = inter[:, iu, ju]                                            # (B,F(F-1)/2)
    x = torch.cat([flat, dense], dim=-1)
    return _mlp_apply(params["top"], x)[:, 0]


# ---------------------------------------------------------------------------
# DCN-v2
# ---------------------------------------------------------------------------

def init_dcn_v2(key, cfg: RecsysConfig, device="cuda"):
    device = resolve_device(device)
    k1, k2, k3 = prng.split(key, 3)
    d0 = cfg.n_dense + cfg.n_sparse * cfg.embed_dim
    cross = []
    for _ in range(cfg.n_cross_layers):
        k2, kk = prng.split(k2)
        cross.append({"w": _dense_init(kk, (d0, d0), 0, cfg.dtype, device),
                      "b": _zeros(d0, cfg, device)})
    deep = _mlp_init(k3, cfg.mlp_dims, cfg, d0, device)
    k3, kk = prng.split(k3)
    return {"tables": _field_tables(k1, cfg, cfg.embed_dim, cfg.vocab_sizes,
                                    device),
            "cross": cross, "deep": deep,
            "head": _head_init(kk, d0 + cfg.mlp_dims[-1], cfg, device)}


def dcn_v2_forward(params, batch, cfg: RecsysConfig, ranks=None):
    emb = field_embeddings(params["tables"], batch["sparse"], ranks)
    x0 = torch.cat([batch["dense"], emb.reshape(emb.shape[0], -1)], -1)
    x = x0
    for lyr in params["cross"]:                  # x_{l+1} = x0 * (W x_l + b) + x_l
        x = x0 * (x @ lyr["w"] + lyr["b"]) + x
    deep = _mlp_apply(params["deep"], x0, final_act=True)
    z = torch.cat([x, deep], -1)
    return (z @ params["head"]["w"] + params["head"]["b"])[:, 0]


# ---------------------------------------------------------------------------
# AutoInt
# ---------------------------------------------------------------------------

def _autoint_cards(cfg: RecsysConfig) -> tuple:
    # 39 fields on Criteo = 13 bucketised dense + 26 categorical
    if cfg.n_sparse > len(cfg.vocab_sizes):
        return (tuple([1000] * (cfg.n_sparse - len(cfg.vocab_sizes)))
                + tuple(cfg.vocab_sizes))
    return tuple(cfg.vocab_sizes[:cfg.n_sparse])


def init_autoint(key, cfg: RecsysConfig, device="cuda"):
    device = resolve_device(device)
    k1, k2, k3 = prng.split(key, 3)
    d, da, h = cfg.embed_dim, cfg.d_attn, cfg.n_heads
    layers = []
    in_d = d
    for _ in range(cfg.n_attn_layers):
        k2, kq, kk, kv, kr = prng.split(k2, 5)
        layers.append({name: _dense_init(k, (in_d, h * da), 0, cfg.dtype,
                                         device)
                       for name, k in (("wq", kq), ("wk", kk), ("wv", kv),
                                       ("wres", kr))})
        in_d = h * da
    return {"tables": _field_tables(k1, cfg, d, _autoint_cards(cfg), device),
            "attn": layers,
            "head": _head_init(k3, cfg.n_sparse * in_d, cfg, device)}


def autoint_forward(params, batch, cfg: RecsysConfig, ranks=None):
    x = field_embeddings(params["tables"], batch["sparse"], ranks)  # (B,F,D)
    h, da = cfg.n_heads, cfg.d_attn
    for lyr in params["attn"]:
        b, f, _ = x.shape
        q = (x @ lyr["wq"]).reshape(b, f, h, da)
        k = (x @ lyr["wk"]).reshape(b, f, h, da)
        v = (x @ lyr["wv"]).reshape(b, f, h, da)
        logits = torch.einsum("bfhd,bghd->bhfg", q, k) / da ** 0.5
        p = torch.softmax(logits, -1)
        o = torch.einsum("bhfg,bghd->bfhd", p, v).reshape(b, f, h * da)
        x = torch.relu(o + x @ lyr["wres"])
    flat = x.reshape(x.shape[0], -1)
    return (flat @ params["head"]["w"] + params["head"]["b"])[:, 0]


# ---------------------------------------------------------------------------
# DIEN (GRU + attention + AUGRU)
# ---------------------------------------------------------------------------

def _gru_init(key, in_dim, hid, cfg, device):
    k1, k2 = prng.split(key)
    return {"wx": _dense_init(k1, (in_dim, 3 * hid), 0, cfg.dtype, device),
            "wh": _dense_init(k2, (hid, 3 * hid), 0, cfg.dtype, device),
            "b": _zeros(3 * hid, cfg, device)}


def _gru_cell(p, h, x, att=None):
    """Standard GRU; if ``att`` given, AUGRU: update gate scaled by attention."""
    hid = h.shape[-1]
    gates = x @ p["wx"] + h @ p["wh"] + p["b"]
    r = torch.sigmoid(gates[..., :hid])
    z = torch.sigmoid(gates[..., hid:2 * hid])
    n = torch.tanh(gates[..., 2 * hid:]
                   + (r - 1.0) * (h @ p["wh"][:, 2 * hid:]))
    if att is not None:
        z = z * att[..., None]
    return (1.0 - z) * n + z * h


def init_dien(key, cfg: RecsysConfig, device="cuda"):
    device = resolve_device(device)
    k1, k2, k3, k4, k5, k6 = prng.split(key, 6)
    d = cfg.embed_dim            # 18 for item and category each
    in_dim = 2 * d               # concat(item, cat) = 36
    hid = cfg.gru_dim
    mlp_in = hid + in_dim
    return {
        "item_table": _dense_init(k1, (_pad_rows(cfg.item_vocab), d), 1,
                                  cfg.dtype, device),
        "cat_table": _dense_init(k2, (_pad_rows(cfg.cat_vocab), d), 1,
                                 cfg.dtype, device),
        "gru1": _gru_init(k3, in_dim, hid, cfg, device),
        "augru": _gru_init(k4, hid, hid, cfg, device),
        "att": {"w": _dense_init(k5, (hid + in_dim, 1), 0, cfg.dtype,
                                 device)},
        "mlp": _mlp_init(k6, tuple(cfg.dien_mlp) + (1,), cfg, mlp_in, device),
    }


def dien_forward(params, batch, cfg: RecsysConfig, ranks=None):
    it, ct, ti, tc = _lookups(                                         # (B,T,d)
        [(params["item_table"], batch["hist_items"]),
         (params["cat_table"], batch["hist_cats"]),
         (params["item_table"], batch["target_item"]),
         (params["cat_table"], batch["target_cat"])], ranks)
    seq = torch.cat([it, ct], -1)                                      # (B,T,2d)
    tgt = torch.cat([ti, tc], -1)
    mask = batch["hist_mask"].to(seq.dtype)                            # (B,T)
    b, t, _ = seq.shape
    keep = mask[:, :, None] > 0

    # the reference's two lax.scans, one step a position, each keeping
    # the previous state where the position is masked
    h = torch.zeros((b, cfg.gru_dim), dtype=seq.dtype, device=seq.device)
    states = []
    for i in range(t):
        h = torch.where(keep[:, i], _gru_cell(params["gru1"], h, seq[:, i]),
                        h)
        states.append(h)
    states = torch.stack(states, 1)                                    # (B,T,H)

    att_in = torch.cat([states, tgt[:, None].expand(b, t, tgt.shape[-1])],
                       -1)
    att_logit = (att_in @ params["att"]["w"])[..., 0]
    att_logit = torch.where(mask > 0, att_logit, -1e30)
    att = torch.softmax(att_logit, -1)                                 # (B,T)

    h = torch.zeros((b, cfg.gru_dim), dtype=seq.dtype, device=seq.device)
    for i in range(t):
        h = torch.where(keep[:, i], _gru_cell(params["augru"], h,
                                              states[:, i], att=att[:, i]),
                        h)
    z = torch.cat([h, tgt], -1)
    return _mlp_apply(params["mlp"], z)[:, 0]


# ---------------------------------------------------------------------------
# Common: loss, retrieval scoring
# ---------------------------------------------------------------------------

ARCHS = {
    "autoint": (init_autoint, autoint_forward),
    "dcn_v2": (init_dcn_v2, dcn_v2_forward),
    "dien": (init_dien, dien_forward),
    "dlrm": (init_dlrm, dlrm_forward),
}


def init_recsys(key, cfg: RecsysConfig, device="cuda"):
    """The reference's parameter tree from the same key, bit for bit,
    drawn on ``device`` (``meta``: the shapes alone); a large table is
    drawn in bounded pieces (``models/transformer.DRAW_CHUNK``)."""
    return ARCHS[cfg.arch][0](key, cfg, device)


def recsys_forward(params, batch, cfg: RecsysConfig,
                   ranks: Optional[Ranks] = None):
    """The logits of the batch's rows (under ``ranks``: of this rank's
    rows, from its shards)."""
    return ARCHS[cfg.arch][1](params, batch, cfg, ranks)


def bce_loss(params, batch, cfg: RecsysConfig,
             ranks: Optional[Ranks] = None):
    """The mean binary cross-entropy of the logits; under ``ranks`` this
    rank's share of it: its rows' mean over the ``n_all`` ranks (each
    batch chunk's ranks hold its rows alike, so the shares sum to the
    mean over the batch)."""
    logit = recsys_forward(params, batch, cfg, ranks).to(torch.float32)
    y = batch["label"].to(torch.float32)
    loss = torch.mean(torch.clamp(logit, min=0) - logit * y
                      + torch.log1p(torch.exp(-torch.abs(logit))))
    return loss if ranks is None else loss / ranks.n_all


def user_vector(params, batch, cfg: RecsysConfig,
                ranks: Optional[Ranks] = None) -> torch.Tensor:
    """Query-side tower for retrieval_cand scoring (per-arch)."""
    if cfg.arch == "dlrm":
        return _mlp_apply(params["bot"], batch["dense"], final_act=True)
    if cfg.arch == "dien":
        it, ct = _lookups([(params["item_table"], batch["hist_items"]),
                           (params["cat_table"], batch["hist_cats"])], ranks)
        seq = torch.cat([it, ct], -1)
        m = batch["hist_mask"][..., None].to(seq.dtype)
        return (seq * m).sum(1) / torch.clamp(m.sum(1), min=1.0)
    # autoint / dcn_v2: mean of field embeddings
    emb = field_embeddings(params["tables"], batch["sparse"], ranks)
    return emb.mean(1)


def item_matrix(params, cfg: RecsysConfig) -> torch.Tensor:
    """Candidate-side embedding matrix used for retrieval scoring (of a
    rank's table shard: its rows of the matrix)."""
    if cfg.arch == "dien":
        t = params["item_table"]
        return torch.cat([t, torch.zeros((t.shape[0], cfg.embed_dim),
                                         dtype=t.dtype, device=t.device)], -1)
    # largest categorical table acts as the item corpus
    big = max(range(len(cfg.vocab_sizes)), key=lambda i: cfg.vocab_sizes[i])
    return params["tables"][f"table_{big}"]


def item_matrix_dim(cfg: RecsysConfig) -> int:
    return 2 * cfg.embed_dim if cfg.arch == "dien" else cfg.embed_dim


def retrieval_scores(params, batch, cfg: RecsysConfig,
                     candidate_ids: torch.Tensor) -> torch.Tensor:
    """Score one query batch against a candidate set: (B, n_cand) dots.
    Top-k selection happens in kernels/topk_scoring."""
    u = user_vector(params, batch, cfg)                       # (B, D)
    return u @ candidate_rows(params, cfg, candidate_ids).T


def candidate_rows(params, cfg: RecsysConfig, candidate_ids: torch.Tensor,
                   ranks: Optional[Ranks] = None) -> torch.Tensor:
    """The item matrix's rows of ``candidate_ids`` (n_cand, D), as the
    reference's ``jnp.take`` gives them; under ``ranks``, the rows of this
    rank's candidates, which lie over ``model``."""
    return _lookups([(item_matrix(params, cfg), candidate_ids)], ranks,
                    ("model",))[0]
