"""Cell builders (port of ``repro/launch/cells.py``): one (architecture x
input shape x mesh) step with the specs of its arguments, for the three
families: LM (train, prefill, decode), recsys (train, serve, retrieval)
and GNN (MACE: train, train_node, train_sampled).

Each builder returns the step function and, for each argument, its
shape, dtype and the placements the mesh's rules give it
(``distributed/sharding.Shaped``, the reference's ``ShapeDtypeStruct``
with its ``NamedSharding``), built from the config's shapes with nothing
allocated (parameter shapes come from the inits on the ``meta`` device).
The launchers build the same cells on real tensors; ``launch/dryrun.py``
runs them on fake ones.

A train step is the reference's: the loss, its gradient by autograd
(unused parameters get zeros, as ``jax.grad`` gives them), then AdamW.
The reference donates its first two arguments (``donate_argnums=(0,
1)``); here the step writes the new parameters and AdamW state into the
tensors it was given, leaf by leaf (``train/optimizer.adamw_update_``,
bit-equal to ``adamw_update``), so the card never holds two copies of the
training state. The recsys retrieval step scores the candidates' rows
through the dense top-k kernel (``kernels/topk_scoring/ops.topk_scores``:
the plain path on the CPU), ties to the lowest candidate position as the
reference's ``lax.top_k`` gives them.

The activation-sharding options (the LM's ``act_*``, MACE's
``act_grid_axes``, the retrieval step's ``sharded_topk``) are set as the
reference sets them; on one rank they change no value. A mesh of more
than one rank raises: training and serving across ranks (the gradient
all-reduce over ``pod``/``data``, ZeRO ``embed`` over ``data``, Megatron
TP over ``model``, DLRM's row-sharded tables, shard-local top-k, MACE's
node and edge tensors over the grid) is ROADMAP.md queue 1 item 15(d).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from repro_torch.configs import get_arch
from repro_torch.core import prng
from repro_torch.distributed.sharding import (LM_RULES, Shaped, placements,
                                              tree_shardings)
from repro_torch.kernels.topk_scoring.ops import topk_scores
from repro_torch.models import mace as mc
from repro_torch.models import recsys as rs
from repro_torch.models import so3
from repro_torch.models import transformer as tf
from repro_torch.train.optimizer import (AdamWConfig, adamw_update_,
                                         tree_leaves, tree_map,
                                         tree_unflatten)


@dataclasses.dataclass
class Cell:
    arch_id: str
    shape_name: str
    fn: Callable            # the step
    args: tuple             # Shaped specs (shape, dtype, placements)
    kind: str               # train | prefill | decode | serve | retrieval
    model_flops_per_step: float  # 6*N*D style estimate (§Roofline)
    donate: tuple = ()      # arguments the step may write its results into


def _mesh_sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _divisible_axes(mesh, b: int) -> tuple:
    """Largest prefix-trimmed ('pod','data') axis set whose product divides
    the batch (batch=1 decode cells replicate their batch dim)."""
    axes = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
    sizes = _mesh_sizes(mesh)
    while axes and b % math.prod(sizes[a] for a in axes) != 0:
        axes = axes[1:]
    return axes


def _axes_or_none(axes: tuple):
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def _one_rank(mesh, what: str) -> None:
    """Raise unless ``mesh`` is one rank (the multi-rank cells are
    ROADMAP.md queue 1 item 15(d))."""
    if mesh.size() > 1:
        raise NotImplementedError(
            f"{what} on a mesh of {mesh.size()} ranks: training and serving "
            f"across ranks (the gradient all-reduce over pod/data, ZeRO "
            f"embed over data, Megatron TP over model, DLRM's row-sharded "
            f"tables, shard-local top-k, MACE's node and edge tensors over "
            f"the grid) are not ported to PyTorch yet (ROADMAP.md queue 1 "
            f"item 15(d)); use a 1-rank mesh")


def value_and_grad(loss_fn, params, *args):
    """``loss_fn(params, *args)`` and its gradient tree (autograd over
    detached leaves; a parameter the loss does not use gets zeros)."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(params, leaves), *args)
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    return loss.detach(), tree_unflatten(params, list(grads))


def _opt_specs(mesh, params_sds, param_shard):
    """AdamW state specs: f32 moments placed as the parameters, a
    replicated int32 step."""
    f32 = lambda s, pl: Shaped(s.shape, torch.float32, pl)
    return {"m": tree_map(f32, params_sds, param_shard),
            "v": tree_map(f32, params_sds, param_shard),
            "step": Shaped((), torch.int32, placements(mesh, ()))}


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def _lm_param_specs(mesh, cfg, dtype=None, rules_override=None):
    rules = {**LM_RULES, **(rules_override or {})}
    shard = tree_shardings(mesh, tf.param_logical_axes(cfg), rules)
    specs = tree_map(lambda shape, pl: Shaped(shape, dtype or cfg.param_dtype,
                                              pl),
                     tf.param_shapes(cfg), shard)
    return specs, shard


def _cache_specs(mesh, cfg, batch, max_seq):
    shapes = tf.init_kv_cache(cfg, batch, max_seq, device="meta")
    b_ax = _axes_or_none(_divisible_axes(mesh, batch))
    model_size = _mesh_sizes(mesh).get("model", 1)
    # shard kv heads over 'model' when they divide; else the head_dim; the
    # rolling (L, B, S, Hkv, Dh) cache is the decode-cell memory budget
    if cfg.n_kv_heads % model_size == 0:
        kv_spec = (None, b_ax, None, "model", None)
    elif cfg.head_dim % model_size == 0:
        kv_spec = (None, b_ax, None, None, "model")
    else:
        kv_spec = (None, b_ax, None, None, None)
    spec = {"k": kv_spec, "v": kv_spec, "pos": (b_ax,)}
    return {k: Shaped(tuple(t.shape), t.dtype, placements(mesh, spec[k]))
            for k, t in shapes.items()}


def lm_model_flops(cfg, n_tokens, kind):
    n_active = tf.active_params(cfg)
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_active * n_tokens


def lm_grads(params, tokens, cfg, microbatches: int = 1):
    """The train step's loss and gradients: over the whole batch, or the
    mean over ``microbatches`` row slices, the gradients summed in f32 in
    slice order (the reference's scan)."""
    if microbatches == 1:
        return value_and_grad(tf.lm_loss, params, tokens, cfg)
    b, s1 = tokens.shape
    grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    losses = []
    for t in tokens.reshape(microbatches, b // microbatches, s1):
        loss, g = value_and_grad(tf.lm_loss, params, t, cfg)
        for acc, gi in zip(tree_leaves(grads), tree_leaves(g)):
            acc.add_(gi.to(torch.float32) / microbatches)
        losses.append(loss)
    return torch.stack(losses).mean(), grads


def build_lm_cell(arch_id, shape_name, mesh, *, reduced=False,
                  overrides: Optional[dict] = None) -> Cell:
    _one_rank(mesh, "an LM cell")
    spec = get_arch(arch_id)
    cfg = spec.make_reduced() if reduced else spec.make_config()
    # activation sharding options (see models/transformer.py): batch over
    # pod+data, heads/ffn/vocab over model
    b_axes = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
    model_size = _mesh_sizes(mesh).get("model", 1)
    shape0 = spec.shapes[shape_name]
    sp = (shape0["kind"] in ("train", "prefill")
          and shape0["seq_len"] % max(model_size, 1) == 0 and not reduced)
    cfg = dataclasses.replace(
        cfg, act_batch_axes=b_axes or None,
        act_model_axis="model" if "model" in mesh.mesh_dim_names else None,
        seq_parallel=sp)
    cfg_overrides = {k: v for k, v in (overrides or {}).items()
                     if k != "microbatches"}
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = dict(spec.shapes[shape_name])
    if reduced:
        shape.update({"seq_len": min(shape["seq_len"], 64),
                      "global_batch": min(shape["global_batch"], 4)})
    kind = shape["kind"]
    b, s = shape["global_batch"], shape["seq_len"]
    d_axes = _divisible_axes(mesh, b)
    b_ax = _axes_or_none(d_axes)
    cfg = dataclasses.replace(cfg, act_batch_axes=d_axes or None)

    if kind == "train":
        params_sds, param_shard = _lm_param_specs(
            mesh, cfg, rules_override=spec.rules_override)
        opt_sds = _opt_specs(mesh, params_sds, param_shard)
        tokens = Shaped((b, s + 1), torch.int32,
                        placements(mesh, (b_ax, None)))
        opt_cfg = AdamWConfig()
        mb = int((overrides or {}).get("microbatches", 1))

        def train_step(params, opt_state, tokens):
            loss, grads = lm_grads(params, tokens, cfg, mb)
            adamw_update_(grads, opt_state, params, opt_cfg)
            return params, opt_state, loss

        return Cell(arch_id, shape_name, train_step,
                    (params_sds, opt_sds, tokens), kind,
                    lm_model_flops(cfg, b * s, "train"), donate=(0, 1))

    serve_dtype = cfg.dtype
    params_sds, _ = _lm_param_specs(mesh, cfg, dtype=serve_dtype,
                                    rules_override=spec.rules_override)
    if kind == "prefill":
        tokens = Shaped((b, s), torch.int32, placements(mesh, (b_ax, None)))

        @torch.no_grad()
        def prefill_step(params, tokens):
            return tf.prefill(params, tokens, cfg)

        return Cell(arch_id, shape_name, prefill_step,
                    (params_sds, tokens), kind,
                    lm_model_flops(cfg, b * s, "prefill"))

    # decode: one new token against a seq_len-deep KV cache
    cache_sds = _cache_specs(mesh, cfg, b, s)
    tokens = Shaped((b, 1), torch.int32, placements(mesh, (b_ax, None)))

    @torch.no_grad()
    def decode(params, cache, tokens):
        return tf.decode_step(params, cache, tokens, cfg)

    return Cell(arch_id, shape_name, decode,
                (params_sds, cache_sds, tokens), kind,
                lm_model_flops(cfg, b, "decode"), donate=(1,))


# ---------------------------------------------------------------------------
# RecSys cells
# ---------------------------------------------------------------------------

def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, path + (str(i),))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def _recsys_param_specs(mesh, cfg):
    shapes = rs.init_recsys(prng.prng_key(0), cfg, device="meta")
    # tables: rows over the whole grid (the 96GB Criteo-TB tables + AdamW
    # slots must split 256 ways, not 16); everything else replicated
    grid = tuple(a for a in ("model", "data") if a in mesh.mesh_dim_names)

    def shard_for(path, leaf):
        if "table" in "/".join(path):
            return placements(mesh, (grid, None))
        return placements(mesh, ())

    shard = _map_with_path(shard_for, shapes)
    specs = tree_map(lambda t, pl: Shaped(tuple(t.shape), t.dtype, pl),
                     shapes, shard)
    return specs, shard


def _recsys_batch(mesh, cfg, batch):
    b_ax = _axes_or_none(_divisible_axes(mesh, batch))

    def bs(shape, dt):
        return Shaped(shape, dt, placements(
            mesh, (b_ax,) + (None,) * (len(shape) - 1)))
    if cfg.arch == "dien":
        return {
            "target_item": bs((batch,), torch.int32),
            "target_cat": bs((batch,), torch.int32),
            "hist_items": bs((batch, cfg.seq_len), torch.int32),
            "hist_cats": bs((batch, cfg.seq_len), torch.int32),
            "hist_mask": bs((batch, cfg.seq_len), torch.float32),
            "label": bs((batch,), torch.float32),
        }
    out = {"sparse": bs((batch, cfg.n_sparse), torch.int32),
           "label": bs((batch,), torch.float32)}
    if cfg.n_dense:
        out["dense"] = bs((batch, cfg.n_dense), torch.float32)
    return out


def build_recsys_cell(arch_id, shape_name, mesh, *, reduced=False,
                      overrides=None) -> Cell:
    _one_rank(mesh, "a recsys cell")
    spec = get_arch(arch_id)
    cfg = spec.make_reduced() if reduced else spec.make_config()
    cfg_overrides = {k: v for k, v in (overrides or {}).items()
                     if k != "sharded_topk"}
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = dict(spec.shapes[shape_name])
    if reduced:
        shape["batch"] = min(shape["batch"], 8)
        shape["n_candidates"] = min(shape.get("n_candidates", 0), 512)
    kind = shape["kind"]
    b = shape["batch"]
    params_sds, param_shard = _recsys_param_specs(mesh, cfg)
    batch_sds = _recsys_batch(mesh, cfg, b)

    # rough flops: embedding gathers + MLP/attention matmuls (dense dims)
    flops = _recsys_flops(cfg, b)

    if kind == "train":
        opt_sds = _opt_specs(mesh, params_sds, param_shard)
        opt_cfg = AdamWConfig()

        def train_step(params, opt_state, batch):
            loss, grads = value_and_grad(rs.bce_loss, params, batch, cfg)
            adamw_update_(grads, opt_state, params, opt_cfg)
            return params, opt_state, loss

        return Cell(arch_id, shape_name, train_step,
                    (params_sds, opt_sds, batch_sds), kind, 3 * flops,
                    donate=(0, 1))

    if kind == "serve":
        @torch.no_grad()
        def serve_step(params, batch):
            return rs.recsys_forward(params, batch, cfg)

        return Cell(arch_id, shape_name, serve_step,
                    (params_sds, batch_sds), kind, flops)

    # retrieval: 1 query batch x n_candidates, fused top-k. On one rank the
    # sharded_topk variants (a per-shard top-k then a merge, or shard-local
    # candidate pools) select what the global top-k does
    nc = shape["n_candidates"]
    grid = tuple(a for a in ("model", "data") if a in mesh.mesh_dim_names)
    grid_n = math.prod(_mesh_sizes(mesh)[a] for a in grid)
    sharded_topk = (overrides or {}).get("sharded_topk", False)
    if sharded_topk == "local":
        nc = ((nc + grid_n - 1) // grid_n) * grid_n   # pad to the grid
    cand_spec = (grid,) if sharded_topk == "local" else ("model",)
    cand = Shaped((nc,), torch.int32, placements(mesh, cand_spec))
    batch_sds.pop("label")

    @torch.no_grad()
    def retrieval_step(params, batch, candidate_ids):
        u = rs.user_vector(params, batch, cfg)
        rows = rs.candidate_rows(params, cfg, candidate_ids)
        return topk_scores(u, rows, k=min(100, rows.shape[0]))

    d = rs.item_matrix_dim(cfg)
    return Cell(arch_id, shape_name, retrieval_step,
                (params_sds, batch_sds, cand), kind, 2.0 * b * nc * d)


def _recsys_flops(cfg, b):
    if cfg.arch == "dlrm":
        dims = [cfg.n_dense] + list(cfg.bot_mlp)
        f = sum(2 * a * c for a, c in zip(dims[:-1], dims[1:]))
        n_f = cfg.n_sparse + 1
        f += 2 * n_f * n_f * cfg.embed_dim
        top_in = n_f * (n_f - 1) // 2 + cfg.embed_dim
        dims = [top_in] + list(cfg.top_mlp)
        f += sum(2 * a * c for a, c in zip(dims[:-1], dims[1:]))
        return b * f
    if cfg.arch == "dcn_v2":
        d0 = cfg.n_dense + cfg.n_sparse * cfg.embed_dim
        f = cfg.n_cross_layers * 2 * d0 * d0
        dims = [d0] + list(cfg.mlp_dims)
        f += sum(2 * a * c for a, c in zip(dims[:-1], dims[1:]))
        return b * f
    if cfg.arch == "autoint":
        fdim = cfg.n_sparse
        f = 0
        in_d = cfg.embed_dim
        for _ in range(cfg.n_attn_layers):
            hd = cfg.n_heads * cfg.d_attn
            f += fdim * (4 * 2 * in_d * hd) + 2 * fdim * fdim * hd * 2
            in_d = hd
        return b * f
    if cfg.arch == "dien":
        in_d, hd = 2 * cfg.embed_dim, cfg.gru_dim
        per_step = 2 * 3 * hd * (in_d + hd) * 2   # gru1 + augru
        return b * cfg.seq_len * per_step
    return b * 1e6


# ---------------------------------------------------------------------------
# GNN (MACE) cells
# ---------------------------------------------------------------------------

def _mace_batch_sds(mesh, n_nodes, n_edges, d_feat, n_graphs, node_loss):
    grid = _axes_or_none(tuple(a for a in ("data", "model")
                               if a in mesh.mesh_dim_names))

    def nd(shape, dt):
        return Shaped(shape, dt, placements(
            mesh, (grid,) + (None,) * (len(shape) - 1)))
    out = {
        "positions": nd((n_nodes, 3), torch.float32),
        "node_feats": nd((n_nodes, d_feat), torch.float32),
        "edge_src": nd((n_edges,), torch.int32),
        "edge_dst": nd((n_edges,), torch.int32),
        "edge_mask": nd((n_edges,), torch.bool),
        "graph_ids": nd((n_nodes,), torch.int32),
    }
    if node_loss:
        out["node_target"] = nd((n_nodes,), torch.float32)
        out["node_mask"] = nd((n_nodes,), torch.float32)
    else:
        out["energy_target"] = Shaped((n_graphs,), torch.float32,
                                      placements(mesh, ()))
        out["force_target"] = nd((n_nodes, 3), torch.float32)
    return out


def mace_flops(cfg, n_edges, n_nodes):
    paths = so3.valid_paths(cfg.l_max)
    path_f = sum((2 * l1 + 1) * (2 * l2 + 1) * (2 * l3 + 1)
                 for l1, l2, l3 in paths)
    per_edge = 2 * path_f * cfg.channels
    per_node = 2 * 2 * path_f * cfg.channels + 8 * cfg.channels ** 2
    return cfg.n_layers * (n_edges * per_edge + n_nodes * per_node)


def build_gnn_cell(arch_id, shape_name, mesh, *, reduced=False,
                   overrides=None) -> Cell:
    _one_rank(mesh, "a GNN cell")
    spec = get_arch(arch_id)
    cfg = spec.make_reduced() if reduced else spec.make_config()
    shape = dict(spec.shapes[shape_name])
    kind = shape["kind"]

    if kind == "train_sampled":
        # static padded block sizes from the fanout schedule
        bn = shape["batch_nodes"]
        f1, f2 = shape["fanouts"]
        n2 = bn * (f2 + 1)
        n_nodes = n2 * (f1 + 1)
        n_edges = bn * f2 + n2 * f1
        d_feat, n_graphs, node_loss = cfg.d_feat, 1, True
    else:
        n_nodes, n_edges = shape["n_nodes"], shape["n_edges"]
        d_feat = shape.get("d_feat", cfg.d_feat)
        n_graphs = shape.get("batch", shape.get("n_graphs", 1))
        if "batch" in shape:   # batched small graphs
            n_nodes, n_edges = n_nodes * n_graphs, n_edges * n_graphs
        node_loss = kind == "train_node"
    if reduced:
        n_nodes, n_edges = min(n_nodes, 64), min(n_edges, 256)
        d_feat, n_graphs = min(d_feat, 8), min(n_graphs, 2)
    # pad node/edge counts to the device-grid multiple (padded entries are
    # masked; the data model is already mask-based)
    grid_axes = tuple(a for a in ("data", "model")
                      if a in mesh.mesh_dim_names)
    grid_n = math.prod(_mesh_sizes(mesh)[a] for a in grid_axes)
    n_nodes = ((n_nodes + grid_n - 1) // grid_n) * grid_n
    n_edges = ((n_edges + grid_n - 1) // grid_n) * grid_n
    cfg = dataclasses.replace(cfg, d_feat=d_feat,
                              act_grid_axes=grid_axes or None)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)

    shapes = mc.init_mace(prng.prng_key(0), cfg, device="meta")
    rep = placements(mesh, ())
    rep_shard = tree_map(lambda t: rep, shapes)
    params_sds = tree_map(lambda t: Shaped(tuple(t.shape), t.dtype, rep),
                          shapes)
    batch_sds = _mace_batch_sds(mesh, n_nodes, n_edges, d_feat, n_graphs,
                                node_loss)
    opt_sds = _opt_specs(mesh, params_sds, rep_shard)
    opt_cfg = AdamWConfig()
    loss_fn = mc.mace_node_loss if node_loss else mc.mace_loss

    def train_step(params, opt_state, batch):
        batch = dict(batch, n_graphs=n_graphs)
        loss, grads = value_and_grad(loss_fn, params, batch, cfg)
        adamw_update_(grads, opt_state, params, opt_cfg)
        return params, opt_state, loss

    mult = 3.0 if node_loss else 7.0   # fwd+bwd (+force second-order)
    return Cell(arch_id, shape_name, train_step,
                (params_sds, opt_sds, batch_sds), "train",
                mult * mace_flops(cfg, n_edges, n_nodes), donate=(0, 1))


# ---------------------------------------------------------------------------

def build_cell(arch_id: str, shape_name: str, mesh, *, reduced=False,
               overrides=None) -> Cell:
    build = {"lm": build_lm_cell, "recsys": build_recsys_cell,
             "gnn": build_gnn_cell}[get_arch(arch_id).family]
    return build(arch_id, shape_name, mesh, reduced=reduced,
                 overrides=overrides)
