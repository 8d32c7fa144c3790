"""LM cells (port of the LM half of ``repro/launch/cells.py``): one
(architecture x input shape x mesh) step with the specs of its arguments.

``build_lm_cell`` returns the step function and, for each argument, its
shape, dtype and the placements the mesh's rules give it
(``distributed/sharding.Shaped``, the reference's ``ShapeDtypeStruct``
with its ``NamedSharding``), built from the config's shapes with nothing
allocated. The launchers build the same cells on real tensors.

The train step is the reference's: ``lm_loss``, its gradient by autograd
(the mean over ``overrides["microbatches"]`` slices of the batch, summed
in f32), then AdamW. The reference donates its first two arguments
(``donate_argnums=(0, 1)``); here the step writes the new parameters and
AdamW state into the tensors it was given, leaf by leaf
(``train/optimizer.adamw_update_``, bit-equal to ``adamw_update``), so
the card never holds two copies of the training state.

The activation-sharding options are set as the reference sets them; on
one rank they change no value (``models/transformer.py``). A mesh of more
than one rank raises: LM training across ranks (the gradient all-reduce
over ``pod``/``data``, ZeRO ``embed`` over ``data``, Megatron TP over
``model``, ``LM_RULES``) is ROADMAP.md queue 1 item 15(d). ``build_cell``
dispatches on the family; ``get_arch`` raises for the recsys and gnn ids
(item 15(c)).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from repro_torch.configs import get_arch
from repro_torch.distributed.sharding import (LM_RULES, Shaped, placements,
                                              tree_shardings)
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
    kind: str               # train | prefill | decode
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


def _lm_opt_specs(mesh, params_sds, param_shard):
    f32 = lambda s, pl: Shaped(s.shape, torch.float32, pl)
    return {"m": tree_map(f32, params_sds, param_shard),
            "v": tree_map(f32, params_sds, param_shard),
            "step": Shaped((), torch.int32, placements(mesh, ()))}


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


def _value_and_grad(params, tokens, cfg):
    """``lm_loss`` and its gradient tree (autograd over detached leaves)."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = tf.lm_loss(tree_unflatten(params, leaves), tokens, cfg)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(params, list(grads))


def lm_grads(params, tokens, cfg, microbatches: int = 1):
    """The train step's loss and gradients: over the whole batch, or the
    mean over ``microbatches`` row slices, the gradients summed in f32 in
    slice order (the reference's scan)."""
    if microbatches == 1:
        return _value_and_grad(params, tokens, cfg)
    b, s1 = tokens.shape
    grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    losses = []
    for t in tokens.reshape(microbatches, b // microbatches, s1):
        loss, g = _value_and_grad(params, t, cfg)
        for acc, gi in zip(tree_leaves(grads), tree_leaves(g)):
            acc.add_(gi.to(torch.float32) / microbatches)
        losses.append(loss)
    return torch.stack(losses).mean(), grads


def build_lm_cell(arch_id, shape_name, mesh, *, reduced=False,
                  overrides: Optional[dict] = None) -> Cell:
    if mesh.size() > 1:
        raise NotImplementedError(
            f"an LM cell on a mesh of {mesh.size()} ranks: LM training "
            f"across ranks (the gradient all-reduce over pod/data, ZeRO "
            f"embed over data, Megatron TP over model) is not ported to "
            f"PyTorch yet (ROADMAP.md queue 1 item 15(d)); use a 1-rank "
            f"mesh")
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
        opt_sds = _lm_opt_specs(mesh, params_sds, param_shard)
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


def build_cell(arch_id: str, shape_name: str, mesh, *, reduced=False,
               overrides=None) -> Cell:
    """The cell of ``arch_id``'s family (``get_arch`` raises for the
    recsys and gnn ids until ROADMAP.md queue 1 item 15(c))."""
    build = {"lm": build_lm_cell}[get_arch(arch_id).family]
    return build(arch_id, shape_name, mesh, reduced=reduced,
                 overrides=overrides)
