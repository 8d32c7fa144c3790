"""Optimizers written out as plain tensor code (port of
``repro/train/optimizer.py``): AdamW and Adafactor.

AdamW is the reference's, not ``torch.optim.AdamW``: b2 defaults to 0.95,
gradients are first clipped by their global norm over all leaves, the
learning rate warms up linearly and then decays on a cosine to
``min_lr_ratio`` (``step`` counted from 1), and the weight decay sits
inside the step ``delta``. Adafactor factors the second moment of
matrices into row and column statistics.

Parameters, gradients and optimizer state are trees of nested dicts (str
or int keys) and lists of tensors, as in the reference; leaves are visited
in sorted key order and list index order, the order in which JAX flattens
them, so the global norm sums in the same order. ``adamw_update`` returns new tensors and changes nothing in place.
``adamw_update_`` is the same step on donated state (the reference's
``donate_argnums``): it writes the new parameters, moments and step into
the tensors it was given, and clips the gradients in place, one leaf at a
time, with the same operations in the same order, so its values are
``adamw_update``'s bit for bit; it needs one leaf-sized temporary where
the functional step holds a second copy of the whole state.
"""
from __future__ import annotations

import dataclasses
import math

import torch


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts and lists: dict keys (str or int) in
    sorted order, list elements in index order (JAX's flatten order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for node in tree for x in tree_leaves(node)]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, list):
            return [build(x) for x in node]
        return next(it)
    return build(like)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and what sits at the same place
    in each of ``rest`` (a leaf, or a subtree such as Adafactor's slot
    dict)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, list):
        return [tree_map(fn, x, *(r[i] for r in rest))
                for i, x in enumerate(tree)]
    return fn(tree, *rest)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    grad_clip: float = 1.0


def _schedule(step: torch.Tensor, cfg) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``min_lr_ratio`` (f32)."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm):
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gn


def adamw_init(params):
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    device = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params),
            "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def adamw_update(grads, state, params, cfg: AdamWConfig):
    """One AdamW step: (new params, new state, {"grad_norm", "lr"})."""
    step = state["step"] + 1
    grads, gn = clip_by_global_norm(grads, cfg.grad_clip)
    lr = _schedule(step, cfg)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)

    def upd(p, g, m, v):
        g32 = g.to(torch.float32)
        p32 = p.to(torch.float32)
        m_new = b1 * m + (1 - b1) * g32
        v_new = b2 * v + (1 - b2) * g32 * g32
        mhat = m_new / (1 - b1 ** stepf)
        vhat = v_new / (1 - b2 ** stepf)
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p32
        return (p32 - lr * delta).to(p.dtype), m_new, v_new

    out = tree_map(upd, params, grads, state["m"], state["v"])
    return (_pick(out, 0), {"m": _pick(out, 1), "v": _pick(out, 2),
                            "step": step},
            {"grad_norm": gn, "lr": lr})


def adamw_update_(grads, state, params, cfg: AdamWConfig):
    """``adamw_update`` on donated ``state`` and ``params``, written in
    place (``grads`` are consumed: clipped in place, then used as
    scratch). Returns ``{"grad_norm", "lr"}``."""
    step = state["step"].add_(1)
    gn = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-9), max=1.0)
    lr = _schedule(step, cfg)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1, bc2 = 1 - b1 ** stepf, 1 - b2 ** stepf
    with torch.no_grad():
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state["m"]),
                              tree_leaves(state["v"])):
            g.mul_(scale.to(g.dtype))
            g32 = g.to(torch.float32)
            p32 = p.to(torch.float32)
            tmp = (1 - b1) * g32
            m.mul_(b1).add_(tmp)                    # b1 m + (1 - b1) g
            torch.mul(g32, 1 - b2, out=tmp)
            v.mul_(b2).add_(tmp.mul_(g32))          # b2 v + (1 - b2) g g
            torch.div(v, bc2, out=tmp)              # vhat
            tmp.sqrt_().add_(cfg.eps)
            torch.div(m, bc1, out=g32)              # mhat
            g32.div_(tmp)
            g32.add_(torch.mul(p32, cfg.weight_decay, out=tmp))  # delta
            update = g32.mul_(lr)
            if p32 is p:
                p.sub_(update)
            else:
                p.copy_(p32.sub_(update))
    return {"grad_norm": gn, "lr": lr}


def _pick(tree, i: int):
    """Element ``i`` of each tuple leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]


# ---------------------------------------------------------------------------
# Adafactor (factored second moments)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdafactorConfig:
    lr: float = 1e-2
    decay: float = 0.8
    eps1: float = 1e-30
    eps2: float = 1e-3
    clip_threshold: float = 1.0
    weight_decay: float = 0.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def _factored(shape):
    return len(shape) >= 2


def adafactor_init(params):
    def init(p):
        if _factored(p.shape):
            return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                      device=p.device),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                      dtype=torch.float32, device=p.device)}
        return {"v": torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device)}
    device = tree_leaves(params)[0].device
    return {"slots": tree_map(init, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def adafactor_update(grads, state, params, cfg: AdafactorConfig):
    """One Adafactor step: (new params, new state, {"lr"})."""
    step = state["step"] + 1
    beta = 1.0 - (step.to(torch.float32) + 1.0) ** (-cfg.decay)
    sched = AdamWConfig(lr=cfg.lr, warmup_steps=cfg.warmup_steps,
                        total_steps=cfg.total_steps,
                        min_lr_ratio=cfg.min_lr_ratio)
    lr = _schedule(step, sched)

    def upd(p, g, slot):
        g32 = g.to(torch.float32)
        p32 = p.to(torch.float32)
        g2 = g32 * g32 + cfg.eps1
        if _factored(p.shape):
            vr = beta * slot["vr"] + (1 - beta) * g2.mean(-1)
            vc = beta * slot["vc"] + (1 - beta) * g2.mean(-2)
            denom = (vr / torch.clamp(vr.mean(-1, keepdim=True),
                                      min=cfg.eps1))[..., None] \
                * vc[..., None, :]
            u = g32 / torch.sqrt(denom + cfg.eps1)
            new_slot = {"vr": vr, "vc": vc}
        else:
            v = beta * slot["v"] + (1 - beta) * g2
            u = g32 / torch.sqrt(v + cfg.eps1)
            new_slot = {"v": v}
        rms_u = torch.sqrt(torch.mean(u * u) + cfg.eps1)
        u = u / torch.clamp(rms_u / cfg.clip_threshold, min=1.0)
        scale = torch.clamp(torch.sqrt(torch.mean(p32 ** 2)), min=cfg.eps2)
        new_p = p32 - lr * scale * u - lr * cfg.weight_decay * p32
        return new_p.to(p.dtype), new_slot

    out = tree_map(upd, params, grads, state["slots"])
    return (_pick(out, 0), {"slots": _pick(out, 1), "step": step},
            {"lr": lr})
