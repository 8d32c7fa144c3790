"""MACE — higher-order E(3)-equivariant message passing [arXiv:2206.07697]
(port of ``repro/models/mace.py``).

Assigned config: n_layers=2, d_hidden=128 channels, l_max=2,
correlation_order=3, n_rbf=8.

* Node states are real-irrep dicts {l: (N, C, 2l+1)}, l = 0..2, one channel
  width C for every l.
* Messages: for each coupling path (l1 from h_j, l2 from Y(r_ij) -> l3),
  m_e = R_path,c(r_ij) * CG[l1,l2,l3](h_j, Y), summed over paths per edge,
  then scattered onto the destination nodes once per l3 (an accumulating
  ``index_put_`` onto zeros: the reference's ``segment_sum``).
* Correlation order 3 via iterated CG products (ACE construction):
  B1 = A;  B2 = CG(A, A);  B3 = CG(B2, A) — per-channel learnable path
  weights.
* Energies are invariant (l=0) readouts summed per graph; forces are
  -dE/dpositions by autograd, kept in the graph (``create_graph``) when the
  loss is differentiated, so the train step takes a second-order gradient
  through each layer's non-reentrant checkpoint (the reference's
  ``jax.checkpoint``).

Across ranks (``ranks=``, a ``distributed/sharding.GridRanks``): nodes
and edges lie over the grid (``data`` and ``model``), node chunk s and
edge chunk s on one rank (``launch/cells.build_gnn_cell`` pads both
counts to the grid). ``src`` and ``dst`` are global node ids. The
positions are gathered once for the edge geometry; each layer gathers the
node state over the grid, computes the messages of the rank's own edges,
sums them into a buffer of every node and reduce-scatters it back to the
node chunks; the correlation products, the channel mixes and the readout
stay on the rank's nodes. The per-graph energy is a sum of the ranks'
partial sums, and a loss is the rank's share (the shares sum to the
loss). The collectives are autograd functions whose backwards are
collectives too, so the forces keep their graph across ranks. Under a
layer's checkpoint its collectives run again in the backward, in the same
order on every rank. ``act_grid_axes`` names the grid the cell places
nodes and edges over; the split itself comes from ``ranks``, and on one
rank nothing is placed (the reference's ``with_sharding_constraint``s).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core import prng
from repro_torch.device import resolve_device
from repro_torch.models import so3
from repro_torch.models.transformer import _dense_init


@dataclasses.dataclass(frozen=True)
class MACEConfig:
    n_layers: int = 2
    channels: int = 128            # d_hidden
    l_max: int = 2
    correlation: int = 3
    n_rbf: int = 8
    r_cut: float = 5.0
    d_feat: int = 16               # input node feature width
    readout_hidden: int = 16
    dtype: Any = torch.float32
    remat: bool = True             # checkpoint each interaction layer:
    # per-edge message tensors at 61.9M edges x 128ch are the memory wall
    act_grid_axes: Any = None      # mesh axes the cell places edge/node
    # tensors over (the model reads its split from ranks=)
    # fuse the 3 per-l3 scatters into one, and carry messages in msg_dtype
    fused_scatter: bool = False
    msg_dtype: Any = None          # e.g. torch.bfloat16


def _paths(cfg):
    return so3.valid_paths(cfg.l_max)


_CG_CACHE: dict = {}


def _cg(l1, l2, l3, like: torch.Tensor) -> torch.Tensor:
    """The real CG tensor on ``like``'s device and dtype, kept per device
    for plain tensors (a fake tensor's, under a dry run, is made anew)."""
    key = (l1, l2, l3, like.device, like.dtype)
    cg = _CG_CACHE.get(key) if type(like) is torch.Tensor else None
    if cg is None:
        cg = torch.tensor(so3.real_clebsch_gordan(l1, l2, l3),
                          dtype=like.dtype, device=like.device)
        if type(like) is torch.Tensor:
            _CG_CACHE[key] = cg
    return cg


def init_mace(key: prng.Key, cfg: MACEConfig, device="cuda"):
    """The reference's parameter tree from the same key, bit for bit,
    drawn on ``device`` (``meta``: the shapes alone)."""
    device = resolve_device(device)
    C = cfg.channels
    n_paths = len(_paths(cfg))
    ks = prng.split(key, 6 + 4 * cfg.n_layers)
    pd = cfg.dtype

    def lin(k, i, o):
        return _dense_init(k, (i, o), 0, pd, device)

    layers = []
    for li in range(cfg.n_layers):
        k1, k2, k3, k4 = prng.split(ks[6 + li], 4)
        layers.append({
            # radial MLP: rbf -> hidden -> per-(path, channel) weights
            "rad_w1": lin(k1, cfg.n_rbf, 64),
            "rad_w2": lin(k2, 64, n_paths * C),
            # per-l channel-mixing linears for self, A, B2, B3 terms
            "mix": {l: {
                "self": lin(prng.fold_in(k3, 10 * l), C, C),
                "a": lin(prng.fold_in(k3, 10 * l + 1), C, C),
                "b2": lin(prng.fold_in(k3, 10 * l + 2), C, C),
                "b3": lin(prng.fold_in(k3, 10 * l + 3), C, C),
            } for l in range(cfg.l_max + 1)},
            # per-path per-channel product weights for B2 / B3
            "w_b2": lin(k4, n_paths, C),
            "w_b3": lin(prng.fold_in(k4, 1), n_paths, C),
        })
    return {
        "embed": lin(ks[0], cfg.d_feat, C),
        "layers_list": layers,
        "readout_w1": lin(ks[1], C, cfg.readout_hidden),
        "readout_w2": lin(ks[2], cfg.readout_hidden, 1),
    }


def _rbf(r, cfg):
    """Gaussian radial basis with cosine cutoff envelope."""
    mu = torch.linspace(0.0, cfg.r_cut, cfg.n_rbf, dtype=r.dtype,
                        device=r.device)
    gamma = (cfg.n_rbf / cfg.r_cut) ** 2
    basis = torch.exp(-gamma * (r[..., None] - mu) ** 2)
    env = 0.5 * (torch.cos(torch.pi * torch.clamp(r / cfg.r_cut, 0, 1))
                 + 1.0)
    return basis * env[..., None]


def _cg_product(x, y, l1, l2, l3):
    """x: (N, C, 2l1+1), y: (N, C, 2l2+1) -> (N, C, 2l3+1)."""
    return torch.einsum("abc,nia,nib->nic", _cg(l1, l2, l3, x), x, y)


def _cg_product_edge(x, y, l1, l2, l3):
    """x: (E, C, 2l1+1), y: (E, 2l2+1) (Y shared over channels)."""
    return torch.einsum("abc,nia,nb->nic", _cg(l1, l2, l3, x), x, y)


def _segment_sum(x, ids, n):
    """``segment_sum``: rows of ``x`` added into ``n`` segments. An
    accumulating ``index_put_`` (sort-based on the card, so its sums are
    the same from run to run: a resumed run equals an uninterrupted one
    bit for bit), not ``index_add_``'s atomics."""
    return torch.zeros((n,) + x.shape[1:], dtype=x.dtype,
                       device=x.device).index_put_((ids,), x,
                                                   accumulate=True)


def _node_flat(d: dict) -> torch.Tensor:
    """{l: (N, C, 2l+1)} as one (N, C * (l_max + 1)^2) tensor."""
    return torch.cat([d[l].reshape(d[l].shape[0], -1) for l in sorted(d)],
                     -1)


def _node_split(flat: torch.Tensor, like: dict) -> dict:
    """:func:`_node_flat`'s inverse, the l pieces shaped as ``like``'s."""
    out, off = {}, 0
    for l in sorted(like):
        width = like[l][0].numel()
        out[l] = flat[:, off:off + width].reshape(
            (flat.shape[0],) + tuple(like[l].shape[1:]))
        off += width
    return out


def _layer(lp, h, src, dst, rbf, ylm, emask, cfg, ranks=None):
    C = cfg.channels
    e = src.shape[0]
    dt = h[0].dtype
    paths = _paths(cfg)
    # across ranks: the node state of every node, in one gather
    across = ranks is not None and ranks.g > 1
    h_all = _node_split(ranks.gather(_node_flat(h)), h) if across else h
    n = h_all[0].shape[0]
    rad = F.silu(rbf @ lp["rad_w1"]) @ lp["rad_w2"]        # (E, n_paths*C)
    rad = rad.reshape(-1, len(paths), C) * emask[:, None, None]

    # messages + aggregation: A[l3] = sum_j R * CG(h_j, Y_ij), every path's
    # message summed per edge first, then one scatter per l3
    msg = {l: torch.zeros((e, C, 2 * l + 1), dtype=dt, device=h[0].device)
           for l in range(cfg.l_max + 1)}
    gathered = {l: h_all[l][src] for l in range(cfg.l_max + 1)}
    for pi, (l1, l2, l3) in enumerate(paths):
        m = _cg_product_edge(gathered[l1], ylm[l2], l1, l2, l3)
        msg[l3] = msg[l3] + m * rad[:, pi, :, None]
    mdt = cfg.msg_dtype or dt
    # across ranks the sums of every node, reduce-scattered back to the
    # rank's nodes in one collective (in msg_dtype, as they were summed)
    if cfg.fused_scatter:
        flat = torch.cat([msg[l].reshape(e, -1)
                          for l in range(cfg.l_max + 1)], -1).to(mdt)
        agg = _segment_sum(flat, dst, n)
        if across:
            agg = ranks.scatter(agg)
        a = _node_split(agg.to(dt), h)
    else:
        a = {l: _segment_sum(msg[l].to(mdt), dst, n)
             for l in range(cfg.l_max + 1)}
        if across:
            a = _node_split(ranks.scatter(_node_flat(a)), h)
        a = {l: x.to(dt) for l, x in a.items()}

    # higher-order products (correlation 3): B2 = AxA, B3 = B2xA
    b2 = {l: torch.zeros_like(a[l]) for l in a}
    for pi, (l1, l2, l3) in enumerate(paths):
        t = _cg_product(a[l1], a[l2], l1, l2, l3)
        b2[l3] = b2[l3] + t * lp["w_b2"][pi][None, :, None]
    b3 = {l: torch.zeros_like(a[l]) for l in a}
    if cfg.correlation >= 3:
        for pi, (l1, l2, l3) in enumerate(paths):
            t = _cg_product(b2[l1], a[l2], l1, l2, l3)
            b3[l3] = b3[l3] + t * lp["w_b3"][pi][None, :, None]

    # update: residual + channel mixes (einsum on the channel dim)
    new_h = {}
    for l in range(cfg.l_max + 1):
        mix = lp["mix"][l]
        new_h[l] = (torch.einsum("ncm,cd->ndm", h[l], mix["self"])
                    + torch.einsum("ncm,cd->ndm", a[l], mix["a"])
                    + torch.einsum("ncm,cd->ndm", b2[l], mix["b2"])
                    + torch.einsum("ncm,cd->ndm", b3[l], mix["b3"]))
    return new_h


def mace_forward(params, batch, cfg: MACEConfig, return_nodes: bool = False,
                 ranks=None):
    """batch: positions (N,3), node_feats (N,d_feat), edge_src/dst (E,),
    edge_mask (E,), graph_ids (N,), n_graphs int.
    Returns per-graph energies (G,) (or per-node readouts). Under
    ``ranks``: the batch's node and edge chunks of this rank; the
    energies summed over the grid, the readouts of the rank's nodes."""
    if return_nodes:
        return _node_energies(params, batch, cfg, ranks)
    e = _graph_energies(params, batch, cfg, ranks)
    return e if ranks is None else ranks.sum(e)


def _graph_energies(params, batch, cfg: MACEConfig, ranks=None):
    """The per-graph sums of the batch's (this rank's) node energies."""
    return _segment_sum(_node_energies(params, batch, cfg, ranks),
                        batch["graph_ids"].long(), batch["n_graphs"])


def _node_energies(params, batch, cfg: MACEConfig, ranks=None):
    """The per-node energies of the batch's (this rank's) nodes."""
    pos = batch["positions"]
    src = batch["edge_src"].long()
    dst = batch["edge_dst"].long()
    emask = batch["edge_mask"].to(pos.dtype)
    n = pos.shape[0]
    C = cfg.channels

    # edge geometry, from every node's position across ranks
    pos_all = pos if ranks is None else ranks.gather(pos)
    rvec = pos_all[src] - pos_all[dst]                          # (E,3)
    r = torch.sqrt(torch.sum(rvec * rvec, -1) + 1e-12)
    rhat = rvec / r[..., None]
    ylm = so3.spherical_harmonics(rhat, torch)                  # {l: (E,2l+1)}
    rbf = _rbf(r, cfg)                                          # (E,n_rbf)

    # initial node state: scalars from features, higher l zero
    h = {0: (batch["node_feats"] @ params["embed"])[:, :, None]}
    for l in range(1, cfg.l_max + 1):
        h[l] = torch.zeros((n, C, 2 * l + 1), dtype=pos.dtype,
                           device=pos.device)

    remat = cfg.remat and torch.is_grad_enabled()
    for lp in params["layers_list"]:
        if remat:
            h = checkpoint(_layer, lp, h, src, dst, rbf, ylm, emask, cfg,
                           ranks, use_reentrant=False)
        else:
            h = _layer(lp, h, src, dst, rbf, ylm, emask, cfg, ranks)

    # invariant readout -> per-node energy
    return (F.silu(h[0][:, :, 0] @ params["readout_w1"])
            @ params["readout_w2"])[:, 0]


def mace_energy_forces(params, batch, cfg: MACEConfig, ranks=None):
    """Per-graph energies and forces -dE/dpositions. Under grad mode the
    forces stay in the graph, so a loss of them has parameter gradients
    (second order); otherwise both come back detached. Under ``ranks``:
    the energies whole, the forces of the rank's nodes (each rank
    differentiates its partial sum of the energies; the backward's
    collectives add the ranks' parts)."""
    create = torch.is_grad_enabled()
    with torch.enable_grad():
        pos = batch["positions"].detach().requires_grad_()
        e = _graph_energies(params, {**batch, "positions": pos}, cfg,
                            ranks)
        (g,) = torch.autograd.grad(e.sum(), pos, create_graph=create)
        if ranks is not None:
            e = ranks.sum(e)
    if not create:
        e = e.detach()
    return e, -g


def mace_loss(params, batch, cfg: MACEConfig, force_weight: float = 10.0,
              ranks=None):
    """Energy MSE plus ``force_weight`` times the force MSE; under
    ``ranks`` this rank's share: the energy term (whole on every rank)
    over ``n_all``, its nodes' force errors over the node count and the
    ``copies`` of each chunk."""
    e, f = mace_energy_forces(params, batch, cfg, ranks)
    le = torch.mean((e - batch["energy_target"]) ** 2)
    if ranks is None:
        lf = torch.mean(torch.sum((f - batch["force_target"]) ** 2, -1))
        return le + force_weight * lf
    lf = torch.sum((f - batch["force_target"]) ** 2) / (f.shape[0] * ranks.g)
    return le / ranks.n_all + force_weight * lf / ranks.copies


def mace_node_loss(params, batch, cfg: MACEConfig, ranks=None):
    """Sampled-training objective (minibatch_lg): per-node invariant
    prediction, MSE over the labelled batch nodes only; under ``ranks``
    this rank's share (its nodes' errors over the grid's labelled count
    and the ``copies`` of each chunk)."""
    preds = mace_forward(params, batch, cfg, return_nodes=True, ranks=ranks)
    mask = batch["node_mask"].to(preds.dtype)
    err = (preds - batch["node_target"]) ** 2 * mask
    count = torch.sum(mask)
    if ranks is not None:
        count = ranks.sum(count)
    loss = torch.sum(err) / torch.clamp(count, min=1.0)
    return loss if ranks is None else loss / ranks.copies


# ---------------------------------------------------------------------------
# Synthetic graph batches (tests / smoke input builders)
# ---------------------------------------------------------------------------

def random_graph_batch(key: prng.Key, *, n_nodes, n_edges, d_feat,
                       n_graphs=1, dtype=torch.float32, device="cuda"):
    """The reference's batch from the same key, bit for bit (f32)."""
    device = resolve_device(device)
    k1, k2, k3, k4, k5 = prng.split(key, 5)
    pos = prng.normal(k1, (n_nodes, 3), device).to(dtype) * 2.0
    feats = prng.normal(k2, (n_nodes, d_feat), device).to(dtype)
    src = prng.randint(k3, (n_edges,), 0, n_nodes, device)
    dst = prng.randint(k4, (n_edges,), 0, n_nodes, device)
    # avoid self loops (zero-length edge vectors)
    dst = torch.where(dst == src, (dst + 1) % n_nodes, dst)
    gid = torch.sort(prng.randint(k5, (n_nodes,), 0, n_graphs, device))[0]
    return {
        "positions": pos, "node_feats": feats,
        "edge_src": src, "edge_dst": dst,
        "edge_mask": torch.ones((n_edges,), dtype=torch.bool, device=device),
        "graph_ids": gid, "n_graphs": n_graphs,
        "energy_target": torch.zeros((n_graphs,), dtype=dtype, device=device),
        "force_target": torch.zeros((n_nodes, 3), dtype=dtype, device=device),
    }
