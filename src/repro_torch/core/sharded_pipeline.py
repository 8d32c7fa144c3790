"""Sharded WindTunnel pipeline — the single-device dataflow of the sampling
core partitioned over the ranks of a mesh (port of
``repro/core/sharded_pipeline.py``).

The reference runs one ``shard_map`` region; here each rank runs the body
on its own shard, and the region's collectives are ``torch.distributed``
ones over the process group of the partition axes
(``distributed/collectives.py``):

  1. **Query-partitioned GraphBuilder.** The (tau-filtered) QRel table is
     routed so that each rank owns a contiguous block of query ids, and
     each rank builds its per-shard ELL table and enumerates affinity
     pairs locally: a query's rows are never split.
  2. **Edge merge.** The per-shard pair lists are concatenated with a
     tiled all-gather and deduplicated with the single-device path's sort
     + segment-max (``collectives.all_concat`` + ``gb.dedup_edges``).
  3. **Node-partitioned label propagation.** The merged edge list is
     packed into ELL rows for the rank's node block only; the i32[N] label
     vector is the replicated carry, refreshed by one label all-gather per
     round, and each round's ``changes`` is an integer all-reduce.
  4. **Sampling + reconstruction** run on the replicated outputs
     (sampling_core.py): the draw is keyed per label id, so the mask is a
     pure function of (seed, labels), bit-identical to the single-device
     path on a 1-rank mesh and independent of the mesh given equal labels.

The LP round follows ``config.engine``: ``ell`` runs the plain round
(``label_prop.ell_round``), ``cuda`` the LP kernel on the rank's rows
(``kernels/label_prop``, with the block's ``row0``). The ``sort`` engine
has no sharded formulation (its per-round global sort is exactly the
shuffle this path removes): selecting it raises.

Padding invariants: queries are padded to a multiple of the shard count
(padded queries have no QRel rows), nodes to a multiple of the shard count
(padded nodes have no edges, keep their own label, and are sliced off
before sampling). On a 1-rank mesh both paddings are empty and every stage
is operation for operation the single-device program.
"""
from __future__ import annotations

import torch

from repro_torch.core import graph_builder as gb
from repro_torch.core import label_prop as lp
from repro_torch.core import segment_utils as su
from repro_torch.core.pipeline import WindTunnelConfig, WindTunnelResult
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.sharded_corpus import ShardedQRels
from repro_torch.distributed.sharding import GNN_RULES, partition_axes

ELL_ENGINES = ("ell", "cuda")


def check_engine(engine: str) -> None:
    """Raise unless ``engine`` has a sharded formulation."""
    if engine not in ELL_ENGINES:
        raise ValueError(
            f"sharded pipeline requires an ELL-family engine ('ell' or "
            f"'cuda'); got {engine!r} — the sort engine's global per-round "
            f"shuffle is exactly what this path eliminates")


def _route_by_query(qrels: gb.QRelTable, *, num_shards: int,
                    queries_per_shard: int) -> gb.QRelTable:
    """Partition QRel rows into per-shard buffers of shape (d, n): shard
    ``q // queries_per_shard`` owns every row of query q. The stable sort
    preserves original row order within a shard, so each shard's local
    table is the compaction of its rows: downstream stable sorts see the
    same tie order as the single-device path."""
    n = qrels.query_ids.shape[0]
    dev = qrels.query_ids.device
    shard = torch.where(qrels.valid, qrels.query_ids // queries_per_shard,
                        num_shards)  # invalid rows route to the drop bucket
    (ss,), (q, e, s, v) = su.sort_by(
        (shard,), (qrels.query_ids, qrels.entity_ids, qrels.scores,
                   qrels.valid.to(torch.int32)))
    rank = su.group_rank(su.run_starts(ss))
    ok = ss < num_shards
    row, col = ss[ok].to(torch.int64), rank[ok]

    def buf(vals, dtype):
        out = torch.zeros((num_shards, n), dtype=dtype, device=dev)
        out[row, col] = vals[ok].to(dtype)
        return out

    return gb.QRelTable(buf(q, torch.int32), buf(e, torch.int32),
                        buf(s, torch.float32), buf(v, torch.int32))


def _resolve_axes(mesh, axes) -> tuple:
    """The partition axes: ``axes``, else the GNN node rule on ``mesh``."""
    if axes is None:
        axes = partition_axes(mesh, "nodes", GNN_RULES)
    axes = tuple(axes) if axes else ()
    if not axes:
        raise ValueError(f"mesh {mesh} has none of the GNN node axes")
    return axes


def sharded_graph_and_labels(qrels, *, num_queries: int,
                             num_entities: int, config: WindTunnelConfig,
                             mesh, axes: tuple = None) -> tuple:
    """Mesh-partitioned graph build + label propagation (stages 1-3 above),
    returning ``(edges, labels, changes_per_round)``; labels and changes
    are replicated on every rank.

    ``qrels`` is either a global :class:`~repro_torch.core.graph_builder.
    QRelTable` on the rank's device (tau-filtered and query-routed there:
    the legacy flow, which holds the full table on every rank) or a
    sharded-from-birth :class:`~repro_torch.distributed.sharded_corpus.
    ShardedQRels` whose buffers were routed host-side and streamed straight
    to their shards. On the born path tau is computed from an all-gather of
    the score column only (``nanquantile`` is permutation-invariant, so
    the threshold is bit-identical to the global ``threshold_tau``), and
    the edge list stays row-sharded: each rank returns its 1/d slice of
    the (identical on every rank) deduplicated edges.
    """
    check_engine(config.engine)
    born = isinstance(qrels, ShardedQRels)
    if born and axes is None:
        axes = qrels.axes
    axes = _resolve_axes(mesh, axes)
    d = coll.axis_size(mesh, axes)
    idx = coll.flat_axis_index(mesh, axes)

    qps = -(-num_queries // d)          # queries per shard (ceil)
    rows_n = -(-num_entities // d)      # nodes per shard (ceil)
    n_pad = rows_n * d
    if born:
        if qrels.num_shards != d or qrels.queries_per_shard != qps:
            raise ValueError(
                f"ShardedQRels routed for {qrels.num_shards} shards × "
                f"{qrels.queries_per_shard} queries/shard, but the mesh "
                f"needs {d} × {qps}")
        q_b, e_b, s_b, v_b = (qrels.query_ids, qrels.entity_ids,
                              qrels.scores, qrels.valid)
    else:
        # Global tau: the only stage needing the full score distribution —
        # a scalar quantile, computed replicated before partitioning.
        tau = gb.threshold_tau(qrels, config.tau_quantile)
        kept = gb.filter_qrels(qrels, tau)
        routed = _route_by_query(kept, num_shards=d, queries_per_shard=qps)
        q_b, e_b, s_b, v_b = (x[idx] for x in routed)
    dev = q_b.device

    # ---- local QRel block ----
    valid = v_b.to(torch.bool)
    if born:
        # tau over the gathered score COLUMN (the table never leaves its
        # shards); invalid/pad rows mark NaN, which nanquantile ignores
        marked = torch.where(valid, s_b, torch.nan)
        tau_l = gb.nanquantile(coll.all_gather(marked, mesh, axes),
                               config.tau_quantile)
        valid = valid & (s_b > tau_l)
    q_local = torch.where(valid, q_b - idx * qps, 0).to(torch.int32)
    local = gb.QRelTable(q_local, e_b, s_b, valid)

    # ---- Alg. 1 on the shard: ELL group-by + pair enumeration ----
    ell_e, ell_s = gb.build_ell(local, qps, config.fanout)
    pairs = gb.affinity_pairs(ell_e, ell_s)

    # ---- merge: all-gather pair lists, dedup with segment-max ----
    gathered = gb.EdgeList(*coll.all_concat(tuple(pairs), mesh, axes))
    edges = gb.dedup_edges(gathered)
    src, dst, w, e_valid = gb.symmetrize(edges)

    # ---- node-partitioned ELL adjacency (local rows only) ----
    row0 = idx * rows_n
    dst_local = dst - row0
    mine = e_valid & (dst_local >= 0) & (dst_local < rows_n)
    nbr_l, wgt_l = lp.edges_to_ell(
        src, torch.where(mine, dst_local, rows_n), w, mine,
        num_nodes=rows_n, max_degree=config.max_degree)

    # ---- LP rounds: sharded adjacency, replicated label carry ----
    if config.engine == "cuda":
        from repro_torch.kernels.label_prop.ops import label_prop_round
        one_round = label_prop_round
    else:
        one_round = lp.ell_round
    labels = coll.pvary_compat(
        torch.arange(n_pad, dtype=torch.int32, device=dev), axes)
    changes = torch.zeros(config.lp_rounds, dtype=torch.int32, device=dev)
    for r in range(config.lp_rounds):
        own = labels[row0:row0 + rows_n]
        new = one_round(labels, nbr_l, wgt_l, row0)
        changes[r] = coll.all_reduce(
            (new != own).sum().to(torch.int32), mesh, axes)
        labels = coll.all_gather(new, mesh, axes)
    labels = coll.unvary_compat(labels, mesh, axes)
    if born:
        # every rank computed the SAME deduplicated edges (dedup of one
        # gather), so each keeps only its slice: the row-sharded edge list
        e_len = edges.u.shape[0] // d
        edges = gb.EdgeList(*(x[idx * e_len:(idx + 1) * e_len]
                              for x in edges))
    return edges, labels[:num_entities], changes


def sharded_degrees(edges: gb.EdgeList, num_entities: int, *, born: bool,
                    mesh, axes: tuple) -> torch.Tensor:
    """Node degrees i32[N] (replicated) of the sharded graph: of the
    replicated edge list, or summed by an integer all-reduce over the
    ranks' slices of a born one."""
    deg = gb.node_degrees(edges, num_entities)
    return coll.all_reduce(deg, mesh, axes) if born else deg


def run_windtunnel_sharded(qrels: gb.QRelTable, *, num_queries: int,
                           num_entities: int, config: WindTunnelConfig,
                           mesh, axes: tuple = None, device="cuda"
                           ) -> WindTunnelResult:
    """Mesh-partitioned ``run_windtunnel`` with identical semantics.

    .. deprecated:: next release — thin wrapper over
       ``sampling_core.SamplerSession`` (``SamplerSpec(sharded=True,
       mesh=...)``), kept one release for existing callers; it re-stages
       the graph + LP on every call.

    Sampling + reconstruction run on the replicated outputs, so a 1-rank
    mesh is bit-identical to ``run_windtunnel``.
    """
    from repro_torch.core.pipeline import note_deprecated
    from repro_torch.core.sampling_core import SamplerSession, SamplerSpec
    note_deprecated("run_windtunnel_sharded",
                    "SamplerSession with SamplerSpec(sharded=True, mesh=...)")
    session = SamplerSession(
        qrels, num_queries=num_queries, num_entities=num_entities,
        spec=SamplerSpec.from_config(config, strategy="windtunnel",
                                     sharded=True, mesh=mesh, axes=axes),
        device=device)
    return session.result()
