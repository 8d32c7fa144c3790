"""Sharded search — Layer 2 of the search core (port of
``repro/retrieval/sharded.py``).

The reference runs each plan as one ``shard_map`` region over a mesh; here
every rank runs the plan's body on its own shard, one rank per device,
and the region's collectives are ``torch.distributed`` ones over the
process group of the corpus axes (``distributed/collectives.py``). Each
shard scores through the scoring backend's primitives, so the ``cuda``
backend launches the kernels on every shard (the dense f32 kernel for
exact and tfidf, the Hamming kernel for lsh, the gathered kernel for
ivfflat, the int8 kernel for the born int8 plan).

Two generations of sharding live here:

**Sharded-from-birth (preferred).** :func:`sharded_build` constructs the
index per shard from a :class:`~repro_torch.distributed.sharded_corpus.
ShardedCorpus` whose rows were streamed straight into the rank's buffer:
nothing proportional to the global corpus is resident on one device.
Shard-local exact/tfidf rows, shard-local LSH codes, shard-local int8
quantization (a scale per shard + float rerank), and IVF lists refined
from shard-local partial sums converged by a per-iteration all-reduce.
The born index types (``Sharded*Index``, each field the rank's block)
route :func:`sharded_search` to the shard-local plans. On a 1-rank mesh
every born build and search is operation for operation the single-device
program (bit-consistent); on larger meshes results are set-equal under
the backend tie policy.

**Build-globally-then-partition (deprecated).** The index is built once
on every rank and only the scoring is sharded: each rank scores its slice
of the replicated index. Kept for pre-built ``engine.build`` indexes.

Both generations merge per-shard (scores, ids) partials with one tiled
all-gather and a stable descending sort (:func:`_merge`): equal scores go
to the lowest position, as ``lax.top_k`` gives them.

Partition plans per engine:

  * ``exact`` / ``tfidf`` — corpus rows over the mesh; per-shard dense
    top-k via ``backend.topk``; global ids from the shard's row offset.
    Born tfidf reduces the document-frequency vector with an integer
    all-reduce (bit-identical IDF weights on any mesh).
  * ``lsh`` — packed codes row-sharded; per-shard Hamming top-k via
    ``backend.hamming_topk``. The born rerank never replicates the
    vectors: each shard scores the merged candidates it owns in f32 and
    the partial score rows merge with an all-reduce MAX.
  * ``ivfflat`` — centroids replicate, so every shard probes the SAME
    lists. The legacy plan partitions the lists (a shard scores the
    members of the lists it owns); born lists are partitioned by row
    origin: each shard keeps a (n_lists, cap_local) ELL of its own rows
    per global list.
  * ``int8`` (born only) — per-shard quantized scan over shard-local codes
    and scale, candidate ids all-gathered, then the float rerank runs
    distributed as in lsh. The deprecated global-partition path rejects
    int8: its -1e30 padding sentinel would destroy the single global
    quantization scale.

Padding invariants: rows pad to a multiple of the shard count; pad rows
mask to -inf/-1 before the merge and never displace a real candidate.
Exact/tfidf pad rows carry a -1e30 sentinel column (queries a 1.0), so the
dense kernel runs at D+1 where the corpus has pad rows; LSH pad rows carry
W+1 all-ones extra code words (the Hamming kernel sees 2W+1); IVF pad rows
assign to a dummy list that is never probed; int8 widens the local
candidate pool by the global pad count.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import prng
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.compression import quantize_int8
from repro_torch.distributed.sharded_corpus import (ShardedCorpus,
                                                    resolve_corpus_axes)
from repro_torch.kernels.topk_scoring import ops as topk_ops
from repro_torch.kernels.topk_scoring.ref import pad_topk
from repro_torch.retrieval.backends import get_backend, rerank_candidates
from repro_torch.retrieval.ivfflat import (_cluster_sums, _sq_dist,
                                           probe_candidates)
from repro_torch.retrieval.lsh import encode


def _row_backend(engine):
    """The engine's backend as its single-device search runs it (the
    torch backend at the engine's streaming block, as ``exact_topk``)."""
    bk = get_backend(engine.backend)
    block = getattr(engine, "block", None)
    if bk.name == "torch" and block is not None and block != bk.block:
        bk = dataclasses.replace(bk, block=block)
    return bk


def _top(s: torch.Tensor, k: int):
    """(top scores, their positions) of each row, equal scores to the
    lowest position (``lax.top_k``'s order): a stable descending sort."""
    pos = torch.sort(s, dim=1, descending=True,
                     stable=True).indices[:, :min(k, s.shape[1])]
    return torch.gather(s, 1, pos), pos


def _merge(s: torch.Tensor, i: torch.Tensor, mesh, axes: tuple, k: int):
    """All-gather per-shard (scores, ids) partials along the k axis and
    reduce to the global top-k (replicated on every rank)."""
    s = coll.all_gather(s, mesh, axes, dim=1)
    i = coll.all_gather(i, mesh, axes, dim=1)
    top_s, pos = _top(s, k)
    return top_s, torch.gather(i, 1, pos)


def _masked(s, i, row0: int, n: int):
    """Global ids of a shard's (scores, local ids); pad rows and misses to
    -inf / -1."""
    gid = row0 + i
    ok = (i >= 0) & (gid < n)
    return torch.where(ok, s, -torch.inf), torch.where(ok, gid, -1)


def _rowwise_topk(backend, vecs: torch.Tensor, queries: torch.Tensor, *,
                  k: int, mesh, axes: tuple):
    """Row-sharded dense top-k: the shared plan for exact and tfidf.

    .. deprecated:: part of the build-globally-then-partition path: the
       full index is resident on every device before the scan. Prefer a
       sharded-from-birth build (:func:`sharded_build`)."""
    n, dim = vecs.shape
    d = coll.axis_size(mesh, axes)
    rows = -(-n // d)
    k_l = min(k, rows)
    pad = rows * d - n
    if pad:
        # sentinel coordinate: queries get 1.0, real rows 0.0, padded rows
        # -BIG, so a padded row scores -BIG and never displaces a real
        # candidate from the LOCAL top-k (a zero row would score 0 and beat
        # genuinely negative candidates before the validity mask)
        queries = torch.nn.functional.pad(queries, (0, 1), value=1.0)
        vp = torch.nn.functional.pad(vecs, (0, 1, 0, pad))
        vp[n:, dim] = -1e30
    else:
        vp = vecs
    row0 = coll.flat_axis_index(mesh, axes) * rows
    s, i = backend.topk(queries, vp[row0:row0 + rows], k=k_l)
    return pad_topk(*_merge(*_masked(s, i, row0, n), mesh, axes, k), k)


def _sharded_exact(engine, index, queries, *, k, mesh, axes):
    return _rowwise_topk(_row_backend(engine), index, queries, k=k,
                         mesh=mesh, axes=axes)


def _sharded_tfidf(engine, index, queries, *, k, mesh, axes):
    # IDF weights were folded into index.vecs at (global) build time, so the
    # sharded scan is the exact engine's plan over the weighted rows
    return _rowwise_topk(_row_backend(engine), index.vecs, queries, k=k,
                         mesh=mesh, axes=axes)


def _code_pad(codes: torch.Tensor, n: int) -> torch.Tensor:
    """Pad-row sentinel of LSH codes: W+1 extra words, all ones (-1) on
    rows at or past ``n``, zeros elsewhere. Their Hamming distance grows by
    32(W+1) > 32W >= any real distance, strictly below every real row
    (exact integer arithmetic; real rows' distances untouched)."""
    rows, w = codes.shape
    extra = torch.zeros((rows, w + 1), dtype=codes.dtype,
                        device=codes.device)
    extra[n:] = -1
    return torch.cat([codes, extra], dim=1)


def _sharded_lsh(engine, index, queries, *, k, mesh, axes):
    backend = get_backend(engine.backend)
    n = index.codes.shape[0]
    d = coll.axis_size(mesh, axes)
    rows = -(-n // d)
    rerank = min(max(engine.rerank, k), n) if engine.rerank > 0 else 0
    target = rerank if rerank > 0 else k
    t_l = min(target, rows)
    qc = encode(index.proj, queries)
    pad = rows * d - n
    if pad:
        w = index.codes.shape[1]
        cp = _code_pad(torch.nn.functional.pad(index.codes, (0, 0, 0, pad)),
                       n)
        qc = torch.nn.functional.pad(qc, (0, w + 1))
    else:
        cp = index.codes
    row0 = coll.flat_axis_index(mesh, axes) * rows
    s, i = backend.hamming_topk(qc, cp[row0:row0 + rows].contiguous(),
                                k=t_l)
    neg, cand = _merge(*_masked(s, i, row0, n), mesh, axes, target)
    if rerank <= 0:
        # search_lsh's no-rerank API: positive Hamming distance, lower =
        # better (+inf for misses)
        neg, cand = pad_topk(neg, cand, k)
        return (-neg).to(queries.dtype), cand
    # exact rerank of the merged global candidates on the replicated
    # vectors: the single-device search_lsh rerank step
    return rerank_candidates(index.vecs, queries, cand, k=k)


def _probe_topk(backend, index, queries, *, nprobe: int, k: int):
    """Probe ``index``'s lists for ``queries`` (``ivfflat.probe_candidates``:
    the same probes on every shard, centroids being replicated) and score
    the members through ``backend.gathered_rows_topk``; a slot whose
    ``mask`` is False is invalid."""
    rows, ids = probe_candidates(index, queries, nprobe=nprobe)
    table = index.vecs.reshape(-1, index.vecs.shape[2])
    return backend.gathered_rows_topk(queries, table, rows, ids, k=k)


def _sharded_ivfflat(engine, index, queries, *, k, mesh, axes):
    backend = get_backend(engine.backend)
    n_lists, cap, _ = index.vecs.shape
    nprobe = min(engine.nprobe, n_lists)
    ll = -(-n_lists // coll.axis_size(mesh, axes))
    l0 = coll.flat_axis_index(mesh, axes) * ll
    # this shard scores the members of the lists l0 .. l0 + ll it owns
    lists = torch.arange(n_lists, device=index.mask.device)
    owned = (lists >= l0) & (lists < l0 + ll)
    s, gid = _probe_topk(backend, index._replace(
        mask=index.mask & owned[:, None]), queries, nprobe=nprobe,
        k=min(k, nprobe * cap))
    return pad_topk(*_merge(s, gid, mesh, axes, k), k)


_SHARDED_IMPLS: Dict[str, Callable] = {
    "exact": _sharded_exact,
    "tfidf": _sharded_tfidf,
    "lsh": _sharded_lsh,
    "ivfflat": _sharded_ivfflat,
}


# ---------------------------------------------------------------------------
# Sharded-from-birth: per-shard index construction + shard-local search.
# The index never exists globally — every corpus-proportional field below
# is the rank's own block, built on its device.
# ---------------------------------------------------------------------------


class ShardedFlatIndex(NamedTuple):
    """Born-sharded dense rows (exact engine). ``aug`` marks the padding
    sentinel column (present only when the corpus has tail padding, so a
    1-rank build stays bit-identical to the global build)."""

    vecs: Any        # f32[rows, D(+1)] this rank's rows
    n: int
    aug: bool


class ShardedTfIdfIndex(NamedTuple):
    """Born-sharded IDF-weighted rows; ``weights`` replicate (an O(D)
    statistic reduced with an integer all-reduce)."""

    vecs: Any        # f32[rows, D(+1)] IDF-weighted, or a ShardedQuantIndex
    weights: Any     # f32[D] replicated
    n: int
    aug: bool


class ShardedQuantIndex(NamedTuple):
    """Born-sharded int8 corpus: per-shard codes with the shard's own
    scale (ranking within a shard is scale-invariant, and shards merge
    after the float rerank, so no global scale is needed). ``vecs`` keeps
    the float rows (IDF-weighted for tfidf) for the distributed rerank."""

    codes: Any       # i8[rows, D]
    scales: Any      # f32[1] this shard's max-abs scale
    vecs: Any        # f32[rows, D]
    n: int


class ShardedLSHIndex(NamedTuple):
    """Born-sharded LSH: codes encoded shard-locally from the replicated
    projection; ``aug`` marks the W+1 all-ones pad-sentinel words."""

    proj: Any        # f32[D, n_bits] replicated
    codes: Any       # i32[rows, W(+W+1)]
    vecs: Any        # f32[rows, D] (rerank)
    n: int
    aug: bool


class ShardedIVFIndex(NamedTuple):
    """Born-sharded IVF: lists partitioned by row ORIGIN shard — each shard
    holds a (n_lists, cap_local) ELL of its own rows per global list, so
    no row moves between shards at build time. Centroids replicate
    (refined from shard-local partial sums converged by an all-reduce per
    iteration), so every shard probes the same lists."""

    centroids: Any   # f32[n_lists, D] replicated
    vecs: Any        # f32[n_lists, cap_local, D]
    ids: Any         # i32[n_lists, cap_local] global ids, -1 pad
    mask: Any        # bool[n_lists, cap_local]
    n: int


_BORN_INDEX_TYPES = (ShardedFlatIndex, ShardedTfIdfIndex, ShardedQuantIndex,
                     ShardedLSHIndex, ShardedIVFIndex)


def _geometry(corpus: ShardedCorpus):
    """(row0, rows, pad) of this rank's block."""
    rows = corpus.rows_per_shard
    return corpus.shard * rows, rows, corpus.pad


def _local_valid(row0: int, rows: int, n: int, device) -> torch.Tensor:
    return (row0 + torch.arange(rows, device=device)) < n


def _augment_rows(corpus: ShardedCorpus, row_vecs):
    """Append the -1e30/0.0 pad-sentinel column shard-locally (only when
    the corpus has pad rows: a pad-free build adds nothing, preserving
    1-rank bit parity with the global build)."""
    row0, rows, pad = _geometry(corpus)
    if not pad:
        return row_vecs, False
    sent = torch.where(_local_valid(row0, rows, corpus.n, row_vecs.device),
                       0.0, -1e30).to(row_vecs.dtype)
    return torch.cat([row_vecs, sent[:, None]], dim=1), True


def _quant_build(corpus: ShardedCorpus, row_vecs) -> ShardedQuantIndex:
    """Per-shard int8 quantization: each shard derives its own max-abs
    scale from its local rows only (zero pad rows cannot perturb it)."""
    codes, scale = quantize_int8(row_vecs)
    return ShardedQuantIndex(codes, scale[None], row_vecs, corpus.n)


def _build_born_exact(engine, corpus: ShardedCorpus, key):
    del key  # deterministic
    if engine.backend == "int8":
        return _quant_build(corpus, corpus.vecs)
    vecs, aug = _augment_rows(corpus, corpus.vecs)
    return ShardedFlatIndex(vecs, corpus.n, aug)


def _build_born_tfidf(engine, corpus: ShardedCorpus, key):
    del key  # deterministic
    # integer document frequencies sum exactly -> IDF weights are
    # bit-identical to the global build on any mesh (pad rows are all-zero,
    # so (v > 0) contributes nothing)
    df = coll.all_reduce((corpus.vecs > 0).sum(dim=0), corpus.mesh,
                         corpus.axes).to(torch.float32) + 1.0
    w = torch.log1p(corpus.n / df)
    weighted = corpus.vecs * w[None, :]
    if engine.backend == "int8":
        return ShardedTfIdfIndex(_quant_build(corpus, weighted), w,
                                 corpus.n, False)
    weighted, aug = _augment_rows(corpus, weighted)
    return ShardedTfIdfIndex(weighted, w, corpus.n, aug)


def _build_born_lsh(engine, corpus: ShardedCorpus, key):
    row0, rows, pad = _geometry(corpus)
    proj = prng.normal(key, (corpus.dim, engine.n_bits), corpus.vecs.device)
    codes = encode(proj, corpus.vecs)
    if pad:
        # the legacy path's pad sentinel, applied at birth to the rows of
        # this shard at or past n
        codes = _code_pad(codes, min(max(corpus.n - row0, 0), rows))
    return ShardedLSHIndex(proj, codes, corpus.vecs, corpus.n, bool(pad))


def _build_born_ivfflat(engine, corpus: ShardedCorpus, key,
                        kmeans_iters: int = 10):
    """IVF build with shard-local centroid refinement: Lloyd iterations
    compute per-shard (sum, count) partials over local rows and converge
    them with one all-reduce per iteration; no rank ever sees another
    shard's rows. List fill is shard-local too: each shard packs its own
    rows into a (n_lists, cap_local) ELL keyed by the replicated
    centroids."""
    mesh, axes = corpus.mesh, corpus.axes
    row0, rows, pad = _geometry(corpus)
    n, dim = corpus.n, corpus.dim
    v_l = corpus.vecs
    dev = v_l.device
    n_lists = min(engine.n_lists, max(1, n // 8))
    cap_l = int(engine.cap_factor * rows / n_lists) + 1
    valid = _local_valid(row0, rows, n, dev)

    # replicated init centroids (ivfflat.kmeans' selection): each shard
    # contributes the init rows it owns; the all-reduce assembles them
    lidx = prng.choice(key, n, n_lists, dev) - row0
    own = (lidx >= 0) & (lidx < rows)
    cand = v_l[torch.clamp(lidx, 0, rows - 1)]
    cent = coll.all_reduce(torch.where(own[:, None], cand, 0.0), mesh, axes)

    # pad rows route to a dummy segment so they never pull a centroid; the
    # dummy exists only where pads do (1-rank parity)
    nseg = n_lists + 1 if pad else n_lists

    def assign_of(c):
        a = torch.argmin(_sq_dist(v_l, c), dim=1)
        return torch.where(valid, a, n_lists) if pad else a

    for _ in range(kmeans_iters):
        sums, cnts = _cluster_sums(v_l, assign_of(cent), nseg)
        sums = coll.all_reduce(sums[:n_lists], mesh, axes)
        cnts = coll.all_reduce(cnts[:n_lists], mesh, axes)
        cent = torch.where(cnts > 0, sums / torch.clamp(cnts, min=1.0), cent)

    # shard-local ELL list fill (build_ivfflat's fill over local rows)
    a = assign_of(cent)
    order = torch.sort(a, stable=True).indices
    sa = a[order]
    starts = torch.ones(rows, dtype=torch.bool, device=dev)
    starts[1:] = sa[1:] != sa[:-1]
    iota = torch.arange(rows, device=dev)
    rank = iota - torch.cummax(torch.where(starts, iota, 0), 0).values
    ok = (rank < cap_l) & (sa < n_lists)
    slot = sa[ok] * cap_l + rank[ok]
    lvecs = torch.zeros((n_lists * cap_l, dim), dtype=v_l.dtype, device=dev)
    lvecs[slot] = v_l[order[ok]]
    lids = torch.full((n_lists * cap_l,), -1, dtype=torch.int32, device=dev)
    lids[slot] = (row0 + order[ok]).to(torch.int32)
    lmask = torch.zeros(n_lists * cap_l, dtype=torch.bool, device=dev)
    lmask[slot] = True
    return ShardedIVFIndex(cent, lvecs.reshape(n_lists, cap_l, dim),
                           lids.reshape(n_lists, cap_l),
                           lmask.reshape(n_lists, cap_l), n)


_BORN_BUILDS: Dict[str, Callable] = {
    "exact": _build_born_exact,
    "tfidf": _build_born_tfidf,
    "lsh": _build_born_lsh,
    "ivfflat": _build_born_ivfflat,
}


def sharded_build(engine, corpus: ShardedCorpus, key=None):
    """Per-shard index construction over a sharded-from-birth corpus.

    Returns a born index (``Sharded*Index``) whose corpus-proportional
    fields are this rank's blocks; :func:`sharded_search` routes them to
    the shard-local plans. On a 1-rank mesh the built index is
    bit-identical to ``engine.build`` on the gathered rows."""
    try:
        impl = _BORN_BUILDS[engine.name]
    except KeyError:
        raise ValueError(
            f"no shard-local build plan for engine {engine.name!r}; "
            f"engines with plans: {', '.join(sorted(_BORN_BUILDS))}"
        ) from None
    if key is None:
        key = prng.prng_key(0)
    return impl(engine, corpus, key)


def _distributed_rerank(v_l, q, cand, row0: int, rows: int, k: int, mesh,
                        axes):
    """Float rerank of replicated candidate ids against row-sharded
    vectors: each shard scores the candidates it owns (-inf elsewhere) and
    the partial score rows merge with an all-reduce MAX. Every real
    candidate is owned by exactly one shard, so the merged row equals
    ``rerank_candidates`` on the gathered vectors, bit for bit on one rank
    and value-equal on any mesh."""
    lid = cand - row0
    own = (cand >= 0) & (lid >= 0) & (lid < rows)
    cv = v_l[torch.clamp(lid, 0, rows - 1).long()]
    s = torch.einsum("qd,qrd->qr", q, cv)
    s = torch.where(own, s, -torch.inf)
    s = coll.all_reduce(s, mesh, axes, "max")
    s = torch.where(cand >= 0, s, -torch.inf)
    top_s, pos = _top(s, k)
    top_i = torch.gather(cand, 1, pos)
    top_i = torch.where(torch.isfinite(top_s), top_i, -1)
    return pad_topk(top_s, top_i, k)


def _search_born_rows(backend, index_vecs, n: int, aug: bool, queries, *,
                      k: int, mesh, axes):
    """Shard-local dense scan over born rows (exact / tfidf): the sentinel
    column was appended at build time, so this is ``_rowwise_topk`` minus
    the global pad step."""
    rows = index_vecs.shape[0]
    k_l = min(k, rows)
    if aug:
        queries = torch.nn.functional.pad(queries, (0, 1), value=1.0)
    row0 = coll.flat_axis_index(mesh, axes) * rows
    s, i = backend.topk(queries, index_vecs, k=k_l)
    return pad_topk(*_merge(*_masked(s, i, row0, n), mesh, axes, k), k)


def _search_born_quant(backend, index: ShardedQuantIndex, queries, *,
                       k: int, mesh, axes):
    """Born int8 plan: per-shard quantized scan on the int8 top-k kernel
    (its plain version on a CPU tensor; the integer ranking is invariant
    to the shard's own scale), candidate ids all-gathered, float rerank
    distributed over the sharded rows. The local pool widens by the global
    pad count so zero-code pad rows never displace a real candidate (they
    score 0, which beats genuinely negative rows before the mask)."""
    d = coll.axis_size(mesh, axes)
    rows = index.codes.shape[0]
    n = index.n
    pad = rows * d - n
    pool = min(max(backend.rerank_factor * k, k), n)
    pool_l = min(pool + pad, rows)
    q_codes, _ = quantize_int8(queries.to(torch.float32))
    row0 = coll.flat_axis_index(mesh, axes) * rows
    _, i = topk_ops.topk_scores_int8(q_codes, index.codes, k=pool_l)
    gid = torch.where((i >= 0) & (row0 + i < n), row0 + i, -1)
    cand = coll.all_gather(gid, mesh, axes, dim=1)
    return _distributed_rerank(index.vecs, queries, cand, row0, rows, k,
                               mesh, axes)


def _search_born_lsh(engine, index: ShardedLSHIndex, queries, *, k: int,
                     mesh, axes):
    backend = get_backend(engine.backend)
    n = index.n
    rows = index.codes.shape[0]
    rerank = min(max(engine.rerank, k), n) if engine.rerank > 0 else 0
    target = rerank if rerank > 0 else k
    t_l = min(target, rows)
    qc = encode(index.proj, queries)
    if index.aug:
        qc = torch.nn.functional.pad(
            qc, (0, index.codes.shape[1] - qc.shape[1]))
    row0 = coll.flat_axis_index(mesh, axes) * rows
    s, i = backend.hamming_topk(qc, index.codes, k=t_l)
    neg, cand = _merge(*_masked(s, i, row0, n), mesh, axes, target)
    if rerank <= 0:
        # positive Hamming distance, matching search_lsh's no-rerank API
        neg, cand = pad_topk(neg, cand, k)
        return (-neg).to(queries.dtype), cand
    return _distributed_rerank(index.vecs, queries, cand, row0, rows, k,
                               mesh, axes)


def _search_born_ivf(engine, index: ShardedIVFIndex, queries, *, k: int,
                     mesh, axes):
    backend = get_backend(engine.backend)
    n_lists, cap_l = index.ids.shape
    nprobe = min(engine.nprobe, n_lists)
    s, gid = _probe_topk(backend, index, queries, nprobe=nprobe,
                         k=min(k, nprobe * cap_l))
    return pad_topk(*_merge(s, gid, mesh, axes, k), k)


def sharded_buffer_topk(buf_vecs, n_valid, queries, *, k: int, mesh,
                        axes: Optional[tuple] = None, id_base: int = 0):
    """Dense exact top-k over a fixed-capacity row-sharded append buffer
    (the serving tier's live-ingest structure).

    ``buf_vecs`` is this rank's f32[cap_l, D] block (rows at global
    position >= ``n_valid`` are unused capacity). Scores are plain f32
    inner products, ids come back offset by ``id_base`` (the frozen
    corpus size), and the per-shard partials merge as every sharded plan's
    do."""
    axes = resolve_corpus_axes(mesh, axes)
    rows = buf_vecs.shape[0]
    k_l = min(k, rows)
    row0 = coll.flat_axis_index(mesh, axes) * rows
    gid = row0 + torch.arange(rows, device=buf_vecs.device)
    s = (queries @ buf_vecs.T).to(torch.float32)
    s = torch.where((gid < int(n_valid))[None, :], s, -torch.inf)
    top_s, pos = _top(s, k_l)
    top_i = torch.where(torch.isfinite(top_s), id_base + row0 + pos,
                        -1).to(torch.int32)
    return pad_topk(*_merge(top_s, top_i, mesh, axes, k), k)


def _born_search(engine, index, queries, *, k: int, mesh, axes):
    if isinstance(index, ShardedTfIdfIndex):
        index = index.vecs if isinstance(index.vecs,
                                         ShardedQuantIndex) else index
    if isinstance(index, (ShardedFlatIndex, ShardedTfIdfIndex)):
        return _search_born_rows(_row_backend(engine), index.vecs, index.n,
                                 index.aug, queries, k=k, mesh=mesh,
                                 axes=axes)
    if isinstance(index, ShardedQuantIndex):
        return _search_born_quant(get_backend(engine.backend), index,
                                  queries, k=k, mesh=mesh, axes=axes)
    if isinstance(index, ShardedLSHIndex):
        return _search_born_lsh(engine, index, queries, k=k, mesh=mesh,
                                axes=axes)
    if isinstance(index, ShardedIVFIndex):
        return _search_born_ivf(engine, index, queries, k=k, mesh=mesh,
                                axes=axes)
    raise TypeError(f"not a born-sharded index: {type(index).__name__}")


def sharded_search(engine, index, queries: torch.Tensor, *, k: int,
                   mesh, axes: Optional[tuple] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mesh-partitioned ``engine.search_scored`` with equivalent
    semantics: (scores f32[Q, k], ids i32[Q, k]) into the corpus the index
    was built from, -inf/-1 padding for misses, replicated on every rank.
    Bit-consistent with single-device search on a 1-rank mesh; set-equal
    under the backend tie policy on larger meshes.

    Born indexes from :func:`sharded_build` route to the shard-local
    plans (including int8); a pre-built global index falls through to the
    deprecated build-globally-then-partition plans."""
    if isinstance(index, _BORN_INDEX_TYPES):
        return _born_search(engine, index, queries, k=k, mesh=mesh,
                            axes=resolve_corpus_axes(mesh, axes))
    if getattr(engine, "backend", None) == "int8":
        # the row-shard padding sentinel (-1e30 coordinate) would destroy
        # the int8 corpus scale on THIS (deprecated, global-partition)
        # path; the born path supports int8 via per-shard scales + float
        # rerank — build with ``sharded_build`` instead
        raise ValueError(
            "sharded search does not support the 'int8' backend; use "
            "backend='torch' or 'cuda' for sharded meshes")
    try:
        impl = _SHARDED_IMPLS[engine.name]
    except KeyError:
        raise ValueError(
            f"no sharded search plan for engine {engine.name!r}; engines "
            f"with plans: {', '.join(sorted(_SHARDED_IMPLS))}") from None
    return impl(engine, index, queries, k=k, mesh=mesh,
                axes=resolve_corpus_axes(mesh, axes))
