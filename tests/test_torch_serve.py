"""The port's serving tier (``repro_torch.serve`` and
``repro_torch.launch.serve``) against the JAX package's on the CPU, at
D = 16, with the same numpy inputs fed to both.

Tolerances as ``tests/test_torch_search.py``: scores rtol 1e-5 (BLAS and
XLA sum the inner products in other orders); ids equal, except where two
neighbouring scores of the reference lie within that tolerance (a
near-tie). Host-only parts (queue, buckets, tenant cache, load counts) are
held equal.

The reference's own ivfflat append tests are red
(``tests/test_serve_tier.py::test_append_then_search_matches_rebuild[
ivfflat-jnp]`` and ``[ivfflat-int8]``: with ``n_lists`` 4 the live index's
frozen 120 rows and a rebuild's 165 fill their capacity-bound lists
differently, so row 3's 10th id differs). So the port's ivfflat
``LiveIndex`` is held to the reference's ``LiveIndex`` on the same inputs,
not to a rebuild.
"""
import json
import threading

import jax
import numpy as np
import pytest
import torch

from repro.launch import serve as jcli
from repro.obs.metrics import Registry as JRegistry
from repro.retrieval import search_core as jsc
from repro.serve import scheduler as jsched
from repro.serve import tenants as jtenants
from repro.serve import ingest as jingest_mod
from repro.serve import (IngestConfig as JIngest, LiveIndex as JLive,
                         LoadSpec as JLoadSpec, RetrievalFrontend as JFront,
                         SearchServer as JServer, run_load as jrun_load)
from repro_torch.launch import serve as tcli
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.obs import REGISTRY
from repro_torch.obs.metrics import Registry
from repro_torch.retrieval import search_core as tsc
from repro_torch.serve import ingest as ingest_mod
from repro_torch.serve import (IngestConfig, LiveIndex, LoadSpec, LRUCache,
                               MicrobatchScheduler, RetrievalFrontend,
                               SchedulerConfig, SearchServer, TenantCache,
                               run_load)

D = 16
RTOL = 1e-5
CPU = dict(device="cpu")
# the reference's exhaustive hyper-parameters (tests/test_serve_tier.py)
ENGINE_OPTS = {
    "exact": None,
    "tfidf": None,
    "ivfflat": {"n_lists": 4, "nprobe": 64},
    "lsh": {"n_bits": 256, "rerank": 10 ** 6},
}
# the port's backends and the reference backends they are held against
BACKENDS = [("torch", "jnp"), ("int8", "int8")]
NO_COMPACT = 10 ** 9


def _corpus(n, seed=0, dim=D):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, dim)).astype(np.float32)


def _sparse(n, seed=0, dim=D):
    """Non-negative sparse rows (tfidf-shaped data with real df
    variation)."""
    rng = np.random.default_rng(seed)
    x = np.abs(rng.normal(size=(n, dim))).astype(np.float32)
    x[x < 0.8] = 0.0
    return x


def _sets(ids):
    return [set(int(i) for i in row if i >= 0) for row in ids]


def _assert_topk_close(ts, ti, js, ji):
    js, ji = np.asarray(js), np.asarray(ji)
    assert ts.shape == js.shape and ti.shape == ji.shape
    assert ts.dtype == np.float32 and ti.dtype == np.int32
    np.testing.assert_allclose(ts, js, rtol=RTOL, atol=RTOL)
    for r, c in zip(*np.nonzero(ti != ji)):
        row = js[r]
        near = [abs(row[c] - row[x]) <= RTOL * max(1.0, abs(row[c]))
                for x in (c - 1, c + 1) if 0 <= x < row.size]
        assert any(near), (r, c, row)


def _live_pair(engine, tb, jb, base, ingest, **kw):
    cfg = tsc.SearchConfig(engine=engine, backend=tb,
                           engine_opts=ENGINE_OPTS[engine])
    jcfg = jsc.SearchConfig(engine=engine, backend=jb,
                            engine_opts=ENGINE_OPTS[engine])
    t = LiveIndex(base, cfg, ingest=IngestConfig(**ingest), **CPU, **kw)
    j = JLive(base, jcfg, ingest=JIngest(**ingest))
    return t, j, cfg


# -- LiveIndex ----------------------------------------------------------------

@pytest.mark.parametrize("tb,jb", BACKENDS)
@pytest.mark.parametrize("engine", sorted(ENGINE_OPTS))
def test_live_index_matches_reference_after_appends(engine, tb, jb):
    make = _sparse if engine == "tfidf" else _corpus
    base, extra = make(120, seed=1), make(45, seed=2)
    queries = make(6, seed=3)
    t, j, cfg = _live_pair(engine, tb, jb, base,
                           dict(append_cap=8, compact_threshold=NO_COMPACT))
    assert t.append(extra[:20]) == j.append(extra[:20]) == (120, 140)
    assert t.append(extra[20:]) == j.append(extra[20:]) == (140, 165)
    assert t.pending_rows == 45 and t.n == 165
    ts, ti = t.search_scored(queries, k=10)
    _assert_topk_close(ts, ti, *j.search_scored(queries, k=10))
    assert np.isfinite(ts).all() and (np.diff(ts, axis=1) <= 1e-5).all()
    if engine != "ivfflat":      # the reference's own ivfflat test is red
        rebuilt = tsc.SearchSession(np.concatenate([base, extra]), cfg, **CPU)
        assert _sets(ti) == _sets(rebuilt.search(queries, k=10))


def test_live_index_capacity_growth_matches_rebuild_and_reference():
    base = _corpus(64, seed=0)
    t, j, cfg = _live_pair("exact", "torch", "jnp", base,
                           dict(append_cap=4, compact_threshold=NO_COMPACT))
    chunks = [_corpus(7, seed=s + 10) for s in range(5)]
    caps = []
    for c in chunks:
        t.append(c)                       # forces repeated buffer growth
        j.append(c)
        caps.append(t._cap)
    assert caps == [8, 16, 32, 32, 64] and t.pending_rows == 35
    q = _corpus(4, seed=99)
    rebuilt = tsc.SearchSession(np.concatenate([base] + chunks), cfg, **CPU)
    assert _sets(t.search(q, k=12)) == _sets(rebuilt.search(q, k=12))
    _assert_topk_close(*t.search_scored(q, k=12), *j.search_scored(q, k=12))


def test_live_index_k_larger_than_corpus_pads():
    t, j, _ = _live_pair("exact", "torch", "jnp", _corpus(5),
                         dict(compact_threshold=NO_COMPACT))
    for li in (t, j):
        li.append(_corpus(3, seed=4))
    ts, ti = t.search_scored(_corpus(2, seed=5), k=12)
    assert ti.shape == (2, 12)
    assert (ti[:, :8] >= 0).all() and (ti[:, 8:] == -1).all()
    assert np.isneginf(ts[:, 8:]).all()
    _assert_topk_close(ts, ti, *j.search_scored(_corpus(2, seed=5), k=12))


def test_live_index_rejects_no_rerank_lsh():
    with pytest.raises(ValueError, match="rerank"):
        LiveIndex(_corpus(64), tsc.SearchConfig(
            engine="lsh", engine_opts={"rerank": 0}), **CPU)


def test_compaction_threshold_triggers_and_preserves_ids():
    reg = Registry()
    li = LiveIndex(_corpus(50, seed=0), tsc.SearchConfig(),
                   ingest=IngestConfig(append_cap=8, compact_threshold=10,
                                       background=False), registry=reg,
                   **CPU)
    q = _corpus(3, seed=9)
    li.append(_corpus(6, seed=1))
    assert li.pending_rows == 6            # below threshold: no compaction
    start, stop = li.append(_corpus(6, seed=2))
    assert (start, stop) == (56, 62)
    assert li.pending_rows == 0 and li.frozen_n == 62
    assert reg.counter("serve.ingest.compactions").value == 1
    rebuilt = tsc.SearchSession(np.concatenate(
        [_corpus(50, seed=0), _corpus(6, seed=1), _corpus(6, seed=2)]),
        tsc.SearchConfig(), **CPU)
    assert np.array_equal(li.search(q, k=8), rebuilt.search(q, k=8))
    # ids are stable across the compaction: a third append continues on
    assert li.append(_corpus(3, seed=3)) == (62, 65)


def _blocking_session(monkeypatch, module=ingest_mod):
    started, release = threading.Event(), threading.Event()
    real = module.SearchSession

    class BlockingSession(real):
        def __init__(self, *a, **kw):
            started.set()
            assert release.wait(timeout=30)
            super().__init__(*a, **kw)

    monkeypatch.setattr(module, "SearchSession", BlockingSession)
    return started, release, real


def _join_worker(li):
    """Join a background compaction's thread without calling the index."""
    t = li._compactor
    assert t is not None and t.name == "live-index-compact"
    t.join(timeout=30)
    assert not t.is_alive()


def _ingest_state(li, reg):
    return dict(frozen_n=li.frozen_n, pending=li.pending_rows, n=li.n,
                compactions=reg.counter("serve.ingest.compactions").value,
                gauge=reg.gauge("serve.ingest.pending").value)


def test_worker_lands_its_compaction_as_the_reference_does(monkeypatch):
    """On one rank the compaction worker swaps its build in itself: after
    the worker is joined, with no further call of the index, frozen_n,
    pending_rows, n, the pending gauge and the compactions counter read the
    state after the compaction, equal to the reference's after the same
    steps (rows appended mid-build stay pending)."""
    base, extra, late = _corpus(60, seed=0), _corpus(12, seed=1), \
        _corpus(5, seed=2)
    ingest = dict(append_cap=8, compact_threshold=10)
    regs, states = (Registry(), JRegistry()), []
    t = LiveIndex(base, tsc.SearchConfig(), ingest=IngestConfig(**ingest),
                  registry=regs[0], **CPU)
    j = JLive(base, jsc.SearchConfig(), ingest=JIngest(**ingest),
              registry=regs[1])
    for li, reg, module in ((t, regs[0], ingest_mod),
                            (j, regs[1], jingest_mod)):
        started, release, _ = _blocking_session(monkeypatch, module)
        li.append(extra)                     # reaches the threshold
        assert started.wait(timeout=30)
        li.append(late)                      # mid-build: stays pending
        assert li.frozen_n == 60 and li.pending_rows == 17
        release.set()
        _join_worker(li)
        states.append(_ingest_state(li, reg))
    assert states[0] == states[1] == dict(frozen_n=72, pending=5, n=77,
                                          compactions=1, gauge=5)
    q = _corpus(3, seed=3)
    _assert_topk_close(*t.search_scored(q, k=9), *j.search_scored(q, k=9))


@pytest.mark.parametrize("call", ["search_scored", "append", "compact",
                                  "flush"])
def test_worker_failure_is_raised_by_the_next_call(monkeypatch, call):
    """A failed background build changes no state: joined with no further
    call, the index reads its old snapshot; the next call of any kind
    raises the failure once, and the old snapshot keeps answering."""
    reg = Registry()
    li = LiveIndex(_corpus(40), tsc.SearchConfig(), ingest=IngestConfig(
        append_cap=8, compact_threshold=NO_COMPACT), registry=reg, **CPU)
    li.append(_corpus(4, seed=1))
    q = _corpus(2, seed=2)
    before = li.search_scored(q, k=5)
    state = _ingest_state(li, reg)

    def boom(*a, **kw):
        raise RuntimeError("injected build failure")

    monkeypatch.setattr(ingest_mod, "SearchSession", boom)
    assert li.compact(background=True)
    _join_worker(li)
    assert _ingest_state(li, reg) == state
    args = {"search_scored": (q,), "append": (_corpus(1, seed=3),),
            "compact": (), "flush": ()}[call]
    kwargs = {"k": 5} if call == "search_scored" else {}
    with pytest.raises(RuntimeError, match="compaction failed") as err:
        getattr(li, call)(*args, **kwargs)
    assert "injected" in str(err.value.__cause__)
    assert li._compactor is None and not li._compacting
    li.flush()                                     # nothing left to raise
    got = li.search_scored(q, k=5)
    assert np.array_equal(got[1], before[1]) and li.frozen_n == 40


def test_searches_succeed_during_background_compaction(monkeypatch):
    """While the rebuild is in flight, searches keep answering from the old
    snapshot and see every appended row; appends mid-build stay pending
    and survive the swap."""
    base, extra = _corpus(80, seed=0), _corpus(30, seed=1)
    queries = _corpus(4, seed=2)
    reg = Registry()
    li = LiveIndex(base, tsc.SearchConfig(), ingest=IngestConfig(
        append_cap=64, compact_threshold=NO_COMPACT), registry=reg, **CPU)
    li.append(extra)
    expect = li.search_scored(queries, k=10)
    started, release, real = _blocking_session(monkeypatch)
    assert li.compact(background=True)
    assert started.wait(timeout=30)
    assert not li.compact(background=True)        # one at a time
    for _ in range(3):
        got = li.search_scored(queries, k=10)
        assert np.array_equal(got[1], expect[1])
    late = _corpus(5, seed=3)
    assert li.append(late) == (110, 115)
    assert li.frozen_n == 80 and li.pending_rows == 35
    release.set()
    li.flush()
    assert li.frozen_n == 110 and li.pending_rows == 5
    assert reg.counter("serve.ingest.compactions").value == 1
    rebuilt = real(np.concatenate([base, extra, late]), tsc.SearchConfig(),
                   **CPU)
    assert _sets(li.search(queries, k=10)) == _sets(
        rebuilt.search(queries, k=10))


def test_background_compaction_failure_raises_on_next_call(monkeypatch):
    li = LiveIndex(_corpus(40), tsc.SearchConfig(), ingest=IngestConfig(
        append_cap=8, compact_threshold=NO_COMPACT), **CPU)
    li.append(_corpus(4, seed=1))
    q = _corpus(2, seed=2)
    before = li.search_scored(q, k=5)

    def boom(*a, **kw):
        raise RuntimeError("injected build failure")

    monkeypatch.setattr(ingest_mod, "SearchSession", boom)
    assert li.compact(background=True)
    li._compactor.join(timeout=30)
    with pytest.raises(RuntimeError, match="compaction failed") as err:
        li.search_scored(q, k=5)
    assert "injected" in str(err.value.__cause__)
    # the failure is consumed; the index keeps serving the old snapshot
    got = li.search_scored(q, k=5)
    assert np.array_equal(got[1], before[1]) and li.pending_rows == 4
    li.flush()                                     # nothing left to raise


def test_append_between_searches_is_masked_for_the_earlier_snapshot(
        monkeypatch):
    """An append within capacity writes its rows into the buffer the
    earlier search snapshotted (in place), past the snapshot's pending
    count: that search masks them, the next one sees them."""
    li = LiveIndex(_corpus(40, seed=0), tsc.SearchConfig(),
                   ingest=IngestConfig(append_cap=64,
                                       compact_threshold=NO_COMPACT), **CPU)
    li.append(_corpus(4, seed=1))
    q = _corpus(3, seed=2)
    late = q * 10.0                       # each query's own top row
    real = ingest_mod._buffer_topk
    seen = {}

    def append_mid_search(queries, buf, n_valid, **kw):
        if not seen:
            li.append(late)
            seen["same_buffer"] = buf is li._buf
            seen["written"] = torch.equal(buf[n_valid:n_valid + 3],
                                          torch.from_numpy(late))
        return real(queries, buf, n_valid, **kw)

    monkeypatch.setattr(ingest_mod, "_buffer_topk", append_mid_search)
    first = li.search(q, k=5)
    assert seen == {"same_buffer": True, "written": True}
    assert not (first >= 44).any()           # masked: snapshot had 4 rows
    second = li.search(q, k=5)
    assert second[:, 0].tolist() == [44, 45, 46]


# -- scheduler ------------------------------------------------------------------

class _Spy:
    """A search target recording each dispatched batch's shape and tenant."""

    def __init__(self, session, calls, tenant):
        self.session, self.calls, self.tenant = session, calls, tenant

    def search_scored(self, q, *, k):
        self.calls.append((self.tenant, np.asarray(q).shape[0], k))
        if self.tenant == "bad":
            raise RuntimeError("engine exploded")
        return self.session.search_scored(q, k=k)


def _drive(make_sched, session):
    """One submit/tick script: three tenants, a queue of 7 (rejections), k
    from 1 to k_max, a failing tenant. Returns what both packages must
    agree on."""
    calls = []
    sched = make_sched(lambda t: _Spy(session, calls, t))
    script = ["a", "a", "b", "a", "bad", "bad", "a", "a", "a", "b"]
    reqs = [sched.submit(_corpus(1, seed=i)[0], k=1 + i % 6, tenant=t)
            for i, t in enumerate(script)]
    served = []
    while True:
        before = [r is not None and r.done for r in reqs]
        if not sched.tick():
            break
        served.append([i for i, r in enumerate(reqs)
                       if r is not None and r.done and not before[i]])
    results = []
    for r in reqs:
        if r is None:
            results.append(None)
            continue
        try:
            results.append(r.result(timeout=0))
        except RuntimeError as e:
            results.append(str(e))
    return dict(rejected=[i for i, r in enumerate(reqs) if r is None],
                served=served, ticks=sched.ticks, calls=calls,
                results=results)


def test_scheduler_agrees_with_reference():
    corpus = _corpus(64, seed=3)
    cfg = dict(max_queue=7, max_batch=4, k_max=6)
    t = _drive(lambda s: MicrobatchScheduler(
        s, SchedulerConfig(**cfg), registry=Registry()),
        tsc.SearchSession(corpus, tsc.SearchConfig(), **CPU))
    j = _drive(lambda s: jsched.MicrobatchScheduler(
        s, jsched.SchedulerConfig(**cfg), registry=JRegistry()),
        jsc.SearchSession(corpus, jsc.SearchConfig()))
    for key in ("rejected", "served", "ticks", "calls"):
        assert t[key] == j[key], key
    assert t["rejected"] == [7, 8, 9]
    assert t["calls"] == [("a", 4, 6), ("b", 1, 6), ("bad", 2, 6)]
    assert t["results"][4] == t["results"][5] == "engine exploded"
    for got, want in zip(t["results"], j["results"]):
        if want is None or isinstance(want, str):
            assert got == want
        else:
            _assert_topk_close(got[0][None], got[1][None], want[0][None],
                               want[1][None])


def test_scheduler_k_bounds_match_reference():
    for sched in (MicrobatchScheduler(lambda t: None,
                                      SchedulerConfig(k_max=4),
                                      registry=Registry()),
                  jsched.MicrobatchScheduler(lambda t: None,
                                             jsched.SchedulerConfig(k_max=4),
                                             registry=JRegistry())):
        with pytest.raises(ValueError, match="k_max"):
            sched.submit(np.zeros(D, np.float32), k=9)
    assert SchedulerConfig(max_batch=24).bucket_set() == \
        jsched.SchedulerConfig(max_batch=24).bucket_set() == \
        (1, 2, 4, 8, 16, 24)


def test_scheduler_completes_with_host_arrays_from_a_tensor_session():
    """A session that hands back tensors still completes its requests with
    host numpy arrays (read back, so latency counts the device's work)."""
    session = tsc.SearchSession(_corpus(32), tsc.SearchConfig(), **CPU)

    class TensorSession:
        def search_scored(self, q, *, k):
            s, i = session.search_scored(q, k=k)
            return torch.from_numpy(s), torch.from_numpy(i)

    sched = MicrobatchScheduler(lambda t: TensorSession(),
                                SchedulerConfig(k_max=4),
                                registry=Registry())
    req = sched.submit(torch.from_numpy(_corpus(1, seed=2)[0]), k=3)
    sched.drain()
    scores, ids = req.result(timeout=0)
    assert isinstance(scores, np.ndarray) and isinstance(ids, np.ndarray)
    assert np.array_equal(ids, session.search(_corpus(1, seed=2), k=3)[0])


# -- tenant cache -----------------------------------------------------------------

class _Flushable:
    def __init__(self, name, log):
        self.name, self.log = name, log

    def flush(self):
        self.log.append(self.name)


def _tenant_script(cache_cls, registry):
    built, flushed = [], []

    def provider(tenant):
        built.append(tenant)
        return _Flushable(tenant, flushed)

    cache = cache_cls(provider, capacity=2, registry=registry)
    states = []
    for op, tenant in [("get", "t1"), ("get", "t2"), ("get", "t1"),
                       ("get", "t3"), ("get", "t2"), ("evict", "t1"),
                       ("evict", "t9"), ("get", "t1"), ("get", "t1")]:
        out = getattr(cache, op)(tenant)
        states.append((op, tenant, cache.resident,
                       out if op == "evict" else out.name))
    counts = {c: registry.counter(f"serve.tenant.{c}").value
              for c in ("hit", "miss", "evict")}
    return states, counts, built, flushed


def test_tenant_cache_agrees_with_reference():
    t = _tenant_script(TenantCache, Registry())
    j = _tenant_script(jtenants.TenantCache, JRegistry())
    assert t == j
    assert t[1] == {"hit": 2, "miss": 5, "evict": 3}


def test_tenant_cache_resident_gauge_reads_the_allocator_peak():
    reg = Registry()
    TenantCache(lambda t: object(), registry=reg).get("a")
    # no card: obs/memory has no reading, and the gauge reads 0
    assert reg.gauge("serve.tenant.resident_bytes").value == 0


def test_lru_cache_agrees_with_reference():
    def script(cls):
        evicted = []
        c = cls(3, on_evict=lambda k, v: evicted.append((k, v)))
        out = []
        for op, key in [("put", "a"), ("put", "b"), ("get", "a"),
                        ("put", "c"), ("put", "d"), ("get", "b"),
                        ("pop", "c"), ("put", "e"), ("put", "f"),
                        ("get", "zz")]:
            val = c.put(key, key.upper()) if op == "put" \
                else getattr(c, op)(key)
            out.append((val, c.keys(), len(c), "a" in c))
        return out, evicted

    assert script(LRUCache) == script(jtenants.LRUCache)
    with pytest.raises(ValueError, match="capacity"):
        LRUCache(0)


# -- load generator -----------------------------------------------------------------

@pytest.mark.parametrize("max_queue,max_batch", [(256, 8), (5, 8)])
def test_run_load_counts_equal_reference(max_queue, max_batch):
    corpus, queries = _corpus(128), _corpus(8, seed=1)
    spec = dict(n_requests=70, k=5, tenants=3)
    cfg = dict(max_queue=max_queue, max_batch=max_batch, k_max=8)
    t = run_load(MicrobatchScheduler(
        lambda s, ss=tsc.SearchSession(corpus, tsc.SearchConfig(), **CPU):
        ss, SchedulerConfig(**cfg), registry=Registry()), queries,
        LoadSpec(**spec))
    j = jrun_load(jsched.MicrobatchScheduler(
        lambda s, ss=jsc.SearchSession(corpus, jsc.SearchConfig()): ss,
        jsched.SchedulerConfig(**cfg), registry=JRegistry()), queries,
        JLoadSpec(**spec))
    for key in ("completed", "rejected", "ticks", "mean_batch"):
        assert getattr(t, key) == getattr(j, key), key
    assert t.completed + t.rejected == 70
    assert t.p50_s <= t.p99_s and t.throughput_rps > 0
    assert set(t.to_row()) == set(j.to_row())


# -- frontend and server --------------------------------------------------------------

def test_frontend_ctx_cache_is_bounded_and_counts_evictions():
    evict0 = REGISTRY.counter("serve.ctx.evict").value
    fe = RetrievalFrontend(_corpus(64), lambda q: torch.as_tensor(q),
                           ctx_cache_size=2, **CPU)
    ref = JFront(_corpus(64), lambda q: np.asarray(q), ctx_cache_size=2)
    queries = _corpus(5, seed=1)
    first = fe.retrieve(queries, k=4)
    assert len(fe._ctx_cache) <= 2
    assert REGISTRY.counter("serve.ctx.evict").value - evict0 == 3
    assert np.array_equal(first, ref.retrieve(queries, k=4))
    # re-retrieval of evicted queries recomputes identical contexts, and
    # a cached query short-circuits to the same answer
    assert np.array_equal(first, fe.retrieve(queries, k=4))
    assert np.array_equal(first[-1:], fe.retrieve(queries[-1:], k=4))


def test_frontend_append_invalidates_ctx_cache():
    kw = dict(ctx_cache_size=8)
    fe = RetrievalFrontend(_corpus(32, seed=0), np.asarray,
                           ingest=IngestConfig(compact_threshold=NO_COMPACT),
                           **kw, **CPU)
    ref = JFront(_corpus(32, seed=0), np.asarray,
                 ingest=JIngest(compact_threshold=NO_COMPACT), **kw)
    target = _corpus(1, seed=7) * 10.0        # dominant-score doc
    before = fe.retrieve(target, k=3)
    assert fe.append(target) == ref.append(target) == (32, 33)
    after = fe.retrieve(target, k=3)
    assert after[0, 0] == 32 and not np.array_equal(before, after)
    assert np.array_equal(after, ref.retrieve(target, k=3))
    with pytest.raises(ValueError, match="ingest"):
        RetrievalFrontend(_corpus(8), np.asarray, **CPU).append(target)


def test_search_server_end_to_end_with_ingest_equals_reference():
    def run(server):
        reqs = [server.submit(_corpus(1, seed=i)[0], k=4,
                              tenant=f"t{i % 3}") for i in range(6)]
        assert server.drain() == 6
        span = server.append("t0", _corpus(16, seed=9))
        reqs.append(server.submit(_corpus(1, seed=42)[0], k=4, tenant="t0"))
        server.drain()
        return span, [r.result(timeout=0) for r in reqs]

    kw = dict(max_tenants=2)
    t = run(SearchServer(lambda t: _corpus(64, seed=len(t)),
                         scheduler=SchedulerConfig(max_batch=4, k_max=8),
                         ingest=IngestConfig(append_cap=8,
                                             compact_threshold=NO_COMPACT),
                         **kw, **CPU))
    j = run(JServer(lambda t: _corpus(64, seed=len(t)),
                    scheduler=jsched.SchedulerConfig(max_batch=4, k_max=8),
                    ingest=JIngest(append_cap=8,
                                   compact_threshold=NO_COMPACT), **kw))
    assert t[0] == j[0] == (64, 80)
    for (ts, ti), (js, ji) in zip(t[1], j[1]):
        _assert_topk_close(ts[None], ti[None], js[None], ji[None])


def test_serve_classes_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        LiveIndex(_corpus(8))
    with pytest.raises(RuntimeError, match="cuda"):
        SearchServer(lambda t: _corpus(8))
    with pytest.raises(RuntimeError, match="cuda"):
        tcli.main(["--single"])


# -- the CLI ------------------------------------------------------------------------

def _cli_lines(capsys, main, argv):
    assert main(argv) == 0
    return [line for line in capsys.readouterr().out.splitlines()
            if line.startswith("top-")]


def test_cli_single_ids_equal_reference(capsys, tmp_path):
    argv = ["--single", "--k", "5", "--docs", "512", "--dim", "16"]
    out = tmp_path / "single.json"
    t = _cli_lines(capsys, tcli.main,
                   argv + ["--device", "cpu", "--out", str(out)])
    j = _cli_lines(capsys, jcli.main, argv)
    assert t[0] == j[0] and t[0].startswith("top-5 ids:")
    t_scores = json.loads(t[1].split(":", 1)[1])
    j_scores = json.loads(j[1].split(":", 1)[1])
    np.testing.assert_allclose(t_scores, j_scores, rtol=RTOL, atol=1e-4)
    row = json.loads(out.read_text())
    assert str(row["ids"]) == t[0].split(":", 1)[1].strip()


@pytest.mark.parametrize("extra", [
    [], ["--tenants", "3", "--max-tenants", "2", "--append-every", "40",
         "--append-rows", "16", "--append-cap", "8",
         "--compact-threshold", "40"]])
def test_cli_out_row_equals_reference(tmp_path, extra):
    argv = ["--requests", "150", "--docs", "256", "--dim", "16",
            "--max-batch", "8"] + extra
    t_out, j_out = tmp_path / "t.json", tmp_path / "j.json"
    assert tcli.main(argv + ["--device", "cpu", "--out", str(t_out)]) == 0
    assert jcli.main(argv + ["--out", str(j_out)]) == 0
    t, j = json.loads(t_out.read_text()), json.loads(j_out.read_text())
    assert set(t) == set(j)
    for key in ("completed", "rejected", "ticks", "mean_batch"):
        assert t[key] == j[key], key


@pytest.mark.parametrize("extra", [[], ["--append-every", "16",
                                        "--compact-threshold", "32"]])
def test_cli_recompile_check_passes(tmp_path, extra):
    out = tmp_path / "row.json"
    assert tcli.main(["--device", "cpu", "--requests", "64", "--docs",
                      "256", "--dim", "16", "--recompile-check", "8",
                      "--out", str(out)] + extra) == 0
    row = json.loads(out.read_text())
    assert row["steady_ticks"] == 8
    assert row["steady_recompiles"] == row["steady_new_shapes"] == 0
    assert row["warmup_shapes"] == {}     # no kernel launches on the CPU


def test_cli_fails_fast_on_unknown_names_and_kernel_backend_on_cpu():
    with pytest.raises(ValueError, match="unknown retrieval engine 'nope'"):
        tcli.main(["--device", "cpu", "--engine", "nope"])
    with pytest.raises(ValueError, match="unknown scoring backend 'jnp'"):
        tcli.main(["--device", "cpu", "--backend", "jnp"])
    with pytest.raises(ValueError, match="needs device='cuda'"):
        tcli.main(["--device", "cpu", "--backend", "cuda"])


def test_cli_tenant_corpus_is_the_references():
    for tenant in ("tenant-0", "tenant-3", "default"):
        assert np.array_equal(
            tcli._tenant_corpus(tenant, docs=9, dim=4, seed=2),
            jcli._tenant_corpus(tenant, docs=9, dim=4, seed=2))


# -- sharded ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh():
    return make_host_mesh(device="cpu")


@pytest.mark.parametrize("engine", sorted(ENGINE_OPTS))
def test_streamed_live_index_bit_equal_single_device(mesh, engine):
    """A 1-rank gloo LiveIndex (streamed, with its own compaction group)
    equals the single-device one bit for bit, before and after a
    background compaction."""
    make = _sparse if engine == "tfidf" else _corpus
    base, extra, q = make(96, seed=6), make(33, seed=7), make(5, seed=8)
    ingest = IngestConfig(append_cap=16, compact_threshold=NO_COMPACT)
    opts = ENGINE_OPTS[engine]
    single = LiveIndex(base, tsc.SearchConfig(engine=engine,
                                              engine_opts=opts),
                       ingest=ingest, **CPU)
    born = LiveIndex(base, tsc.SearchConfig(engine=engine, engine_opts=opts,
                                            streamed=True, mesh=mesh),
                     ingest=ingest, **CPU)
    assert born._groups is not None
    for li in (single, born):
        li.append(extra[:20])
        li.append(extra[20:])
    for a, b in zip(single.search_scored(q, k=10),
                    born.search_scored(q, k=10)):
        assert np.array_equal(a, b)
    for li in (single, born):
        assert li.compact(background=True, wait=True)
        assert li.pending_rows == 0 and li.frozen_n == 129
    for a, b in zip(single.search_scored(q, k=10),
                    born.search_scored(q, k=10)):
        assert np.array_equal(a, b)


def test_streamed_live_index_matches_reference_one_device(mesh):
    base, extra, q = _corpus(96, seed=6), _corpus(33, seed=7), _corpus(5, 8)
    ingest = dict(append_cap=16, compact_threshold=NO_COMPACT)
    t = LiveIndex(base, tsc.SearchConfig(streamed=True, mesh=mesh),
                  ingest=IngestConfig(**ingest), **CPU)
    j = JLive(base, jsc.SearchConfig(streamed=True,
                                     mesh=jax.make_mesh((1,), ("data",))),
              ingest=JIngest(**ingest))
    t.append(extra)
    j.append(extra)
    _assert_topk_close(*t.search_scored(q, k=10), *j.search_scored(q, k=10))


@pytest.mark.parametrize("in_flight", [False, True])
def test_closed_streamed_index_gives_its_groups_back(mesh, monkeypatch,
                                                     in_flight):
    """A 1-rank streamed index lands its compaction from the worker (the
    new append buffer is the rank's block, made with no collective); close()
    joins a worker still in flight, lets it land, and gives the index's
    groups to the mesh's free list, from which the next index takes
    them."""
    reg = Registry()
    cfg = tsc.SearchConfig(streamed=True, mesh=mesh)
    li = LiveIndex(_corpus(64, seed=30), cfg, registry=reg,
                   ingest=IngestConfig(append_cap=16, compact_threshold=8),
                   **CPU)
    groups = li._groups
    assert groups is not None
    started, release, _ = _blocking_session(monkeypatch)
    li.append(_corpus(9, seed=31))
    assert started.wait(timeout=30)
    if in_flight:
        threading.Timer(0.2, release.set).start()
        li.close()                          # joins the worker
    else:
        release.set()
        _join_worker(li)
        assert li.frozen_n == 73 and li.pending_rows == 0
        li.close()
    assert li._groups is None and li.config.mesh is mesh
    assert li.frozen_n == 73 and li.pending_rows == 0
    assert reg.counter("serve.ingest.compactions").value == 1
    free = mesh.__dict__["_compactor_groups"]
    assert any(g is groups for sets in free.values() for g in sets)
    monkeypatch.undo()
    nxt = LiveIndex(_corpus(64, seed=32), cfg, **CPU)
    assert nxt._groups is groups
    nxt.close()


def test_streamed_tenant_churn_reuses_compaction_groups(mesh):
    """Evicting a streamed tenant closes its LiveIndex, whose compaction
    groups go to the next index built on the mesh: the count of process
    groups stays bounded however often tenants are evicted and rebuilt,
    and every background compaction still lands, its session searching on
    the mesh itself."""
    def n_groups():
        return len(torch.distributed.distributed_c10d._world.pg_map)

    reg = Registry()
    cfg = tsc.SearchConfig(streamed=True, mesh=mesh)
    ingest = IngestConfig(append_cap=16, compact_threshold=8)
    corpora = {t: _corpus(64, seed=20 + i) for i, t in enumerate("abc")}
    cache = TenantCache(lambda t: LiveIndex(corpora[t], cfg, ingest=ingest,
                                            registry=reg, **CPU),
                        capacity=1, registry=reg)
    counts, built = [], []
    for step, tenant in enumerate("abcabcabc"):
        live = cache.get(tenant)
        built.append(live)
        live.append(_corpus(9, seed=40 + step))    # a background compaction
        counts.append(n_groups())
    cache.flush()
    assert len(set(counts[1:])) == 1, counts
    assert reg.counter("serve.tenant.evict").value == 8
    assert reg.counter("serve.ingest.compactions").value == 9
    for live in built:
        assert live.frozen_n == 73 and live.pending_rows == 0
        assert live.config.mesh is mesh
    assert all(live._groups is None for live in built[:-1])
    # a closed index still searches and appends, but compacts no more
    closed = built[0]
    closed.append(_corpus(9, seed=60))
    assert not closed.compact(background=True, wait=True)
    assert closed.pending_rows == 9
    ids = closed.search(_corpus(3, seed=61), k=82)
    assert {int(i) for i in ids[0]} == set(range(82))
