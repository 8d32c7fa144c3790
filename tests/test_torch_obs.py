"""The port's observability layer on the CPU, mirroring the reference's
``tests/test_obs.py`` and ``tests/test_runtime_contracts.py``: the timers
and provenance, the trace reader (held equal to the reference's on the
same spans), the tuning counters, the recompile sentinel driven by a
simulated nvcc build, the memory gauge, and the debug locks."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.launch import trace as ref_trace_cli
from repro_torch.kernels import build, tuning
from repro_torch.launch import trace as trace_cli
from repro_torch.obs import (REGISTRY, locks, memory, provenance, recompile,
                             timeit, trace)
from repro_torch.obs.metrics import Registry
from repro_torch.obs.timing import cuda_ms

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


# --------------------------------------------------------------------------
# timing helpers
# --------------------------------------------------------------------------

def test_timeit_and_provenance():
    us = timeit(lambda: torch.arange(16.0) * 2, n=2)
    assert us > 0.0
    meta = provenance()
    assert set(meta) == {"platform", "python", "torch", "cuda", "backend",
                         "device_kind", "device_count", "git_sha"}
    assert meta["torch"] == torch.__version__
    assert meta["backend"] == ("cuda" if torch.cuda.is_available()
                               else "cpu")
    assert meta["device_kind"] and meta["device_count"] >= 1


def test_device_timers_raise_without_a_card(no_card):
    with pytest.raises(RuntimeError, match="is_available"):
        cuda_ms(lambda: None, 2)
    assert provenance()["backend"] == "cpu"


# --------------------------------------------------------------------------
# launch/trace.py: aggregation + CLI
# --------------------------------------------------------------------------

def test_trace_cli_aggregate_compile_share():
    spans = (
        [{"name": "s", "id": i, "parent": None, "t0": 0.0, "dur_s": 1.0,
          "first": i == 1} for i in range(1, 5)]      # 1 first + 3 steady
        + [{"name": "plain", "id": 9, "parent": None, "t0": 0.0,
            "dur_s": 0.5}])
    aggs = trace_cli.aggregate(spans)
    s = aggs["s"]
    assert s["count"] == 4 and s["total_s"] == pytest.approx(4.0)
    assert s["compile_s"] == pytest.approx(0.0)
    assert aggs["plain"]["first_count"] == 0
    assert aggs["plain"]["compile_share"] == 0.0
    aggs2 = trace_cli.aggregate(
        [{"name": "s", "dur_s": 5.0, "first": True},
         {"name": "s", "dur_s": 1.0, "first": False}])
    assert aggs2["s"]["compile_s"] == pytest.approx(4.0)
    assert aggs2["s"]["compile_share"] == pytest.approx(4.0 / 6.0)


def test_trace_cli_percentile_exact():
    vals = sorted([1.0, 2.0, 3.0, 4.0])
    assert trace_cli._percentile(vals, 50) == pytest.approx(2.5)
    assert trace_cli._percentile(vals, 100) == pytest.approx(4.0)
    assert trace_cli._percentile([7.0], 99) == 7.0
    assert trace_cli._percentile([], 50) == 0.0


def _device_trace(path):
    """A port trace: nested spans, two device spans of one compile key
    (first, then steady) and one that failed."""
    trace.enable(str(path))
    try:
        with trace.span("alpha", x=1):
            for n in (4, 5):
                with trace.device_span("beta", compile_key="beta/k") as sp:
                    sp.declare(torch.arange(n))
        with pytest.raises(ValueError):
            with trace.device_span("gamma"):
                raise ValueError("boom")
    finally:
        trace.disable()


def test_trace_reader_reads_device_spans_as_the_reference_does(tmp_path):
    """The port's reader and the reference's give the same table on the
    same port trace: the compile share comes from ``device_span``'s
    ``first`` flag."""
    sink = tmp_path / "t.jsonl"
    _device_trace(sink)
    spans = trace_cli.load_spans(str(sink))
    assert [r["name"] for r in spans] == ["beta", "beta", "alpha", "gamma"]
    assert [r.get("first") for r in spans] == [True, False, None, True]
    aggs = trace_cli.aggregate(spans)
    assert aggs == ref_trace_cli.aggregate(spans)
    assert aggs["beta"]["first_count"] == 1 and aggs["gamma"]["errors"] == 1
    assert trace_cli.aggregate(spans, prefix="b").keys() == {"beta"}
    for sort in ("name", "total"):
        assert trace_cli.format_table(aggs, sort=sort) == \
            ref_trace_cli.format_table(aggs, sort=sort)


def test_trace_cli_main_json(tmp_path, capsys):
    sink = tmp_path / "t.jsonl"
    _device_trace(sink)
    out_json = tmp_path / "agg.json"
    assert trace_cli.main([str(sink), "--json", str(out_json)]) == 0
    payload = json.loads(out_json.read_text())
    assert payload["spans"] == 4
    assert set(payload["stages"]) == {"alpha", "beta", "gamma"}
    table = capsys.readouterr().out
    assert "alpha" in table and "beta" in table
    assert trace_cli.main([str(sink), "--json", "-"]) == 0
    assert json.loads(capsys.readouterr().out)["spans"] == 4


def test_trace_cli_runs_as_a_module(tmp_path):
    sink = tmp_path / "t.jsonl"
    _device_trace(sink)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.trace",
                          str(sink), "--sort", "name"], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[0] == f"4 spans in {sink}"
    assert out.stdout.splitlines()[2].startswith("alpha")


def test_trace_cli_rejects_bad_jsonl(tmp_path):
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"name": "ok"}\nnot json\n')
    with pytest.raises(ValueError, match="bad.jsonl:2"):
        trace_cli.load_spans(str(bad))
    assert trace_cli.main([str(tmp_path / "missing.jsonl")]) == 2


# --------------------------------------------------------------------------
# tuning counters
# --------------------------------------------------------------------------

def test_tuning_resolve_counters():
    hit0 = REGISTRY.counter("tuning.resolve.hit").value
    miss0 = REGISTRY.counter("tuning.resolve.miss").value
    tuning.resolve("topk", n=1024, dtype="float32")
    hit1 = REGISTRY.counter("tuning.resolve.hit").value
    miss1 = REGISTRY.counter("tuning.resolve.miss").value
    assert (hit1 + miss1) - (hit0 + miss0) == 1   # exactly one resolution


def test_kernel_wrappers_resolve_once_a_call():
    """Each ops wrapper resolves its launch params once a call, on any
    device, as the reference's wrappers do."""
    from repro_torch.kernels.label_prop.ops import label_prop_round
    from repro_torch.kernels.lsh_hamming.ops import hamming_topk
    from repro_torch.kernels.topk_scoring.ops import (gathered_topk,
                                                      topk_scores,
                                                      topk_scores_int8)

    def resolutions():
        return (REGISTRY.counter("tuning.resolve.hit").value
                + REGISTRY.counter("tuning.resolve.miss").value)

    q = torch.eye(3)
    codes = torch.ones((3, 2), dtype=torch.int32)
    rows = torch.zeros((3, 2), dtype=torch.int32)
    calls = [lambda: topk_scores(q, q, k=2),
             lambda: topk_scores_int8(q.to(torch.int8), q.to(torch.int8),
                                      k=2),
             lambda: hamming_topk(codes, codes, k=2),
             lambda: gathered_topk(q, q, rows, rows, k=1),
             lambda: label_prop_round(torch.arange(3, dtype=torch.int32),
                                      rows, torch.ones((3, 2)))]
    for call in calls:
        before = resolutions()
        call()
        assert resolutions() == before + 1


# --------------------------------------------------------------------------
# recompile sentinel: nvcc builds counted per region
# --------------------------------------------------------------------------

@pytest.fixture
def sentinel():
    """Build counting on, zeroed, and off again afterwards."""
    recompile.enable()
    recompile.reset()
    yield recompile
    recompile.disable()
    recompile.reset()


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """``build._build`` with nvcc replaced by a stand-in that writes the
    library file, into a scratch build directory; returns the nvcc runs."""
    runs = []

    def run(cmd, stdout=None, stderr=None):
        out = cmd[cmd.index("-o") + 1]
        open(out, "wb").close()
        runs.append(cmd[-1])
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "run", run)
    return runs


def test_sentinel_counts_a_build_not_a_cached_library(sentinel, fake_nvcc):
    with sentinel.region("contract.cold"):
        build._build("lp_round.cu")
    assert len(fake_nvcc) == 1
    assert sentinel.total("contract.cold") == 1
    with sentinel.region("contract.warm"):
        build._build("lp_round.cu")       # the library exists: no nvcc
    assert len(fake_nvcc) == 1
    assert sentinel.total("contract.warm") == 0
    with sentinel.region("contract.warm"):
        build._build("hamming_topk.cu")   # another source: a build
    assert sentinel.total("contract.warm") == 1
    assert sentinel.counts() == {"contract.cold": 1, "contract.warm": 1}
    assert REGISTRY.counter("recompile.contract.warm").value >= 1


def test_sentinel_mark_since_waterline(sentinel, fake_nvcc):
    build._build("lp_round.cu")
    assert sentinel.counts() == {recompile.UNATTRIBUTED: 1}
    sentinel.mark()
    assert sentinel.since() == 0
    build._build("lp_round.cu")           # cached: waterline holds
    assert sentinel.since() == 0
    build._build("flash_attention.cu")    # a new build crosses it
    assert sentinel.since() == 1
    assert sentinel.since(recompile.UNATTRIBUTED) == 1


def test_sentinel_region_nesting_innermost_wins(sentinel):
    with sentinel.region("outer"):
        with sentinel.region("inner"):
            recompile.report(recompile.COMPILE_EVENT)
        recompile.report(recompile.COMPILE_EVENT)
    assert sentinel.total("inner") == 1
    assert sentinel.total("outer") == 1
    recompile.report("/some/other/event")     # not a build: ignored
    assert sentinel.total() == 2


def test_sentinel_disabled_counts_nothing(fake_nvcc):
    recompile.disable()
    recompile.reset()
    build._build("lp_round.cu")
    assert len(fake_nvcc) == 1
    assert recompile.total() == 0


# --------------------------------------------------------------------------
# memory gauge
# --------------------------------------------------------------------------

def test_memory_gauge_without_a_card(no_card):
    reg = Registry()
    assert memory.bytes_per_device() == {}
    assert memory.record_build_peak(reg) == 0
    assert reg.gauge(memory.PEAK_GAUGE).value == 0.0


def test_memory_gauge_publishes_the_largest_card(monkeypatch):
    peaks = {0: 1000, 1: 5000}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda i: peaks[i])
    assert memory.bytes_per_device() == {"cuda:0": 1000, "cuda:1": 5000}
    reg = Registry()
    assert memory.record_build_peak(reg) == 5000
    assert reg.gauge("build.peak_bytes_per_device").value == 5000.0


def test_search_session_records_the_build_peak_and_tuned_blocks(tmp_path):
    """A SearchSession publishes the build gauge after its build, and each
    chunk span carries the launch params its kernel wrapper resolved: the
    int8 backend's top-k (its plain version on the CPU)."""
    from repro_torch.retrieval.search_core import SearchConfig, SearchSession
    REGISTRY.gauge(memory.PEAK_GAUGE).set(-1.0)
    vecs = np.random.default_rng(0).standard_normal((300, 8)) \
        .astype(np.float32)
    table = tuning.TunedTable()
    table.add(tuning.TunedConfig("topk", "le1024", "int8",
                                 (("split_blocks", 264),)))
    sink = tmp_path / "t.jsonl"
    trace.enable(str(sink))
    try:
        tuning.set_table(table)
        sess = SearchSession(vecs, SearchConfig(backend="int8",
                                                query_chunk=4),
                             device="cpu")
        sess.search(vecs[:6], k=3)
    finally:
        trace.disable()
        tuning.reset_table()
    assert REGISTRY.gauge(memory.PEAK_GAUGE).value >= 0.0
    chunks = [r for r in trace_cli.load_spans(str(sink))
              if r["name"] == "search.chunk"]
    assert len(chunks) == 2
    for rec in chunks:
        blocks = rec["attrs"]["tuned_blocks"]
        assert blocks == [{"kernel": "topk", "tuned": True, "params": {
            "block_q": 128, "block_n": 128, "split_blocks": 264}}]


# --------------------------------------------------------------------------
# instrumented debug locks
# --------------------------------------------------------------------------

@pytest.fixture
def debug_locks():
    """DebugLock wrappers from make_lock()/make_rlock(), reset + off after."""
    locks.enable()
    locks.reset()
    yield locks
    locks.disable()
    locks.reset()


def test_make_lock_plain_when_disabled():
    locks.disable()
    try:
        lk = locks.make_lock("plain")
        assert not isinstance(lk, locks.DebugLock)
        with lk:
            pass
    finally:
        locks.reset()


def test_debug_lock_counts_and_edges(debug_locks):
    a = debug_locks.make_lock("A")
    b = debug_locks.make_lock("B")
    with a:
        with b:
            pass
    with a:
        pass
    assert debug_locks.acquire_counts() == {"A": 2, "B": 1}
    assert ("A", "B") in debug_locks.edges()
    assert debug_locks.inversions() == []


def test_debug_lock_detects_inversion(debug_locks):
    a = debug_locks.make_lock("A")
    b = debug_locks.make_lock("B")
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    assert debug_locks.inversions() == [("A", "B")]


def test_debug_rlock_reentrant_no_self_edge(debug_locks):
    r = debug_locks.make_rlock("R")
    with r:
        with r:
            pass
    assert debug_locks.acquire_counts()["R"] == 2
    assert all(e != ("R", "R") for e in debug_locks.edges())


def test_debug_lock_timeout_and_threads(debug_locks):
    """acquire(timeout=...) behaves as the plain lock's; each thread keeps
    its own held stack, so no edge crosses threads."""
    import threading
    a = debug_locks.make_lock("A")
    b = debug_locks.make_lock("B")
    assert a.acquire(timeout=1.0)
    got = []
    t = threading.Thread(target=lambda: got.append(a.acquire(timeout=0.05)))
    t.start()
    t.join(timeout=10)
    assert not t.is_alive() and got == [False]
    t = threading.Thread(target=lambda: b.acquire() and b.release())
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    a.release()
    assert debug_locks.edges() == set()


@pytest.mark.parametrize("value,debug", [("1", True), ("0", False),
                                         ("", False)])
def test_debug_locks_env_hatch(value, debug):
    """REPRO_DEBUG_LOCKS decides at import what make_lock hands out."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               REPRO_DEBUG_LOCKS=value)
    code = ("from repro_torch.obs import locks; "
            "print(isinstance(locks.make_lock('x'), locks.DebugLock))")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(debug)
