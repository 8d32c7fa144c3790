"""The port's kernel autotuner (``repro_torch/kernels/tuning.py``) on the
CPU, mirroring the reference's ``tests/test_tuning.py``: size buckets,
the explicit > tuned > default resolution order, compiled tiles held to
their one value, the env escape hatch and the port's own table path,
table persistence, the ask/tell hillclimb (and the tuner end to end with
``measure`` replaced, over the traffic the kernels' launch counters
recorded), every split-target candidate's plan covering the
corpus's tiles exactly with the same results, and the engine default of
``WindTunnelConfig`` on the CPU and under a simulated card."""
import collections
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kernels import tuning as ref_tuning
from repro_torch.core import (SamplerSession, SamplerSpec, WindTunnelConfig,
                              run_windtunnel)
from repro_torch.core import sampling_core
from repro_torch.data.synthetic import generate_corpus
from repro_torch.device import default_engine
from repro_torch.kernels import tuning
from repro_torch.kernels.lsh_hamming import ops as ham_ops
from repro_torch.kernels.lsh_hamming.ref import hamming_topk_ref
from repro_torch.kernels.topk_scoring import ops as topk_ops
from repro_torch.kernels.topk_scoring.ref import (topk_scores_int8_ref,
                                                  topk_scores_ref)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _restore_table():
    """Every test leaves the process-wide active table as it found it."""
    yield
    tuning.reset_table()


def test_size_bucket_boundaries_are_the_references():
    for n in (1, 1024, 1025, 4096, 65536, 65537, 524288):
        assert tuning.size_bucket(n) == ref_tuning.size_bucket(n)
    for bucket in ("le1024", "le4096", "le16384", "le65536", "gt65536"):
        assert tuning.bucket_rep_size(bucket) == \
            ref_tuning.bucket_rep_size(bucket)
    assert tuning.size_bucket(65537) == "gt65536"
    assert tuning.bucket_rep_size("gt65536") == 2 * 65536


def test_dtype_str():
    assert tuning.dtype_str("int8") == "int8"
    assert tuning.dtype_str(torch.float32) == "float32"
    assert tuning.dtype_str(torch.int8) == "int8"
    assert tuning.dtype_str(np.dtype("int32")) == "int32"
    assert tuning.dtype_str(np.float32) == "float32"


def test_defaults_are_todays_launches():
    """With no table every launch is today's: the defaults are the ops
    modules' tiles and split targets, and the LP kernel's block shape is
    its source's."""
    d = tuning.DEFAULTS
    assert d["topk"] == {"block_q": topk_ops.DENSE_QUERIES,
                         "block_n": topk_ops.DENSE_ROWS,
                         "split_blocks": topk_ops.DENSE_BLOCKS}
    assert d["hamming_topk"] == {"block_q": ham_ops.HAMMING_QUERIES,
                                 "block_n": ham_ops.HAMMING_ROWS,
                                 "split_blocks": ham_ops.HAMMING_BLOCKS}
    assert d["gathered_topk"] == {"tile_rows": topk_ops.TILE_ROWS,
                                  "tile_pieces": topk_ops.TILE_PIECES}
    src = (ROOT / "src" / "repro_torch" / "csrc" / "lp_round.cu").read_text()
    consts = {k: int(v) for k, v in
              re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert d["label_prop_round"] == {
        "warps_per_block": consts["kWarpsPerBlock"],
        "nodes_per_warp": consts["kNodes"]}
    for kernel, space in tuning.SPACES.items():
        assert space.default_point() == d[kernel]
        assert set(space.axes) == set(d[kernel])
        for name, values in space.axes.items():
            if name != tuning.RUNTIME_PARAM:
                assert values == (d[kernel][name],), (kernel, name)
    tuning.set_table(None)
    for kernel in tuning.SPACES:
        assert tuning.resolve(kernel, n=524288, dtype="float32") == \
            d[kernel]


def test_resolve_order_explicit_over_table_over_default():
    table = tuning.TunedTable()
    table.add(tuning.TunedConfig("topk", "le1024", "float32",
                                 (("split_blocks", 264),)))
    tuning.set_table(table)
    want = dict(tuning.DEFAULTS["topk"], split_blocks=264)
    # tuned entry beats the hard-coded default
    assert tuning.resolve("topk", n=500, dtype=torch.float32) == want
    # explicit kwarg beats the tuned entry; None means unspecified
    assert tuning.resolve("topk", n=500, dtype="float32", split_blocks=66,
                          block_q=None) == dict(want, split_blocks=66)
    # other buckets / dtypes fall through to the defaults
    assert tuning.resolve("topk", n=5000, dtype="float32") == \
        tuning.DEFAULTS["topk"]
    assert tuning.resolve("topk", n=500, dtype="int8") == \
        tuning.DEFAULTS["topk"]


def test_resolve_rejects_unknown_and_out_of_space_params():
    with pytest.raises(ValueError, match="no block param"):
        tuning.resolve("topk", n=100, dtype="float32", block_z=64)
    with pytest.raises(ValueError, match="no block param"):
        tuning.resolve("gathered_topk", n=100, dtype="float32",
                       split_blocks=132)
    # a compiled tile other than the kernel's own, explicit or tuned
    with pytest.raises(ValueError, match="not the compiled 128"):
        tuning.resolve("topk", n=100, dtype="float32", block_n=1024)
    with pytest.raises(ValueError, match="not the compiled 32"):
        tuning.resolve("gathered_topk", n=100, dtype="float32",
                       tile_pieces=8)
    with pytest.raises(ValueError, match=">= 1"):
        tuning.resolve("hamming_topk", n=100, dtype="int32",
                       split_blocks=0)
    table = tuning.TunedTable()
    table.add(tuning.TunedConfig("hamming_topk", "le1024", "int32",
                                 (("block_q", 128), ("split_blocks", 264))))
    tuning.set_table(table)
    with pytest.raises(ValueError, match="not the compiled 32"):
        tuning.resolve("hamming_topk", n=100, dtype="int32")
    # and the wrappers apply the same checks before any work
    with pytest.raises(ValueError, match="not the compiled 32"):
        ham_ops.hamming_topk(torch.ones((2, 1), dtype=torch.int32),
                             torch.ones((5, 1), dtype=torch.int32), k=1)


def test_set_table_none_forces_defaults():
    table = tuning.TunedTable()
    table.add(tuning.TunedConfig("topk", "le1024", "float32",
                                 (("split_blocks", 528),)))
    tuning.set_table(table)
    assert tuning.resolve("topk", n=100,
                          dtype="float32")["split_blocks"] == 528
    tuning.set_table(None)        # the --no-tuned-kernels hatch
    assert tuning.resolve("topk", n=100, dtype="float32") == \
        tuning.DEFAULTS["topk"]


def test_evaluate_no_tuned_kernels_flag(monkeypatch):
    from repro_torch.launch import evaluate
    table = tuning.TunedTable()
    table.add(tuning.TunedConfig("topk", "le1024", "float32",
                                 (("split_blocks", 528),)))
    tuning.set_table(table)
    seen = []

    class Stop(Exception):
        pass

    def run_grid(*args, **kwargs):     # the table the grid would run with
        seen.append(tuning.get_table().entries)
        raise Stop

    monkeypatch.setattr(evaluate, "run_grid", run_grid)
    with pytest.raises(Stop):
        evaluate.main(["--grid", "smoke", "--queries", "16", "--device",
                       "cpu", "--no-tuned-kernels", "--quiet"])
    assert seen == [{}]


def test_env_escape_hatch_and_path(tmp_path):
    """REPRO_TORCH_TUNED_KERNELS=off forces defaults; =<path> loads that
    table; nothing else does: neither the reference's REPRO_TUNED_KERNELS
    and results path nor the port's own results path in the working
    directory feeds a launch. Subprocess because the active table
    resolves once per process."""
    assert tuning.ENV_VAR == "REPRO_TORCH_TUNED_KERNELS" != ref_tuning.ENV_VAR
    assert tuning.RESULTS_TABLE_PATH == os.path.join(
        "results", "tuned_kernels_torch.json")
    assert tuning.RESULTS_TABLE_PATH != ref_tuning.RESULTS_TABLE_PATH
    assert not list((ROOT / "src" / "repro_torch" / "kernels").glob(
        "*.json"))                                        # none ships
    table = tuning.TunedTable(meta={"origin": "test"})
    table.add(tuning.TunedConfig("topk", "le1024", "float32",
                                 (("split_blocks", 264),)))
    path = tmp_path / "t.json"
    table.save(str(path))
    ref_table = tmp_path / "results" / "tuned_kernels.json"
    ref_table.parent.mkdir()
    ref_table.write_text(json.dumps({"meta": {}, "entries": [{
        "kernel": "topk", "bucket": "le1024", "dtype": "float32",
        "params": {"block_q": 8, "block_n": 2048}}]}))
    script = ("from repro_torch.kernels import tuning; "
              "print(tuning.resolve('topk', n=100, dtype='float32'))")

    def run(**env_vars):
        env = {k: v for k, v in os.environ.items()
               if k not in (tuning.ENV_VAR, ref_tuning.ENV_VAR)}
        env.update(PYTHONPATH=str(ROOT / "src"), **env_vars)
        out = subprocess.run([sys.executable, "-c", script], env=env,
                             cwd=tmp_path, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode == 0, out.stdout + out.stderr
        return out.stdout.strip()

    default = str(tuning.DEFAULTS["topk"])
    assert run(REPRO_TORCH_TUNED_KERNELS="off") == default
    assert "264" in run(REPRO_TORCH_TUNED_KERNELS=str(path))
    assert run(REPRO_TUNED_KERNELS=str(path)) == default
    assert run() == default
    (tmp_path / tuning.RESULTS_TABLE_PATH).write_text(path.read_text())
    assert run() == default               # autotune's output is not read
    assert "264" in run(REPRO_TORCH_TUNED_KERNELS=tuning.RESULTS_TABLE_PATH)


def test_table_save_load_roundtrip(tmp_path):
    table = tuning.TunedTable(meta={"device_kind": "NVIDIA H100 80GB HBM3",
                                    "power_limit": "700.00 W"})
    table.add(tuning.TunedConfig("hamming_topk", "gt65536", "int32",
                                 (("block_n", 128), ("block_q", 32),
                                  ("split_blocks", 1056)),
                                 score_ms=0.25, evals=4))
    path = str(tmp_path / "round.json")
    table.save(path)
    loaded = tuning.TunedTable.load(path)
    assert loaded.meta == table.meta
    assert loaded.entries == table.entries
    raw = json.load(open(path))
    assert raw["entries"][0]["params"] == {"block_n": 128, "block_q": 32,
                                           "split_blocks": 1056}


@pytest.mark.parametrize("kernel,target", [("topk", 528), ("topk", 66),
                                           ("hamming_topk", 1056)])
def test_hillclimb_converges_on_synthetic_score(kernel, target):
    """Ask/tell finds the optimum of a convex score along the split axis
    from the default start."""
    space = tuning.SPACES[kernel]
    tuner = tuning.HillclimbTuner(space)
    asked = []
    while True:
        point = tuner.ask()
        if point is None:
            break
        asked.append(point["split_blocks"])
        tuner.tell(point, abs(np.log2(point["split_blocks"] / target)))
    assert tuner.best == dict(tuning.DEFAULTS[kernel], split_blocks=target)
    assert asked[0] == tuning.DEFAULTS[kernel]["split_blocks"]
    assert tuner.num_evals <= sum(1 for _ in space.candidates())


#: launch counts by integer arguments, as ``build.Kernel.shapes`` keeps
#: them (Q, N, D or W, k, then the split plan and the alignment flag)
SHAPES = {
    "topk_partial": {(256, 524700, 2048, 3, 63, 66, 1): 4,
                     (256, 524700, 2048, 10, 63, 66, 1): 4,
                     (256, 39780, 2048, 3, 5, 63, 1): 4},
    "topk_int8_partial": {(128, 524700, 2048, 40, 32, 129, 1): 4},
    "hamming_topk": {(256, 524700, 4, 64, 63, 66, 1): 4,
                     (256, 39780, 4, 64, 5, 63, 1): 2,
                     (256, 39780, 4, 64, 10, 32, 1): 2},
    "gathered_tiles": {(97386, 11243, 1049408, 2048, 3, 1794, 1): 1},
}


def test_launched_traffic_reads_the_launch_counters(monkeypatch):
    """The traffic is each tunable kernel's launches by (Q, N, D, k),
    summed over split plans; other kernels' launches are not traffic. By
    default it reads the kernels' own counters."""
    want = {
        ("topk", "float32"): {(256, 524700, 2048, 3): 4,
                              (256, 524700, 2048, 10): 4,
                              (256, 39780, 2048, 3): 4},
        ("topk", "int8"): {(128, 524700, 2048, 40): 4},
        ("hamming_topk", "int32"): {(256, 524700, 4, 64): 4,
                                    (256, 39780, 4, 64): 4},
    }
    assert tuning.launched_traffic(SHAPES) == want
    assert tuning.launched_traffic({}) == {}
    for kern in (topk_ops.TOPK_PARTIAL, topk_ops.TOPK_INT8_PARTIAL,
                 ham_ops.HAMMING_TOPK):
        monkeypatch.setattr(kern, "shapes",
                            collections.Counter(SHAPES[kern.name]))
    assert tuning.launched_traffic() == want


def test_tuner_end_to_end_with_measure_replaced(tmp_path, monkeypatch):
    """tune_kernel and autotune drive ``measure`` over each cell's calls;
    here a synthetic score takes its place (the inputs are never made),
    the table is written with the traffic it was tuned for, activated,
    and the wrappers resolve through it. A bucket the traffic never
    reached gets no entry."""
    best = {"float32": 264, "int8": 66, "int32": 1056}
    cells = []

    def fake_measure(bench, point, iters=10):
        cells.append((bench.kernel, bench.dtype, bench.calls))
        score = abs(np.log2(point["split_blocks"] / best[bench.dtype]))
        return {"ms": score, "score_ms": score}

    monkeypatch.setattr(tuning, "measure", fake_measure)
    params, score, evals = tuning.tune_kernel(
        "topk", calls={(256, 65536, 2048, 10): 1}, dtype="float32")
    assert params["split_blocks"] == 264 and score == 0.0 and evals >= 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "card")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    out = tmp_path / "tuned.json"
    cells.clear()
    traffic = tuning.launched_traffic(SHAPES)
    table = tuning.autotune(["topk", "hamming_topk"], traffic=traffic,
                            buckets=("le65536", "gt65536"), max_evals=4,
                            out_path=str(out), verbose=False)
    # int8 was launched only over the full corpus: no le65536 entry
    assert sorted(table.entries) == [
        ("hamming_topk", "gt65536", "int32"),
        ("hamming_topk", "le65536", "int32"),
        ("topk", "gt65536", "float32"), ("topk", "gt65536", "int8"),
        ("topk", "le65536", "float32")]
    # each cell measured at the calls made in its bucket, and only those
    assert {(k, d, tuple(sorted(c))) for k, d, c in cells} == {
        ("topk", "float32", ((256, 524700, 2048, 3),
                             (256, 524700, 2048, 10))),
        ("topk", "float32", ((256, 39780, 2048, 3),)),
        ("topk", "int8", ((128, 524700, 2048, 40),)),
        ("hamming_topk", "int32", ((256, 524700, 4, 64),)),
        ("hamming_topk", "int32", ((256, 39780, 4, 64),))}
    assert table.meta["device_kind"] == "card"
    assert table.meta["generated_by"] == \
        "repro_torch.kernels.tuning.autotune"
    assert ["topk", "int8", 128, 524700, 2048, 40, 4] in \
        table.meta["traffic"]
    assert tuning.TunedTable.load(str(out)).entries == table.entries
    assert tuning.resolve("topk", n=524288, dtype="int8")["split_blocks"] \
        == 66
    assert tuning.resolve("topk", n=40000, dtype="int8") == \
        tuning.DEFAULTS["topk"]
    got = tuning.resolve("hamming_topk", n=524288, dtype=torch.int32)
    assert got["split_blocks"] == 1056
    with pytest.raises(ValueError, match="nothing to tune"):
        tuning.tune_kernel("label_prop_round", calls={(1, 1024, 1, 1): 1},
                           dtype="float32")
    with pytest.raises(ValueError, match="run the workload"):
        tuning.autotune(["topk"], traffic={}, out_path=None)
    with pytest.raises(ValueError, match="run the workload"):
        tuning.autotune(["topk"], traffic=traffic, buckets=("le1024",),
                        out_path=None)


def test_measure_and_autotune_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bench = tuning.Bench("topk", "float32", {(256, 65536, 2048, 10): 3})
    with pytest.raises(RuntimeError, match="is_available"):
        tuning.measure(bench, tuning.DEFAULTS["topk"])
    with pytest.raises(RuntimeError, match="is_available"):
        tuning.autotune(["topk"], traffic=tuning.launched_traffic(SHAPES),
                        out_path=None)
    # the bound terms need no card; each call counts as often as launched
    n_bytes, n_ops, peak = bench.work()
    terms = tuning.roofline(n_bytes, n_ops, peak)
    assert terms["compute_ms"] == pytest.approx(
        3 * 3 * 2.0 * 256 * 65536 * 2048 / tuning.H100_TF32_FLOPS * 1e3)
    assert n_bytes == 3 * ((256 + 65536) * 2048 * 4 + 256 * 10 * 8)
    ham = tuning.Bench("hamming_topk", "int32", {(512, 524288, 4, 64): 1})
    assert ham.work() == ((512 + 524288) * 4 * 4 + 512 * 64 * 8,
                          512.0 * 524288 * 4, tuning.H100_POPC_PER_S)


CANDIDATES = [(kernel, blocks) for kernel in ("topk", "hamming_topk")
              for blocks in tuning.SPACES[kernel].axes["split_blocks"]]


@pytest.mark.parametrize("kernel,blocks", CANDIDATES)
@pytest.mark.parametrize("nq,n", [(1, 1), (128, 524288), (256, 65536),
                                  (512, 524288), (257, 78705), (5000, 300)])
def test_split_plan_covers_the_tiles_for_every_candidate(kernel, blocks,
                                                         nq, n):
    """Every row tile falls in exactly one split and the grid takes no
    more query-tile rows of splits than the target asks, whatever the
    candidate. Hamming: no split is empty. Dense: splits come in clusters
    of DENSE_CLUSTER walking equal runs of tiles, and no cluster is
    empty."""
    if kernel == "topk":
        per, splits = topk_ops.dense_plan(nq, n, blocks)
        tiles = -(-n // topk_ops.DENSE_ROWS)
        q_tiles = -(-nq // topk_ops.DENSE_QUERIES)
        step = topk_ops.DENSE_CLUSTER
        assert per >= 1 and splits % step == 0
        assert per * (splits - step) < tiles <= per * splits
        assert splits * q_tiles <= max(blocks, step * q_tiles)
        return
    q_tile, rows = ham_ops.HAMMING_QUERIES, ham_ops.HAMMING_ROWS
    per, splits = topk_ops.split_plan(nq, n, q_tile, rows, blocks)
    tiles = -(-n // rows)
    q_tiles = -(-nq // q_tile)
    assert per >= 1 and splits >= 1
    assert per * (splits - 1) < tiles <= per * splits
    assert splits <= -(-blocks // q_tiles) or splits == 1


@pytest.mark.parametrize("kernel,blocks", CANDIDATES)
def test_every_candidate_gives_the_same_results(kernel, blocks):
    """A split only decides which block scans which tiles: the plain
    version run split by split (its blocked merge, ties to the lowest id)
    gives the one-pass results for every candidate, ties included."""
    rng = np.random.default_rng(blocks)
    n, nq = 5000, 40
    if kernel == "topk":
        rows = topk_ops.DENSE_ROWS
        cases = [(topk_scores_ref,
                  torch.from_numpy(rng.standard_normal((nq, 16))
                                   .astype(np.float32)),
                  torch.from_numpy(rng.standard_normal((n, 16))
                                   .astype(np.float32)), 10),
                 (topk_scores_int8_ref,
                  torch.from_numpy(rng.integers(-3, 4, (nq, 8))
                                   .astype(np.int8)),
                  torch.from_numpy(rng.integers(-3, 4, (n, 8))
                                   .astype(np.int8)), 40)]
    else:
        q_tile, rows = ham_ops.HAMMING_QUERIES, ham_ops.HAMMING_ROWS
        cases = [(hamming_topk_ref,
                  torch.from_numpy(rng.integers(0, 8, (nq, 1))
                                   .astype(np.int32)),
                  torch.from_numpy(rng.integers(0, 8, (n, 1))
                                   .astype(np.int32)), 64)]
    for ref, q, c, k in cases:
        c[n // 2:] = c[:n - n // 2].clone()            # exact ties
        per = (topk_ops.dense_plan(nq, n, blocks)[0] if kernel == "topk"
               else topk_ops.split_plan(nq, n, q_tile, rows, blocks)[0])
        s1, i1 = ref(q, c, k=k, block=n)
        s2, i2 = ref(q, c, k=k, block=per * rows)
        assert torch.equal(s1, s2) and torch.equal(i1, i2)


def test_windtunnel_config_engine_follows_the_device(monkeypatch):
    """The reference's WindTunnelConfig.engine defaults to 'sort'; the
    port's to None, the device's default, so run_windtunnel on the card
    takes the LP kernel and on the CPU the plain sort engine."""
    assert WindTunnelConfig().engine is None
    assert SamplerSpec.from_config(WindTunnelConfig()).engine is None
    c = generate_corpus(num_queries=32, qrels_per_query=4, num_topics=4,
                        seed=0)
    seen = []
    monkeypatch.setattr(SamplerSession, "result", lambda self: seen.append(
        (self.device.type, self.spec.engine)))
    run = lambda device: run_windtunnel(
        c.qrels, num_queries=c.num_queries, num_entities=c.num_entities,
        config=WindTunnelConfig(), device=device)
    run("cpu")
    # a simulated card: the session resolves to cuda and keeps its tables
    # where they are
    monkeypatch.setattr(sampling_core, "resolve_device",
                        lambda device: torch.device(device))
    monkeypatch.setattr(sampling_core.gb.QRelTable, "to",
                        lambda self, device: self)
    run("cuda")
    assert seen == [("cpu", "sort"), ("cuda", "cuda")]
    assert default_engine(torch.device("cuda")) == "cuda"
    run_explicit = run_windtunnel(
        c.qrels, num_queries=c.num_queries, num_entities=c.num_entities,
        config=WindTunnelConfig(engine="ell"), device="cuda")
    assert run_explicit is None and seen[-1] == ("cuda", "ell")
