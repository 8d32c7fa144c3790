"""The dry run on the reference's single-pod layout (``python -m
repro_torch.launch.dryrun --all --mesh single``, here an arch a
process): a fake process group of 256 ranks, each cell's step run as rank
0 on fake tensors, in a subprocess (the fake group is the process's
default group). The LM
configs are cut to 2 layers (``--layers 2``) to keep the run short; every
width and shape is the published one.

Every cell runs, the LM's, the recsys rankers' and MACE's, its per-rank
argument bytes equal to the whole arguments' bytes over each leaf's shard
count by the placements of its specs (gemma-2b's embedding (256000 / 16) x
(2048 / 16) by the reference's rules table; a recsys table's rows and
MACE's nodes and edges over all 256 ranks). All equal, no tolerance."""
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Shard

from repro.distributed import sharding as jsh
from repro_torch.configs import get_arch, iter_cells
from repro_torch.launch import cells
from repro_torch.launch.dryrun import PRODUCTION
from repro_torch.train.optimizer import tree_leaves

LAYERS = 2
TIMEOUT = 400
CELLS = list(iter_cells())
LM_CELLS = [c for c in CELLS if get_arch(c[0]).family == "lm"]
OTHER_CELLS = [c for c in CELLS if get_arch(c[0]).family != "lm"]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Every cell's row: ``dryrun --arch A`` for each arch (all its cells,
    as ``--all`` runs them), three processes at a time."""
    tmp = tmp_path_factory.mktemp("dryrun")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH", ""))

    def run(arch):
        out = tmp / arch
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--mesh", "single", "--layers", str(LAYERS), "--out",
             str(out)], env=env, text=True, capture_output=True,
            timeout=TIMEOUT)
        assert proc.returncode == 0, (proc.stdout[-3000:]
                                      + proc.stderr[-3000:])
        with open(str(out) + ".json") as f:
            return json.load(f)

    archs = list(dict.fromkeys(a for a, _ in CELLS))
    with ThreadPoolExecutor(3) as pool:
        rows = [r for got in pool.map(run, archs) for r in got]
    return {(r["arch"], r["shape"]): r for r in rows}


def _spec_bytes(spec, sizes) -> int:
    """One argument's bytes on a rank: its placements' shard counts."""
    count = 1
    for name, p in zip(("data", "model"), spec.placements):
        if p.is_shard():
            count *= sizes[name]
    return int(np.prod(spec.shape)) * spec.dtype.itemsize // count


@pytest.mark.parametrize("arch,shape", LM_CELLS,
                         ids=[f"{a}-{s}" for a, s in LM_CELLS])
def test_every_lm_cell_runs_on_256_ranks(results, arch, shape):
    """The cell ran as rank 0 of 16 x 16, with flops counted and its
    arguments' bytes each leaf's whole bytes over its shard count: the
    spec's placements, which are the reference's rules
    (``test_gemma_embedding_shard_is_the_rules_share`` holds one leaf to
    the rules table itself)."""
    row = results[(arch, shape)]
    assert row["ok"] and row["mesh"] == "single-pod-16x16", row
    assert row["n_chips"] == 256 and row["layers"] == LAYERS
    assert row["flops_per_device"] > 0
    _, mesh = PRODUCTION["single"]
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    cell = cells.build_cell(arch, shape, mesh,
                            overrides={"n_layers": LAYERS})
    want = sum(_spec_bytes(s, sizes)
               for s in tree_leaves(list(cell.args)))
    assert row["bytes_per_device"] == want


@pytest.mark.parametrize("arch,shape", OTHER_CELLS,
                         ids=[f"{a}-{s}" for a, s in OTHER_CELLS])
def test_recsys_and_gnn_cells_fail_naming_the_next_item(results, arch,
                                                        shape):
    """The recsys and GNN cells run as rank 0 of 16 x 16 at their
    published configs, with flops counted and their arguments' bytes each
    leaf's whole bytes over its shard count (a table's rows and MACE's
    nodes and edges over all 256 ranks, the batch over ``data``, the
    rest replicated)."""
    row = results[(arch, shape)]
    assert row["ok"] and row["mesh"] == "single-pod-16x16", row
    assert row["n_chips"] == 256
    assert row["flops_per_device"] > 0
    _, mesh = PRODUCTION["single"]
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    cell = cells.build_cell(arch, shape, mesh)
    want = sum(_spec_bytes(s, sizes)
               for s in tree_leaves(list(cell.args)))
    assert row["bytes_per_device"] == want


def test_gemma_embedding_shard_is_the_rules_share():
    """gemma-2b's (256000, 2048) embedding on 16 x 16: vocab over
    ``model`` and embed over ``data`` by the reference's rules, so a rank
    holds (16000, 128)."""
    _, mesh = PRODUCTION["single"]
    cell = cells.build_cell("gemma-2b", "train_4k", mesh)
    spec = cell.args[0]["embed"]
    assert (jsh.LM_RULES["vocab"], jsh.LM_RULES["embed"]) == ("model",
                                                              "data")
    assert spec.placements == (Shard(1), Shard(0))   # (data, model)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    assert spec.shape == (256000, 2048) and spec.dtype == torch.float32
    assert _spec_bytes(spec, sizes) == 16000 * 128 * 4
