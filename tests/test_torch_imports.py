"""Package rules of the PyTorch port: no JAX and no ``repro`` imports, import
without nvcc or a card, and the device contract of every entry point."""
import ast
import importlib
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import device as devmod
from repro_torch.core import SamplerSession, SamplerSpec
from repro_torch.data.synthetic import generate_corpus
from repro_torch.kernels.label_prop.ops import label_prop_round, lp_round_cuda
from repro_torch.kernels.topk_scoring.ops import (topk_scores,
                                                  topk_scores_cuda,
                                                  topk_scores_int8,
                                                  topk_scores_int8_cuda)
from repro_torch.retrieval import experiment
from repro_torch.retrieval.encoder import EncoderConfig, embed_corpus
from repro_torch.retrieval.search_core import SearchConfig, SearchSession

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "src", "repro_torch")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PKG):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_never_imports_jax_or_repro(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_every_module_imports_without_nvcc_or_card():
    mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                  "repro_torch.")]
    env = dict(os.environ, PATH="/usr/bin:/bin", CUDA_VISIBLE_DEVICES="")
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "assert 'jax' not in sys.modules and 'repro' not in sys.modules\n"
            "import torch; assert not torch.cuda.is_initialized()\n")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert len(mods) > 20
    for m in mods:
        importlib.import_module(m)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_cuda_device_without_card_raises(no_card):
    with pytest.raises(RuntimeError, match="cuda"):
        devmod.resolve_device("cuda")
    c = generate_corpus(num_queries=64, qrels_per_query=4, num_topics=4,
                        seed=0)
    with pytest.raises(RuntimeError):
        SamplerSession(c.qrels, num_queries=c.num_queries,
                       num_entities=c.num_entities)
    with pytest.raises(RuntimeError):
        SearchSession(np.zeros((4, 8), np.float32))


@pytest.mark.parametrize("argv", [
    ["repro_torch.launch.sample", "--queries", "32"],
    ["repro_torch.launch.evaluate", "--grid", "smoke", "--queries", "32"],
    ["repro_torch.launch.train", "--arch", "gemma-2b", "--steps", "1"],
    ["repro_torch.launch.train", "--arch", "dcn-v2", "--steps", "1"],
    ["repro_torch.launch.train", "--arch", "mace", "--steps", "1"]])
def test_clis_default_to_the_card(no_card, argv):
    mod = importlib.import_module(argv[0])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        mod.main(argv[1:])


def test_cpu_defaults_are_the_plain_engine_and_backend():
    cpu = torch.device("cpu")
    assert devmod.default_engine(cpu) == "sort"
    assert devmod.default_backend(cpu) == "torch"
    assert devmod.default_engine(torch.device("cuda")) == "cuda"
    assert devmod.default_backend(torch.device("cuda")) == "cuda"
    c = generate_corpus(num_queries=64, qrels_per_query=4, num_topics=4,
                        seed=0)
    s = SamplerSession(c.qrels, num_queries=c.num_queries,
                       num_entities=c.num_entities, device="cpu")
    assert s.spec.engine == "sort"
    ss = SearchSession(np.eye(4, dtype=np.float32), device="cpu")
    assert ss.config.backend == "torch"


def test_naming_the_cuda_engine_or_backend_on_cpu_raises():
    c = generate_corpus(num_queries=64, qrels_per_query=4, num_topics=4,
                        seed=0)
    with pytest.raises(ValueError, match="engine 'cuda'"):
        SamplerSession(c.qrels, num_queries=c.num_queries,
                       num_entities=c.num_entities,
                       spec=SamplerSpec(engine="cuda"), device="cpu")
    with pytest.raises(ValueError, match="backend 'cuda'"):
        SearchSession(np.eye(4, dtype=np.float32),
                      SearchConfig(backend="cuda"), device="cpu")


def test_sharded_paths_raise_naming_the_roadmap_item():
    """The sharded paths are ported (ROADMAP queue 1 item 12): asked for
    without a mesh, each session names what is missing."""
    c = generate_corpus(num_queries=64, qrels_per_query=4, num_topics=4,
                        seed=0)
    with pytest.raises(ValueError, match="sharded sampling needs a mesh"):
        SamplerSession(c.qrels, num_queries=c.num_queries,
                       num_entities=c.num_entities,
                       spec=SamplerSpec(engine="ell", sharded=True),
                       device="cpu")
    with pytest.raises(ValueError, match="sharded search needs a mesh"):
        SearchSession(np.eye(4, dtype=np.float32),
                      SearchConfig(sharded=True), device="cpu")


def test_kernel_wrappers_take_the_plain_path_only_on_cpu_tensors():
    labels = torch.arange(4, dtype=torch.int32)
    nbr = torch.tensor([[1, -1], [0, 2], [1, -1], [-1, -1]],
                       dtype=torch.int32)
    wgt = torch.tensor([[1.0, 0.0], [1.0, 2.0], [1.0, 0.0], [0.0, 0.0]])
    assert label_prop_round(labels, nbr, wgt).tolist() == [1, 2, 1, 3]
    with pytest.raises(ValueError, match="CUDA"):
        lp_round_cuda(labels, nbr, wgt)
    q = torch.eye(3)
    s, i = topk_scores(q, q, k=5)
    assert i.tolist() == [[0, 1, 2, -1, -1], [1, 0, 2, -1, -1],
                          [2, 0, 1, -1, -1]]
    with pytest.raises(ValueError, match="CUDA"):
        topk_scores_cuda(q, q, 2)


def test_int8_wrapper_takes_the_plain_path_only_on_cpu_tensors():
    codes = torch.tensor([[1, 0], [0, 2], [3, 3]], dtype=torch.int8)
    s, i = topk_scores_int8(codes, codes, k=4)
    assert i.tolist() == [[2, 0, 1, -1], [2, 1, 0, -1], [2, 1, 0, -1]]
    assert s[:, :3].tolist() == [[3.0, 1.0, 0.0], [6.0, 4.0, 0.0],
                                 [18.0, 6.0, 3.0]]
    with pytest.raises(ValueError, match="CUDA"):
        topk_scores_int8_cuda(codes, codes, 2)


def test_encoder_entry_points_default_to_the_card(no_card):
    """train_encoder, embed_corpus and run_table1_experiment run on the
    card unless given device='cpu', and raise without one."""
    c = generate_corpus(num_queries=48, qrels_per_query=6, num_topics=4,
                        vocab_size=32, passage_len=8, query_len=4, seed=0)
    cfg = EncoderConfig(vocab_size=32, d_model=16, n_layers=1, n_heads=1,
                        d_ff=16)
    calls = [lambda **kw: experiment.train_encoder(c, cfg, steps=1,
                                                   batch_size=4,
                                                   log_every=0, **kw),
             lambda **kw: experiment.run_table1_experiment(
                 c, encoder_cfg=cfg, encoder_steps=1, verbose=False, **kw)]
    for call in calls:
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            call()
    params, losses = calls[0](device="cpu")
    assert len(losses) == 1 and np.isfinite(losses[0])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        embed_corpus(params, c.passage_tokens, cfg)
    vecs = embed_corpus(params, c.passage_tokens, cfg, device="cpu")
    assert vecs.shape == (c.num_entities, 16)
    np.testing.assert_allclose(np.linalg.norm(vecs, axis=1), 1.0, rtol=1e-5)
    res = calls[1](device="cpu")
    assert set(res) == {"full", "uniform", "windtunnel"}
