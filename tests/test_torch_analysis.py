"""The port's contract analyzer (``repro_torch.analysis``,
``repro_torch.launch.lint``): one positive and one negative fixture per
rule, written as ``repro_torch/`` (or bare-package) trees in ``tmp_path``,
suppression comments, baseline round-trip, the --json report schema,
import cycle/layering fixtures, and the meta tests — the analyzer run over
``src/repro_torch`` itself reports no error finding, finds the five
registries, and its committed baseline (``lint_baseline_torch.json``)
covers the tree. The package surface is the reference's."""
import json
import os
import subprocess
import sys
import textwrap

import pytest

import repro.analysis as janalysis
import repro_torch.analysis as tanalysis
from repro_torch.analysis import core as acore
from repro_torch.analysis.concurrency_rules import (graph_cycle,
                                                    lock_order_graph)
from repro_torch.analysis.core import (Finding, Project, analyze,
                                       load_default_rules)
from repro_torch.launch import lint as lint_cli

load_default_rules()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_PORT = os.path.join(REPO, "src", "repro_torch")
BASELINE = os.path.join(REPO, "lint_baseline_torch.json")

RULE_IDS = {
    # the reference's seven rules that do not concern JAX
    "conc-unguarded-write", "conc-unguarded-read", "conc-lock-order",
    "conc-thread-no-surface", "import-cycle", "import-layering",
    "reg-conformance",
    # the torch analogues of its five JAX rules
    "torch-host-sync", "torch-tensor-branch", "torch-unbounded-launch",
    "torch-inplace-reuse", "serve-inplace-append"}


def _write_tree(root, files):
    root.mkdir(parents=True, exist_ok=True)
    (root / "__init__.py").write_text("")
    for rel, src in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        d = path.parent
        while d != root:
            if not (d / "__init__.py").exists():
                (d / "__init__.py").write_text("")
            d = d.parent
        path.write_text(textwrap.dedent(src))
    return Project.load([str(root)])


def _project(tmp_path, sources, pkg="fix"):
    """Write {relpath: source} under a package dir and load it."""
    return _write_tree(tmp_path / pkg, sources)


def _port_tree(tmp_path, files):
    """A fake repro_torch.* package tree (module names resolve as
    repro_torch.<pkg>...)."""
    return _write_tree(tmp_path / "repro_torch", files)


def _rules_hit(findings, rule):
    return [f for f in findings if f.rule == rule]


def test_package_surface_is_the_references():
    assert set(tanalysis.__all__) == set(janalysis.__all__)
    for name in tanalysis.__all__:
        assert getattr(tanalysis, name) is not None, name


def test_module_package_keys_on_the_port(tmp_path):
    project = _port_tree(tmp_path, {"serve/ingest.py": "", "device.py": ""})
    got = {m.name: m.package for m in project.modules}
    assert got["repro_torch.serve.ingest"] == "serve"
    assert got["repro_torch.device"] == "device"
    assert got["repro_torch"] == ""


# ---------------------------------------------------------------------------
# Family 1: host syncs in hot code
# ---------------------------------------------------------------------------


HOT_BAD = """
    import torch

    def f(x: torch.Tensor, y: torch.Tensor):
        v = float(x)          # a host read of a tensor
        if y > 0:             # a branch on a tensor
            v = v + 1.0
        return v
"""

HOT_OK = """
    import torch

    def _aligned(*ts: torch.Tensor) -> bool:
        return all(t.data_ptr() % 16 == 0 for t in ts)

    def f(x: torch.Tensor, *, k: int):
        steps = float(k)                 # k is a host int
        if x.shape[0] > 4:               # shapes are host metadata
            x = x * steps
        vec = int(x.dim() == 2 and _aligned(x))   # no tensor either
        n = torch.stack([x.sum(), x.max()]).tolist()[0]
        if n:                            # tolist() made host values
            vec += 1
        return torch.where(x > 0, x, 0.0), vec
"""


def test_host_sync_positive_and_negative(tmp_path):
    bad = analyze(_port_tree(tmp_path / "a", {"kernels/foo/ops.py": HOT_BAD}))
    hits = _rules_hit(bad, "torch-host-sync")
    assert len(hits) == 1 and hits[0].severity == "error"
    assert "float()" in hits[0].message and hits[0].symbol == "f"
    good = analyze(_port_tree(tmp_path / "b", {"kernels/foo/ops.py": HOT_OK}))
    assert [f.line for f in _rules_hit(good, "torch-host-sync")] == [12]
    # the same code outside the declared hot set is not checked
    cold = analyze(_port_tree(tmp_path / "c", {"core/cold.py": HOT_BAD}))
    assert not _rules_hit(cold, "torch-host-sync")


def test_tensor_branch_positive_and_negative(tmp_path):
    bad = analyze(_project(tmp_path, {"ingest.py": HOT_BAD}, pkg="serve"))
    hits = _rules_hit(bad, "torch-tensor-branch")
    assert len(hits) == 1 and hits[0].severity == "error"
    good = analyze(_project(tmp_path, {"ingest2.py": HOT_OK}, pkg="serve2"))
    assert not _rules_hit(good, "torch-tensor-branch")
    good = analyze(_port_tree(tmp_path, {"retrieval/backends.py": HOT_OK}))
    assert not _rules_hit(good, "torch-tensor-branch")


@pytest.mark.parametrize("expr,what", [
    ("x.sum().item()", ".item()"), ("(x > 0).tolist()", ".tolist()"),
    ("x.cpu()", ".cpu()"), ("x.detach().numpy()", ".numpy()"),
    ("bool(torch.isfinite(x).all())", "bool()"),
    ("int(F.relu(x).argmax())", "int()")])
def test_host_methods_and_casts_flagged(tmp_path, expr, what):
    src = f"""
        import torch
        import torch.nn.functional as F

        def f(x: torch.Tensor):
            return {expr}
    """
    hits = _rules_hit(analyze(_port_tree(tmp_path, {
        "kernels/foo/ops.py": src})), "torch-host-sync")
    assert len(hits) == 1 and what in hits[0].message


@pytest.mark.parametrize("stmt", [
    "assert (x > 0).all()", "y = 1 if x.any() else 2",
    "while x.sum() > 0:\n                x = x - 1"],
    ids=["assert", "ternary", "while"])
def test_tensor_branch_forms(tmp_path, stmt):
    src = f"""
        import torch

        def f(q):
            x = torch.as_tensor(q)     # a torch call makes a tensor
            {stmt}
            return x
    """
    hits = _rules_hit(analyze(_port_tree(tmp_path, {
        "serve/tick.py": src})), "torch-tensor-branch")
    assert len(hits) == 1


def test_search_step_is_hot_and_the_build_is_not(tmp_path):
    src = """
        import torch

        class SearchSession:
            def __init__(self, vecs):
                x = torch.as_tensor(vecs)
                self.n = int(x.shape[0]) + int(x.abs().max())

            def search_scored(self, queries, *, k):
                q = torch.as_tensor(queries)
                return q.max().item()
    """
    hits = _rules_hit(analyze(_port_tree(tmp_path, {
        "retrieval/search_core.py": src})), "torch-host-sync")
    assert [f.symbol for f in hits] == ["SearchSession.search_scored"]


KERNEL_OPS = """
    import torch
    from repro_torch.kernels import tuning

    def split_plan(nq: int, n: int) -> int:      # a helper, not a wrapper
        return nq + n

    def topk(x: torch.Tensor, *, k: int, width: int,
             split_blocks: int = None):
        blocks = tuning.resolve("topk", n=x.shape[0], dtype=x.dtype,
                                split_blocks=split_blocks)
        return topk_cuda(x, k, blocks["split_blocks"])

    def topk_cuda(x: torch.Tensor, k: int, blocks: int):
        TOPK_KERNEL(x.data_ptr(), k, blocks)
        return x[:k]
"""


def test_unbounded_launch_flags_free_value_not_clamped(tmp_path):
    callers = """
        from repro_torch.kernels.foo import ops as foo_ops
        from repro_torch.kernels.foo.ops import split_plan, topk

        K_MAX = 16

        def serve(x, user_k, rows):
            split_plan(user_k, rows)                     # no launch
            return foo_ops.topk(x, k=user_k, width=rows)  # both unbounded

        def serve_clamped(x, user_k):
            k = min(user_k, K_MAX)                       # min-clamp: bounded
            return topk(x, k=k, width=x.shape[1])
    """
    findings = analyze(_port_tree(tmp_path, {
        "kernels/foo/ops.py": KERNEL_OPS, "retrieval/search.py": callers}))
    hits = _rules_hit(findings, "torch-unbounded-launch")
    assert {(f.symbol, f.severity) for f in hits} == {("serve", "warning")}
    assert len(hits) == 2          # k and width at the bare call site
    # the wrapper hands its own k on to topk_cuda: checked at its callers
    assert all("search.py" in f.path for f in hits)


def test_tuned_block_kwargs_are_known_static(tmp_path):
    # split_blocks is in the finite kernels/tuning.py table: never flagged
    callers = """
        from repro_torch.kernels.foo.ops import topk

        def dispatch(x, resolved):
            return topk(x, k=4, width=8, split_blocks=resolved)
    """
    findings = analyze(_port_tree(tmp_path, {
        "kernels/foo/ops.py": KERNEL_OPS, "serve/tick.py": callers}))
    assert not _rules_hit(findings, "torch-unbounded-launch")


# ---------------------------------------------------------------------------
# Family 2: in-place write safety
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("write", [
    "labels[row0:row0 + n] = new", "labels.copy_(new)", "labels.add_(1)",
    "torch.add(labels, 1, out=labels)", "labels += 1"])
def test_inplace_reuse_positive_and_negative(tmp_path, write):
    src = f"""
        import torch

        def bad(labels: torch.Tensor, new: torch.Tensor, row0: int, n: int):
            own = labels[row0:row0 + n]
            {write}
            return (new != own).sum()      # own sees the write

        def good(labels: torch.Tensor, new: torch.Tensor, row0: int,
                 n: int):
            own = labels[row0:row0 + n].clone()
            {write}
            return (new != own).sum(), labels

        def rebound(labels: torch.Tensor, new: torch.Tensor):
            own = labels.view(-1)
            {write.replace("row0:row0 + n", ":")}
            own = new                      # a new binding: not stale
            return own
    """
    findings = analyze(_project(tmp_path, {"m.py": src}))
    hits = _rules_hit(findings, "torch-inplace-reuse")
    assert [f.symbol for f in hits] == ["bad"]
    assert hits[0].severity == "error" and "own" in hits[0].message


APPEND_OK = """
    import threading

    import numpy as np
    import torch

    class Live:
        def __init__(self):
            self._lock = threading.RLock()
            self._pending = np.zeros((0, 4), np.float32)
            self._buf = torch.zeros((8, 4))

        @property
        def pending_rows(self):
            with self._lock:
                return int(self._pending.shape[0])

        def append(self, rows):
            with self._lock:
                start = self.pending_rows
                old = self.pending_rows
                self._pending = np.concatenate([self._pending, rows], 0)
                if self.pending_rows > 8:
                    self._buf = torch.zeros((16, 4))
                else:
                    # in place at rows >= old: every snapshot masks them
                    self._buf[old:self.pending_rows] = torch.from_numpy(
                        self._pending[old:])
            return start
"""

APPEND_BAD = {
    # the same write made before old is read
    "before-read": ("""
                old = self.pending_rows
                self._pending = np.concatenate([self._pending, rows], 0)
""", """
                self._buf[old:old + rows.shape[0]] = torch.from_numpy(rows)
                old = self.pending_rows
                self._pending = np.concatenate([self._pending, rows], 0)
"""),
    # the count read after the block's update: the new count
    "after-update": ("""
                old = self.pending_rows
                self._pending = np.concatenate([self._pending, rows], 0)
""", """
                self._pending = np.concatenate([self._pending, rows], 0)
                old = self.pending_rows
                self._buf[old:].copy_(torch.from_numpy(rows))
"""),
    # outside the lock
    "unlocked": ("""
                if self.pending_rows > 8:""", """
                self._buf[:4] = torch.from_numpy(rows[:4])
                if self.pending_rows > 8:"""),
}


@pytest.mark.parametrize("case", ["ok"] + sorted(APPEND_BAD))
def test_serve_inplace_append_contract(tmp_path, case):
    src = APPEND_OK
    if case != "ok":
        old, new = APPEND_BAD[case]
        assert old in src
        src = src.replace(old, new)
        if case == "unlocked":
            src = src.replace("            with self._lock:\n                "
                              "start", "            if True:\n"
                              "                start")
    hits = _rules_hit(analyze(_project(tmp_path, {"ingest.py": src},
                                       pkg="serve")), "serve-inplace-append")
    # after-update and unlocked also move the original write's snapshot
    want = {"ok": 0, "before-read": 1, "after-update": 2, "unlocked": 2}
    assert len(hits) == want[case]
    assert all(f.severity == "error" and f.symbol == "Live.append"
               for f in hits)
    # the same code outside serve/: the LiveIndex contract does not apply
    other = analyze(_project(tmp_path, {"other.py": src}, pkg="elsewhere"))
    assert not _rules_hit(other, "serve-inplace-append")


# ---------------------------------------------------------------------------
# Family 3: concurrency
# ---------------------------------------------------------------------------


GUARDED_BAD = """
    import threading

    class Box:
        def __init__(self):
            self._lock = threading.Lock()
            self._items = []
            self._n = 0

        def put(self, x):
            with self._lock:
                self._items.append(x)
                self._n += 1

        def drop_all(self):
            self._items = []      # bare write: races put()

        def size(self):
            return self._n        # bare read
"""

GUARDED_OK = """
    import threading

    class Box:
        def __init__(self):
            self._lock = threading.Lock()
            self._items = []

        def put(self, x):
            with self._lock:
                self._items.append(x)

        def size(self):
            with self._lock:
                return len(self._items)
"""


def test_unguarded_write_and_read(tmp_path):
    findings = analyze(_project(tmp_path, {"box.py": GUARDED_BAD},
                                pkg="serve"))
    writes = _rules_hit(findings, "conc-unguarded-write")
    reads = _rules_hit(findings, "conc-unguarded-read")
    assert [f.symbol for f in writes] == ["Box.drop_all"]
    assert writes[0].severity == "error"
    assert [f.symbol for f in reads] == ["Box.size"]
    assert reads[0].severity == "warning"
    clean = analyze(_project(tmp_path, {"box2.py": GUARDED_OK},
                             pkg="obs"))
    assert not _rules_hit(clean, "conc-unguarded-write")
    assert not _rules_hit(clean, "conc-unguarded-read")


def test_concurrency_rules_cover_the_ports_threaded_packages(tmp_path):
    project = _port_tree(tmp_path, {"kernels/build.py": GUARDED_BAD,
                                    "serve/box.py": GUARDED_BAD,
                                    "train/box.py": GUARDED_BAD,
                                    "core/box.py": GUARDED_BAD})
    hits = _rules_hit(analyze(project), "conc-unguarded-write")
    assert sorted(os.path.basename(os.path.dirname(f.path))
                  for f in hits) == ["kernels", "serve", "train"]


LOCK_CYCLE = """
    import threading

    class A:
        def __init__(self, b):
            self._lock = threading.Lock()
            self._b = b

        def step(self):
            with self._lock:
                self._b.poke()     # A.lock held -> takes B.lock

    class B:
        def __init__(self):
            self._lock = threading.Lock()
            self._a = A(self)

        def poke(self):
            with self._lock:
                pass

        def kick(self):
            with self._lock:
                self._a.step()     # B.lock held -> takes A.lock: cycle
"""


def test_lock_order_cycle(tmp_path):
    project = _project(tmp_path, {"locks.py": LOCK_CYCLE}, pkg="serve")
    edges = lock_order_graph(project)
    assert graph_cycle(edges) is not None
    hits = _rules_hit(analyze(project), "conc-lock-order")
    assert len(hits) == 1 and "A" in hits[0].message \
        and "B" in hits[0].message


THREAD_BAD = """
    import threading

    class Fire:
        def start(self):
            t = threading.Thread(target=self._work, daemon=True)
            t.start()

        def _work(self):
            pass
"""

THREAD_OK = """
    import threading

    class Fire:
        def __init__(self):
            self._lock = threading.Lock()
            self._err = None

        def start(self):
            threading.Thread(target=self._work, daemon=True).start()

        def _work(self):
            try:
                pass
            except Exception as e:   # raised by the next call
                with self._lock:
                    self._err = e

        def call(self):
            with self._lock:
                err, self._err = self._err, None
            if err is not None:
                raise RuntimeError("worker failed") from err
"""


def test_thread_failure_surfacing(tmp_path):
    bad = analyze(_project(tmp_path, {"t.py": THREAD_BAD}, pkg="serve"))
    hits = _rules_hit(bad, "conc-thread-no-surface")
    assert len(hits) == 1 and hits[0].severity == "error"
    good = analyze(_project(tmp_path, {"t.py": THREAD_OK}, pkg="serve"))
    assert not _rules_hit(good, "conc-thread-no-surface")
    assert not _rules_hit(good, "conc-unguarded-write")


# ---------------------------------------------------------------------------
# Family 4: registry conformance
# ---------------------------------------------------------------------------


REGISTRY_SRC = """
    from typing import Dict, Protocol, runtime_checkable

    @runtime_checkable
    class Engine(Protocol):
        name: str

        def run(self, state, *, rounds): ...

    _REGISTRY: Dict[str, "Engine"] = {}

    def register(cls):
        inst = cls()
        _REGISTRY[inst.name] = inst
        return cls

    @register
    class Good:
        name = "good"

        def run(self, state, *, rounds):
            return state

    @register
    class MissingMethod:
        name = "missing"

    @register
    class BadSignature:
        name = "badsig"

        def run(self, state, extra_required, *, rounds):
            return state

    @register
    class MissingAttr:
        def run(self, state, *, rounds):
            return state
"""


def test_registry_conformance(tmp_path):
    findings = analyze(_project(tmp_path, {"engines.py": REGISTRY_SRC}))
    hits = _rules_hit(findings, "reg-conformance")
    by_symbol = {f.symbol: f for f in hits}
    assert "Good" not in {s.split(".")[0] for s in by_symbol}
    assert any(s.startswith("MissingMethod") for s in by_symbol)
    assert any(s.startswith("BadSignature") for s in by_symbol)
    assert any(s.startswith("MissingAttr") for s in by_symbol)
    assert all(f.severity == "error" for f in hits)


# ---------------------------------------------------------------------------
# Imports: cycles + layering
# ---------------------------------------------------------------------------


def test_import_cycle_detected(tmp_path):
    project = _port_tree(tmp_path, {
        "core/a.py": "from repro_torch.data import b\n",
        "data/b.py": "from repro_torch.core import a\n",
    })
    hits = _rules_hit(analyze(project, rules=["import-cycle"]),
                      "import-cycle")
    assert len(hits) == 1 and hits[0].severity == "error"
    assert "core" in hits[0].message and "data" in hits[0].message


def test_latent_deferred_cycle_warns(tmp_path):
    # the shape the port had before ell_round moved beside its kernel
    project = _port_tree(tmp_path, {
        "kernels/lp/ops.py": "from repro_torch.core.lp import ell_round\n",
        "core/lp.py": ("def ell_round():\n"
                       "    pass\n"
                       "def propagate():\n"
                       "    from repro_torch.kernels.lp import ops\n"
                       "    return ops\n"),
    })
    hits = _rules_hit(analyze(project, rules=["import-cycle"]),
                      "import-cycle")
    assert len(hits) == 1 and hits[0].severity == "warning"
    assert "latent" in hits[0].message
    layering = _rules_hit(analyze(project, rules=["import-layering"]),
                          "import-layering")
    assert [f.symbol for f in layering] == ["kernels"]


def test_layering_eval_upward_is_error(tmp_path):
    project = _port_tree(tmp_path, {
        "eval/metrics.py": "from repro_torch.serve import engine\n",
        "serve/engine.py": "",
    })
    hits = _rules_hit(analyze(project, rules=["import-layering"]),
                      "import-layering")
    assert len(hits) == 1 and hits[0].severity == "error"
    assert hits[0].symbol == "eval"


def test_layering_downward_is_clean(tmp_path):
    project = _port_tree(tmp_path, {
        "eval/metrics.py": "from repro_torch.core import thing\n"
                           "from repro_torch.obs import trace\n",
        "core/thing.py": "from repro_torch.obs import trace\n"
                         "from repro_torch import device\n",
        "models/net.py": "from repro_torch.core import prng\n",
        "interop.py": "from repro_torch.retrieval import lsh\n",
        "obs/trace.py": "",
        "device.py": "",
    })
    assert not analyze(project, rules=["import-layering", "import-cycle"])


def test_real_tree_imports_clean():
    project = Project.load([SRC_PORT])
    findings = analyze(project, rules=["import-cycle", "import-layering"])
    assert findings == [], [f.format() for f in findings]


# ---------------------------------------------------------------------------
# Framework: suppression, baseline, CLI
# ---------------------------------------------------------------------------


def test_suppression_comment_silences(tmp_path):
    src = HOT_BAD.replace("v = float(x)",
                          "v = float(x)  # lint: disable=torch-host-sync")
    findings = analyze(_port_tree(tmp_path, {"kernels/foo/ops.py": src}))
    assert not _rules_hit(findings, "torch-host-sync")
    assert _rules_hit(findings, "torch-tensor-branch")  # others still fire


def test_suppression_line_above_and_bare(tmp_path):
    src = """
        import torch

        def f(x: torch.Tensor):
            # lint: disable
            return float(x)
    """
    assert not analyze(_port_tree(tmp_path, {"kernels/foo/ops.py": src}))


def test_baseline_round_trip(tmp_path):
    project = _port_tree(tmp_path, {"kernels/foo/ops.py": HOT_BAD})
    findings = analyze(project)
    assert findings
    path = str(tmp_path / "baseline.json")
    acore.save_baseline(path, findings)
    baseline = acore.load_baseline(path)
    assert acore.new_findings(findings, baseline) == []
    extra = Finding("torch-host-sync", "error", "x.py", 1, "new issue")
    assert acore.new_findings(findings + [extra], baseline) == [extra]
    # fingerprints are line-free: moving a finding does not churn
    moved = [Finding(f.rule, f.severity, f.path, f.line + 7, f.message,
                     f.symbol) for f in findings]
    assert acore.new_findings(moved, baseline) == []


def test_missing_baseline_is_empty(tmp_path):
    assert acore.load_baseline(str(tmp_path / "absent.json")) == frozenset()


def _bad_root(tmp_path):
    root = tmp_path / "repro_torch"
    _write_tree(root, {"kernels/foo/ops.py": HOT_BAD})
    return root


def test_cli_json_schema_and_exit_codes(tmp_path, capsys):
    root = _bad_root(tmp_path)
    baseline = str(tmp_path / "b.json")
    rc = lint_cli.main(["--json", str(root), "--baseline", baseline])
    assert rc == 1                       # new error findings
    report = json.loads(capsys.readouterr().out)
    assert report["version"] == 1
    assert set(report["counts"]) == {"info", "warning", "error"}
    assert report["counts"]["error"] >= 2
    assert report["failing"] == report["counts"]["error"]
    for f in report["findings"]:
        assert {"rule", "severity", "path", "line", "symbol", "message",
                "fingerprint", "new"} <= set(f)
    # accept into the baseline -> clean run
    assert lint_cli.main(["--write-baseline", str(root),
                          "--baseline", baseline]) == 0
    assert lint_cli.main([str(root), "--baseline", baseline]) == 0
    out = str(tmp_path / "report.json")
    assert lint_cli.main([str(root), "--baseline", baseline,
                          "--json-out", out, "--fail-on", "info"]) == 0
    assert json.load(open(out))["new"] == 0


def test_cli_rules_subset_and_unknown(tmp_path, capsys):
    root = _bad_root(tmp_path)
    rc = lint_cli.main(["--rules", "import-cycle", str(root),
                        "--baseline", str(tmp_path / "nb.json")])
    assert rc == 0                       # torch rules not selected
    assert lint_cli.main(["--imports", str(root), "--baseline",
                          str(tmp_path / "nb.json")]) == 0
    with pytest.raises(ValueError):
        lint_cli.main(["--rules", "no-such-rule", str(root)])
    assert lint_cli.main([str(tmp_path / "absent.txt")]) == 2


def test_module_entrypoint_lists_all_twelve_rules():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.lint", "--list-rules"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    listed = {line.split()[0] for line in out.stdout.splitlines()}
    assert listed == RULE_IDS
    assert set(acore.available_rules()) == RULE_IDS


# ---------------------------------------------------------------------------
# Meta: the port obeys its own contracts
# ---------------------------------------------------------------------------


def test_meta_no_error_findings_on_src_repro_torch():
    findings = analyze(Project.load([SRC_PORT]))
    errors = [f for f in findings if f.severity == "error"]
    assert errors == [], "\n".join(f.format() for f in errors)
    serve = [f for f in findings if f"{os.sep}serve{os.sep}" in f.path]
    assert serve == [], "\n".join(f.format() for f in serve)


def test_meta_registries_discovered():
    from repro_torch.analysis.registry_rules import find_registries
    project = Project.load([SRC_PORT])
    by_proto = {r.protocol.name: len(r.implementations)
                for r in find_registries(project)}
    for proto in ("LPEngine", "SamplerStrategy", "RetrievalEngine",
                  "ScoringBackend", "LintRule"):
        assert by_proto.get(proto, 0) >= 2, by_proto
    assert by_proto["LintRule"] == len(RULE_IDS)


def test_meta_baseline_matches_tree():
    """The committed baseline covers every current finding (no drift), and
    the CLI's default run over the tree exits 0 against it."""
    findings = analyze(Project.load([SRC_PORT]))
    baseline = acore.load_baseline(BASELINE)
    fresh = acore.new_findings(findings, baseline)
    assert fresh == [], "\n".join(f.format() for f in fresh)
    assert lint_cli.main([SRC_PORT, "--baseline", BASELINE]) == 0
