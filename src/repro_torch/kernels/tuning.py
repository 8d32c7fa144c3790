"""Kernel autotuner — ask/tell hillclimb over what the port's CUDA kernels
can vary at run time (port of ``repro/kernels/tuning.py``; DESIGN.md §11).

The reference tunes its Pallas kernels' block shapes. The port's kernels
fix their tiles when they are compiled (``csrc/*.cu``), and a tile other
than the compiled one is not a slower launch but a wrong one: each block
finds its rows by the compiled constants. So every tile appears in its
kernel's :class:`TuningSpace` with its one compiled value, and
:func:`resolve` rejects any other. What does vary at run time is the split
plan of the dense and Hamming top-k kernels (``topk_scoring/ops.dense_plan``
and ``split_plan``): how many splits the corpus's row tiles are cut into,
from a target block count (``split_blocks``). A split only changes which
block scans which tiles, never a score or the merge's order, so results are
the same for every candidate.

* :data:`SPACES` — one :class:`TuningSpace` per kernel primitive (``topk``,
  ``hamming_topk``, ``gathered_topk``, ``label_prop_round``); only ``topk``
  and ``hamming_topk`` have more than one point.
* :class:`HillclimbTuner` — a DeepHyper-style ask/tell optimizer: ``ask()``
  proposes the next untried candidate (the default point first, then
  one-axis neighbours of the incumbent best), ``tell(point, score)`` records
  a measurement and re-seeds the frontier when the incumbent improves.
* :func:`measure` — scores one candidate on the card over a cell's traffic:
  the device time, by CUDA events (``obs/timing.cuda_ms``), that the calls
  the workload made in that cell take, beside the least time the card
  could take for the same work (``compute_ms``, ``memory_ms``: the calls'
  operation and byte counts at the H100 data-sheet peaks below). It raises
  on a host with no card.
* :func:`launched_traffic` — the traffic to tune for: the (Q, N, D, k) of
  every launch of a tunable kernel, counted by the kernels themselves
  (``build.Kernel.shapes``). The reference measures each bucket at one
  representative size (:func:`bucket_rep_size`); here a bucket is measured
  at the calls the workload made in it, because the best split target
  moves within a bucket (``gt65536`` spans 1.3e5 to 5.2e5 rows on the
  evaluation path), and a bucket the workload never reached gets no entry.
* :class:`TunedTable` — the persisted winners, keyed by
  ``(kernel, corpus-size bucket, dtype)``. :func:`autotune` writes
  ``results/tuned_kernels_torch.json`` by default. No default table ships:
  a TPU table's shapes say nothing of this card, and a port table is
  committed only as :func:`autotune` wrote it on the card (its ``meta``
  names the card, its power limit and the traffic it was tuned for).

Dispatch-time lookup order (what every ``kernels/*/ops.py`` wrapper applies
via :func:`resolve`):

  explicit kwarg  >  tuned table entry  >  hard-coded default

With no table every launch is the one the defaults give. A table is used
only when asked for: the ``REPRO_TORCH_TUNED_KERNELS`` env var names its
path (``off``/``0``/``none`` or unset: the hard-coded defaults), read once
per process; nothing is loaded from the working directory. ``set_table`` /
``reset_table`` override it in process (tests, ``autotune``'s activation,
the ``--no-tuned-kernels`` CLI flag). The reference's
``REPRO_TUNED_KERNELS`` and its tables never feed the port.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import json
import os
import subprocess
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import timing as obs_timing
from repro_torch.obs import trace as obs_trace

ENV_VAR = "REPRO_TORCH_TUNED_KERNELS"

# NVIDIA H100 SXM data-sheet peaks (dense, at the 700 W limit) for the
# roofline terms. They live here, at the bottom of the port's kernel
# stack, so the autotuner and chip_smoke.py read the same numbers.
H100_BYTES_PER_S = 3.35e12      # HBM3
H100_F32_FLOPS = 67e12          # f32 outside the tensor cores
H100_TF32_FLOPS = 495e12        # TF32, tensor cores: an f32-accurate
                                # product takes three of them (3xTF32)
H100_INT8_OPS = 1979e12         # int8, tensor cores
H100_BF16_FLOPS = 989e12        # bf16, tensor cores
# 32-bit popc: 16 results a clock an SM on compute capability 9.0 (the
# CUDA C++ Programming Guide's arithmetic-instruction table), 132 SMs at
# the 1.98 GHz boost clock; chip_smoke.py measures the rate the card
# reaches (tools/mma_rate.popc_rate)
H100_POPC_PER_S = 16 * 132 * 1.98e9

RESULTS_TABLE_PATH = os.path.join("results", "tuned_kernels_torch.json")

#: the launches of today's wrappers: the compiled tiles (which must equal
#: DENSE_QUERIES/DENSE_ROWS, HAMMING_QUERIES/HAMMING_ROWS and
#: TILE_ROWS/TILE_PIECES in the ops modules, kWarpsPerBlock/kNodes in
#: csrc/lp_round.cu; tests/test_torch_tuning.py pins them) and the split
#: plans' target block counts (DENSE_BLOCKS, HAMMING_BLOCKS)
DEFAULTS: Dict[str, Dict[str, int]] = {
    "topk": {"block_q": 128, "block_n": 128, "split_blocks": 132},
    "hamming_topk": {"block_q": 32, "block_n": 128, "split_blocks": 528},
    "gathered_topk": {"tile_rows": 128, "tile_pieces": 32},
    "label_prop_round": {"warps_per_block": 8, "nodes_per_warp": 4},
}

#: the one parameter a launch may change; every other one is compiled in
RUNTIME_PARAM = "split_blocks"

#: corpus-size bucket upper bounds (rows scored per call), ascending
SIZE_BUCKETS: Tuple[Tuple[int, str], ...] = (
    (1024, "le1024"), (4096, "le4096"), (16384, "le16384"),
    (65536, "le65536"),
)
_OVERFLOW_BUCKET = "gt65536"


def size_bucket(n: int) -> str:
    """Corpus-size bucket name for an n-row scoring call."""
    for bound, name in SIZE_BUCKETS:
        if n <= bound:
            return name
    return _OVERFLOW_BUCKET


def bucket_rep_size(bucket: str) -> int:
    """The reference's representative row count for a bucket (its upper
    bound; 2x the last bound for the overflow bucket). The port's tuner
    measures a bucket at the calls it saw there instead
    (:func:`launched_traffic`)."""
    for bound, name in SIZE_BUCKETS:
        if name == bucket:
            return bound
    return SIZE_BUCKETS[-1][0] * 2


def dtype_str(dtype: Any) -> str:
    """Canonical dtype key ('float32', 'int8', ...) from a torch or numpy
    dtype or a str."""
    if isinstance(dtype, str):
        return dtype
    text = str(dtype)
    if text.startswith("torch."):
        return text[len("torch."):]
    import numpy as np
    return np.dtype(dtype).name


def roofline(n_bytes: float, n_ops: float,
             peak_ops: float) -> Dict[str, float]:
    """The least times (ms) the card could take for a call that moves
    ``n_bytes`` (each input read once, each output written once) and does
    ``n_ops`` operations at ``peak_ops`` a second."""
    return {"compute_ms": n_ops / peak_ops * 1e3,
            "memory_ms": n_bytes / H100_BYTES_PER_S * 1e3}


# ---------------------------------------------------------------------------
# Tuning space + ask/tell hillclimb
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TuningSpace:
    """Candidate axes for one kernel primitive: param -> ascending values."""

    kernel: str
    axes: Mapping[str, Tuple[int, ...]]

    def candidates(self):
        """Every point of the cross product, as param dicts."""
        names = list(self.axes)
        for combo in itertools.product(*(self.axes[a] for a in names)):
            yield dict(zip(names, combo))

    def default_point(self) -> Dict[str, int]:
        """The hard-coded default, snapped to the nearest axis value."""
        point = {}
        for name, values in self.axes.items():
            want = DEFAULTS[self.kernel].get(name, values[0])
            point[name] = min(values, key=lambda v: abs(v - want))
        return point

    def neighbours(self, point: Mapping[str, int]):
        """One-axis steps up/down from ``point`` (the hillclimb moves)."""
        for name, values in self.axes.items():
            i = values.index(point[name])
            for j in (i - 1, i + 1):
                if 0 <= j < len(values):
                    yield {**point, name: values[j]}


SPACES: Dict[str, TuningSpace] = {
    # the dense kernels hold one block an SM (132 on an H100) in clusters
    # of two: half the card, one wave, two and four waves of blocks
    "topk": TuningSpace("topk", {
        "block_q": (128,), "block_n": (128,),
        "split_blocks": (66, 132, 264, 528),
    }),
    "hamming_topk": TuningSpace("hamming_topk", {
        "block_q": (32,), "block_n": (128,),
        "split_blocks": (132, 264, 528, 1056),
    }),
    "gathered_topk": TuningSpace("gathered_topk", {
        "tile_rows": (128,), "tile_pieces": (32,),
    }),
    "label_prop_round": TuningSpace("label_prop_round", {
        "warps_per_block": (8,), "nodes_per_warp": (4,),
    }),
}

#: which dtypes each primitive is tuned for (the dispatch key's third axis)
KERNEL_DTYPES: Dict[str, Tuple[str, ...]] = {
    "topk": ("float32", "int8"),
    "hamming_topk": ("int32",),
    "gathered_topk": ("float32",),
    "label_prop_round": ("float32",),
}


def _key(point: Mapping[str, int]) -> Tuple[Tuple[str, int], ...]:
    return tuple(sorted(point.items()))


class HillclimbTuner:
    """Ask/tell hillclimb over one :class:`TuningSpace`.

    The optimizer-side half of the DeepHyper ask/tell loop: the driver owns
    measurement, the tuner owns the frontier. ``ask()`` returns the next
    untried candidate or ``None`` once every neighbour of the incumbent has
    been measured (converged); ``tell()`` records a score (lower = better)
    and, on improvement, pushes the new incumbent's neighbours.
    """

    def __init__(self, space: TuningSpace, *,
                 start: Optional[Mapping[str, int]] = None):
        self.space = space
        first = dict(start) if start is not None else space.default_point()
        self._frontier = [first]
        self._asked = set()
        self.results: Dict[Tuple, float] = {}
        self.best: Optional[Dict[str, int]] = None
        self.best_score = float("inf")

    def ask(self) -> Optional[Dict[str, int]]:
        while self._frontier:
            point = self._frontier.pop(0)
            k = _key(point)
            if k not in self._asked:
                self._asked.add(k)
                return point
        return None

    def tell(self, point: Mapping[str, int], score: float) -> None:
        self.results[_key(point)] = score
        if score < self.best_score:
            self.best, self.best_score = dict(point), score
            self._frontier.extend(self.space.neighbours(point))

    @property
    def num_evals(self) -> int:
        return len(self.results)


# ---------------------------------------------------------------------------
# Candidate measurement on the card
# ---------------------------------------------------------------------------

#: a call's shape: (queries, corpus rows, row width: D, or W words, k)
Shape = Tuple[int, int, int, int]

#: the tunable cells' kernels, by (kernel, dtype): their launch counters'
#: first four integer arguments are a call's :data:`Shape`
TUNED_LAUNCHES: Dict[Tuple[str, str], str] = {
    ("topk", "float32"): "topk_partial",
    ("topk", "int8"): "topk_int8_partial",
    ("hamming_topk", "int32"): "hamming_topk",
}


def launched_traffic(shapes: Optional[Mapping[str, Mapping]] = None
                     ) -> Dict[Tuple[str, str], "collections.Counter"]:
    """The calls the tunable kernels were launched with: (kernel, dtype) ->
    Counter of :data:`Shape` -> launches. ``shapes`` maps a launch
    counter's name to its counts by integer arguments (as
    ``build.Kernel.shapes`` keeps them); by default each kernel's own
    counts, every launch of this process since they were cleared."""
    if shapes is None:
        from repro_torch.kernels.lsh_hamming import ops as lsh_ops
        from repro_torch.kernels.topk_scoring import ops as topk_ops
        shapes = {k.name: k.shapes for k in (
            topk_ops.TOPK_PARTIAL, topk_ops.TOPK_INT8_PARTIAL,
            lsh_ops.HAMMING_TOPK)}
    traffic = {}
    for cell, name in TUNED_LAUNCHES.items():
        calls = collections.Counter()
        for args, count in shapes.get(name, {}).items():
            calls[tuple(args[:4])] += count
        if calls:
            traffic[cell] = calls
    return traffic


class Bench:
    """One (kernel, dtype) cell's calls, ``{shape: launches}``. Inputs are
    made on the card from a fixed seed at first use, one corpus for each
    (N, D) the calls share, so a tuner can be driven without a card when
    ``measure`` is replaced."""

    def __init__(self, kernel: str, dtype: str, calls: Mapping[Shape, int]):
        if (kernel, dtype) not in TUNED_LAUNCHES:
            raise ValueError(
                f"nothing to tune for {kernel!r} [{dtype}]: its tiles are "
                f"compiled in; tunable: {sorted(TUNED_LAUNCHES)}")
        if not calls:
            raise ValueError(f"no calls to tune {kernel!r} [{dtype}] at")
        self.kernel, self.dtype = kernel, dtype
        self.calls = dict(calls)
        self._inputs: Dict[Tuple[int, int], Any] = {}

    def work(self) -> Tuple[float, float, float]:
        """(bytes, operations, peak operations a second) of the calls,
        each counted as often as it was launched."""
        if self.kernel == "hamming_topk":          # W popcounts a pair
            item, ops_a_term, peak = 4, 1.0, H100_POPC_PER_S
        elif self.dtype == "int8":
            item, ops_a_term, peak = 1, 2.0, H100_INT8_OPS
        else:                                      # 3xTF32 products
            item, ops_a_term, peak = 4, 3 * 2.0, H100_TF32_FLOPS
        n_bytes = sum(count * ((q + n) * d * item + q * k * 8)
                      for (q, n, d, k), count in self.calls.items())
        n_ops = sum(count * ops_a_term * q * n * d
                    for (q, n, d, k), count in self.calls.items())
        return n_bytes, n_ops, peak

    def inputs(self, rows: int, width: int):
        """``rows`` x ``width`` rows of the cell's dtype on the card (the
        queries are the corpus's first rows)."""
        key = (rows, width)
        if key not in self._inputs:
            import torch
            g = torch.Generator(device="cuda").manual_seed(0)
            if self.dtype == "float32":
                x = torch.randn(rows, width, generator=g, device="cuda")
            else:
                lo, hi = ((-127, 128) if self.dtype == "int8"
                          else (-2 ** 31, 2 ** 31 - 1))
                x = torch.randint(lo, hi, (rows, width), generator=g,
                                  device="cuda",
                                  dtype=getattr(torch, self.dtype))
            self._inputs[key] = x
        return self._inputs[key]

    def run(self, shape: Shape, point: Mapping[str, int]):
        """One call of the kernel's wrapper at ``shape`` and ``point`` (its
        tiles are the compiled ones; the wrapper takes the split
        target)."""
        q, n, d, k = shape
        corpus = self.inputs(max(n, q), d)
        if self.kernel == "hamming_topk":
            from repro_torch.kernels.lsh_hamming import ops as lsh_ops
            fn = lsh_ops.hamming_topk
        else:
            from repro_torch.kernels.topk_scoring import ops as topk_ops
            fn = (topk_ops.topk_scores_int8 if self.dtype == "int8"
                  else topk_ops.topk_scores)
        return fn(corpus[:q], corpus[:n], k=k,
                  split_blocks=point[RUNTIME_PARAM])


def measure(bench: Bench, point: Mapping[str, int], *,
            iters: int = 10) -> Dict[str, float]:
    """Score one candidate on the card: ``ms`` is the device time the
    cell's calls take, each call's mean by CUDA events after a warm-up
    times its launches, and is ``score_ms``; ``compute_ms`` and
    ``memory_ms`` are the same calls' operations and bytes at the
    data-sheet peaks. Raises on a host with no card."""
    ms = sum(count * obs_timing.cuda_ms(
        lambda shape=shape: bench.run(shape, point), iters)
        for shape, count in bench.calls.items())
    n_bytes, n_ops, peak = bench.work()
    return {**roofline(n_bytes, n_ops, peak), "ms": ms, "score_ms": ms}


def tune_kernel(kernel: str, *, calls: Mapping[Shape, int], dtype: str,
                space: Optional[TuningSpace] = None, max_evals: int = 12,
                iters: int = 10, verbose: bool = False
                ) -> Tuple[Dict[str, int], float, int]:
    """Hillclimb one (kernel, dtype) cell over its ``calls`` ({shape:
    launches}); returns (best params, best score_ms, evals)."""
    bench = Bench(kernel, dtype, calls)
    tuner = HillclimbTuner(space or SPACES[kernel])
    while tuner.num_evals < max_evals:
        point = tuner.ask()
        if point is None:
            break
        score = measure(bench, point, iters=iters)["score_ms"]
        tuner.tell(point, score)
        if verbose:
            print(f"    {kernel}[{dtype}] {point} -> {score:.4f}ms")
    assert tuner.best is not None
    return tuner.best, tuner.best_score, tuner.num_evals


# ---------------------------------------------------------------------------
# Persisted TunedConfig table
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TunedConfig:
    kernel: str
    bucket: str
    dtype: str
    params: Tuple[Tuple[str, int], ...]   # sorted items, hashable
    score_ms: float = 0.0
    evals: int = 0

    def params_dict(self) -> Dict[str, int]:
        return dict(self.params)


@dataclasses.dataclass
class TunedTable:
    """(kernel, bucket, dtype) -> TunedConfig, with provenance metadata."""

    entries: Dict[Tuple[str, str, str], TunedConfig] = dataclasses.field(
        default_factory=dict)
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def add(self, cfg: TunedConfig) -> None:
        self.entries[(cfg.kernel, cfg.bucket, cfg.dtype)] = cfg

    def lookup(self, kernel: str, bucket: str, dtype: str
               ) -> Dict[str, int]:
        cfg = self.entries.get((kernel, bucket, dtype))
        return cfg.params_dict() if cfg is not None else {}

    def to_json(self) -> dict:
        return {"meta": self.meta,
                "entries": [{"kernel": c.kernel, "bucket": c.bucket,
                             "dtype": c.dtype, "params": c.params_dict(),
                             "score_ms": c.score_ms, "evals": c.evals}
                            for c in sorted(
                                self.entries.values(),
                                key=lambda c: (c.kernel, c.bucket,
                                               c.dtype))]}

    @classmethod
    def from_json(cls, data: dict) -> "TunedTable":
        table = cls(meta=dict(data.get("meta", {})))
        for e in data.get("entries", []):
            table.add(TunedConfig(
                kernel=e["kernel"], bucket=e["bucket"], dtype=e["dtype"],
                params=tuple(sorted((k, int(v))
                                    for k, v in e["params"].items())),
                score_ms=float(e.get("score_ms", 0.0)),
                evals=int(e.get("evals", 0))))
        return table

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2)

    @classmethod
    def load(cls, path: str) -> "TunedTable":
        with open(path) as f:
            return cls.from_json(json.load(f))


# active table: resolved once per process, overridable (tests, CLI flags)
_ACTIVE: list = []


def _load_active() -> TunedTable:
    env = os.environ.get(ENV_VAR, "")
    if env.strip().lower() in ("", "0", "off", "none"):
        return TunedTable()              # the hard-coded defaults
    return TunedTable.load(env)


def get_table() -> TunedTable:
    if not _ACTIVE:
        _ACTIVE.append(_load_active())
    return _ACTIVE[0]


def set_table(table: Optional[TunedTable]) -> None:
    """Override the active table in-process (``None`` = empty table, i.e.
    force the hard-coded defaults — the CLI ``--no-tuned-kernels`` hatch)."""
    _ACTIVE[:] = [table if table is not None else TunedTable()]


def reset_table() -> None:
    """Drop the in-process table so the next lookup re-reads the env
    var."""
    _ACTIVE.clear()


def lookup(kernel: str, *, n: int, dtype: Any) -> Dict[str, int]:
    """Tuned params for an n-row call, or {} when none recorded."""
    return get_table().lookup(kernel, size_bucket(n), dtype_str(dtype))


# Observability (DESIGN.md §12): every resolve() bumps the tuned-table
# hit/miss counters, and — while tracing is enabled — appends the concrete
# resolution to a bounded log so the span wrapping the dispatch (e.g.
# SearchSession's per-chunk span) can attach the block choice as attrs.
_RESOLUTION_LOG: "collections.deque" = collections.deque(maxlen=512)
_RESOLUTION_SEQ = itertools.count()


def resolution_mark() -> int:
    """Opaque mark; pass to :func:`resolutions_since` to read back every
    resolution that happened after it (tracing-enabled only)."""
    return next(_RESOLUTION_SEQ)


def resolutions_since(mark: int) -> list:
    """Resolution records (kernel, bucket, dtype, params, tuned) logged
    after ``mark``; empty when tracing is disabled or nothing dispatched."""
    return [rec for seq, rec in _RESOLUTION_LOG if seq >= mark]


def _check(kernel: str, name: str, value: int) -> None:
    if name == RUNTIME_PARAM:
        if value < 1:
            raise ValueError(f"kernel {kernel!r}: {name}={value} must be "
                             f">= 1")
    elif value != DEFAULTS[kernel][name]:
        raise ValueError(
            f"kernel {kernel!r}: {name}={value} is not the compiled "
            f"{DEFAULTS[kernel][name]}; its tiles are fixed in csrc/ and "
            f"another value would launch a wrong kernel")


def resolve(kernel: str, *, n: int, dtype: Any,
            **explicit: Optional[int]) -> Dict[str, int]:
    """Final launch params for one dispatch: explicit kwarg > tuned table >
    hard-coded default. ``None`` explicit values mean 'not specified'. A
    compiled tile other than the kernel's own, from either, raises."""
    params = dict(DEFAULTS[kernel])
    tuned = lookup(kernel, n=n, dtype=dtype)
    obs_metrics.REGISTRY.counter(
        "tuning.resolve.hit" if tuned else "tuning.resolve.miss").inc()
    for name, value in itertools.chain(
            tuned.items(),
            ((k, v) for k, v in explicit.items() if v is not None)):
        if name not in params:
            raise ValueError(f"kernel {kernel!r} has no block param "
                             f"{name!r}; known: {', '.join(params)}")
        _check(kernel, name, int(value))
        params[name] = int(value)
    if obs_trace.is_enabled():
        _RESOLUTION_LOG.append((next(_RESOLUTION_SEQ), {
            "kernel": kernel, "bucket": size_bucket(n),
            "dtype": dtype_str(dtype), "params": dict(params),
            "tuned": bool(tuned)}))
    return params


# ---------------------------------------------------------------------------
# End-to-end autotune driver
# ---------------------------------------------------------------------------


def _power_limit() -> Optional[str]:
    """The card's power limit as nvidia-smi reports it, else None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


def autotune(kernels: Optional[Sequence[str]] = None, *,
             traffic: Optional[Mapping[Tuple[str, str], Mapping]] = None,
             buckets: Optional[Sequence[str]] = None,
             dtypes: Optional[Mapping[str, Sequence[str]]] = None,
             max_evals: int = 12, iters: int = 10,
             out_path: Optional[str] = RESULTS_TABLE_PATH,
             activate: bool = True, verbose: bool = True) -> TunedTable:
    """Tune every (kernel, bucket, dtype) cell that ``traffic`` reaches on
    the card, persist the winners, and (by default) make the new table the
    active dispatch table. ``traffic`` is (kernel, dtype) -> {shape:
    launches}, by default :func:`launched_traffic`: the calls this process
    has launched, so a workload is run first and tuned after. ``kernels``
    defaults to those with a runtime axis (``topk``, ``hamming_topk``); a
    bucket with no call gets no entry. Raises on a host with no card, and
    when the traffic reaches no cell."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("autotune measures on the card, and "
                           "torch.cuda.is_available() is False")
    traffic = launched_traffic() if traffic is None else traffic
    kernels = (list(kernels) if kernels is not None else
               sorted({k for k, _ in TUNED_LAUNCHES}))
    buckets = (list(buckets) if buckets is not None
               else [name for _, name in SIZE_BUCKETS] + [_OVERFLOW_BUCKET])
    cells = []
    for kernel in kernels:
        for dt in (dtypes or KERNEL_DTYPES)[kernel]:
            by_bucket: Dict[str, Dict[Shape, int]] = {}
            for shape, count in traffic.get((kernel, dt), {}).items():
                by_bucket.setdefault(size_bucket(shape[1]), {})[
                    tuple(shape)] = count
            cells += [(kernel, bucket, dt, by_bucket[bucket])
                      for bucket in buckets if bucket in by_bucket]
    if not cells:
        raise ValueError(
            f"no launch of {kernels} in buckets {buckets} to tune for: run "
            f"the workload in this process first, or pass traffic")
    table = TunedTable(meta={
        **obs_timing.provenance(), "power_limit": _power_limit(),
        "max_evals": max_evals, "iters": iters,
        "traffic": [[kernel, dt, *shape, count]
                    for kernel, _, dt, calls in cells
                    for shape, count in sorted(calls.items())],
        "generated_by": "repro_torch.kernels.tuning.autotune",
    })
    for kernel, bucket, dt, calls in cells:
        if verbose:
            print(f"  tuning {kernel} [{bucket}, {dt}] over {len(calls)} "
                  f"shapes, {sum(calls.values())} launches...")
        params, score, evals = tune_kernel(
            kernel, calls=calls, dtype=dt, max_evals=max_evals, iters=iters,
            verbose=verbose)
        table.add(TunedConfig(
            kernel=kernel, bucket=bucket, dtype=dt,
            params=tuple(sorted(params.items())),
            score_ms=round(score, 4), evals=evals))
        if verbose:
            print(f"  -> {kernel}[{bucket},{dt}] best={params} "
                  f"({score:.4f}ms, {evals} evals)")
    if out_path:
        table.save(out_path)
        if verbose:
            print(f"wrote {out_path} ({len(table.entries)} entries)")
    if activate:
        set_table(table)
    return table
