"""Elastic re-mesh resume + fault-tolerance policies (port of
``repro/train/elastic.py``).

Checkpoints are stored unsharded (train/checkpoint.py), so resuming on a
DIFFERENT mesh (a pod dropped out, or capacity grew) is a pure placement
operation: rebuild the placements for the new mesh and distribute each
leaf. Global batch is preserved by rescaling gradient-accumulation steps.
The mesh is a ``DeviceMesh`` with the reference's axis names.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

from repro_torch.train.checkpoint import restore_checkpoint


@dataclasses.dataclass
class ElasticPlan:
    mesh: Any
    accum_steps: int            # microbatches to keep the global batch fixed
    per_step_batch: int


def plan_for_mesh(mesh, *, global_batch: int, base_data_parallel: int) -> ElasticPlan:
    """Given a (possibly shrunken/grown) mesh, keep the global batch constant
    by trading data-parallel width against gradient-accumulation depth."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    dp = sizes.get("data", 1) * sizes.get("pod", 1)
    accum = max(1, base_data_parallel // dp)
    return ElasticPlan(mesh, accum, global_batch // accum)


def resume_on_mesh(ckpt_dir: str, like: Any, mesh, shardings) -> tuple:
    """Restore the latest checkpoint onto ``mesh`` with ``shardings``
    (placements, a tree matching ``like``). Works regardless of the
    writing mesh."""
    return restore_checkpoint(ckpt_dir, like, shardings=shardings, mesh=mesh)


class StragglerPolicy:
    """Step-deadline straggler mitigation for the synchronous train loop.

    The launcher wraps each step; if wall time exceeds
    ``deadline_factor`` x the rolling median, the step is flagged. After
    ``max_flags`` consecutive flags the runner requests a re-mesh without
    the slow host (in this single-host research harness that surfaces as an
    ElasticPlan with smaller data-parallel width). Deterministic and
    side-effect free so it is unit-testable.
    """

    def __init__(self, deadline_factor: float = 3.0, max_flags: int = 3,
                 window: int = 32):
        self.deadline_factor = deadline_factor
        self.max_flags = max_flags
        self.window = window
        self._times: list = []
        self._flags = 0

    def observe(self, step_seconds: float) -> str:
        """Returns 'ok' | 'flag' | 'remesh'."""
        self._times = (self._times + [step_seconds])[-self.window:]
        med = sorted(self._times)[len(self._times) // 2]
        if len(self._times) >= 5 and step_seconds > self.deadline_factor * med:
            self._flags += 1
            if self._flags >= self.max_flags:
                self._flags = 0
                return "remesh"
            return "flag"
        self._flags = 0
        return "ok"


class HeartbeatMonitor:
    """Host-level liveness: workers call ``beat(worker_id)``; ``dead()``
    reports workers silent for longer than ``timeout_s``. The launcher
    converts dead workers into an elastic re-mesh."""

    def __init__(self, timeout_s: float = 60.0, now: Callable = time.time):
        self.timeout_s = timeout_s
        self._now = now
        self._last: dict = {}

    def beat(self, worker_id: str):
        self._last[worker_id] = self._now()

    def dead(self) -> list:
        t = self._now()
        return [w for w, last in self._last.items()
                if t - last > self.timeout_s]
