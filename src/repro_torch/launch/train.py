"""Training launcher (port of ``repro/launch/train.py``): ``--arch <id>``
trains any registry architecture (LM, recsys or MACE) at its REDUCED
config on a 1-rank host mesh, with async checkpoints and resume, on the
card unless ``--device cpu``. The full-width steps are
``launch/cells.build_cell(..., reduced=False)``'s (``chip_smoke.py``
phases 18b and 19b-c train gemma-2b, DCN-v2 and MACE with them).

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm-mlperf \
      --steps 50 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch mace \
      --steps 20 --checkpoint-dir /tmp/ck --device cpu

The initial parameters are the reference's draw, bit for bit: a normal
draw of each leaf from ``np.random.default_rng(seed)`` in JAX's flatten
order (sorted dict keys, list index order), times 0.02 in f32; step
``i``'s batch comes from ``np.random.default_rng(i)`` (int32 leaves
``integers(0, 2)``, bool leaves ones, float leaves normal), so a resumed
run sees the same batches. The default shape is the arch's first train
shape (``train_4k``, ``train_batch``, MACE's ``full_graph_sm``).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_arch, list_archs
from repro_torch.device import resolve_device
from repro_torch.launch.cells import build_cell
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.optimizer import (adamw_init, tree_leaves, tree_map,
                                         tree_unflatten)


def _batch_like(specs, rng, device):
    """A tree of host draws shaped like ``specs`` (``Shaped`` leaves, drawn
    in JAX's flatten order), on ``device``: int32 leaves ``integers(0,
    2)``, bool leaves ones (no draw), float leaves normal in f32 (the
    reference's ``_batch_like``)."""
    def one(s):
        if s.dtype == torch.int32:
            arr = rng.integers(0, 2, size=s.shape).astype(np.int32)
        elif s.dtype == torch.bool:
            arr = np.ones(s.shape, bool)
        else:
            arr = rng.normal(size=s.shape).astype(np.float32)
        return torch.from_numpy(arr).to(device)
    return tree_unflatten(specs, [one(s) for s in tree_leaves(specs)])


def initial_params(cell, seed: int, device):
    """The reference launcher's initial parameters for ``cell``."""
    params = _batch_like(cell.args[0], np.random.default_rng(seed), "cpu")
    return tree_map(lambda x: (x * 0.02).to(device), params)


def step_batch(cell, step: int, device):
    """Step ``step``'s batch: a pure function of the step index."""
    return _batch_like(cell.args[2], np.random.default_rng(step), device)


def main(argv=None) -> list:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True, choices=list_archs())
    p.add_argument("--shape", default=None)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    spec = get_arch(args.arch)
    shape = args.shape or next(s for s, v in spec.shapes.items()
                               if v["kind"].startswith("train"))
    mesh = make_host_mesh(device=device)
    cell = build_cell(args.arch, shape, mesh, reduced=True)
    params = initial_params(cell, args.seed, device)
    opt_state = adamw_init(params)

    cfg = LoopConfig(total_steps=args.steps, log_every=5,
                     checkpoint_every=10, checkpoint_dir=args.checkpoint_dir)
    _, _, losses = train_loop(cell.fn, params, opt_state,
                              lambda step: step_batch(cell, step, device),
                              cfg)
    return losses


if __name__ == "__main__":
    main()
