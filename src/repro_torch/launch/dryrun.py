"""Dry run (port of ``repro/launch/dryrun.py``): build every (architecture x
input-shape) cell from its specs and run its step once on fake tensors,
counting the step's flops and reading the roofline terms, with nothing
allocated.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch dcn-v2 \
      --shape train_batch
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out /tmp/dryrun
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --layers 2
      # every LM cell at 2 layers: a quick check
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh host

Each cell is ``launch/cells.build_cell``'s, on ``--mesh``: ``single`` (the
default: 16 x 16, 256 ranks), ``multi`` (2 x 16 x 16, 512) and ``both`` are
the reference's production layouts, built on a fake process group
(``launch/mesh.fake_world``: this process is rank 0, collectives move
nothing), where each argument is rank 0's shard of its spec (a
``DTensor`` over a fake local tensor) and the step runs rank 0's part of
the model: the LM's Megatron and ZeRO shards, the recsys tables' rows and
MACE's nodes and edges over the grid. ``host`` is the 1-rank mesh (a
gloo group on the CPU, which no step touches). A cell that raises is
recorded as failed, as the reference records a cell that does not
compile. The step runs under ``FakeTensorMode`` (each
argument an empty tensor of its spec's shape and dtype) and
``torch.utils.flop_counter.FlopCounterMode``: the flops are what the
step's matmuls, convolutions and attention calls do (elementwise work is
not counted, where XLA's ``cost_analysis`` counts it too); the retrieval
step's top-k goes through the plain path, whose blocked products are its
2 B nc D flops. ``bytes_per_device`` is rank 0's bytes of the arguments
(the whole on the host mesh), each read once (the least the step can
move); the flops are rank 0's too. The roofline is at the port's H100 constants
(``kernels/tuning.py``): bf16 tensor-core peak for the LM configs, which
compute in bf16, the f32 peak for the others. XLA's own numbers
(``compile_s``, ``generated_code_size``, ``temp_size``, the HLO's
collectives) have no counterpart here and are ``null``.
"""
from __future__ import annotations

import argparse
import json
import logging
import math
import sys
import time
import traceback
from typing import NamedTuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_arch, iter_cells, list_archs
from repro_torch.kernels.tuning import (H100_BF16_FLOPS, H100_BYTES_PER_S,
                                        H100_F32_FLOPS)
from repro_torch.distributed.collectives import axis_group
from repro_torch.distributed.sharding import as_placed, local_shape, to_local
from repro_torch.launch.cells import build_cell
from repro_torch.launch.logs import add_logging_args, setup_logging
from repro_torch.launch.mesh import (fake_world, make_host_mesh,
                                     make_production_mesh)
from repro_torch.train.optimizer import tree_leaves, tree_map

log = logging.getLogger("repro_torch.launch.dryrun")


class MeshShape(NamedTuple):
    """A mesh by its axis names and sizes alone (no process group): what
    a builder reads for its specs."""

    mesh_dim_names: tuple
    shape: tuple

    def size(self) -> int:
        return math.prod(self.shape)


PRODUCTION = {
    "single": ("single-pod-16x16", MeshShape(("data", "model"), (16, 16))),
    "multi": ("multi-pod-2x16x16",
              MeshShape(("pod", "data", "model"), (2, 16, 16))),
}


def _nbytes(tree) -> int:
    return sum(math.prod(t.shape) * t.dtype.itemsize
               for t in tree_leaves(tree) if hasattr(t, "dtype"))


def _local_nbytes(tree, mesh) -> int:
    """Rank 0's bytes of a tree of specs."""
    return sum(math.prod(local_shape(s.shape, mesh, s.placements))
               * s.dtype.itemsize for s in tree_leaves(tree))


def _fake_arg(s, mesh):
    """A fake tensor of a spec: whole on one rank, else rank 0's shard
    placed as a DTensor."""
    if mesh.size() == 1:
        return torch.empty(s.shape, dtype=s.dtype)
    local = torch.empty(local_shape(s.shape, mesh, s.placements),
                        dtype=s.dtype)
    return as_placed(local, mesh, s.placements, s.shape)


def _peak(arch_id: str) -> float:
    """The peak rate of the config's compute dtype."""
    cfg = get_arch(arch_id).make_config()
    return (H100_BF16_FLOPS if getattr(cfg, "dtype", None) == torch.bfloat16
            else H100_F32_FLOPS)


def run_cell(arch_id: str, shape_name: str, mesh, n_chips: int,
             verbose: bool = True, layers: int = None) -> dict:
    t0 = time.time()
    overrides = None
    if layers and get_arch(arch_id).family == "lm":
        overrides = {"n_layers": layers}
    cell = build_cell(arch_id, shape_name, mesh, overrides=overrides)
    with FakeTensorMode():
        args = tree_map(lambda s: _fake_arg(s, mesh), list(cell.args))
        counter = FlopCounterMode(display=False)
        with counter:
            out = cell.fn(*args)
        out_leaves = [to_local(t) for t in tree_leaves(list(out) if isinstance(
            out, tuple) else out) if isinstance(t, torch.Tensor)]
    t_run = time.time() - t0
    flops = float(counter.get_total_flops())
    arg_bytes = _local_nbytes(list(cell.args), mesh)
    res = {
        "arch": arch_id, "shape": shape_name, "n_chips": n_chips,
        "ok": True,
        "lower_s": round(t_run, 1), "compile_s": None,
        "flops_per_device": flops,
        "bytes_per_device": float(arg_bytes),
        "collective_bytes_per_device": None,
        "collectives": None,
        "model_flops_per_step": cell.model_flops_per_step,
        "memory": {
            "argument_size": arg_bytes,
            "output_size": _nbytes(out_leaves),
            "temp_size": None,
            "generated_code_size": None,
        },
        "roofline": {
            "compute_s": flops / _peak(arch_id),
            "memory_s": arg_bytes / H100_BYTES_PER_S,
            "collective_s": None,
        },
    }
    r = res["roofline"]
    r["bottleneck"] = max((k for k in r if r[k] is not None),
                          key=lambda k: r[k])
    total_useful = cell.model_flops_per_step / n_chips
    r["useful_flops_ratio"] = (total_useful / flops) if flops else 0.0
    if verbose:
        log.info("[%s x %s] ok (%.1fs) compute %.2fms memory %.2fms -> %s",
                 arch_id, shape_name, t_run, r["compute_s"] * 1e3,
                 r["memory_s"] * 1e3, r["bottleneck"])
        log.info("    args %.2f GiB/device", arg_bytes / 2**30)
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default=None, choices=list_archs())
    p.add_argument("--shape", default=None)
    p.add_argument("--all", action="store_true")
    p.add_argument("--mesh", default="single",
                   choices=["host", "single", "multi", "both"],
                   help="single (the default), multi and both: the "
                        "production layouts on 256 and 512 fake ranks, "
                        "every cell run as rank 0 on its shards; host: "
                        "the 1-rank mesh")
    p.add_argument("--out", default=None, help="write JSON results here")
    p.add_argument("--layers", type=int, default=None,
                   help="cut every LM config to this many layers (a quick "
                        "check that each cell runs; the numbers are then "
                        "the cut model's)")
    add_logging_args(p)
    args = p.parse_args(argv)
    setup_logging(args)

    meshes = []
    if args.mesh == "host":
        meshes.append(("host-1x1", lambda: make_host_mesh(device="cpu"), 1))
    for key, multi in (("single", False), ("multi", True)):
        if args.mesh in (key, "both"):
            name, shape = PRODUCTION[key]
            meshes.append((name, lambda m=multi, n=shape.size(): (
                fake_world(n), make_production_mesh(multi_pod=m,
                                                    device="cpu"))[1],
                shape.size()))

    cells = (list(iter_cells()) if args.all or not args.arch
             else [(args.arch, s) for s in
                   (get_arch(args.arch).shapes if not args.shape
                    else [args.shape])
                   if s not in get_arch(args.arch).skip_shapes])

    results = []
    failures = 0
    for mesh_name, make_mesh, n_chips in meshes:
        mesh = make_mesh()
        # every group of axes a step may reduce over, made before the
        # steps run on fake tensors (a group's ranks are real ones)
        names = mesh.mesh_dim_names
        for pick in range(1, 2 ** len(names)):
            axis_group(mesh, tuple(n for i, n in enumerate(names)
                                   if pick >> i & 1))
        log.info("=== mesh %s (%d ranks) ===", mesh_name, n_chips)
        for arch_id, shape_name in cells:
            try:
                res = run_cell(arch_id, shape_name, mesh, n_chips,
                               layers=args.layers)
            except Exception as e:
                failures += 1
                traceback.print_exc()
                res = {"arch": arch_id, "shape": shape_name, "ok": False,
                       "mesh": mesh_name, "error": repr(e)[:500]}
            res["mesh"] = mesh_name
            res["layers"] = args.layers
            results.append(res)
            if args.out:
                with open(args.out + ".json", "w") as f:
                    json.dump(results, f, indent=2)
    log.info("%d/%d cells ran", len(results) - failures, len(results))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
