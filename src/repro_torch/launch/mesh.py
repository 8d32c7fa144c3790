"""Process-group meshes for the sharded paths (port of
``repro/launch/mesh.py``).

The reference builds a ``jax.sharding.Mesh`` over the devices of one
program. The port runs one process (rank) per device, and its mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks with the
reference's axis names: ``("data", "model")``, ``("pod", "data",
"model")`` across pods.

  * :func:`make_host_mesh` — a 1-rank group on this process's device
    (NCCL on the card, gloo on the CPU), made through an in-process
    ``HashStore`` when no default group exists: no launcher needed; on a
    world of R ranks, a ``(R / model_axis, model_axis)`` mesh (the
    reference's ``(1, model_axis)`` on R devices).
  * :func:`parse_mesh` — the CLIs' ``--mesh``: ``host`` as above; ``auto``
    the world group that ``torchrun`` set up (``RANK``/``WORLD_SIZE`` in
    the environment), shaped ``(world, 1)``, or one rank when none was.
  * :func:`make_production_mesh` / :func:`batch_axes` — the reference's
    shapes; a world of another size raises. :func:`fake_world` makes the
    default group a fake one of 256 or 512 ranks (this process rank 0,
    collectives doing nothing), on which the dry run builds them.

NCCL refuses two ranks on one card, so two ranks that resolve to one card
raise; no other backend is taken in its place. A caller may make the
default group a gloo one for ranks that share a card: the meshes then
take it, and the collectives copy CUDA tensors through the host
(``distributed/collectives.py``). Nothing here runs at import.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.device import resolve_device


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _init_world(device: torch.device, *, env: bool) -> None:
    """Create the default process group for ``device`` if there is none:
    from torchrun's environment (``env``) or as one in-process rank."""
    if dist.is_initialized():
        backend = dist.get_backend()
        if backend != _backend(device) and backend not in ("gloo", "fake"):
            raise RuntimeError(
                f"the default process group runs {dist.get_backend()!r}; a "
                f"mesh on {device.type} needs {_backend(device)!r}")
        return
    backend = _backend(device)
    if env:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local = int(os.environ.get("LOCAL_RANK", rank))
        if device.type == "cuda":
            cards = torch.cuda.device_count()
            if world > cards:
                raise RuntimeError(
                    f"{world} ranks on {cards} card(s): NCCL refuses two "
                    f"ranks on one card; run at most one rank a card")
            torch.cuda.set_device(local)
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world)
    else:
        if device.type == "cuda":
            torch.cuda.set_device(device.index or 0)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


def _mesh(device: torch.device, shape: tuple, names: tuple) -> DeviceMesh:
    world = dist.get_world_size()
    n = 1
    for s in shape:
        n *= s
    if n != world:
        raise ValueError(f"a mesh of shape {shape} {names} needs {n} ranks; "
                         f"the process group has {world}")
    return DeviceMesh(device.type, torch.arange(world).reshape(shape),
                      mesh_dim_names=names)


def make_host_mesh(model_axis: int = 1, device="cuda") -> DeviceMesh:
    """A mesh with the production axis NAMES over the default group's R
    ranks: ``(R / model_axis, model_axis)`` (one rank, made here, when
    there is no group), so the same sharded code runs on one device."""
    dev = resolve_device(device)
    _init_world(dev, env=False)
    data = max(dist.get_world_size() // model_axis, 1)
    return _mesh(dev, (data, model_axis), ("data", "model"))


def fake_world(ranks: int) -> None:
    """Make the default process group a fake one of ``ranks`` ranks with
    this process as rank 0 (an earlier default group is destroyed): its
    collectives return at once and move nothing, so a step on fake
    tensors runs as rank 0 of a production mesh in one process."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=ranks)


def make_production_mesh(*, multi_pod: bool = False,
                         device="cuda") -> DeviceMesh:
    """The reference's layout: (data=16, model=16), or (pod=2, data=16,
    model=16) across pods; the world group must have as many ranks."""
    dev = resolve_device(device)
    _init_world(dev, env="RANK" in os.environ)
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(dev, shape, axes)


def batch_axes(mesh) -> tuple:
    """Mesh axes the global batch is sharded over."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def parse_mesh(name: str, device="cuda") -> DeviceMesh:
    """CLI ``--mesh`` flag -> mesh: ``host`` is the 1-rank mesh with
    production axis names, ``auto`` puts every rank of torchrun's world on
    the data axis (one rank without torchrun)."""
    if name == "host":
        return make_host_mesh(device=device)
    if name == "auto":
        dev = resolve_device(device)
        _init_world(dev, env="RANK" in os.environ
                    and "WORLD_SIZE" in os.environ)
        return _mesh(dev, (dist.get_world_size(), 1), ("data", "model"))
    raise ValueError(f"unknown mesh {name!r}; known meshes: auto, host")


def is_main_rank() -> bool:
    """True on rank 0, or without a process group: the rank that writes a
    CLI's outputs and logs its results."""
    return not dist.is_initialized() or dist.get_rank() == 0
