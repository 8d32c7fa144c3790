"""Fault-tolerant training loop (port of ``repro/train/loop.py``): a step
function + async checkpoints + straggler policy + resume. Used by
launch/train.py. On R ranks every rank runs the loop (its saves are
collectives: train/checkpoint.py) and only rank 0 prints.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.train.checkpoint import (AsyncCheckpointer, is_writer,
                                          latest_step, restore_checkpoint)
from repro_torch.train.elastic import StragglerPolicy


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    log_every: int = 10
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    keep_checkpoints: int = 3


def _wait(loss: torch.Tensor) -> None:
    """The reference's ``block_until_ready``: the step's work is done on
    the loss's device."""
    if loss.device.type == "cuda":
        torch.cuda.synchronize(loss.device)


def _any_rank(flag: bool) -> bool:
    """``flag`` on any rank of the default group (every rank calls it), so
    ranks that time their steps apart still save together."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return flag
    dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
    t = torch.tensor([int(flag)], device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def train_loop(step_fn: Callable, params: Any, opt_state: Any,
               batch_fn: Callable[[int], Any], cfg: LoopConfig,
               *, metrics_cb: Optional[Callable] = None) -> tuple:
    """Runs ``step_fn(params, opt_state, batch) -> (params, opt_state, loss)``
    for cfg.total_steps, resuming from the latest checkpoint if present.
    The data order is a pure function of the step index, so restarts are
    exactly-once without an iterator checkpoint. A step may write its
    results into the tensors it was given (a donating step): every save
    copies them to the host before the next step runs."""
    start = 0
    ckpt = None
    if cfg.checkpoint_dir:
        ckpt = AsyncCheckpointer(cfg.checkpoint_dir, keep=cfg.keep_checkpoints)
        last = latest_step(cfg.checkpoint_dir)
        if last is not None:
            (params, opt_state), start = restore_checkpoint(
                cfg.checkpoint_dir, (params, opt_state))
            if is_writer():
                print(f"resumed from step {start}")

    policy = StragglerPolicy()
    losses = []
    for step in range(start, cfg.total_steps):
        t0 = time.time()
        batch = batch_fn(step)
        params, opt_state, loss = step_fn(params, opt_state, batch)
        _wait(loss)
        status = policy.observe(time.time() - t0)
        if _any_rank(status == "remesh"):
            if is_writer():
                print(f"step {step}: persistent straggler -> snapshot + "
                      f"remesh requested (see train/elastic.py)")
            if ckpt:
                ckpt.save(step + 1, (params, opt_state))
        losses.append(float(loss))
        if cfg.log_every and step % cfg.log_every == 0 and is_writer():
            print(f"step {step}: loss {float(loss):.4f} "
                  f"({time.time() - t0:.2f}s)", flush=True)
        if ckpt and (step + 1) % cfg.checkpoint_every == 0:
            ckpt.save(step + 1, (params, opt_state))
    if ckpt:
        ckpt.save(cfg.total_steps, (params, opt_state))
        ckpt.close()
    return params, opt_state, losses
