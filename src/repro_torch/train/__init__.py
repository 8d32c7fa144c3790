"""Training on PyTorch (port of ``repro.train``): the AdamW and Adafactor
optimizers (AdamW also on donated state, written in place), checkpoints
written on a background thread and published by an atomic rename, elastic
re-mesh resume and the straggler policy, and the fault-tolerant train
loop (``train/loop.py``)."""
from repro_torch.train.checkpoint import (AsyncCheckpointer, latest_step,
                                          restore_checkpoint, save_checkpoint)
from repro_torch.train.optimizer import (AdafactorConfig, AdamWConfig,
                                         adafactor_init, adafactor_update,
                                         adamw_init, adamw_update)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "AdafactorConfig",
           "adafactor_init", "adafactor_update", "save_checkpoint",
           "restore_checkpoint", "latest_step", "AsyncCheckpointer"]
