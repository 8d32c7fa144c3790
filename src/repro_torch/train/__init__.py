"""Training on PyTorch (port of ``repro.train``): the AdamW and Adafactor
optimizers. The training loop, checkpoints and elastic restarts are not
ported yet (ROADMAP.md queue 1 item 15)."""
from repro_torch.train.optimizer import (AdafactorConfig, AdamWConfig,
                                         adafactor_init, adafactor_update,
                                         adamw_init, adamw_update)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "AdafactorConfig",
           "adafactor_init", "adafactor_update"]
