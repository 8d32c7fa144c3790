"""Training on PyTorch (port of ``repro.train``): the AdamW and Adafactor
optimizers. The training loop, checkpoints and elastic restarts are not
ported yet (ROADMAP.md queue 1 item 15)."""
