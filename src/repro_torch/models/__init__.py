"""Models on PyTorch (port of ``repro.models``): the dense transformer's
forward path, which the retrieval encoder runs. ``lm_loss``,
``decode_step`` and ``init_kv_cache`` wait for ROADMAP.md queue 1 item
15."""
from repro_torch.models.transformer import (MoEConfig, TransformerConfig,
                                            init_transformer,
                                            transformer_forward)

__all__ = ["TransformerConfig", "MoEConfig", "init_transformer",
           "transformer_forward"]
