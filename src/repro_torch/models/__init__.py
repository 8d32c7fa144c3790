"""Models on PyTorch (port of ``repro.models``): the composable transformer
covering the five LM architectures (dense + MoE, GQA/MQA, RoPE,
sliding-window / chunked attention, GeGLU/SwiGLU, KV-cache serving), which
the retrieval encoder and the serving engine run. The recsys rankers and
MACE wait for ROADMAP.md queue 1 item 15(c)."""
from repro_torch.models.transformer import (MoEConfig, TransformerConfig,
                                            decode_step, init_kv_cache,
                                            init_transformer, lm_loss,
                                            transformer_forward)

__all__ = ["TransformerConfig", "MoEConfig", "init_transformer",
           "transformer_forward", "lm_loss", "decode_step", "init_kv_cache"]
