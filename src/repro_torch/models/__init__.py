"""Models on PyTorch (port of ``repro.models``): the composable transformer
covering the five LM architectures (dense + MoE, GQA/MQA, RoPE,
sliding-window / chunked attention, GeGLU/SwiGLU, KV-cache serving), which
the retrieval encoder and the serving engine run; four recsys rankers over
a shared EmbeddingBag substrate (``recsys``); and an E(3)-equivariant MACE
(``mace``) with its own spherical-harmonic / Clebsch-Gordan machinery
(``so3``)."""
from repro_torch.models.transformer import (MoEConfig, TransformerConfig,
                                            decode_step, init_kv_cache,
                                            init_transformer, lm_loss,
                                            transformer_forward)

__all__ = ["TransformerConfig", "MoEConfig", "init_transformer",
           "transformer_forward", "lm_loss", "decode_step", "init_kv_cache"]
