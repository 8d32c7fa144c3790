"""gemma-2b [dense]: 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000
— GeGLU, head_dim=256, embeddings scaled by sqrt(d_model), tied LM head.
[arXiv:2403.08295; hf]

Pure full attention -> long_500k SKIPPED (DESIGN.md §5).
"""
import torch

from repro_torch.configs import ArchSpec, LM_SHAPES
from repro_torch.models.transformer import TransformerConfig


def make_config() -> TransformerConfig:
    return TransformerConfig(
        vocab_size=256_000, d_model=2048, n_layers=18, n_heads=8,
        n_kv_heads=1, d_head=256, d_ff=16_384,
        activation="geglu", rope_theta=10_000.0, causal=True,
        tie_embeddings=True, embed_scale=True,
        dtype=torch.bfloat16, remat="full",
    )


def make_reduced() -> TransformerConfig:
    return TransformerConfig(
        vocab_size=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=1,
        d_head=32, d_ff=128, activation="geglu", causal=True,
        tie_embeddings=True, embed_scale=True, dtype=torch.float32)


SPEC = ArchSpec(
    arch_id="gemma-2b", family="lm",
    make_config=make_config, make_reduced=make_reduced,
    shapes=LM_SHAPES, skip_shapes=("long_500k",),
    notes="MQA (kv=1), GeGLU, head_dim 256; full attention -> long_500k skipped",
)
