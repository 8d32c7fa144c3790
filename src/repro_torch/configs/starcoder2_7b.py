"""starcoder2-7b [dense]: 32L d_model=4608 36H (GQA kv=4) d_ff=18432
vocab=49152 — GQA, RoPE. [arXiv:2402.19173; hf]

Assigned as a pure full-attention dense arch -> long_500k is SKIPPED
(DESIGN.md §5: sub-quadratic attention required for that cell).
"""
import torch

from repro_torch.configs import ArchSpec, LM_SHAPES
from repro_torch.models.transformer import TransformerConfig


def make_config() -> TransformerConfig:
    return TransformerConfig(
        vocab_size=49_152, d_model=4608, n_layers=32, n_heads=36,
        n_kv_heads=4, d_head=128, d_ff=18_432,
        activation="gelu", rope_theta=100_000.0, causal=True,
        dtype=torch.bfloat16, remat="full",
    )


def make_reduced() -> TransformerConfig:
    return TransformerConfig(
        vocab_size=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_head=16, d_ff=128, activation="gelu", causal=True,
        dtype=torch.float32)


SPEC = ArchSpec(
    arch_id="starcoder2-7b", family="lm",
    make_config=make_config, make_reduced=make_reduced,
    shapes=LM_SHAPES, skip_shapes=("long_500k",),
    notes="pure full attention -> long_500k skipped per assignment",
)
