"""yi-9b [dense]: 48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000 —
llama-architecture GQA. [arXiv:2403.04652; hf]

Pure full attention -> long_500k SKIPPED (DESIGN.md §5).
"""
import torch

from repro_torch.configs import ArchSpec, LM_SHAPES
from repro_torch.models.transformer import TransformerConfig


def make_config() -> TransformerConfig:
    return TransformerConfig(
        vocab_size=64_000, d_model=4096, n_layers=48, n_heads=32,
        n_kv_heads=4, d_head=128, d_ff=11_008,
        activation="swiglu", rope_theta=10_000.0, causal=True,
        dtype=torch.bfloat16, remat="full",
    )


def make_reduced() -> TransformerConfig:
    return TransformerConfig(
        vocab_size=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_head=16, d_ff=128, activation="swiglu", causal=True,
        dtype=torch.float32)


SPEC = ArchSpec(
    arch_id="yi-9b", family="lm",
    make_config=make_config, make_reduced=make_reduced,
    shapes=LM_SHAPES, skip_shapes=("long_500k",),
    notes="llama-arch GQA; full attention -> long_500k skipped",
)
