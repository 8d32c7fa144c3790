"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]
"""
import torch

from repro_torch.configs import ArchSpec, LM_SHAPES
from repro_torch.models.transformer import MoEConfig, TransformerConfig


def make_config() -> TransformerConfig:
    return TransformerConfig(
        vocab_size=32_768, d_model=6144, n_layers=56, n_heads=48,
        n_kv_heads=8, d_head=128, d_ff=16_384,
        moe=MoEConfig(num_experts=8, top_k=2),
        activation="swiglu", rope_theta=1_000_000.0,
        window=4096, causal=True,
        dtype=torch.bfloat16, remat="full",
    )


def make_reduced() -> TransformerConfig:
    return TransformerConfig(
        vocab_size=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_head=16, d_ff=96, moe=MoEConfig(num_experts=4, top_k=2),
        activation="swiglu", window=16, causal=True, dtype=torch.float32)


SPEC = ArchSpec(
    arch_id="mixtral-8x22b", family="lm",
    make_config=make_config, make_reduced=make_reduced,
    shapes=LM_SHAPES,
    notes="8 experts top-2; SWA 4096 -> long_500k runs with rolling cache",
)
