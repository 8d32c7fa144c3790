"""llama4-scout-17b-a16e [moe]: 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 experts top-1, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

Llama-4 uses iRoPE chunked local attention on most layers (chunk 8192),
which is what makes its long_500k decode cell sub-quadratic (DESIGN.md §5).
The [vlm]-style early-fusion frontend is a stub per the assignment:
input_specs provide token ids / precomputed embeddings only.
"""
import torch

from repro_torch.configs import ArchSpec, LM_SHAPES
from repro_torch.models.transformer import MoEConfig, TransformerConfig


def make_config() -> TransformerConfig:
    return TransformerConfig(
        vocab_size=202_048, d_model=5120, n_layers=48, n_heads=40,
        n_kv_heads=8, d_head=128, d_ff=8192,
        moe=MoEConfig(num_experts=16, top_k=1),
        activation="swiglu", rope_theta=500_000.0,
        attention_chunk=8192, causal=True,
        dtype=torch.bfloat16, remat="full",
    )


def make_reduced() -> TransformerConfig:
    return TransformerConfig(
        vocab_size=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_head=16, d_ff=96, moe=MoEConfig(num_experts=4, top_k=1),
        activation="swiglu", attention_chunk=16, causal=True,
        dtype=torch.float32)


SPEC = ArchSpec(
    arch_id="llama4-scout-17b-a16e", family="lm",
    make_config=make_config, make_reduced=make_reduced,
    shapes=LM_SHAPES,
    notes="MoE top-1, chunked attention 8192 -> long_500k runs windowed",
    # 16 experts == data axis: exact expert parallelism, expert-weight
    # gradients stay (1, D, F/16) per device instead of f32 full-D partials
    rules_override={"experts": "data", "embed": None},
)
