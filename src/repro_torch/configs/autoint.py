"""autoint [recsys]: n_sparse=39 embed_dim=16 n_attn_layers=3 n_heads=2
d_attn=32, self-attention feature interaction. [arXiv:1810.11921; paper]

39 Criteo fields = 13 bucketised dense + 26 categorical (Kaggle cards).
"""
from repro_torch.configs import ArchSpec, RECSYS_SHAPES
from repro_torch.models.recsys import CRITEO_KAGGLE_CARDS, RecsysConfig


def make_config() -> RecsysConfig:
    return RecsysConfig(
        arch="autoint", n_dense=0, n_sparse=39, embed_dim=16,
        vocab_sizes=CRITEO_KAGGLE_CARDS,
        n_attn_layers=3, n_heads=2, d_attn=32)


def make_reduced() -> RecsysConfig:
    return RecsysConfig(
        arch="autoint", n_dense=0, n_sparse=39, embed_dim=8,
        vocab_sizes=tuple([64] * 26), n_attn_layers=2, n_heads=2, d_attn=8)


SPEC = ArchSpec(
    arch_id="autoint", family="recsys",
    make_config=make_config, make_reduced=make_reduced,
    shapes=RECSYS_SHAPES,
)
