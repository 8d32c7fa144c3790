"""dien [recsys]: embed_dim=18 seq_len=100 gru_dim=108 mlp=200-80,
GRU + attention + AUGRU interest evolution. [arXiv:1809.03672; unverified]
"""
from repro_torch.configs import ArchSpec, RECSYS_SHAPES
from repro_torch.models.recsys import RecsysConfig


def make_config() -> RecsysConfig:
    return RecsysConfig(
        arch="dien", embed_dim=18, seq_len=100, gru_dim=108,
        dien_mlp=(200, 80), item_vocab=1_000_000, cat_vocab=10_000,
        n_dense=0, n_sparse=0)


def make_reduced() -> RecsysConfig:
    return RecsysConfig(
        arch="dien", embed_dim=8, seq_len=12, gru_dim=16, dien_mlp=(16, 8),
        item_vocab=128, cat_vocab=16, n_dense=0, n_sparse=0)


SPEC = ArchSpec(
    arch_id="dien", family="recsys",
    make_config=make_config, make_reduced=make_reduced,
    shapes=RECSYS_SHAPES,
)
